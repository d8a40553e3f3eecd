"""Snapshot serialization, JSON and Prometheus text (counterpart of
paddle_tpu/obs/export.py). Both are pure functions over
`MetricsRegistry.snapshot()`: they hold no lock and touch no live
object.

Prometheus exposition (text format 0.0.4): families render with
``# TYPE`` (and ``# HELP`` when set); histograms emit ``_bucket{le=...}``,
``_sum`` and ``_count``. Collector dicts flatten to untyped samples:
nested keys join with ``_``, lists of dicts take an ``idx`` label, number
and bool leaves emit, strings and None stay JSON-only. The order is
deterministic (sorted names, label sets and keys).
"""
from __future__ import annotations

import json
import math
import numbers
import re

__all__ = ["render_json", "render_prometheus", "sanitize_name",
           "escape_label_value"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(name):
    """A Prometheus metric name: [a-zA-Z_][a-zA-Z0-9_]*."""
    s = _NAME_RE.sub("_", str(name))
    if not s or s[0].isdigit():
        s = "_" + s
    return s


def escape_label_value(v):
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_text(labels, extra=None):
    items = dict(labels or {})
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{sanitize_name(k)}="{escape_label_value(v)}"'
                    for k, v in sorted(items.items()))
    return "{" + body + "}"


def _fmt(v):
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if not math.isfinite(f):
        return "NaN" if math.isnan(f) else ("+Inf" if f > 0 else "-Inf")
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _json_default(o):
    for cast in (int, float):
        try:
            return cast(o)
        except (TypeError, ValueError):
            continue
    return str(o)


def render_json(snapshot, indent=None):
    """Deterministic JSON of a registry snapshot (odd leaves such as numpy
    scalars degrade to numbers or strings)."""
    return json.dumps(snapshot, sort_keys=True, indent=indent,
                      default=_json_default)


def _numeric(value):
    if isinstance(value, bool):
        return 1 if value else 0
    if isinstance(value, numbers.Real):
        return float(value) if value % 1 else int(value)
    return None


def _flatten(prefix, value, out):
    num = _numeric(value)
    if num is not None:
        out.append((prefix, None, num))
    elif isinstance(value, dict):
        for k in sorted(value, key=str):
            _flatten(f"{prefix}_{sanitize_name(k)}", value[k], out)
    elif isinstance(value, (list, tuple)):
        for i, item in enumerate(value):
            if isinstance(item, dict):
                sub = []
                _flatten(prefix, item, sub)
                for name, lbl, v in sub:
                    merged = {"idx": i}
                    if lbl:
                        merged.update(lbl)
                    out.append((name, merged, v))
            else:
                num = _numeric(item)
                if num is not None:
                    out.append((prefix, {"idx": i}, num))


def render_prometheus(snapshot, exemplars=False):
    """`MetricsRegistry.snapshot()` as Prometheus text. ``exemplars=True``
    renders the OpenMetrics flavour: histogram buckets carry their
    trace-id exemplars (``# {trace_id="..."} v``, a parse error to a
    classic 0.0.4 parser, so obs.http serves it only under the OpenMetrics
    content type) and the text ends with ``# EOF``."""
    lines = []
    for name in sorted(snapshot.get("metrics", {})):
        children = snapshot["metrics"][name]
        pname = sanitize_name(name)
        kind = children[0]["kind"]
        helps = [c.get("help") for c in children if c.get("help")]
        if helps:
            lines.append(f"# HELP {pname} {escape_label_value(helps[0])}")
        lines.append(f"# TYPE {pname} {kind}")
        for c in sorted(children, key=lambda c: sorted(c["labels"].items())):
            labels = c["labels"]
            if kind == "histogram":
                exs = (c.get("exemplars") or {}) if exemplars else {}
                for i, (le, cum) in enumerate(c["buckets"]):
                    le = "+Inf" if le == "+Inf" else _fmt(le)
                    line = (f"{pname}_bucket"
                            f"{_labels_text(labels, {'le': le})} "
                            f"{_fmt(cum)}")
                    ex = exs.get(i, exs.get(str(i)))
                    if ex is not None:
                        # the last traced observation in this bucket
                        line += (f' # {{trace_id="{ex["trace_id"]}"}} '
                                 f'{_fmt(ex["value"])}')
                    lines.append(line)
                lines.append(f"{pname}_sum{_labels_text(labels)} "
                             f"{_fmt(c['sum'])}")
                lines.append(f"{pname}_count{_labels_text(labels)} "
                             f"{_fmt(c['count'])}")
            else:
                v = c.get("value")
                if v is None:
                    continue  # broken gauge callback: JSON has the error
                lines.append(f"{pname}{_labels_text(labels)} {_fmt(v)}")
    for cname in sorted(snapshot.get("collectors", {})):
        stats = snapshot["collectors"][cname]
        if not isinstance(stats, dict):
            continue
        flat = []
        _flatten(sanitize_name(cname), stats, flat)
        if not flat:
            continue
        lines.append(f"# collector {cname}")
        for name, lbl, v in sorted(
                flat, key=lambda t: (t[0], sorted((t[1] or {}).items()))):
            lines.append(f"{name}{_labels_text(None, lbl)} {_fmt(v)}")
    if exemplars:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"
