"""Declared service-level objectives and their gate (counterpart of the
`Objective` / `evaluate` half of paddle_tpu/obs/slo.py). The router's
SLO autoscaler evaluates its windowed p99s through `evaluate`, so the
autoscaler and any release gate share one notion of meeting an SLO.

An `Objective` names one number and its direction: ``kind="max"`` must
stay at or under its bound (a latency p99), ``kind="min"`` at or over it
(a throughput). A declared objective missing from the measured values or
from the baseline is a breach.
"""
from __future__ import annotations

__all__ = ["Objective", "evaluate", "format_report"]


class Objective:
    """One named SLO: a measured value, a direction and ratchet slack."""

    KINDS = ("max", "min")

    def __init__(self, name, kind, description="", unit="", slack=2.0):
        if kind not in self.KINDS:
            raise ValueError(f"kind must be one of {self.KINDS}, "
                             f"got {kind!r}")
        if slack < 1.0:
            raise ValueError(f"slack must be >= 1.0, got {slack}")
        self.name = str(name)
        self.kind = kind
        self.description = str(description)
        self.unit = str(unit)
        self.slack = float(slack)

    def bound_from(self, value):
        """The bound a measurement of `value` ratchets to."""
        v = float(value)
        return v * self.slack if self.kind == "max" else v / self.slack

    def ok(self, value, bound):
        return (value <= bound) if self.kind == "max" else (value >= bound)

    def __repr__(self):
        return (f"Objective({self.name!r}, {self.kind!r}, "
                f"unit={self.unit!r}, slack={self.slack})")


def evaluate(values, baseline, objectives):
    """Gate `values` ({name: measured}) against `baseline` ({name:
    {"kind", "bound"}}). Returns ``{"ok", "results": [{name, kind, value,
    bound, ok, reason?}], "breaches": [name, ...]}``."""
    results = []
    for obj in objectives:
        entry = baseline.get(obj.name)
        value = values.get(obj.name)
        row = {"name": obj.name, "kind": obj.kind, "unit": obj.unit,
               "value": value,
               "bound": None if entry is None else entry.get("bound")}
        if value is None:
            row.update(ok=False, reason="objective declared but not measured")
        elif entry is None or entry.get("bound") is None:
            row.update(ok=False, reason="no baseline bound")
        elif entry.get("kind", obj.kind) != obj.kind:
            row.update(ok=False, reason=f"baseline kind {entry.get('kind')!r}"
                                        f" != declared {obj.kind!r}")
        else:
            row["ok"] = obj.ok(float(value), float(entry["bound"]))
            if not row["ok"]:
                cmp = "over" if obj.kind == "max" else "under"
                row["reason"] = (f"{value:.6g} {obj.unit} is {cmp} the "
                                 f"bound {entry['bound']:.6g}")
        results.append(row)
    breaches = [r["name"] for r in results if not r["ok"]]
    return {"ok": not breaches, "results": results, "breaches": breaches}


def format_report(report):
    """One line an objective, then the verdict."""
    lines = []
    for r in report["results"]:
        mark = "PASS" if r["ok"] else "FAIL"
        op = "<=" if r["kind"] == "max" else ">="
        val = "unmeasured" if r["value"] is None else f"{r['value']:.6g}"
        bound = "unset" if r["bound"] is None else f"{r['bound']:.6g}"
        line = f"  {mark} {r['name']}: {val} {op} {bound} {r['unit']}".rstrip()
        if not r["ok"] and r.get("reason"):
            line += f"  ({r['reason']})"
        lines.append(line)
    verdict = "SLO gate: PASS" if report["ok"] else \
        f"SLO gate: FAIL ({len(report['breaches'])} breach(es))"
    return "\n".join(lines + [verdict])
