"""Per-request sampling for the decode engine (counterpart of
paddle_tpu/inference/sampling.py), batched over ``[n, V]`` logit rows.

`SamplingParams` is the request-side contract (temperature / top-k /
top-p / repetition penalty / seed / stop sequences). The helpers below
are the math the engine runs on the logits' device, one row per
sequence, each row with its own knobs and its own key:

* **Counter-based randomness.** A row's key is ``fold_in(PRNGKey(seed),
  ctr)`` with ``ctr`` the token's absolute output index, computed with
  JAX's threefry (`_threefry`): a draw is a pure function of (seed,
  output index) and the port draws the same random bits as the JAX
  engine.
* **Greedy rows are bit-identical to greedy decoding.** A row with
  ``greedy=1`` takes the raw-logits argmax behind a `torch.where`.
* **A row's draw does not depend on how many rows share the call**: the
  one reduction whose order PyTorch picks by the row count, top-p's
  cumsum, runs on fixed-size row groups.

The knobs travel as a "samp pack": one ``[n]`` tensor per `PACK_FIELDS`
entry.
"""
from __future__ import annotations

import torch

from . import _threefry

__all__ = ["SamplingParams", "apply_top_k", "apply_top_p",
           "apply_repetition_penalty", "sample_token", "PACK_FIELDS"]


class SamplingParams:
    """Per-request sampling contract for `DecodeEngine.submit`.

    ``temperature <= 0`` means greedy (argmax): the engine then takes the
    raw-argmax path regardless of the other knobs. ``stop_sequences`` are
    token-id tuples handled by the scheduler (the stream never emits a
    stop sequence or any part of one)."""

    __slots__ = ("temperature", "top_k", "top_p", "repetition_penalty",
                 "seed", "stop_sequences")

    def __init__(self, temperature=1.0, top_k=0, top_p=1.0,
                 repetition_penalty=1.0, seed=0, stop_sequences=()):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.repetition_penalty = float(repetition_penalty)
        self.seed = int(seed)
        stops = []
        for s in stop_sequences or ():
            toks = tuple(int(t) for t in s)
            if not toks:
                raise ValueError("empty stop sequence")
            stops.append(toks)
        self.stop_sequences = tuple(stops)
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.repetition_penalty <= 0.0:
            raise ValueError(f"repetition_penalty must be > 0, got "
                             f"{self.repetition_penalty}")
        if not 0 <= self.seed < 2 ** 32:
            raise ValueError(f"seed must be a u32, got {self.seed}")

    def is_greedy(self):
        return self.temperature <= 0.0

    def to_dict(self):
        """Wire form."""
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p,
                "repetition_penalty": self.repetition_penalty,
                "seed": self.seed, "stop_sequences": self.stop_sequences}

    @classmethod
    def from_dict(cls, d):
        return cls(**d)

    def __repr__(self):
        return (f"SamplingParams(temperature={self.temperature}, "
                f"top_k={self.top_k}, top_p={self.top_p}, "
                f"repetition_penalty={self.repetition_penalty}, "
                f"seed={self.seed}, "
                f"stop_sequences={self.stop_sequences})")


#: samp-pack fields and their dtypes: one [n] tensor each (the u32 seed
#: and the counter ride as int64)
PACK_FIELDS = (("ctr", torch.int64), ("greedy", torch.int32),
               ("rep", torch.float32), ("seed", torch.int64),
               ("temp", torch.float32), ("top_k", torch.int64),
               ("top_p", torch.float32))


def _col(v, logits, dtype):
    """A per-row knob (python number or [n] tensor) as an [n, 1] column."""
    t = torch.as_tensor(v, dtype=dtype, device=logits.device)
    return t.reshape(-1, 1).expand(logits.shape[0], 1)


def apply_top_k(logits, k):
    """Mask everything below each row's k-th largest logit; ``k <= 0``
    leaves the row as it is."""
    v = logits.shape[-1]
    k = _col(k, logits, torch.int64)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, (k - 1).clamp(0, v - 1))
    return torch.where((k > 0) & (logits < kth), float("-inf"), logits)


#: rows per cumsum call (see `_row_cumsum`)
_SCAN_ROWS = 8


def _row_cumsum(x):
    """cumsum over the last dim of [n, V] in an order that does not depend
    on n: PyTorch's CUDA scan sets its threads per row by the number of
    rows (and scans a lone row with CUB's device-wide scan), so the rows
    are scanned in zero-padded groups of exactly `_SCAN_ROWS`."""
    n = x.shape[0]
    pad = -n % _SCAN_ROWS
    if pad:
        x = torch.cat([x, x.new_zeros(pad, x.shape[1])])
    return torch.cat([torch.cumsum(g, dim=-1)
                      for g in x.split(_SCAN_ROWS)])[:n]


def apply_top_p(logits, p):
    """Nucleus filter: keep the smallest set of tokens whose cumulative
    probability reaches each row's `p`; ``p >= 1`` leaves the row."""
    v = logits.shape[-1]
    p = _col(p, logits, torch.float32)
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    cum = _row_cumsum(torch.softmax(sorted_l, dim=-1))
    cutoff_idx = (cum < p).sum(-1, keepdim=True)
    cutoff = sorted_l.gather(-1, cutoff_idx.clamp(0, v - 1))
    return torch.where((p < 1.0) & (logits < cutoff), float("-inf"), logits)


def apply_repetition_penalty(logits, history, penalty):
    """CTRL-style penalty over `history` [n, L] (token ids, -1 padding):
    seen tokens' logits are divided by the row's penalty when positive and
    multiplied when negative; ``penalty == 1`` leaves the row."""
    penalty = _col(penalty, logits, torch.float32)
    valid = history >= 0
    counts = torch.zeros(logits.shape, dtype=torch.int32,
                         device=logits.device)
    counts.scatter_add_(1, torch.where(valid, history, 0).long(),
                        valid.to(torch.int32))
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where((counts > 0) & (penalty != 1.0), pen, logits)


def sample_token(logits, pack, history=None):
    """One token per row of `logits` [n, V] (f32).

    `pack` maps each `PACK_FIELDS` name to this batch's [n] tensor;
    `history` [n, L] is the rows' token history (-1 padded) for the
    repetition penalty, or None where no row penalises. Greedy rows take
    the raw-logits argmax; sampled rows draw
    ``categorical(fold_in(PRNGKey(seed), ctr), filtered logits)``."""
    greedy_tok = torch.argmax(logits, dim=-1)
    l = logits
    if history is not None:
        l = apply_repetition_penalty(l, history, pack["rep"])
    l = l / _col(pack["temp"], logits, torch.float32).clamp_min(1e-6)
    l = apply_top_k(l, pack["top_k"])
    l = apply_top_p(l, pack["top_p"])
    key = _threefry.fold_in(_threefry.prng_key(pack["seed"]), pack["ctr"])
    sampled = _threefry.categorical(key, l)
    return torch.where(pack["greedy"] > 0, greedy_tok, sampled)
