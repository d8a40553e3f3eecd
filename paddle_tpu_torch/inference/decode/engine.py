"""Continuous-batching LLM decode over a paged KV cache (counterpart of
paddle_tpu/inference/decode/engine.py).

Iteration-level scheduling (Orca, vLLM): one scheduler thread runs rounds;
each round admits waiting sequences, runs ONE prefill chunk and ONE
batched decode step:

* **Paged KV cache** (`block_pool.BlockKVCache`): one pool of fixed-size
  blocks per layer on the GPU. A sequence grows block by block and
  returns its blocks the moment it leaves.
* **Admission with worst-case reservation**: a sequence is admitted when
  a batch slot is free AND the free blocks cover its worst-case growth on
  top of every live sequence's remaining worst case, so lazy per-step
  block allocation never fails mid-flight.
* **Chunked prefill** (Sarathi-Serve): a prompt longer than the chunk is
  prefilled one block-aligned chunk per round, shortest remaining prompt
  first, interleaved with the running batch's decode steps. The chunk
  writes its K/V rows block by block into the pool and attends in plain
  PyTorch over the sequence's gathered rows. The sequence joins the
  running batch after its last chunk.
* **Bucketed batched decode step**: the active sequences are padded to
  the smallest decode bucket that holds them (padded rows carry an
  all-zeros block table, so their writes land in reserved block 0). The
  step writes each sequence's new K/V row at ``(table[pos // BS],
  pos % BS)`` (int8 pools quantize it first) and attends with the paged
  flash-decoding kernel (`ops.decode_attn.paged_decode_attention`),
  which reads every sequence's blocks in place through its table.
* **Typed request semantics**: a bounded waiting queue (`Overloaded`),
  per-sequence deadlines covering queue wait and generation
  (`DeadlineExceeded`), cancel (`PoolClosed`), `PoolClosed` after
  shutdown, and `RequestFailed` for execution faults. A failed
  multi-sequence step is re-run as single-sequence steps so only the
  culpable sequence fails (a re-run rewrites the same rows from the same
  committed state).

Determinism contract. Decoding is greedy (argmax). The JAX engine gets
bit-identity across batch sizes from a scan over sequences; this port runs
the batch as one set of batched products instead, and promises this:
both hand-written kernels are row-stable — each output row is reduced in
an order that does not depend on how many rows share the launch (the
weight-only matmul runs its GEMV for every m <= 16, which covers every
decode bucket; the paged attention has one block per (head, sequence)) —
and, in float32 on the CPU, a sequence's tokens are the same decoded
alone and in a batch (tested). The float Linears go through the BLAS
library (cuBLAS on the GPU), which may pick another reduction for another
batch size, so on the GPU with float weights the logits of a sequence can
differ in the last bits between batch sizes and a near-tie can flip a
token; `chip_smoke.py` reports how many sequences agree.

Not ported yet (passing them raises `NotImplementedError`): the prefix
cache with copy-on-write sharing (``prefix_cache`` therefore defaults to
False here), speculative decoding, LoRA adapters (BGMV), `SamplingParams`,
tensor-parallel meshes, the `ServingPool` integration, the AOT compile
cache and the fault hook.

Usage::

    engine = DecodeEngine(model, max_length=1024, block_size=16)
    stream = engine.submit(prompt_ids, max_new_tokens=64, timeout=5.0)
    for tok in stream:          # tokens stream out as they are decoded
        ...
    engine.shutdown()
"""
from __future__ import annotations

import math
import queue
import threading
import time

import numpy as np
import torch

from ... import resolve_device
from ...models.gpt import PagedBatch
from ..serving import (Deadline, DeadlineExceeded, Overloaded, PoolClosed,
                       RequestFailed)
from .block_pool import OutOfBlocks, RESERVED_BLOCKS

__all__ = ["DecodeEngine", "SequenceStream"]

_WAITING, _PREFILL, _ACTIVE, _DONE = "waiting", "prefill", "active", "done"
_END = object()   # stream sentinel

#: unported constructor / submit options -> the later slice that ports them
_LATER = {
    "prefix_cache": "the prefix-cache (copy-on-write sharing) slice",
    "prefix_cache_blocks": "the prefix-cache (copy-on-write sharing) slice",
    "draft_model": "the speculative-decoding slice",
    "speculate_k": "the speculative-decoding slice",
    "draft_num_blocks": "the speculative-decoding slice",
    "adapters": "the multi-tenant LoRA (BGMV) slice",
    "adapter": "the multi-tenant LoRA (BGMV) slice",
    "sampling": "the prefix-cache slice, with SamplingParams",
    "resume_committed": "the serving-runtime slice",
    "mesh": "the parallelism (NCCL) slice",
    "sharding_rules": "the parallelism (NCCL) slice",
    "compile_cache": "the serving-runtime slice",
    "fault_hook": "the serving-runtime slice",
}


def _not_ported(name):
    raise NotImplementedError(
        f"{name}= is not ported to paddle_tpu_torch yet; it comes with "
        f"{_LATER[name]}")


class SequenceStream:
    """Per-sequence streaming handle returned by `DecodeEngine.submit`.

    Iterate to receive tokens as they are decoded; iteration ends on
    completion or raises the sequence's typed error. The deadline is also
    enforced on the caller side. `.tokens` holds the tokens delivered so
    far; `.logits` the first `keep_logits` next-token logit rows (f32, on
    the CPU) when the submit asked for them."""

    def __init__(self, seq_id, deadline):
        self.id = seq_id
        self.deadline = deadline
        self.tokens = []
        self.logits = []
        self.ttft = None          # seconds from submit to first token
        self._q = queue.Queue()
        self._status = "running"
        self._error = None
        self._cancel = None
        self._raised = False

    def _push(self, tok):
        self.tokens.append(tok)
        self._q.put(tok)

    def _finish(self, status, error=None):
        self._status = status
        self._error = error
        self._q.put(_END)

    @property
    def status(self):
        return self._status

    def done(self):
        return self._status != "running"

    def cancel(self):
        """Evict this sequence at the next step boundary."""
        if self._cancel is not None:
            self._cancel()

    def __iter__(self):
        return self

    def __next__(self):
        if self._raised:
            raise StopIteration
        limit = self.deadline.remaining()
        try:
            if limit is not None and limit <= 0:
                item = self._q.get_nowait()
            else:
                item = self._q.get(timeout=limit)
        except queue.Empty:
            self._raised = True
            raise DeadlineExceeded(
                f"sequence {self.id} exceeded its deadline while waiting "
                f"for the next token") from None
        if item is not _END:
            return item
        self._raised = True
        if self._status == "completed":
            raise StopIteration
        raise self._error

    def result(self):
        """Drain to completion; returns the generated tokens or raises."""
        for _ in self:
            pass
        return list(self.tokens)


class _Seq:
    __slots__ = ("id", "prompt", "max_new", "deadline", "stream", "state",
                 "blocks", "reserved_total", "outstanding", "pos",
                 "prefill_pos", "last_token", "generated", "cancelled",
                 "submitted_at", "keep_logits")

    def __init__(self, sid, prompt, max_new, deadline):
        self.id = sid
        self.prompt = prompt            # np.int64 [prompt_len]
        self.max_new = max_new
        self.deadline = deadline
        self.stream = SequenceStream(sid, deadline)
        self.state = _WAITING
        self.blocks = []                # pool block ids, table order
        self.reserved_total = 0         # worst-case blocks (admission)
        self.outstanding = 0            # allocations still to come
        self.pos = 0                    # cache position of last_token
        self.prefill_pos = 0            # prompt tokens already cached
        self.last_token = None
        self.generated = 0
        self.cancelled = False
        self.submitted_at = None
        self.keep_logits = 0


class DecodeEngine:
    """Iteration-level greedy decode engine over a paged KV cache. See
    the module docstring for the semantics and the determinism contract.

    `device` defaults to the GPU (raising when there is none) and must be
    the model's device."""

    def __init__(self, model, *, max_length, block_size=16, num_blocks=None,
                 decode_buckets=(1, 2, 4, 8), prefill_buckets=None,
                 prefill_chunk=None, quant=None, max_waiting=64,
                 default_timeout=None, eos_token_id=None, pad_token_id=0,
                 prefix_cache=False, device=None, clock=time.monotonic,
                 **unported):
        for name, value in unported.items():
            if name not in _LATER:
                raise TypeError(f"DecodeEngine got an unexpected keyword "
                                f"argument {name!r}")
            if value not in (None, 0, False):
                _not_ported(name)
        if prefix_cache:
            _not_ported("prefix_cache")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine device is "
                             f"{self.device}")
        if max_length < 2:
            raise ValueError("max_length must be >= 2 (prompt + 1 token)")
        bs = sorted({int(b) for b in decode_buckets})
        if not bs or bs[0] < 1:
            raise ValueError(f"decode_buckets must be positive ints, got "
                             f"{decode_buckets}")
        self.model = model
        model.eval()
        self.max_length = int(max_length)
        self.block_size = int(block_size)
        self.decode_buckets = tuple(bs)
        self.max_active = self.decode_buckets[-1]
        self.eos_token_id = eos_token_id
        self.pad_token_id = int(pad_token_id)
        self.default_timeout = default_timeout
        self._clock = clock
        self._vocab = model.cfg.vocab_size

        if prefill_buckets is None:
            p, buckets = min(8, self.max_length - 1), []
            while p < self.max_length - 1:
                buckets.append(p)
                p *= 2
            buckets.append(self.max_length - 1)
            prefill_buckets = buckets
        # eager PyTorch needs no padded prefill shapes: the buckets bound
        # the prompt length and name the legal chunk sizes, as in the JAX
        # engine, but a chunk runs at its own length
        self.prefill_buckets = tuple(sorted({int(p)
                                             for p in prefill_buckets}))
        self.max_prompt = min(self.prefill_buckets[-1], self.max_length - 1)
        candidates = [b for b in self.prefill_buckets
                      if b % self.block_size == 0]
        if prefill_chunk is None:
            fits = [b for b in candidates if 2 * b <= self.max_prompt]
            self._chunk = fits[-1] if fits else 0
        elif not prefill_chunk:
            self._chunk = 0
        else:
            c = int(prefill_chunk)
            if c not in candidates:
                raise ValueError(
                    f"prefill_chunk {c} must be one of the prefill buckets "
                    f"{self.prefill_buckets} and a multiple of block_size "
                    f"{self.block_size}")
            self._chunk = c

        self._nb = max(1, math.ceil(self.max_length / self.block_size))
        if num_blocks is None:
            num_blocks = RESERVED_BLOCKS + self.max_active * self._nb
        self.pool = model.init_block_pool(num_blocks, self.block_size,
                                          quant=quant, name="target")

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._waiting = []
        self._prefill_q = []
        self._active = []
        self.max_waiting = int(max_waiting)
        self._ids = 0
        self._closed = False
        self._stopping = False
        self._shutdown_called = False
        self._drained = False

        self._admitted = self._completed = self._failed = 0
        self._timed_out = self._cancelled = self._shed = 0
        self._steps_run = self._prefills = self._prefill_chunks = 0
        self._tokens_out = self._isolations = 0
        self._step_slots = self._step_active = self._peak_resident = 0
        self._ttfts = []

        self._thread = threading.Thread(target=self._loop,
                                        name="DecodeEngine-scheduler",
                                        daemon=True)
        self._thread.start()

    # -- admission ---------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens, timeout=None, *,
               keep_logits=0, **unported):
        """Admit one generation request; returns its `SequenceStream`.

        Malformed requests raise `ValueError` synchronously; a full
        waiting queue raises `Overloaded`, a closed engine `PoolClosed`, a
        dead-on-arrival deadline `DeadlineExceeded`. `timeout` (None ->
        `default_timeout`, both None -> unbounded) covers queue wait and
        generation. `keep_logits=k` keeps the first k next-token logit
        rows on the stream (the prefill's, then each decode step's)."""
        for name, value in unported.items():
            if name not in _LATER:
                raise TypeError(f"submit() got an unexpected keyword "
                                f"argument {name!r}")
            if value is not None:
                _not_ported(name)
        ids = np.asarray(prompt_ids.cpu() if torch.is_tensor(prompt_ids)
                         else prompt_ids)
        if ids.ndim == 2 and ids.shape[0] == 1:
            ids = ids[0]
        if ids.ndim != 1 or not np.issubdtype(ids.dtype, np.integer):
            raise ValueError(f"prompt must be a 1-D integer id array, got "
                             f"shape {ids.shape} dtype {ids.dtype}")
        if not 1 <= ids.shape[0] <= self.max_prompt:
            raise ValueError(f"prompt length {ids.shape[0]} outside [1, "
                             f"{self.max_prompt}]")
        if int(ids.min()) < 0 or int(ids.max()) >= self._vocab:
            raise ValueError(f"prompt ids must be in [0, {self._vocab})")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if ids.shape[0] + max_new > self.max_length:
            raise ValueError(
                f"prompt ({ids.shape[0]}) + max_new_tokens ({max_new}) "
                f"exceeds max_length {self.max_length}")
        worst = self.pool.blocks_for(ids.shape[0] + max_new)
        if worst > self.pool.num_blocks - RESERVED_BLOCKS:
            raise ValueError(f"request needs {worst} worst-case blocks but "
                             f"the pool holds only "
                             f"{self.pool.num_blocks - RESERVED_BLOCKS}")
        eff = self.default_timeout if timeout is None else timeout
        dl = Deadline(eff, clock=self._clock)
        with self._cv:
            if self._closed:
                self._shed += 1
                raise PoolClosed("decode engine is shut down — admission "
                                 "refused")
            if dl.expired():
                self._shed += 1
                raise DeadlineExceeded("dead on arrival: deadline expired "
                                       "before admission")
            if len(self._waiting) >= self.max_waiting:
                self._shed += 1
                raise Overloaded(f"decode waiting queue full "
                                 f"({self.max_waiting} deep) — request shed")
            self._ids += 1
            seq = _Seq(self._ids, ids.astype(np.int64), max_new, dl)
            seq.keep_logits = int(keep_logits)
            seq.submitted_at = self._clock()
            seq.stream._cancel = lambda s=seq: self._request_cancel(s)
            self._waiting.append(seq)
            self._admitted += 1
            self._cv.notify()
        return seq.stream

    def generate(self, prompt_ids, max_new_tokens, timeout=None):
        """Submit and drain; returns the generated token list."""
        return self.submit(prompt_ids, max_new_tokens,
                           timeout=timeout).result()

    def _request_cancel(self, seq):
        with self._cv:
            seq.cancelled = True
            self._cv.notify()

    # -- scheduler ---------------------------------------------------------
    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            while True:
                with self._cv:
                    if self._stopping:
                        return
                    idle = not (self._waiting or self._active
                                or self._prefill_q)
                    if idle and self._closed:
                        return
                    if idle:
                        self._cv.wait(0.05)
                        continue
                try:
                    self._sweep_waiting()
                    self._admit_waiting()
                    self._sweep_prefilling()
                    self._prefill_round()
                    if self._active:
                        self._decode_round()
                except Exception as exc:  # noqa: BLE001 — the scheduler
                    # survives anything: fail the implicated sequences
                    err = RequestFailed(f"decode scheduler error: "
                                        f"{type(exc).__name__}: {exc}",
                                        cause=exc)
                    for seq in list(self._active) + list(self._prefill_q):
                        self._finish(seq, "failed", err)

    def _sweep_waiting(self):
        with self._cv:
            keep = []
            for seq in self._waiting:
                if seq.cancelled:
                    self._finish_locked(seq, "cancelled", PoolClosed(
                        f"sequence {seq.id} cancelled before prefill"))
                elif seq.deadline.expired():
                    self._finish_locked(seq, "timed_out", DeadlineExceeded(
                        f"sequence {seq.id} expired in the waiting queue"))
                else:
                    keep.append(seq)
            self._waiting = keep

    def _admit_waiting(self):
        """Admit from the head of the queue while a batch slot is free and
        the free blocks cover the newcomer's worst case on top of every
        live sequence's outstanding worst case."""
        with self._cv:
            while self._waiting and not self._stopping:
                if len(self._active) + len(self._prefill_q) \
                        >= self.max_active:
                    return
                seq = self._waiting[0]
                seq.reserved_total = self.pool.blocks_for(
                    len(seq.prompt) + seq.max_new)
                reserve = sum(s.outstanding
                              for s in self._active + self._prefill_q)
                if self.pool.free_count < reserve + seq.reserved_total:
                    return        # not enough headroom yet
                self._waiting.pop(0)
                seq.outstanding = seq.reserved_total
                seq.state = _PREFILL
                self._prefill_q.append(seq)
                self._peak_resident = max(
                    self._peak_resident,
                    len(self._active) + len(self._prefill_q))

    def _sweep_prefilling(self):
        with self._cv:
            for seq in list(self._prefill_q):
                if seq.cancelled:
                    self._finish_locked(seq, "cancelled", PoolClosed(
                        f"sequence {seq.id} cancelled during prefill"))
                elif seq.deadline.expired():
                    self._finish_locked(seq, "timed_out", DeadlineExceeded(
                        f"sequence {seq.id} expired during prefill"))

    def _prefill_round(self):
        """ONE prefill chunk for the queued sequence with the fewest
        remaining prompt tokens; a fault fails only that sequence."""
        with self._cv:
            if self._stopping or not self._prefill_q:
                return
            seq = min(self._prefill_q,
                      key=lambda s: (len(s.prompt) - s.prefill_pos, s.id))
        try:
            self._prefill_chunk(seq)
        except Exception as exc:  # noqa: BLE001 — fail THIS sequence
            self._finish(seq, "failed", RequestFailed(
                f"sequence {seq.id}: prefill error: "
                f"{type(exc).__name__}: {exc}", cause=exc))

    def _prefill_chunk(self, seq):
        plen = len(seq.prompt)
        start = seq.prefill_pos
        remaining = plen - start
        this_len = self._chunk if (self._chunk and remaining > self._chunk) \
            else remaining
        need = self.pool.blocks_for(start + this_len) - len(seq.blocks)
        if need > 0:
            seq.blocks += self.pool.alloc(need, owner=seq.id)
            seq.outstanding -= need
        dev = self.device
        table = torch.tensor(seq.blocks, dtype=torch.int64, device=dev)
        batch = PagedBatch.prefill(table, start, this_len, self.block_size)
        tokens = torch.as_tensor(seq.prompt[start:start + this_len],
                                 device=dev)[None]
        logits = self.model.decode_step_paged(tokens, self.pool.tensors,
                                              batch)
        last = logits[0, -1].to(torch.float32)
        done = start + this_len
        seq.prefill_pos = done
        with self._lock:
            self._prefill_chunks += 1
        if done < plen:
            return
        tok = int(last.argmax())
        if seq.keep_logits:
            seq.stream.logits.append(last.cpu())
        with self._cv:
            self._prefills += 1
            seq.state = _ACTIVE
            seq.pos = plen
            if seq in self._prefill_q:
                self._prefill_q.remove(seq)
            self._active.append(seq)
        self._deliver(seq, tok)

    def _deliver(self, seq, tok):
        """Commit one token: stream it, retire the sequence if done."""
        seq.last_token = tok
        seq.generated += 1
        if seq.generated == 1 and seq.submitted_at is not None:
            seq.stream.ttft = self._clock() - seq.submitted_at
            with self._lock:
                self._ttfts.append(seq.stream.ttft)
        seq.stream._push(int(tok))
        with self._lock:
            self._tokens_out += 1
        if (self.eos_token_id is not None and tok == self.eos_token_id) \
                or seq.generated >= seq.max_new:
            self._finish(seq, "completed")

    def _decode_round(self):
        for seq in list(self._active):
            if seq.cancelled:
                self._finish(seq, "cancelled", PoolClosed(
                    f"sequence {seq.id} cancelled mid-generation"))
            elif seq.deadline.expired():
                self._finish(seq, "timed_out", DeadlineExceeded(
                    f"sequence {seq.id} exceeded its deadline "
                    f"mid-generation"))
        active = list(self._active)
        for seq in list(active):
            if seq.pos >= len(seq.blocks) * self.block_size:
                try:
                    seq.blocks += self.pool.alloc(1, owner=seq.id)
                    seq.outstanding -= 1
                except OutOfBlocks as e:
                    active.remove(seq)
                    self._finish(seq, "failed", RequestFailed(
                        f"sequence {seq.id}: block pool exhausted "
                        f"mid-decode (admission reserve bug)", cause=e))
        if not active:
            return
        try:
            nxt = self._dispatch_decode(active)
        except Exception as exc:  # noqa: BLE001 — isolate the culprit
            if len(active) == 1:
                self._finish(active[0], "failed", RequestFailed(
                    f"sequence {active[0].id}: decode step error: "
                    f"{type(exc).__name__}: {exc}", cause=exc))
                return
            with self._lock:
                self._isolations += 1
            self._run_isolated(active)
            return
        for seq, tok in zip(active, nxt):
            self._deliver(seq, tok)

    def _dispatch_decode(self, active):
        n = len(active)
        bucket = next(b for b in self.decode_buckets if b >= n)
        tokens = np.zeros((bucket, 1), np.int64)
        positions = np.zeros(bucket, np.int32)
        tables = np.zeros((bucket, self._nb), np.int32)  # pad rows -> 0
        for i, seq in enumerate(active):
            tokens[i, 0] = seq.last_token
            positions[i] = seq.pos
            tables[i, :len(seq.blocks)] = seq.blocks
        dev = self.device
        batch = PagedBatch.decode(torch.from_numpy(tables).to(dev),
                                  torch.from_numpy(positions).to(dev),
                                  self.block_size)
        logits = self.model.decode_step_paged(
            torch.from_numpy(tokens).to(dev), self.pool.tensors, batch)
        rows = logits[:n, -1].to(torch.float32)
        nxt = rows.argmax(-1).tolist()
        for i, seq in enumerate(active):
            if len(seq.stream.logits) < seq.keep_logits:
                seq.stream.logits.append(rows[i].cpu())
            seq.pos += 1
        with self._lock:
            self._steps_run += 1
            self._step_slots += bucket
            self._step_active += n
        return nxt

    def _run_isolated(self, seqs):
        for seq in seqs:
            if seq.state != _ACTIVE:
                continue
            try:
                nxt = self._dispatch_decode([seq])
            except Exception as exc:  # noqa: BLE001
                self._finish(seq, "failed", RequestFailed(
                    f"sequence {seq.id}: decode step error: "
                    f"{type(exc).__name__}: {exc}", cause=exc))
                continue
            self._deliver(seq, nxt[0])

    # -- lifecycle ---------------------------------------------------------
    def _finish(self, seq, status, error=None):
        with self._cv:
            self._finish_locked(seq, status, error)

    def _finish_locked(self, seq, status, error=None):
        if seq.state == _DONE:
            return
        seq.state = _DONE
        seq.outstanding = 0
        if seq in self._active:
            self._active.remove(seq)
        if seq in self._prefill_q:
            self._prefill_q.remove(seq)
        self.pool.free_owned(seq.id)
        if status == "completed":
            self._completed += 1
        elif status == "failed":
            self._failed += 1
        elif status == "timed_out":
            self._timed_out += 1
        else:
            self._cancelled += 1
        seq.stream._finish(status, error)

    def shutdown(self, drain_timeout=30.0):
        """Stop admissions, decode until every live sequence finishes (or
        `drain_timeout` passes), fail leftovers with `PoolClosed`, stop
        the scheduler. Returns True on a full drain. Idempotent."""
        with self._cv:
            if self._shutdown_called:
                return self._drained
            self._shutdown_called = True
            self._closed = True
            self._cv.notify_all()
        dl = Deadline(drain_timeout, clock=self._clock)
        drained = True
        while True:
            with self._cv:
                if not (self._waiting or self._active or self._prefill_q):
                    break
            if dl.expired():
                drained = False
                break
            time.sleep(0.005)
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._thread.join(timeout=30.0)
        with self._cv:
            leftovers = self._waiting + self._prefill_q + self._active
            self._waiting = []
            for seq in list(leftovers):
                self._finish_locked(seq, "cancelled", PoolClosed(
                    f"engine shut down before sequence {seq.id} finished"))
        self._drained = drained
        return drained

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- observability -----------------------------------------------------
    def stats(self):
        """Counter snapshot. Quiesced: ``admitted == completed + failed +
        timed_out + cancelled``; `blocks` carries the pool's conservation
        numbers (checked as they are read)."""
        with self._cv:
            used = sum(s.pos for s in self._active)
            slots = sum(len(s.blocks) for s in self._active) \
                * self.block_size
            ttfts = sorted(self._ttfts)
            snap = {
                "admitted": self._admitted,
                "completed": self._completed,
                "failed": self._failed,
                "timed_out": self._timed_out,
                "cancelled": self._cancelled,
                "shed": self._shed,
                "waiting": len(self._waiting),
                "prefilling": len(self._prefill_q),
                "active": len(self._active),
                "peak_resident": self._peak_resident,
                "steps": self._steps_run,
                "prefills": self._prefills,
                "prefill_chunks": self._prefill_chunks,
                "tokens_out": self._tokens_out,
                "isolation_rounds": self._isolations,
                "occupancy": (self._step_active / self._step_slots)
                if self._step_slots else 0.0,
                "internal_fragmentation": (1.0 - used / slots)
                if slots else 0.0,
                "prefix_cache": {"enabled": False},
                "buckets": {"decode": list(self.decode_buckets),
                            "prefill": list(self.prefill_buckets),
                            "prefill_chunk": self._chunk},
            }

        def pct(q):
            if not ttfts:
                return None
            return ttfts[min(len(ttfts) - 1, int(q * len(ttfts)))]

        snap["ttft"] = {"count": len(ttfts),
                        "avg_s": sum(ttfts) / len(ttfts) if ttfts else None,
                        "p50_s": pct(0.5), "p95_s": pct(0.95),
                        "p99_s": pct(0.99)}
        snap["blocks"] = self.pool.stats()
        return snap
