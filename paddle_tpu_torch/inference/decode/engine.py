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
* **One step program per (kind, bucket)** (`step_graphs`, the
  counterpart of the JAX engine's bucketed AOT step executables): a
  greedy and a sampled decode step, and with speculation on a propose
  and a verify step, each over static input buffers. On the GPU each is
  a CUDA graph, captured once on the scheduler thread (`warmup()`
  builds them all up front), and a step is one host-to-device copy, one
  replay and the copy of its tokens; on the CPU the same program runs
  eagerly. Prefill chunks run eagerly, at their own length.
* **Speculative decoding** (Leviathan et al. 2023; ``draft_model=``,
  ``speculate_k=K``): a draft model proposes K tokens a round from its
  own paged pool (the propose program: K + 1 draft steps, each fed the
  previous step's argmax), and the target scores the K + 1 positions in
  the verify program: K + 1 runs of the plain decode step's own body, so
  every verified argmax is the plain greedy step's bit for bit. Greedy
  acceptance commits the longest agreeing prefix plus the target's
  correction (or bonus) token; the draft's rejected rows roll back by
  position. Greedy, adapter-free sequences speculate; the rest take the
  plain step. The draft prefills each of the target's prefill chunks
  beside it; where it lags (a prefix-cache hit, plain steps after a
  fallback) it catches up over the committed tokens one chunk a round,
  eagerly like prefill.
* **Copy-on-write prefix sharing** (vLLM): a completed prefill publishes
  its prompt's blocks into a prefix cache keyed by token content and
  adapter signature — a full-prompt entry, plus one entry at every
  chunk boundary. Admission matches the longest cached prefix and bumps
  block refcounts instead of prefilling those tokens again; a sequence
  whose write lands in a block another holder references copies that
  block first (`BlockKVCache.copy_block`, in place). Entries pin their
  blocks and are LRU-evicted under admission pressure or the block cap.
  Chunks start at absolute multiples of the chunk size and run at their
  own length, so a sequence that matched a boundary prefills its
  remainder in the same chunks a private run would: sharing is
  bit-exact.
* **Per-request sampling** (`sampling.SamplingParams`): temperature,
  top-k, top-p, repetition penalty, seed and stop sequences; the draw of
  a token is a pure function of (seed, output index), made with JAX's
  threefry. Greedy rows (no params, or temperature <= 0) take the
  raw-logits argmax. Only greedy sequences publish full-prompt entries
  and take full-prompt hits (a hit delivers the publisher's next token).
* **Multi-tenant LoRA** (`adapter_pool.AdapterPool`, S-LoRA / Punica): a
  request names an adapter; its slot is pinned for the sequence's life,
  and every model call runs inside an `adapter_context`: a scalar slot
  id for a prefill chunk, a ``[bucket]`` id vector (padded rows at slot
  0) for a decode step, whose deltas go through the BGMV kernel
  (`ops.bgmv.lora_delta`) in one launch per projection.
* **Typed request semantics**: a bounded waiting queue (`Overloaded`),
  per-sequence deadlines covering queue wait and generation
  (`DeadlineExceeded`), cancel (`PoolClosed`), `PoolClosed` after
  shutdown, and `RequestFailed` for execution faults. A failed
  multi-sequence step is re-run as single-sequence steps so only the
  culpable sequence fails (a re-run rewrites the same rows from the same
  committed state).

Determinism contract. The JAX engine gets bit-identity across batch sizes
from a scan over sequences; this port runs the batch as one set of
batched products instead, and promises this: the hand-written kernels are
row-stable — each output row is reduced in an order that does not depend
on how many rows share the launch (the weight-only matmul runs its GEMV
for every m <= 16, which covers every decode bucket; a decode step's
float Linears and vocab projection run the float GEMV `ops.weight_only.
row_gemv` (cuBLAS may pick its reduction by m); the paged attention
has one block per (head, sequence); BGMV reduces each row inside one
CTA), the norms sum each row in two fixed stages and the sampler scans
top-p's cumsum in fixed-size row groups (PyTorch's own CUDA mean and scan
pick their order by the row count) — and, in float32 on the
CPU, a sequence's tokens are the same decoded alone and in a batch
(tested). So on the GPU a sequence's decode logits are bit-identical in
every bucket (tests/test_torch_cuda.py holds the bf16 decode step), and
`chip_smoke.py` holds every sequence's tokens alone equal to its tokens
in a batch. Prefill chunks keep cuBLAS: a chunk is one sequence's, of
the same length alone and in a batch.

Not ported yet (passing them raises `NotImplementedError`):
`resume_committed`, tensor-parallel meshes, the `ServingPool`
integration, the on-disk compile cache and the fault hook.

Usage::

    engine = DecodeEngine(model, max_length=1024, block_size=16)
    stream = engine.submit(prompt_ids, max_new_tokens=64, timeout=5.0)
    for tok in stream:          # tokens stream out as they are decoded
        ...
    engine.shutdown()
"""
from __future__ import annotations

import contextlib
import hashlib
import itertools
import math
import queue
import threading
import time

import numpy as np
import torch

from ... import resolve_device
from ...models.gpt import PagedBatch
from ..sampling import PACK_FIELDS, SamplingParams, sample_token
from ..serving import (AdapterNotLoaded, Deadline, DeadlineExceeded,
                       Overloaded, PoolClosed, RequestFailed)
from .adapter_pool import AdapterPool, adapter_context
from .block_pool import OutOfBlocks, RESERVED_BLOCKS
from .step_graphs import StepPrograms

__all__ = ["DecodeEngine", "SequenceStream"]

_WAITING, _PREFILL, _ACTIVE, _DONE = "waiting", "prefill", "active", "done"
_END = object()   # stream sentinel

#: reference-owner tag of the blocks the prefix cache pins
_CACHE_OWNER = "prefix-cache"

#: unported constructor / submit options -> the later slice that ports them
_LATER = {
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
                 "prefill_pos", "last_token", "generated",
                 "cancelled", "submitted_at", "keep_logits", "sampling",
                 "adapter", "adapter_slot", "adapter_sig", "sample_base",
                 "out_tokens", "held", "draft_blocks", "draft_pos",
                 "draft_outstanding")

    def __init__(self, sid, prompt, max_new, deadline):
        self.id = sid
        self.prompt = prompt            # np.int64 [prompt_len]
        self.max_new = max_new
        self.deadline = deadline
        self.stream = SequenceStream(sid, deadline)
        self.state = _WAITING
        self.blocks = []                # pool block ids, table order
        self.reserved_total = 0         # worst-case FRESH blocks (admission)
        self.outstanding = 0            # fresh allocations still to come
        self.pos = 0                    # cache position of last_token
        self.prefill_pos = 0            # prompt tokens already cached
        self.last_token = None
        self.generated = 0
        self.cancelled = False
        self.submitted_at = None
        self.keep_logits = 0
        self.sampling = None            # SamplingParams or None (greedy)
        self.adapter = None             # adapter name or None (base model)
        self.adapter_slot = 0           # slot 0 = reserved no-adapter lane
        self.adapter_sig = (0, 0)       # (slot, generation) cache signature
        self.sample_base = 0            # committed tokens before this run
        self.out_tokens = []            # every committed token (incl. held)
        self.held = []                  # committed, not yet streamed (a
        #                                 possible stop-sequence prefix)
        self.draft_blocks = []          # draft-pool block ids, table order
        self.draft_pos = 0              # valid draft KV rows (rollback line)
        self.draft_outstanding = 0      # draft fresh allocations to come


class DecodeEngine:
    """Iteration-level decode engine over a paged KV cache, with prefix
    sharing, per-request sampling, LoRA adapters and speculative
    decoding. See the module docstring for the semantics and the
    determinism contract.

    `device` defaults to the GPU (raising when there is none) and must be
    the model's device. `adapters` is an `AdapterPool` built over `model`
    (or None). `draft_model` (a causal LM on the same device with the
    target's vocabulary; the target itself is allowed) and `speculate_k`
    >= 1 turn speculation on; its pool holds `draft_num_blocks` blocks
    (default: a full bucket of worst-case sequences).

    On the GPU the step programs are CUDA graphs, and a graph holds the
    tensors its capture read: the KV pools and adapter stacks (written in
    place, so later writes are seen) and the model's parameters as they
    were. A parameter replaced out of place after a program was built
    (``module.weight = ...``, or `quantize_for_inference` swapping a
    layer) is not seen by that program: build the engine after the model
    is final. A failed capture or replay raises; nothing falls back to
    eager steps."""

    #: samp-pack values of a greedy row: the raw-argmax lane
    _PACK_DEFAULTS = {"ctr": 0, "greedy": 1, "rep": 1.0, "seed": 0,
                      "temp": 1.0, "top_k": 0, "top_p": 1.0}

    def __init__(self, model, *, max_length, block_size=16, num_blocks=None,
                 decode_buckets=(1, 2, 4, 8), prefill_buckets=None,
                 prefill_chunk=None, quant=None, max_waiting=64,
                 default_timeout=None, eos_token_id=None, pad_token_id=0,
                 prefix_cache=True, prefix_cache_blocks=None, adapters=None,
                 draft_model=None, speculate_k=0, draft_num_blocks=None,
                 device=None, clock=time.monotonic, _eager_steps=False,
                 **unported):
        for name, value in unported.items():
            if name not in _LATER:
                raise TypeError(f"DecodeEngine got an unexpected keyword "
                                f"argument {name!r}")
            if value not in (None, 0, False):
                _not_ported(name)
        if adapters is not None and not isinstance(adapters, AdapterPool):
            raise ValueError(f"adapters must be an AdapterPool, got "
                             f"{type(adapters).__name__}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine device is "
                             f"{self.device}")
        if adapters is not None and adapters.device != self.device:
            raise ValueError(f"adapter pool is on {adapters.device}, engine "
                             f"device is {self.device}")
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

        # default capacity: a full bucket of worst-case sequences, plus
        # one copy-on-write block per slot when sharing is on (a sequence
        # whose shared prompt tail ends mid-block copies that one block)
        self._prefix_on = bool(prefix_cache)
        self._nb = max(1, math.ceil(self.max_length / self.block_size))
        if num_blocks is None:
            num_blocks = RESERVED_BLOCKS + self.max_active * (
                self._nb + (1 if self._prefix_on else 0))
        self.pool = model.init_block_pool(num_blocks, self.block_size,
                                          quant=quant, name="target")
        self._init_speculation(draft_model, speculate_k, draft_num_blocks,
                               quant)
        # the step programs by (kind, bucket); graphs on the GPU unless
        # `_eager_steps` (tests and chip_smoke.py compare the two)
        self._programs = StepPrograms(
            self.device, self.device.type == "cuda" and not _eager_steps)

        # prefix -> block-table cache (scheduler-owned; structure reads and
        # counters under _cv): entries pin their blocks with _CACHE_OWNER
        # references and are LRU-evicted under pressure or the block cap
        self._prefix_cache = {}
        self._lru = itertools.count()
        if prefix_cache_blocks is None:
            prefix_cache_blocks = max(
                0, (self.pool.num_blocks - RESERVED_BLOCKS) // 2)
        self._prefix_cap = int(prefix_cache_blocks)
        self._adapters = adapters

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
        self._prefix_hits = self._prefix_misses = self._prefix_full_hits = 0
        self._prefix_tokens_reused = self._prefix_evictions = 0
        self._cow_copies = self._sampled = self._stop_hits = 0
        self._ttfts = []
        self._spec_rounds = self._spec_proposed = self._spec_accepted = 0
        self._spec_rejected = self._spec_bonus = self._spec_committed = 0
        self._spec_verify_dispatches = self._spec_draft_dispatches = 0
        self._spec_catchup_chunks = self._spec_fallbacks = 0
        self._jobs = []             # calls run on the scheduler thread

        self._thread = threading.Thread(target=self._loop,
                                        name="DecodeEngine-scheduler",
                                        daemon=True)
        self._thread.start()

    def _init_speculation(self, draft_model, speculate_k, draft_num_blocks,
                          quant):
        """Speculation is on when a draft model and ``speculate_k >= 1``
        are given; ``speculate_k=0`` is the plain engine. The draft pool
        shares the target pool's geometry and quant mode."""
        self._k = int(speculate_k)
        if self._k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        self._spec_on = draft_model is not None and self._k > 0
        self.draft_model = draft_model if self._spec_on else None
        self.draft_pool = None
        if not self._spec_on:
            return
        if not (hasattr(draft_model, "decode_step_paged")
                and hasattr(draft_model, "init_block_pool")):
            raise ValueError(
                f"draft_model must be a causal LM with a paged step "
                f"(decode_step_paged, init_block_pool), got "
                f"{type(draft_model).__name__}")
        if draft_model.device != self.device:
            raise ValueError(f"draft model is on {draft_model.device}, "
                             f"engine device is {self.device}")
        draft_model.eval()
        dvocab = draft_model.cfg.vocab_size
        if dvocab != self._vocab:
            raise ValueError(f"draft model vocab {dvocab} != target vocab "
                             f"{self._vocab}: proposals would be "
                             f"meaningless")
        # a catch-up span beyond the largest prefill bucket is cut at the
        # largest block-aligned bucket, as in the reference
        if not any(b % self.block_size == 0 for b in self.prefill_buckets) \
                and self.prefill_buckets[-1] < self.max_length - 1:
            raise ValueError(
                f"speculative draft catch-up needs a prefill bucket that "
                f"is a multiple of block_size {self.block_size} (got "
                f"{self.prefill_buckets}), or a largest bucket spanning "
                f"max_length - 1 so that catch-up never has to chunk")
        if draft_num_blocks is None:
            draft_num_blocks = RESERVED_BLOCKS + self.max_active * self._nb
        self.draft_pool = draft_model.init_block_pool(
            draft_num_blocks, self.block_size, quant=quant, name="draft")

    # -- admission ---------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens, timeout=None, *,
               keep_logits=0, sampling=None, adapter=None, **unported):
        """Admit one generation request; returns its `SequenceStream`.

        Malformed requests raise `ValueError` synchronously; a full
        waiting queue raises `Overloaded`, a closed engine `PoolClosed`, a
        dead-on-arrival deadline `DeadlineExceeded`. `timeout` (None ->
        `default_timeout`, both None -> unbounded) covers queue wait and
        generation. `sampling` (a `SamplingParams` or its `to_dict()`
        form) samples this request; None is greedy. `adapter` names a
        LoRA adapter of the engine's `AdapterPool` (an unknown name, or no
        pool, raises `AdapterNotLoaded`). `keep_logits=k` keeps the first
        k next-token logit rows on the stream (the prefill's, then each
        decode step's); such a request recomputes its last prompt chunk
        rather than take a full-prompt cache hit."""
        for name, value in unported.items():
            if name not in _LATER:
                raise TypeError(f"submit() got an unexpected keyword "
                                f"argument {name!r}")
            if value is not None:
                _not_ported(name)
        if sampling is not None and not isinstance(sampling, SamplingParams):
            sampling = SamplingParams.from_dict(dict(sampling))
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
        worst = self.pool.blocks_for(ids.shape[0] + max_new) + (
            1 if self._prefix_on and ids.shape[0] % self.block_size else 0)
        if worst > self.pool.num_blocks - RESERVED_BLOCKS:
            raise ValueError(f"request needs {worst} worst-case blocks but "
                             f"the pool holds only "
                             f"{self.pool.num_blocks - RESERVED_BLOCKS}")
        if self._spec_on:
            dworst = self._draft_worst(ids.shape[0], max_new)
            if dworst > self.draft_pool.num_blocks - RESERVED_BLOCKS:
                raise ValueError(
                    f"request needs {dworst} worst-case draft blocks but "
                    f"the draft pool holds only "
                    f"{self.draft_pool.num_blocks - RESERVED_BLOCKS}")
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
            seq.sampling = sampling
            if adapter is not None:
                if self._adapters is None:
                    raise AdapterNotLoaded(
                        f"adapter {adapter!r} requested but this engine has "
                        f"no adapter pool (pass adapters= to DecodeEngine)")
                # the slot is pinned for the sequence's life: a reload of
                # the same name lands in a fresh slot, and this sequence
                # keeps the weights it was admitted with
                slot, gen = self._adapters.acquire(adapter, owner=seq.id)
                seq.adapter = adapter
                seq.adapter_slot = slot
                seq.adapter_sig = (slot, gen)
            seq.submitted_at = self._clock()
            seq.stream._cancel = lambda s=seq: self._request_cancel(s)
            self._waiting.append(seq)
            self._admitted += 1
            if sampling is not None:
                self._sampled += 1
            self._cv.notify()
        return seq.stream

    def generate(self, prompt_ids, max_new_tokens, timeout=None, *,
                 sampling=None, adapter=None):
        """Submit and drain; returns the generated token list."""
        return self.submit(prompt_ids, max_new_tokens, timeout=timeout,
                           sampling=sampling, adapter=adapter).result()

    def _request_cancel(self, seq):
        with self._cv:
            seq.cancelled = True
            self._cv.notify()

    # -- scheduler ---------------------------------------------------------
    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            with torch.no_grad():
                self._rounds()
        finally:
            self._fail_jobs()

    def _rounds(self):
        while True:
            with self._cv:
                if self._stopping:
                    return
                jobs, self._jobs = self._jobs, []
                idle = not (self._waiting or self._active
                            or self._prefill_q or jobs)
                if idle and self._closed:
                    return
                if idle:
                    self._cv.wait(0.05)
                    continue
            for job in jobs:
                try:
                    job["result"] = job["fn"]()
                except Exception as exc:  # noqa: BLE001 — the caller
                    job["error"] = exc    # raises it
                job["done"].set()
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

    def _on_scheduler(self, fn):
        """Run `fn` on the scheduler thread between rounds (where every
        step runs and every program is captured) and return its result or
        raise its error."""
        job = {"fn": fn, "done": threading.Event(), "result": None,
               "error": None}
        with self._cv:
            if self._closed:
                raise PoolClosed("decode engine is shut down")
            self._jobs.append(job)
            self._cv.notify()
        job["done"].wait()
        if job["error"] is not None:
            raise job["error"]
        return job["result"]

    def _fail_jobs(self):
        with self._cv:
            jobs, self._jobs = self._jobs, []
        for job in jobs:
            job["error"] = PoolClosed("decode engine stopped before the "
                                      "call ran")
            job["done"].set()

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
        the free blocks cover the newcomer's worst-case FRESH growth (its
        worst case minus the blocks a prefix-cache hit shares, plus one
        copy-on-write block when its prompt ends mid-block) on top of
        every live sequence's outstanding worst case. Under pressure, LRU
        cache entries are evicted to make room."""
        while True:
            with self._cv:
                if self._stopping or not self._waiting:
                    return
                if len(self._active) + len(self._prefill_q) \
                        >= self.max_active:
                    return
                seq = self._waiting[0]
                plen = len(seq.prompt)
                cow = 1 if (self._prefix_on and plen % self.block_size) \
                    else 0
                seq.reserved_total = self.pool.blocks_for(
                    plen + seq.max_new) + cow
                entry = self._match_prefix(
                    seq.prompt, seq.adapter_sig,
                    full_ok=self._full_hit_ok(seq)) \
                    if self._prefix_on else None
                matched = len(entry["blocks"]) if entry else 0
                reserve = sum(s.outstanding
                              for s in self._active + self._prefill_q)
                fresh = seq.reserved_total - matched
                if self.pool.free_count < reserve + fresh \
                        and not self._evict_for(reserve + fresh,
                                                keep=entry):
                    return        # not enough headroom yet
                if self._spec_on:
                    # the draft pool has no cache to evict from: its
                    # worst case must simply fit beside the live ones'
                    dworst = self._draft_worst(plen, seq.max_new)
                    dreserve = sum(s.draft_outstanding
                                   for s in self._active + self._prefill_q)
                    if self.draft_pool.free_count < dreserve + dworst:
                        return    # draft headroom pending
                    seq.draft_outstanding = dworst
                self._waiting.pop(0)
            try:
                self._begin_sequence(seq, entry)
            except Exception as exc:  # noqa: BLE001 — the sequence is in
                # no queue here: fail it, or its stream hangs
                self._finish(seq, "failed", RequestFailed(
                    f"sequence {seq.id}: admission error: "
                    f"{type(exc).__name__}: {exc}", cause=exc))

    def _begin_sequence(self, seq, entry):
        """Attach an admitted sequence to its prefix-cache hit (refcounts,
        not prefill) and route it: a full-prompt hit joins the running
        batch at once, anything else enters the chunked-prefill queue."""
        plen = len(seq.prompt)
        if entry is not None:
            self.pool.incref(entry["blocks"], owner=seq.id)
            seq.blocks = list(entry["blocks"])
            seq.prefill_pos = entry["t"]
            with self._cv:
                self._prefix_hits += 1
                self._prefix_tokens_reused += entry["t"]
                if entry["t"] == plen:
                    self._prefix_full_hits += 1
        elif self._prefix_on:
            with self._cv:
                self._prefix_misses += 1
        seq.outstanding = seq.reserved_total - len(seq.blocks)
        if seq.prefill_pos == plen:
            # the whole prompt and its next token are cached
            seq.state = _ACTIVE
            seq.pos = plen
            with self._cv:
                self._active.append(seq)
                self._note_resident()
            self._deliver(seq, int(entry["next_token"]))
            return
        seq.state = _PREFILL
        with self._cv:
            self._prefill_q.append(seq)
            self._note_resident()

    def _note_resident(self):
        self._peak_resident = max(self._peak_resident,
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

    def _adapter_scope(self, ids):
        """The adapter context of one model call (`ids`: a scalar slot or
        a [bucket] vector), or a no-op without an adapter pool."""
        if self._adapters is None:
            return contextlib.nullcontext()
        return adapter_context(
            self._adapters.stacks(),
            torch.as_tensor(ids, dtype=torch.int32).to(self.device))

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
        with self._adapter_scope(seq.adapter_slot):
            logits = self.model.decode_step_paged(tokens, self.pool.tensors,
                                                  batch)
        last = logits[0, -1].to(torch.float32)
        done = start + this_len
        seq.prefill_pos = done
        if self._spec_on and seq.draft_pos == start \
                and self._may_speculate(seq):
            # the draft prefills the same chunk. On the GPU cuBLAS picks a
            # product's reduction by the chunk's length, so only the
            # target's own chunks give a self-draft the target's prompt
            # rows bit for bit (one catch-up chunk of the whole prompt
            # read acceptance 0.95 at llama2_7b width on an H100); and
            # the first speculation round needs no catch-up
            self._draft_prefill(seq, start, this_len)
        with self._lock:
            self._prefill_chunks += 1
        greedy = self._is_greedy(seq)
        # the raw argmax is what a greedy full-prompt hit on this entry
        # must deliver, whoever published it
        argmax = int(last.argmax())
        if self._prefix_on and self._chunk and done % self._chunk == 0 \
                and (greedy or done < plen):
            # a chunk boundary: publish tokens[0:done]. Boundaries are
            # absolute multiples of the chunk size, so a later prompt
            # sharing these tokens would have computed the same chunks
            with self._cv:
                self._prefix_insert(
                    "chunk", seq.prompt[:done],
                    seq.blocks[:done // self.block_size], argmax,
                    seq.adapter_sig)
        if done < plen:
            return
        tok = argmax if greedy else self._sample_rows(last[None], [seq])[0]
        if seq.keep_logits:
            seq.stream.logits.append(last.cpu())
        # prompt complete: greedy sequences publish the full-prompt entry
        # (a mid-block tail is shared too: its writer copies it first)
        if self._prefix_on and greedy \
                and not (self._chunk and plen % self._chunk == 0):
            with self._cv:
                self._prefix_insert("full", seq.prompt, seq.blocks, tok,
                                    seq.adapter_sig)
        with self._cv:
            self._prefills += 1
            seq.state = _ACTIVE
            seq.pos = plen
            if seq in self._prefill_q:
                self._prefill_q.remove(seq)
            self._active.append(seq)
        self._deliver(seq, tok)

    # -- prefix cache (copy-on-write block sharing) ------------------------
    # The helpers below run on the scheduler thread with _cv held. Entries
    # pin their blocks with _CACHE_OWNER references; a sequence that
    # matches bumps refcounts instead of prefilling, and a holder that
    # must write into a shared block copies it first (_decode_round).

    @staticmethod
    def _digest(ids, t):
        return hashlib.sha1(
            np.ascontiguousarray(ids[:t]).tobytes()).hexdigest()

    def _match_prefix(self, ids, sig=(0, 0), full_ok=True):
        """Longest cached prefix of `ids` under adapter signature `sig`:
        the full-prompt entry first, then chunk boundaries descending.
        Token contents are compared, never just hashes. `full_ok=False`
        skips any entry covering the WHOLE prompt (such a hit delivers the
        publisher's next token)."""
        plen = len(ids)
        if full_ok:
            e = self._prefix_cache.get(
                ("full", plen, self._digest(ids, plen), sig))
            if e is not None and np.array_equal(e["tokens"], ids):
                e["stamp"] = next(self._lru)
                return e
        if self._chunk:
            t = (plen // self._chunk) * self._chunk
            if not full_ok and t == plen:
                t -= self._chunk
            while t >= self._chunk:
                e = self._prefix_cache.get(
                    ("chunk", t, self._digest(ids, t), sig))
                if e is not None and np.array_equal(e["tokens"], ids[:t]):
                    e["stamp"] = next(self._lru)
                    return e
                t -= self._chunk
        return None

    def _prefix_insert(self, kind, toks, blocks, next_token, sig=(0, 0)):
        """Publish `blocks` (the KV of `toks`) for reuse; the cache takes a
        reference on every block. The cap bounds the distinct blocks the
        cache pins (LRU evictions make room; an entry that cannot fit is
        not cached)."""
        key = (kind, len(toks), self._digest(toks, len(toks)), sig)
        e = self._prefix_cache.get(key)
        if e is not None:
            e["stamp"] = next(self._lru)
            return
        want = set(blocks)

        def held():
            return len({b for x in self._prefix_cache.values()
                        for b in x["blocks"]} | want)

        while self._prefix_cache and held() > self._prefix_cap:
            self._evict_one()
        if held() > self._prefix_cap:
            return
        self.pool.incref(blocks, owner=_CACHE_OWNER)
        self._prefix_cache[key] = {
            "key": key, "tokens": np.array(toks, np.int64), "t": len(toks),
            "blocks": list(blocks), "next_token": int(next_token),
            "stamp": next(self._lru)}

    def _evict_one(self, keep=None):
        """Drop the least recently used entry (never `keep`) and its block
        references. Returns the entry or None."""
        victims = [e for e in self._prefix_cache.values() if e is not keep]
        if not victims:
            return None
        e = min(victims, key=lambda x: x["stamp"])
        del self._prefix_cache[e["key"]]
        self.pool.decref(e["blocks"], owner=_CACHE_OWNER)
        self._prefix_evictions += 1
        return e

    def _evict_for(self, need_free, keep=None):
        """Evict LRU entries until `need_free` blocks are free. True when
        satisfied."""
        while self.pool.free_count < need_free:
            if self._evict_one(keep=keep) is None:
                return False
        return True

    def _clear_prefix_cache_locked(self):
        for e in list(self._prefix_cache.values()):
            self.pool.decref(e["blocks"], owner=_CACHE_OWNER)
        self._prefix_cache.clear()

    # -- sampling ----------------------------------------------------------
    @staticmethod
    def _is_greedy(seq):
        """True when this sequence's next token is the raw-logits argmax
        (no params, or temperature <= 0)."""
        return seq.sampling is None or seq.sampling.is_greedy()

    def _full_hit_ok(self, seq):
        """A full-prompt hit delivers the publisher's cached next token and
        skips the prefill logits: exact only for greedy sequences that keep
        no logits."""
        return self._is_greedy(seq) and not seq.keep_logits

    def _pack_values(self, seq):
        """This sequence's samp-pack scalars for its NEXT token; the
        counter is the token's absolute output index."""
        sp = seq.sampling
        ctr = seq.sample_base + seq.generated
        if sp is None or sp.is_greedy():
            return dict(self._PACK_DEFAULTS, ctr=ctr)
        return {"ctr": ctr, "greedy": 0, "rep": sp.repetition_penalty,
                "seed": sp.seed, "temp": sp.temperature, "top_k": sp.top_k,
                "top_p": sp.top_p}

    def _committed_tokens(self, seq):
        """Every committed token (prompt + generated, held ones included),
        index == cache position."""
        if not seq.out_tokens:
            return seq.prompt
        return np.concatenate([seq.prompt,
                               np.asarray(seq.out_tokens, np.int64)])

    def _hist_fill(self, row, seq):
        sp = seq.sampling
        if sp is not None and not sp.is_greedy() \
                and sp.repetition_penalty != 1.0:
            toks = self._committed_tokens(seq)
            row[:len(toks)] = toks

    def _sample_rows(self, rows, seqs):
        """Next tokens of `seqs` from their f32 logit rows [n, V]: the
        samp pack and (when a row penalises repetition) the -1 padded
        history go to `sampling.sample_token` on the logits' device."""
        vals = [self._pack_values(s) for s in seqs]
        pack = {name: torch.tensor([v[name] for v in vals], dtype=dt,
                                   device=rows.device)
                for name, dt in PACK_FIELDS}
        hist = None
        if any(v["rep"] != 1.0 for v in vals):
            h = np.full((len(seqs), self.max_length), -1, np.int64)
            for i, s in enumerate(seqs):
                self._hist_fill(h[i], s)
            hist = torch.from_numpy(h).to(rows.device)
        return sample_token(rows, pack, hist).tolist()

    # -- decode ------------------------------------------------------------
    def _push_tokens(self, seq, toks):
        for t in toks:
            seq.stream._push(int(t))
        if toks:
            with self._lock:
                self._tokens_out += len(toks)

    def _deliver(self, seq, tok):
        """Commit one token: stream it (stop-sequence hold-back), retire
        the sequence if done.

        A token is held back while it could still be the prefix of a stop
        sequence and released once it provably is not, so the released
        tokens never end with a proper prefix of a stop sequence; a match
        swallows the stop's own tokens and completes the sequence."""
        seq.last_token = tok
        seq.generated += 1
        seq.out_tokens.append(int(tok))
        if seq.generated == 1 and seq.submitted_at is not None:
            seq.stream.ttft = self._clock() - seq.submitted_at
            with self._lock:
                self._ttfts.append(seq.stream.ttft)
        sps = seq.sampling.stop_sequences if seq.sampling is not None else ()
        if not sps:
            self._push_tokens(seq, [tok])
        else:
            seq.held.append(int(tok))
            out = seq.out_tokens
            hit = next((stop for stop in sps if len(out) >= len(stop)
                        and tuple(out[-len(stop):]) == stop), None)
            if hit is not None:
                flush = seq.held[:len(seq.held) - len(hit)]
                seq.held = []
                self._push_tokens(seq, flush)
                with self._lock:
                    self._stop_hits += 1
                self._finish(seq, "completed")
                return
            keep = 0
            for stop in sps:
                top = min(len(stop) - 1, len(seq.held))
                for n in range(top, keep, -1):
                    if tuple(out[-n:]) == stop[:n]:
                        keep = n
                        break
            if len(seq.held) > keep:
                flush = seq.held[:len(seq.held) - keep]
                seq.held = seq.held[len(seq.held) - keep:]
                self._push_tokens(seq, flush)
        if (self.eos_token_id is not None and tok == self.eos_token_id) \
                or seq.generated >= seq.max_new:
            self._finish(seq, "completed")

    def _cow_block(self, seq, bi):
        """Copy-on-write: give `seq` a private copy of `seq.blocks[bi]`
        (written in place in every layer's pool tensors) before it writes
        there."""
        new = self.pool.alloc(1, owner=seq.id)[0]
        self.pool.copy_block(seq.blocks[bi], new)
        self.pool.decref([seq.blocks[bi]], owner=seq.id)
        seq.blocks[bi] = new
        seq.outstanding -= 1
        with self._lock:
            self._cow_copies += 1

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
        if self._spec_on:
            # a sequence speculates when it still wants two tokens or more
            # (one is exactly a plain step) and all K + 1 verify rows fit
            # its table (near max_length it takes plain steps); sampled
            # and adapter sequences take plain steps
            limit = self._nb * self.block_size
            spec = [s for s in active
                    if s.max_new - s.generated > 1
                    and s.pos + self._k + 1 <= limit
                    and s.sampling is None and s.adapter is None]
            active = [s for s in active if s not in spec]
            if spec:
                # a sequence whose draft is still catching up (one chunk
                # a round) takes a plain step this round
                active += self._speculate_round(spec)
        if active:
            self._plain_round(active)

    def _plain_round(self, active):
        # lazy block growth and copy-on-write (the admission reserve covers
        # both): this step writes each sequence's row at seq.pos, and a
        # write into a block another holder references must not be seen
        # by it
        for seq in list(active):
            try:
                if seq.pos >= len(seq.blocks) * self.block_size:
                    seq.blocks += self.pool.alloc(1, owner=seq.id)
                    seq.outstanding -= 1
                else:
                    bi = seq.pos // self.block_size
                    if self.pool.refcount(seq.blocks[bi]) > 1:
                        self._cow_block(seq, bi)
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

    # -- step programs -----------------------------------------------------
    def _bucket(self, n):
        return next(b for b in self.decode_buckets if b >= n)

    def _program(self, kind, bucket):
        """The (kind, bucket) step program, built on first use."""
        return self._programs.get(kind, bucket,
                                  lambda: self._make_program(kind, bucket))

    def _make_program(self, kind, bucket):
        """(fields, body) of a step program. Kinds: "greedy" and "sampled"
        (one decode step of the target), "propose" (K + 1 draft steps)
        and "verify" (K + 1 target steps). Pad rows keep the fill values:
        table 0 (their writes land in reserved block 0), slot 0, the
        greedy samp pack and a -1 history."""
        nb, bs = self._nb, self.block_size
        fields = [("pos", (bucket,), torch.int32, 0),
                  ("tables", (bucket, nb), torch.int32, 0)]
        width = self._k + 1 if kind == "verify" else 1
        fields.append(("tokens", (bucket, width), torch.int64, 0))
        if kind in ("greedy", "sampled"):
            fields.append(("aids", (bucket,), torch.int32, 0))
        if kind == "sampled":
            fields += [(name, (bucket,), dt, self._PACK_DEFAULTS[name])
                       for name, dt in PACK_FIELDS]
            fields.append(("hist", (bucket, self.max_length), torch.int64,
                           -1))

        def step(model, pool, t, tokens, j=0):
            """One decode step of `model` over `pool` at pos + j: the f32
            logit rows [bucket, V]."""
            batch = PagedBatch.decode(t["tables"], t["pos"] + j, bs)
            return model.decode_step_paged(tokens, pool.tensors,
                                           batch)[:, -1].to(torch.float32)

        if kind in ("greedy", "sampled"):
            def body(t):
                with self._adapter_scope(t["aids"]):
                    rows = step(self.model, self.pool, t, t["tokens"])
                if kind == "greedy":
                    nxt = rows.argmax(-1)
                else:
                    # rows that do not penalise repetition (penalty 1, or
                    # an all -1 history) come out as without the history
                    nxt = sample_token(
                        rows, {name: t[name] for name, _ in PACK_FIELDS},
                        t["hist"])
                return {"next": nxt, "logits": rows}
        elif kind == "propose":
            def body(t):
                # K + 1 draft steps, each fed the previous argmax: the
                # last writes row pos + K (its argmax is dropped), so that
                # a round whose K proposals are all accepted leaves every
                # draft row below the new position written
                tok, props = t["tokens"], []
                for j in range(self._k + 1):
                    nxt = step(self.draft_model, self.draft_pool, t, tok,
                               j).argmax(-1)
                    props.append(nxt)
                    tok = nxt[:, None]
                return {"props": torch.stack(props[:self._k], 1)}
        else:
            def body(t):
                # K + 1 runs of the plain step's body: each argmax is the
                # plain greedy step's at that position, bit for bit
                preds = [step(self.model, self.pool, t,
                              t["tokens"][:, j:j + 1], j).argmax(-1)
                         for j in range(self._k + 1)]
                return {"preds": torch.stack(preds, 1)}
        return fields, body

    def _dispatch_decode(self, active):
        n = len(active)
        bucket = self._bucket(n)
        greedy = all(self._is_greedy(s) for s in active)
        prog = self._program("greedy" if greedy else "sampled", bucket)
        a = prog.stage()
        for i, seq in enumerate(active):
            a["tokens"][i, 0] = seq.last_token
            a["pos"][i] = seq.pos
            a["tables"][i, :len(seq.blocks)] = seq.blocks
            a["aids"][i] = seq.adapter_slot
            if not greedy:
                for name, v in self._pack_values(seq).items():
                    a[name][i] = v
                self._hist_fill(a["hist"][i], seq)
        out = prog.run()
        nxt = prog.fetch("next", n)
        for i, seq in enumerate(active):
            if len(seq.stream.logits) < seq.keep_logits:
                seq.stream.logits.append(out["logits"][i].cpu())
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

    def warmup(self):
        """Build every step program up front, largest bucket first, on the
        scheduler thread: each decode bucket's greedy and sampled step,
        and with speculation on its propose and verify step. On the GPU
        each is a CUDA graph captured after an eager warm-up; after this
        no traffic builds another (`stats()["compiles"]`). Prefill chunks
        run eagerly at their own length, so nothing is built for them.
        Returns ``{"decode": [...], "prefill": [...]}``, plus
        ``"speculate_k"`` when speculation is on."""
        kinds = ("greedy", "sampled") + (
            ("propose", "verify") if self._spec_on else ())

        def build():
            for b in reversed(self.decode_buckets):
                for kind in kinds:
                    self._program(kind, b)

        self._on_scheduler(build)
        out = {"decode": list(self.decode_buckets),
               "prefill": list(self.prefill_buckets)}
        if self._spec_on:
            out["speculate_k"] = self._k
        return out

    # -- speculative decoding ----------------------------------------------
    # One round for every eligible sequence:
    #   1. draft catch-up: rebuild the draft's KV over committed tokens
    #      where it lags (the prompt, a full prefix hit, after a fallback);
    #   2. propose: one draft program, K tokens a sequence;
    #   3. verify: one target program, K + 1 positions a sequence;
    #   4. commit: the longest agreeing prefix plus the target's own token;
    #      rows past the committed position (both pools) are rewritten
    #      before anything attends them.
    # A failed propose or verify falls back to plain isolated steps from
    # the committed state.

    def _draft_worst(self, plen, max_new):
        """Worst-case draft blocks of one sequence: a round writes rows
        pos .. pos + K with pos at most plen + max_new - 2, and never past
        the table."""
        return min(self._nb,
                   self.draft_pool.blocks_for(plen + max_new - 1 + self._k))

    def _may_speculate(self, seq):
        """Whether `seq` can take a speculation round after its prefill:
        greedy, no adapter, at least two tokens to go after the first, and
        K + 1 verify rows that fit its table."""
        return (seq.sampling is None and seq.adapter is None
                and seq.max_new > 2 and len(seq.prompt) + self._k + 1
                <= self._nb * self.block_size)

    def _draft_catchup(self, seq):
        """Bring the draft's KV toward the committed position where it lags
        (a prefix-cache hit skipped the prefill it rides on, or plain
        steps ran after a fallback): prefill committed tokens [draft_pos,
        pos) into the draft's pool, one chunk a call (a round), at most
        the largest prefill bucket (then the largest block-aligned one);
        True when the draft has caught up. The port's prefill writes row
        by row, so a chunk starts at draft_pos itself (the reference
        rounds it down to a block boundary for its block-wise scatter)."""
        if seq.draft_pos >= seq.pos:
            return True
        start = seq.draft_pos
        this_len = seq.pos - start
        if this_len > self.prefill_buckets[-1]:
            aligned = [b for b in self.prefill_buckets
                       if b % self.block_size == 0]
            if not aligned:
                raise RequestFailed(
                    f"sequence {seq.id}: draft catch-up of {this_len} "
                    f"tokens needs a block-aligned prefill bucket (have "
                    f"{self.prefill_buckets})")
            this_len = aligned[-1]
        self._draft_prefill(seq, start, this_len)
        return seq.draft_pos >= seq.pos

    def _draft_prefill(self, seq, start, n):
        """Prefill committed tokens [start, start + n) into the draft's
        pool, eagerly like the target's prefill chunks."""
        need = self.draft_pool.blocks_for(start + n) - len(seq.draft_blocks)
        if need > 0:
            try:
                seq.draft_blocks += self.draft_pool.alloc(need,
                                                          owner=seq.id)
            except OutOfBlocks as e:
                raise RequestFailed(
                    f"sequence {seq.id}: draft pool exhausted at catch-up "
                    f"(admission reserve bug)", cause=e) from e
            seq.draft_outstanding -= need
        dev = self.device
        table = torch.tensor(seq.draft_blocks, dtype=torch.int64,
                             device=dev)
        tokens = torch.as_tensor(
            self._committed_tokens(seq)[start:start + n], device=dev)[None]
        self.draft_model.decode_step_paged(
            tokens, self.draft_pool.tensors,
            PagedBatch.prefill(table, start, n, self.block_size))
        seq.draft_pos = start + n
        with self._lock:
            self._spec_catchup_chunks += 1
            self._spec_draft_dispatches += 1

    def _prepare_spec_blocks(self, seq):
        """Block growth and copy-on-write for one round: target rows pos ..
        pos + K are written, but only rows below plen + max_new can be
        committed, so only those get blocks (the rest sink into reserved
        block 0 through the table's padding); the draft writes rows pos ..
        pos + K."""
        cap_rows = min(seq.pos + self._k + 1, len(seq.prompt) + seq.max_new)
        need = self.pool.blocks_for(cap_rows) - len(seq.blocks)
        if need > 0:
            seq.blocks += self.pool.alloc(need, owner=seq.id)
            seq.outstanding -= need
        bi = seq.pos // self.block_size
        if bi < len(seq.blocks) and self.pool.refcount(seq.blocks[bi]) > 1:
            self._cow_block(seq, bi)
        dneed = self.draft_pool.blocks_for(seq.pos + self._k + 1) \
            - len(seq.draft_blocks)
        if dneed > 0:
            seq.draft_blocks += self.draft_pool.alloc(dneed, owner=seq.id)
            seq.draft_outstanding -= dneed

    def _dispatch_propose(self, seqs):
        prog = self._program("propose", self._bucket(len(seqs)))
        a = prog.stage()
        for i, seq in enumerate(seqs):
            a["tokens"][i, 0] = seq.last_token
            a["pos"][i] = seq.pos
            a["tables"][i, :len(seq.draft_blocks)] = seq.draft_blocks
        prog.run()
        props = prog.fetch("props", len(seqs))
        with self._lock:
            self._spec_draft_dispatches += 1
        return props

    def _dispatch_verify(self, seqs, props):
        prog = self._program("verify", self._bucket(len(seqs)))
        a = prog.stage()
        for i, seq in enumerate(seqs):
            a["tokens"][i, 0] = seq.last_token
            a["tokens"][i, 1:] = props[i]
            a["pos"][i] = seq.pos
            a["tables"][i, :len(seq.blocks)] = seq.blocks
        prog.run()
        preds = prog.fetch("preds", len(seqs))
        with self._lock:
            self._spec_verify_dispatches += 1
        return preds

    def _speculate_round(self, seqs):
        """One speculation round; returns the sequences left to the plain
        round because their draft is still catching up."""
        ready, deferred = [], []
        for seq in seqs:
            try:
                caught_up = self._draft_catchup(seq)
            except RequestFailed as e:
                self._finish(seq, "failed", e)
                continue
            except Exception as exc:  # noqa: BLE001 — fail THIS sequence
                self._finish(seq, "failed", RequestFailed(
                    f"sequence {seq.id}: draft catch-up error: "
                    f"{type(exc).__name__}: {exc}", cause=exc))
                continue
            if not caught_up:
                deferred.append(seq)
                continue
            try:
                self._prepare_spec_blocks(seq)
            except OutOfBlocks as e:
                self._finish(seq, "failed", RequestFailed(
                    f"sequence {seq.id}: block pool exhausted preparing "
                    f"a speculation round (admission reserve bug)",
                    cause=e))
                continue
            ready.append(seq)
        if not ready:
            return deferred
        try:
            props = self._dispatch_propose(ready)
            preds = self._dispatch_verify(ready, props)
        except Exception:  # noqa: BLE001 — blame is ambiguous: plain
            # isolated steps from the committed state (nothing of the
            # round was delivered; the draft rolls back by position)
            with self._lock:
                self._spec_fallbacks += 1
                if len(ready) > 1:
                    self._isolations += 1
            self._run_isolated(ready)
            return deferred
        with self._lock:
            self._spec_rounds += 1
        self._commit_speculation(ready, props, preds)
        return deferred

    def _commit_speculation(self, seqs, props, preds):
        """Greedy acceptance: proposal i is accepted while it equals the
        target's argmax at pos + i; the accepted proposals and the
        target's next argmax are committed (what is committed is always
        the target's argmax, so the tokens are plain greedy's)."""
        k = self._k
        for seq, d, g in zip(seqs, props, preds):
            a = 0
            while a < k and d[a] == g[a]:
                a += 1
            pos0, delivered = seq.pos, 0
            for tok in d[:a] + [g[a]]:
                self._deliver(seq, tok)
                delivered += 1
                if seq.state == _DONE:       # EOS or max_new: stop here
                    break
            seq.pos = pos0 + delivered
            # rows from draft_pos on are rewritten before the draft attends
            # them: the propose program wrote pos0 .. pos0 + K, each valid
            # when its token was committed
            seq.draft_pos = seq.pos
            with self._lock:
                # agreements cut off by EOS or max_new are not rejections
                self._spec_proposed += k
                self._spec_accepted += a
                self._spec_rejected += k - a
                self._spec_committed += delivered
                if delivered == k + 1:
                    self._spec_bonus += 1

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
        if seq.held and status == "completed":
            # eos / max_new ended the stream mid-hold: no stop match is
            # coming, so the held tail is plain output (pushed inline:
            # _lock is held here)
            for t in seq.held:
                seq.stream._push(int(t))
            self._tokens_out += len(seq.held)
        seq.held = []
        # exclusive blocks free; shared prefix blocks stay with their
        # other holders
        self.pool.free_owned(seq.id)
        if self._adapters is not None:
            self._adapters.release_owned(seq.id)
        if self._spec_on:
            self.draft_pool.free_owned(seq.id)
            seq.draft_outstanding = 0
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
        the scheduler, release the step programs (their graphs and
        buffers; `stats()` keeps their counts) and the prefix cache's
        blocks. Returns True on a full drain. Idempotent."""
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
        if not self._thread.is_alive():
            # no step can run any more: free the graphs and their buffers
            self._programs.release()
        with self._cv:
            leftovers = self._waiting + self._prefill_q + self._active
            self._waiting = []
            for seq in list(leftovers):
                self._finish_locked(seq, "cancelled", PoolClosed(
                    f"engine shut down before sequence {seq.id} finished"))
            # a shut-down engine returns the pool to allocated == 0
            self._clear_prefix_cache_locked()
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
        timed_out + cancelled`` and ``blocks.allocated ==
        prefix_cache.physical_blocks`` (the cache's pins); `blocks` (and
        `draft_blocks` with speculation on) carry the pools' conservation
        numbers (checked as they are read). `step_programs` gives each
        built program's replays (eager runs where it is not a graph) and a
        replay's launches by kernel wrapper."""
        with self._cv:
            used = sum(s.pos for s in self._active)
            slots = sum(len(s.blocks) for s in self._active) \
                * self.block_size
            ttfts = sorted(self._ttfts)
            lookups = self._prefix_hits + self._prefix_misses
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
                "prefix_hit_rate": (self._prefix_hits / lookups)
                if lookups else 0.0,
                "cow_copies": self._cow_copies,
                "sampled": self._sampled,
                "stop_hits": self._stop_hits,
                "prefix_cache": {
                    "enabled": self._prefix_on,
                    "entries": len(self._prefix_cache),
                    "blocks": sum(len(e["blocks"])
                                  for e in self._prefix_cache.values()),
                    # distinct pool blocks the cache pins: a quiesced
                    # engine holds exactly these, anything beyond leaks
                    "physical_blocks": len(
                        {b for e in self._prefix_cache.values()
                         for b in e["blocks"]}),
                    "block_cap": self._prefix_cap,
                    "hits": self._prefix_hits,
                    "full_hits": self._prefix_full_hits,
                    "misses": self._prefix_misses,
                    "tokens_reused": self._prefix_tokens_reused,
                    "evictions": self._prefix_evictions,
                },
                "buckets": {"decode": list(self.decode_buckets),
                            "prefill": list(self.prefill_buckets),
                            "prefill_chunk": self._chunk},
                "speculative": {
                    "enabled": self._spec_on,
                    "k": self._k if self._spec_on else 0,
                    "rounds": self._spec_rounds,
                    "proposed": self._spec_proposed,
                    "accepted": self._spec_accepted,
                    "rejected": self._spec_rejected,
                    "bonus": self._spec_bonus,
                    "committed": self._spec_committed,
                    "verify_dispatches": self._spec_verify_dispatches,
                    "draft_dispatches": self._spec_draft_dispatches,
                    "catchup_chunks": self._spec_catchup_chunks,
                    "fallbacks": self._spec_fallbacks,
                    "acceptance_rate":
                        (self._spec_accepted / self._spec_proposed)
                        if self._spec_proposed else 0.0,
                    "accepted_per_dispatch":
                        (self._spec_committed
                         / self._spec_verify_dispatches)
                        if self._spec_verify_dispatches else 0.0,
                },
            }

        def pct(q):
            if not ttfts:
                return None
            return ttfts[min(len(ttfts) - 1, int(q * len(ttfts)))]

        snap["ttft"] = {"count": len(ttfts),
                        "avg_s": sum(ttfts) / len(ttfts) if ttfts else None,
                        "p50_s": pct(0.5), "p95_s": pct(0.95),
                        "p99_s": pct(0.99)}
        # step programs built (a CUDA graph each on the GPU); nothing is
        # loaded from disk
        snap["compiles"] = {"built": self._programs.built, "disk": 0}
        snap["step_programs"] = self._programs.stats()
        snap["blocks"] = self.pool.stats()
        if self._adapters is not None:
            snap["adapters"] = self._adapters.stats()
        if self._spec_on:
            snap["draft_blocks"] = self.draft_pool.stats()
        return snap
