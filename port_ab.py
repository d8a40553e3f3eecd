#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch/CUDA port on one GPU, alternating.

    python3 port_ab.py PARENT CHANGE
        [--what decode,flash,short,weight_only,dense_decode,sparse,ring,
                gemv,decode_busy,resblock,pair,bgmv,tenants,decode_step,
                step_device,bert_step,dispatch,trace]
        [--rounds 1]

PARENT and CHANGE are the roots of two checkouts (for example a
`git archive` of each commit unpacked into a git-ignored directory). Both
trees' kernels are built first, in parallel, and the kernels whose ptxas
register or spill lines differ between the two builds are printed (one
JSON line, "what": "ptxas"). Then each measurement runs
in a child process that imports one tree only, in the order PARENT,
CHANGE, CHANGE, PARENT for each round, so that a drift of the card's
clock or power falls on both sides.

Measurements:

* ``decode``: first the paged decode kernel alone at
  `chip_smoke.py`'s row-2 cases (B=8, H=32, D=128, BS=16, positions
  0..2000; bf16 MHA, int8 MHA, bf16 GQA 4:1): median CUDA-event ms over
  50 calls and the device time of a call (``_dev_ms``, as for
  ``flash``); then `chip_smoke.py`'s serving run (a) of that tree —
  llama2_7b at full size, random bf16 weights from seed 0, a bf16 KV
  pool, `DecodeEngine` with buckets 1-8, the smoke's 8 prompts and 32 new
  tokens each, no solo pass — served 3 times on one model after a
  warm-up serve: tokens/s, time to first token p50/p95, wall seconds;
* ``flash``: the whole-sequence FlashAttention kernels at gpt_base's
  training shape (B=16, S=1024, H=12, D=64, bf16, causal) and at
  llama2_7b's (B=4, S=2048, H=32, D=128), q, k, v views of one fused QKV
  tensor as the models give them: median CUDA-event ms of forward, dq and
  dkv over 50 calls after 5 warm-up calls, and each one's device time
  (``_dev_ms``: 32 calls in one CUDA graph, median of 7 replays);
* ``short``: the short-attention kernels with attention dropout inside
  at bert_base's fine-tune shape (B=128, S=128, H=12, D=64, bf16, p=0.1)
  and at S=512 (B=16), q, k, v views of one fused QKV tensor as BERT
  gives them: median CUDA-event ms of the forward and of the backward
  call (its dQ and dK/dV launches) over 50 calls after 5 warm-up calls,
  and each one's device time (``_dev_ms``, as for ``flash``);
* ``weight_only``: `weight_only_matmul` on llama2_7b's gate_up (n=22016,
  k=4096) and down (n=4096, k=11008) weights quantized from one seeded
  random weight, int8 and int4, at m = 1, 8 (decode) and 256 (a prefill
  chunk), bf16 x: median CUDA-event ms over 50 calls (``_ms``: a call as
  a caller sees it, its host time included) and the device time of a
  call (``_dev_ms``: 32 calls in one CUDA graph cycling through 4 copies
  of the weight, so that each call reads it from HBM as a decode step's
  layer after layer does; median of 7 replays);
* ``dense_decode``: `decode_attention` at llama2_7b's decode width (B=8,
  H=32, D=128, T=4096; `chip_smoke.py`'s caches) on int8 and bf16 caches
  at pos 4095 and 2000, MHA, and at pos 4095 GQA 4:1 (8 KV heads):
  median ms over 50 calls and the device time of a call (``_dev_ms``);
* ``sparse``: the block-sparse kernel on `chip_smoke.py`'s BigBird tables
  (seed 0) at [4*12, 4096, 64] and [12, 4096, 128] bf16 and [4*12, 4096,
  64] f32: median ms over 50 calls and the device time of a call
  (``_dev_ms``), and the launches by body where the tree counts them
  (``routes``);
* ``ring``: the ring-step kernels of context parallelism at cp = 2 with
  zigzag placement — gpt_base's shards (B=8, s=512, H=12, D=64; ranks 0
  and 1, own and visiting shard) and llama2_7b's (B=1, s=2048, H=32,
  D=128; rank 0, own and visiting), bf16: median CUDA-event ms of the
  forward, dq and dkv over 50 calls and each one's device time
  (``_dev_ms``, as for ``flash``); beside them, as ``{shape}_causal_``,
  the whole-sequence causal kernels on the same q, k, v (the own shard's
  work, without positions);
* ``gemv``: the row-stable float GEMV (`row_gemv`) and cuBLAS
  (`torch.nn.functional.linear`, the yardstick) on `chip_smoke.py`'s five
  llama2_7b Linears (bf16 weights from seed 4) at m = 1 and 8: median
  CUDA-event ms over 50 calls and the device time of a call (``_dev_ms``:
  32 calls in one CUDA graph cycling through 4 copies of the weight, so
  each call reads it from HBM), and the launches by body where the tree
  counts them (``routes``);
* ``decode_busy``: `chip_smoke.py`'s `profile_decode` of run (a)'s model
  (llama2_7b, 32 layers, bf16 weights from seed 0): 12 decode steps at
  bucket 8 under torch.profiler, the device-busy ms a step among its
  results;
* ``resblock``: the fused bottleneck kernels at `chip_smoke.py`'s four
  ResNet-50 stage shapes (N = 128, bf16, its seeded block inputs): the
  forward and the backward, a call (median of 20) and on the device (8
  calls in one CUDA graph, median of 7 replays); the per-op block (a
  BottleneckBlock, cuDNN and PyTorch's batch norm, as phase 6's per-op
  route runs it) likewise, its backward's device time the captured
  forward + backward less the forward (4 calls a graph); the step sums
  (each stage times its blocks a step); the forward's and the backward's
  device time by launch from one torch.profiler pass
  (`resblock_products`), with their step sums, and the forward's launches
  by body where the tree counts them (``routes``);
* ``pair``: row 12c, the coupled pair of blocks, at the four stage shapes
  (`check_fused_pair`'s seeded inputs) beside two chained one-block
  forwards, a call and on the device (8 calls a graph); and from one
  torch.profiler pass (`pair_products`) the coupled kernel's device time
  a call (the launch whose name holds "k41") beside F4 + F1 of a
  one-block forward call on the same stage;
* ``bgmv``: BGMV at `chip_smoke.py`'s `BGMV_CASES`: median CUDA-event ms
  over 50 calls, the device time of a call and of the yardstick pair of
  `torch.bmm` calls (``_dev_ms``, cycling through 16 copies of the slot
  stacks), and the body each case took where the tree counts them;
* ``tenants``: `chip_smoke.py`'s `profile_tenants` (run (d): the int8
  llama2_7b at 32 layers with six LoRA adapters, 12 decode steps at bs 8
  under torch.profiler), the `bgmv` family's ms a step among its results;
* ``decode_step``: run (b)'s decode step (llama2_7b at 32 layers, int8
  weights quantized from seed 0, an int8 KV pool, 8 sequences of 300
  prompt tokens at bucket 8, the engine's step programs built first where
  the tree has `warmup()`): the host-clock ms a step over a window of
  `STEP_WINDOW_S` seconds without the profiler (the window's mean, and
  the median and p90 of the intervals between consecutive steps'
  starts); where the engine runs its steps on a supervised executor
  (`_submit_step`), HANDOFFS steps with no device work sent through it
  with the engine idle (µs each: the executor's own cost a step); then
  the tree's `chip_smoke.py` `profile_decode` of the same model (its
  device-busy ms a step among its results);
* ``step_device`` (CHANGE alone, once a round; a tree whose engine has
  step programs): run (b)'s bucket-8 greedy step program, built and
  staged by the engine's own steps as in ``decode_step``, then driven
  from the measuring thread once the engine is idle, in five phases:
  the graph's replays back to back under CUDA events (no profiler), the
  same program's body run eagerly under torch.profiler (its kernels'
  summed device time a run), the replays under torch.profiler (the same
  sum), the eager body under CUDA events, and the replays under CUDA
  events again. nvidia-smi samples the SM clock, the power draw and the
  temperature every 100 ms, reported for each phase.

* ``bert_step``: `chip_smoke.py` phase 5's BERT fine-tune step of that
  tree (bert_base at 12 layers, bf16 compute, dropout 0.1, one fixed
  [128, 128] batch from seed 0): `bert_throughput`'s step ms and
  sequences/s over 20 steps after 2 warm-up steps;
* ``dispatch``: the host cost of one wrapper call, where the change's
  wrappers are `torch.library` operators: `flash_attention_fwd` on
  bert_base's eval shape ([1, 128, 12, 64] bf16, not causal) and
  `weight_only_matmul` on its int8 qkv Linear (m = 128, k = 768,
  n = 2304), DISPATCH_CALLS calls back to back (host clock, the device
  synchronized before and after; the kernels are shorter than a call's
  host work, so the host sets the pace): µs a call, median of 5 runs.

* ``trace``: request tracing's cost (`obs.trace`, where the tree has
  it): an exported bert_base (bf16, 12 layers, weights from seed 0,
  [1, 128] ids and token types) served by `ServingPool(Config(path),
  size=2)`, TRACE_REQUESTS requests one after another, each under a root
  span when tracing is on (so the pool's admission and execution spans
  record): ms a request (median, p90) for each of on, off, on, off (a
  tree without tracing: four runs as they are); then run (b)'s decode
  step as in ``decode_step`` over four windows of TRACE_WINDOW_S seconds,
  tracing on, off, on, off.

Prints the card's name and power limit (nvidia-smi), then one JSON line
per measurement, each naming its tree. Every child has a time limit and
is killed when it passes it; any failure exits non-zero.
"""
import argparse
import importlib
import json
import os
import re
import subprocess
import sys

CHILD_TIMEOUT_S = 900
#: measurements of the change's own paths, made in CHANGE alone
CHANGE_ONLY = ("step_device",)
DECODE_SERVES = 3


def _time_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return sorted(times)[len(times) // 2]


def _graph_ms(torch, fns, calls=32, reps=7):
    """Device time of one call: `calls` calls cycling through `fns`
    captured in one CUDA graph, the median of `reps` replays over
    `calls`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return sorted(times)[len(times) // 2]


FLASH_SHAPES = (("gpt_base", 16, 1024, 12, 64), ("llama2_7b", 4, 2048, 32, 128))
WO_LAYERS = (("gate_up", 22016, 4096), ("down", 4096, 11008))
SHORT_SHAPES = (("bert_base", 128, 128, 12, 64), ("s512", 16, 512, 12, 64))
SHORT_P = 0.1


def child_flash(tree):
    import torch

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    res = {"tree": tree, "what": "flash"}
    for name, B, S, H, D in FLASH_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(3)
        qkv = torch.randn(B, S, 3, H, D, device="cuda", generator=g).to(
            torch.bfloat16)
        q, k, v = qkv.unbind(2)
        do = torch.randn(B, S, H, D, device="cuda", generator=g).to(
            torch.bfloat16)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = fa.attention_delta(out, do)
        calls = {
            "fwd": lambda: fa.flash_attention_fwd(q, k, v, causal=True),
            "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                    causal=True),
            "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                      delta, causal=True)}
        for part, fn in calls.items():
            res[f"{name}_{part}_ms"] = _time_ms(torch, fn)
            res[f"{name}_{part}_dev_ms"] = _graph_ms(torch, [fn])
        del qkv, q, k, v, do, out, lse, delta
    return res


RING_SHARDS = (("gpt_base", 8, 512, 12, 64, ((0, 0), (0, 1), (1, 1), (1, 0))),
               ("llama2_7b", 1, 2048, 32, 128, ((0, 0), (0, 1))))


def child_ring(tree):
    import torch

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    cpm = importlib.import_module(
        "paddle_tpu_torch.distributed.context_parallel")
    res = {"tree": tree, "what": "ring"}
    for name, B, s, H, D, ranks in RING_SHARDS:
        g = torch.Generator(device="cuda").manual_seed(11)
        q, k, v, do = (torch.randn(B, s, H, D, device="cuda",
                                   generator=g).to(torch.bfloat16)
                       for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v)
        delta = fa.attention_delta(out, do)
        whole = {
            "fwd": lambda: fa.flash_attention_fwd(q, k, v),
            "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
            "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                      delta)}
        for part, fn in whole.items():
            res[f"{name}_causal_{part}_ms"] = _time_ms(torch, fn)
            res[f"{name}_causal_{part}_dev_ms"] = _graph_ms(torch, [fn])
        for rq, rk in ranks:
            qp = cpm._local_positions(rq, 2, s, True, "cuda")
            kp = cpm._local_positions(rk, 2, s, True, "cuda")
            label = f"{name}_r{rq}_{'own' if rq == rk else 'visiting'}"
            out, lse = fa.flash_fwd_pos(q, k, v, qp, kp)
            delta = fa.attention_delta(out, do)
            bwd = (q, k, v, do, lse, delta, qp, kp)
            calls = {
                "fwd": lambda: fa.flash_fwd_pos(q, k, v, qp, kp),
                "dq": lambda: fa.flash_bwd_pos_dq(*bwd),
                "dkv": lambda: fa.flash_bwd_pos_dkv(*bwd)}
            for part, fn in calls.items():
                res[f"{label}_{part}_ms"] = _time_ms(torch, fn)
                res[f"{label}_{part}_dev_ms"] = _graph_ms(torch, [fn])
            del out, lse, delta, bwd
        del q, k, v, do
    return res


def child_short(tree):
    import torch

    sa = importlib.import_module("paddle_tpu_torch.ops.short_attention")
    res = {"tree": tree, "what": "short", "p": SHORT_P}
    for name, B, S, H, D in SHORT_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(5)
        qkv = torch.randn(B, S, 3, H, D, device="cuda", generator=g).to(
            torch.bfloat16)
        q, k, v = qkv.unbind(2)
        do = torch.randn(B, S, H, D, device="cuda", generator=g).to(
            torch.bfloat16)
        seed = torch.tensor([1234], device="cuda")
        _, lse = sa.short_attention_fwd(q, k, v, seed, SHORT_P)
        calls = {
            "fwd": lambda: sa.short_attention_fwd(q, k, v, seed, SHORT_P),
            "bwd": lambda: sa.short_attention_bwd(q, k, v, do, lse, seed,
                                                  SHORT_P)}
        for part, fn in calls.items():
            res[f"{name}_{part}_ms"] = _time_ms(torch, fn)
            res[f"{name}_{part}_dev_ms"] = _graph_ms(torch, [fn])
        del qkv, q, k, v, do, lse
    return res


def child_weight_only(tree):
    import torch

    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.weight_only import weight_only_matmul

    res = {"tree": tree, "what": "weight_only"}
    for name, n, k in WO_LAYERS:
        g = torch.Generator(device="cuda").manual_seed(1)
        w = torch.randn(n, k, device="cuda", generator=g) * 0.02
        for wdt in ("int8", "int4"):
            qw, sc = weight_quantize(w.t(), f"weight_only_{wdt}")
            copies = [qw] + [qw.clone() for _ in range(3)]
            for m in (1, 8, 256):
                x = torch.randn(m, k, device="cuda", generator=g).to(
                    torch.bfloat16)
                res[f"{wdt}_{name}_m{m}_ms"] = _time_ms(
                    torch, lambda: weight_only_matmul(x, qw, sc, wdt))
                res[f"{wdt}_{name}_m{m}_dev_ms"] = _graph_ms(
                    torch, [lambda c=c: weight_only_matmul(x, c, sc, wdt)
                            for c in copies])
            del copies
        del w
    return res


def child_dense_decode(tree):
    import torch

    smoke = importlib.import_module("chip_smoke")
    from paddle_tpu_torch.ops.decode_attn import decode_attention

    g = torch.Generator(device="cuda").manual_seed(17)
    res = {"tree": tree, "what": "dense_decode"}
    H = smoke.DECODE_H
    for cache in ("int8", "bfloat16"):
        for hkv, pos in ((H, smoke.DECODE_T - 1), (H, 2000),
                         (H // 4, smoke.DECODE_T - 1)):
            q, ((kq, ks), (vq, vs)) = smoke._decode_cache(
                torch, g, H, hkv, pos, cache)
            q = q.to(torch.bfloat16)
            name = f"{cache}_hkv{hkv}_pos{pos}"

            def fn():
                return decode_attention(q, kq, ks, vq, vs, pos)
            res[f"{name}_ms"] = _time_ms(torch, fn)
            res[f"{name}_dev_ms"] = _graph_ms(torch, [fn])
            del q, kq, ks, vq, vs
    return res


def child_sparse(tree):
    import numpy as np
    import torch

    smoke = importlib.import_module("chip_smoke")
    bsa = importlib.import_module(
        "paddle_tpu_torch.ops.block_sparse_attention")
    nb = smoke.BIGBIRD_SEQ // smoke.SPARSE_BLOCK
    idx, cnt, _ = smoke._block_tables(torch, np,
                                      smoke.bigbird_blocks(np, nb, 0))
    g = torch.Generator(device="cuda").manual_seed(13)
    res = {"tree": tree, "what": "sparse"}
    for BH, D, dt in ((48, 64, "bfloat16"), (12, 128, "bfloat16"),
                      (48, 64, "float32")):
        q, k, v = (torch.randn(BH, smoke.BIGBIRD_SEQ, D, device="cuda",
                               generator=g).to(getattr(torch, dt))
                   for _ in range(3))

        def fn():
            return bsa.block_sparse_attention(q, k, v, idx, cnt, D ** -0.5,
                                              smoke.SPARSE_BLOCK)
        tag = f"bh{BH}_d{D}" + ("_f32" if dt == "float32" else "")
        res[f"{tag}_ms"] = _time_ms(torch, fn, iters=20 if dt ==
                                    "float32" else 50)
        res[f"{tag}_dev_ms"] = _graph_ms(torch, [fn], calls=8 if dt ==
                                         "float32" else 32)
    res["routes"] = dict(getattr(bsa.block_sparse_attention, "routes", {}))
    return res


def child_decode(tree):
    import numpy as np
    import torch

    smoke = importlib.import_module("chip_smoke")
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.decode_attn import paged_decode_attention

    kernel = {}
    g = torch.Generator(device="cuda").manual_seed(2)
    pos = [0, 7, 150, 511, 900, 1333, 1700, 2000]
    for name, H, Hkv, int8 in (("bf16_mha", 32, 32, False),
                               ("int8_mha", 32, 32, True),
                               ("bf16_gqa", 32, 8, False)):
        q, (kp, ksp, vp, vsp), tables, pos_t = smoke._paged_case(
            torch, g, 8, H, Hkv, 128, 16, pos, int8)
        args = (q, kp.permute(0, 2, 1, 3),
                None if ksp is None else ksp.permute(0, 2, 1),
                vp.permute(0, 2, 1, 3),
                None if vsp is None else vsp.permute(0, 2, 1), tables, pos_t)

        def fn():
            return paged_decode_attention(*args)
        kernel[f"paged_{name}_ms"] = _time_ms(torch, fn)
        kernel[f"paged_{name}_dev_ms"] = _graph_ms(torch, [fn])
        del args, q, kp, ksp, vp, vsp

    model = gpt("llama2_7b", dtype="bfloat16", device="cuda", seed=0,
                num_layers=32)
    args = (torch, np, model, None, smoke.PROMPT_LENS, 32)
    smoke.serve(*args, "warm-up", check_dense=False)
    runs = [smoke.serve(*args, "a: bf16 weights, bf16 KV",
                        check_dense=False) for _ in range(DECODE_SERVES)]
    return {"tree": tree, "what": "decode", **kernel,
            "tokens_per_s": [r["tokens_per_s"] for r in runs],
            "ttft_p50_s": [r["ttft_p50_s"] for r in runs],
            "ttft_p95_s": [r["ttft_p95_s"] for r in runs],
            "wall_s": [r["wall_s"] for r in runs],
            "steps": [r["steps"] for r in runs],
            "launches": runs[-1]["launches"]}


GEMV_ROWS = (1, 8)


def child_gemv(tree):
    import torch
    import torch.nn.functional as F

    smoke = importlib.import_module("chip_smoke")
    wo = importlib.import_module("paddle_tpu_torch.ops.weight_only")
    res = {"tree": tree, "what": "gemv"}
    routes = getattr(wo.row_gemv, "routes", None)
    for name, (n, k) in smoke.LLAMA_LINEARS.items():
        g = torch.Generator(device="cuda").manual_seed(4)
        w = (torch.randn(n, k, device="cuda", generator=g) * 0.02).to(
            torch.bfloat16)
        copies = [w] + [w.clone() for _ in range(3)]
        for m in GEMV_ROWS:
            x = torch.randn(m, k, device="cuda", generator=g).to(
                torch.bfloat16)
            for label, fn in (("row_gemv", wo.row_gemv), ("cublas", F.linear)):
                res[f"{name}_m{m}_{label}_ms"] = _time_ms(
                    torch, lambda: fn(x, w))
                res[f"{name}_m{m}_{label}_dev_ms"] = _graph_ms(
                    torch, [lambda c=c: fn(x, c) for c in copies])
        del w, copies
    if routes is not None:
        res["routes"] = dict(routes)
    return res


def child_decode_busy(tree):
    """Run (a)'s model: the decode step's device-busy time (every float
    Linear a row_gemv launch)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import gpt

    smoke = importlib.import_module("chip_smoke")
    model = gpt("llama2_7b", dtype="bfloat16", device="cuda", seed=0,
                num_layers=32)
    prof = smoke.profile_decode(torch, np, model, None,
                                "a: bf16 weights, bf16 KV, bs 8")
    return {"tree": tree, "what": "decode_busy", **prof}


#: the fused backward's launches in order (ops/fused_resblock.py `_bwd_cuda`)
BWD_PRODUCTS = ("B1", "bn3", "B2A", "B2B", "bn2", "W3", "W3 sum", "B3",
                "bn1", "W2", "W2 sum", "B4", "W1", "W1 sum")
#: the fused forward's launches in order, for a tree whose module does not
#: name them (`FWD_PRODUCTS` of ops/fused_resblock.py where it does)
FWD_PRODUCTS = ("F1", "bn1", "F2", "bn2", "F3", "bn3", "F4")


def resblock_products(torch, rb, smoke, calls=2):
    """The fused forward's and backward's device time by launch (ms a
    call) at each of `smoke.RESNET_STAGES`, from one torch.profiler pass
    (only the first profiling session of a process records device
    kernels): the kernels whose names hold "rb_", in launch order, cut
    into calls of the forward's and the backward's launch counts. Returns
    {stage: {"fwd": {launch: ms, ..., "total"}, "bwd": {...}}}."""
    from torch.profiler import ProfilerActivity, profile

    fwd_names = getattr(rb, "FWD_PRODUCTS", FWD_PRODUCTS)
    g = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for stage, H, C, _ in smoke.RESNET_STAGES:
        args, dy = smoke._block_inputs(torch, smoke.RESNET_BATCH, H, C, g)
        _, res, _ = rb.fused_bottleneck_fwd(*args)
        rb.fused_bottleneck_bwd(res, dy)
        cases.append((stage, args, res, dy))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _, args, res, dy in cases:
            for _ in range(calls):
                rb.fused_bottleneck_fwd(*args)
            for _ in range(calls):
                rb.fused_bottleneck_bwd(res, dy)
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type.name == "CUDA" and "rb_" in e.name),
                  key=lambda e: e.time_range.start)
    nf, nb = len(fwd_names), len(BWD_PRODUCTS)
    per_case = (nf + nb) * calls
    if len(kern) != per_case * len(cases):
        return {"error": f"{len(kern)} rb_ kernels recorded, want "
                         f"{per_case * len(cases)}"}
    out = {}
    for i, (stage, _, _, _) in enumerate(cases):
        ev = kern[i * per_case:(i + 1) * per_case]
        row = {}
        for part, names, first in (("fwd", fwd_names, 0),
                                   ("bwd", BWD_PRODUCTS, nf * calls)):
            n = len(names)
            row[part] = {p: sum(ev[first + c * n + j].time_range
                                .elapsed_us() for c in range(calls))
                         / calls / 1e3 for j, p in enumerate(names)}
            row[part]["total"] = sum(row[part][p] for p in names)
        out[stage] = row
    return out


def products_step(products, smoke):
    """`resblock_products`' ms a call summed over a ResNet-50 step (each
    stage's launches times its blocks a step), by direction."""
    if "error" in products:
        return products
    blocks = {stage: b for stage, _, _, b in smoke.RESNET_STAGES}
    step = {}
    for stage, row in products.items():
        for part, times in row.items():
            acc = step.setdefault(part, {})
            for p, ms in times.items():
                acc[p] = acc.get(p, 0.0) + ms * blocks[stage]
    return step


def child_resblock(tree):
    import torch

    smoke = importlib.import_module("chip_smoke")
    rb = importlib.import_module("paddle_tpu_torch.ops.fused_resblock")
    res = {"tree": tree, "what": "resblock"}
    res["products"] = resblock_products(torch, rb, smoke)
    res["products_step"] = products_step(res["products"], smoke)
    res["routes"] = dict(getattr(rb.fused_bottleneck_fwd, "routes", {}))
    g = torch.Generator(device="cuda").manual_seed(11)
    step = {}
    for stage, H, C, blocks in smoke.RESNET_STAGES:
        args, dy = smoke._block_inputs(torch, smoke.RESNET_BATCH, H, C, g)
        _, fres, _ = rb.fused_bottleneck_fwd(*args)
        row = {}
        for part, fn in (
                ("fwd", lambda: rb.fused_bottleneck_fwd(*args)),
                ("bwd", lambda: rb.fused_bottleneck_bwd(fres, dy))):
            row[f"{part}_ms"] = _time_ms(torch, fn, iters=20)
            row[f"{part}_dev_ms"] = _graph_ms(torch, [fn], calls=8)
        blk, params = smoke._per_op_block(torch, args, C)
        xin = args[0].detach().requires_grad_()
        leaves = [xin, *params.values()]

        def per_op():
            return torch.func.functional_call(blk, params, (xin,))

        def per_op_both():
            return torch.autograd.grad(per_op(), leaves, dy)

        with smoke._route(None):
            # captured first: a live autograd graph of these leaves (out,
            # below) keeps AccumulateGrad nodes on the default stream,
            # which breaks a capture
            torch.cuda.empty_cache()    # a capture may not free blocks
            try:
                fwd_dev = _graph_ms(torch, [per_op], calls=4)
                both = _graph_ms(torch, [per_op_both], calls=4)
                row["per_op_fwd_dev_ms"] = fwd_dev
                row["per_op_bwd_dev_ms"] = both - fwd_dev
            except RuntimeError as e:    # capture refused: not measured
                row["per_op_dev_error"] = str(e)[:200]
            out = per_op()
            row["per_op_fwd_ms"] = _time_ms(torch, per_op, iters=20)
            row["per_op_bwd_ms"] = _time_ms(
                torch, lambda: torch.autograd.grad(out, leaves, dy,
                                                   retain_graph=True),
                iters=20)
        res[stage] = row
        for key, v in row.items():
            if key.endswith("_ms"):
                step[key] = step.get(key, 0.0) + v * blocks
        del args, dy, fres, blk, params, xin, leaves, out
        torch.cuda.empty_cache()
    res["step"] = step
    return res


def child_pair(tree):
    """Row 12c: `fused_bottleneck2_fwd` at `chip_smoke.py`'s four stage
    shapes (its `check_fused_pair` inputs, seed 19), beside two chained
    one-block forwards: a call (median of 20) and on the device (8 calls
    in one CUDA graph), and the pair's launches by body where the tree
    counts them (``routes``)."""
    import torch

    smoke = importlib.import_module("chip_smoke")
    rb = importlib.import_module("paddle_tpu_torch.ops.fused_resblock")
    res = {"tree": tree, "what": "pair"}
    g = torch.Generator(device="cuda").manual_seed(19)
    cases = []
    for stage, H, C, _ in smoke.RESNET_STAGES:
        a1, _ = smoke._block_inputs(torch, smoke.RESNET_BATCH, H, C, g)
        a2, _ = smoke._block_inputs(torch, smoke.RESNET_BATCH, H, C, g)
        x, p1, p2 = a1[0], a1[1:], a2[1:]
        calls = {"pair": lambda: rb.fused_bottleneck2_fwd(x, p1, p2),
                 "two_12a": lambda: rb.fused_bottleneck_fwd(
                     rb.fused_bottleneck_fwd(x, *p1)[0], *p2)[0]}
        for part, fn in calls.items():
            res[f"{stage}_{part}_ms"] = _time_ms(torch, fn, iters=20)
            res[f"{stage}_{part}_dev_ms"] = _graph_ms(torch, [fn], calls=8)
        cases.append((stage, x, p1, p2))
        torch.cuda.empty_cache()
    res["routes"] = dict(getattr(rb.fused_bottleneck2_fwd, "routes", {}))
    res["products"] = pair_products(torch, rb, cases)
    return res


def pair_products(torch, rb, cases, calls=2):
    """Device ms a call, by stage, from one torch.profiler pass: the
    coupled kernel of a pair call (the launch whose name holds "k41") and
    F1, F4 and their sum of a one-block forward call on block 1's
    operands. Returns {stage: {"coupled", "f1", "f4", "f4_f1"}}."""
    from torch.profiler import ProfilerActivity, profile

    pair_n, fwd_n = 15, len(getattr(rb, "FWD_PRODUCTS", FWD_PRODUCTS))
    for _, x, p1, p2 in cases:
        rb.fused_bottleneck2_fwd(x, p1, p2)
        rb.fused_bottleneck_fwd(x, *p1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _, x, p1, p2 in cases:
            for _ in range(calls):
                rb.fused_bottleneck2_fwd(x, p1, p2)
            for _ in range(calls):
                rb.fused_bottleneck_fwd(x, *p1)
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type.name == "CUDA" and "rb_" in e.name),
                  key=lambda e: e.time_range.start)
    per_case = (pair_n + fwd_n) * calls
    if len(kern) != per_case * len(cases):
        return {"error": f"{len(kern)} rb_ kernels recorded, want "
                         f"{per_case * len(cases)}"}
    out = {}
    for i, (stage, _, _, _) in enumerate(cases):
        ev = kern[i * per_case:(i + 1) * per_case]
        pair_ev, fwd_ev = ev[:pair_n * calls], ev[pair_n * calls:]
        coupled = [e for e in pair_ev if "k41" in e.name]
        row = {"coupled": sum(e.time_range.elapsed_us() for e in coupled)
               / calls / 1e3}
        for name, j in (("f1", 0), ("f4", fwd_n - 1)):
            row[name] = sum(fwd_ev[c * fwd_n + j].time_range.elapsed_us()
                            for c in range(calls)) / calls / 1e3
        row["f4_f1"] = row["f1"] + row["f4"]
        out[stage] = row
    return out


def child_bgmv(tree):
    """BGMV at `chip_smoke.py`'s `BGMV_CASES` (its seeded inputs): the
    kernel's median CUDA-event ms over 50 calls, its device time and the
    device time of the yardstick torch.bmm(torch.bmm(x.float(), A[ids]),
    B[ids]) (``_dev_ms``: 32 calls in one CUDA graph cycling through 16
    copies of the slot stacks, so each call reads them from HBM), and the
    body each case launched where the tree counts them (``route``)."""
    import torch

    smoke = importlib.import_module("chip_smoke")
    bg = importlib.import_module("paddle_tpu_torch.ops.bgmv")
    routes = getattr(bg.lora_delta, "routes", None)
    res = {"tree": tree, "what": "bgmv"}
    g = torch.Generator(device="cuda").manual_seed(4)
    for label, d_in, d_out, r, b, s, dt in smoke.BGMV_CASES:
        x = torch.randn(b, s, d_in, device="cuda", generator=g).to(
            getattr(torch, dt))
        A = torch.randn(8, d_in, r, device="cuda", generator=g) * 0.02
        B = torch.randn(8, r, d_out, device="cuda", generator=g) * 0.02
        ids = torch.tensor(smoke.BGMV_IDS[:b], dtype=torch.int32,
                           device="cuda")
        idl = ids.long()
        name = f"{label.replace(' ', '_')}_{dt}"
        if routes is not None:
            for k in routes:
                routes[k] = 0
        bg.lora_delta(x, A, B, ids)
        if routes is not None:
            res[f"{name}_route"] = [k for k, c in routes.items() if c]
        copies = [(A.clone(), B.clone()) for _ in range(16)]
        res[f"{name}_ms"] = _time_ms(torch,
                                     lambda: bg.lora_delta(x, A, B, ids))
        res[f"{name}_dev_ms"] = _graph_ms(
            torch, [lambda a=a, b_=b_: bg.lora_delta(x, a, b_, ids)
                    for a, b_ in copies])
        res[f"{name}_bmm_dev_ms"] = _graph_ms(
            torch, [lambda a=a, b_=b_: torch.bmm(torch.bmm(
                x.float(), a[idl]), b_[idl]) for a, b_ in copies])
        del x, A, B, copies
    return res


def child_tenants(tree):
    """Run (d)'s decode step (`chip_smoke.py`'s `profile_tenants`: the int8
    llama2_7b at 32 layers with six LoRA adapters, bs 8) under
    torch.profiler: its results, the `bgmv` family's ms a step among them,
    and BGMV's launches by body in the child where the tree counts them."""
    import numpy as np
    import torch

    smoke = importlib.import_module("chip_smoke")
    bg = importlib.import_module("paddle_tpu_torch.ops.bgmv")
    prof = smoke.profile_tenants(torch, np, 32)
    return {"tree": tree, "what": "tenants", **prof,
            "routes": dict(getattr(bg.lora_delta, "routes", {}))}


STEP_WINDOW_S = 3.0
HANDOFFS = 2000                  # no-op steps through the step executor


def _run_b_engine():
    """Run (b)'s engine — llama2_7b, weights quantized to int8 from seed 0,
    an int8 KV pool, buckets 1-8, its step programs built where the tree
    has `warmup()` — decoding 8 sequences of 300 prompt tokens at bucket
    8, every prompt prefilled. Returns (torch, np, the tree's chip_smoke,
    the model, the engine, its streams)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn.quant import quantize_for_inference

    smoke = importlib.import_module("chip_smoke")
    model = gpt("llama2_7b", dtype="bfloat16", device="cuda", seed=0,
                num_layers=32)
    quantize_for_inference(model, "int8")
    torch.cuda.empty_cache()
    eng = DecodeEngine(model, max_length=1024, block_size=16,
                       decode_buckets=(1, 2, 4, 8), prefill_chunk=256,
                       quant="int8", default_timeout=600.0,
                       device=model.device)
    if hasattr(eng, "warmup"):
        eng.warmup()
    streams = [eng.submit(p, 1024 - 300) for p in smoke._prompts(
        np, model.cfg.vocab_size, (300,) * 8)]
    for st in streams:
        next(iter(st))                    # every prompt is prefilled
    return torch, np, smoke, model, eng, streams


def _wait_idle(eng):
    import time

    give_up = time.perf_counter() + 60.0
    while eng.stats()["active"] or eng.stats()["prefilling"]:
        if time.perf_counter() > give_up:
            raise AssertionError("the engine did not go idle")
        time.sleep(0.01)


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def child_decode_step(tree):
    """Run (b)'s decode step: unprofiled host-clock step ms (the window's
    mean, and the median and p90 of the intervals between consecutive
    steps' starts), the executor's no-op hand-off where the tree has one,
    then the tree's `profile_decode` (device-busy ms a step)."""
    import time

    torch, np, smoke, model, eng, streams = _run_b_engine()
    graphs = hasattr(eng, "warmup")
    starts, dispatch = [], eng._dispatch_decode

    def timed(active):
        starts.append(time.perf_counter())
        return dispatch(active)

    eng._dispatch_decode = timed
    s0, t0 = eng.stats()["steps"], time.perf_counter()
    time.sleep(STEP_WINDOW_S)
    s1, t1 = eng.stats()["steps"], time.perf_counter()
    del eng._dispatch_decode
    if any(st.done() for st in streams):
        raise AssertionError("a stream finished inside the window")
    for st in streams:
        st.cancel()
    gaps = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    handoff = None
    if hasattr(eng, "_submit_step"):
        # the step executor's own cost: a step with no device work sent
        # through it (a supervised one-slot pool) from this thread, with
        # the engine idle
        _wait_idle(eng)
        per = []
        for _ in range(HANDOFFS):
            h0 = time.perf_counter()
            eng._submit_step(lambda: None, "decode", [], {"bucket": 8})
            per.append((time.perf_counter() - h0) * 1e6)
        handoff = {"n": HANDOFFS, "median_us": _pct(per, 0.5),
                   "p90_us": _pct(per, 0.9),
                   "mean_us": sum(per) / len(per)}
    eng.shutdown()
    del eng
    prof = smoke.profile_decode(torch, np, model, "int8",
                                "b: int8 + int8 KV, bs 8")
    return {"tree": tree, "what": "decode_step", "graphs": graphs,
            "steps": s1 - s0, "step_ms": (t1 - t0) * 1e3 / (s1 - s0),
            "interval_median_ms": _pct(gaps, 0.5),
            "interval_p90_ms": _pct(gaps, 0.9),
            "handoff": handoff,
            "profiled_step_ms": prof["step_ms"],
            "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
            "device_idle_share": prof["device_idle_share"],
            "kernel_ms_per_step": prof["kernel_ms_per_step"]}


STEP_DEVICE_S = 2.0
STEP_DEVICE_PROFILED = 30


def _smi_sampler():
    """nvidia-smi printing the SM clock, power draw and temperature every
    100 ms until it is terminated."""
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)


def _smi_phases(out, phases):
    """{phase: {"samples", "sm_mhz" [min, median, max], "power_w" [...],
    "temp_c" max}} of the sampler's lines inside each phase's window."""
    import datetime

    rows = []
    for ln in out.splitlines():
        f = [x.strip() for x in ln.split(",")]
        try:
            rows.append((datetime.datetime.strptime(
                f[0], "%Y/%m/%d %H:%M:%S.%f"), float(f[1]), float(f[2]),
                float(f[3])))
        except (ValueError, IndexError):
            continue

    def spread(v):
        v = sorted(v)
        return [v[0], v[len(v) // 2], v[-1]] if v else None

    res = {}
    for name, (t0, t1) in phases.items():
        got = [r for r in rows if t0 <= r[0] <= t1]
        res[name] = {"samples": len(got),
                     "sm_mhz": spread([r[1] for r in got]),
                     "power_w": spread([r[2] for r in got]),
                     "temp_c": max((r[3] for r in got), default=None)}
    return res


def child_step_device(tree):
    """Run (b)'s bucket-8 greedy step program: device ms of a replay
    without the profiler against the summed kernel time of the same body
    run eagerly, and both under the profiler; see the module docstring."""
    import datetime
    import time

    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import DecodeEngine

    if not hasattr(DecodeEngine, "warmup"):
        return {"tree": tree, "what": "step_device", "graphs": False}
    torch, np, smoke, model, eng, streams = _run_b_engine()
    s0 = eng.stats()["steps"]
    while eng.stats()["steps"] < s0 + 20:   # bucket-8 steps staged
        time.sleep(0.01)
    for st in streams:
        st.cancel()
    _wait_idle(eng)
    prog = eng._programs.get("greedy", 8, None)
    if not prog.graph:
        raise AssertionError("run (b)'s bucket-8 program is not a graph")
    # the engine is idle and its pools unread from here on: the replays
    # and eager runs rewrite the last step's KV rows in its blocks
    replay = prog._graph.replay

    def eager():
        with torch.no_grad():
            prog._body(prog._staging.tensors)

    def events(fn):
        """(ms a run under CUDA events, runs): fn back to back for
        STEP_DEVICE_S seconds of host time."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        n, t_end = 0, time.perf_counter() + STEP_DEVICE_S
        a.record()
        while time.perf_counter() < t_end:
            for _ in range(5):
                fn()
            n += 5
            torch.cuda.synchronize()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n, n

    def profiled(fn):
        """(summed kernel ms a run, kernels a run, families) of
        STEP_DEVICE_PROFILED runs under torch.profiler."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(STEP_DEVICE_PROFILED):
                fn()
            torch.cuda.synchronize()
        evts = smoke.device_events(prof)
        fam = smoke.kernel_families(prof, (
            ("paged_decode_attention", ("paged_decode", "merge_splits")),
            ("weight_only_matmul", ("wo_gemv", "wo_mma_gemv", "wo_wgmma")),
            ("row_gemv", ("row_mma_gemv", "row_gemv")),
            ("library_gemm", smoke.GEMM_NAMES)))
        n = STEP_DEVICE_PROFILED
        return (sum(e.self_device_time_total for e in evts) / 1e3 / n,
                sum(e.count for e in evts) / n,
                {k: v / 1e3 / n for k, v in fam.items()})

    smi = _smi_sampler()
    time.sleep(1.0)                       # the sampler is up
    phases, res = {}, {}
    try:
        for name, run in (("graph_events", lambda: events(replay)),
                          ("eager_profiled", lambda: profiled(eager)),
                          ("graph_profiled", lambda: profiled(replay)),
                          ("eager_events", lambda: events(eager)),
                          ("graph_events_again", lambda: events(replay))):
            t0 = datetime.datetime.now()
            res[name] = run()
            phases[name] = (t0, datetime.datetime.now())
    finally:
        smi.terminate()
        smi_out, _ = smi.communicate(timeout=30)
    eng.shutdown()
    return {"tree": tree, "what": "step_device", "graphs": True,
            "graph_replay_ms": res["graph_events"][0],
            "graph_replays": res["graph_events"][1],
            "graph_replay_ms_again": res["graph_events_again"][0],
            "eager_run_ms": res["eager_events"][0],
            "eager_kernel_ms": res["eager_profiled"][0],
            "eager_kernels": res["eager_profiled"][1],
            "eager_families_ms": res["eager_profiled"][2],
            "graph_profiled_kernel_ms": res["graph_profiled"][0],
            "graph_profiled_kernels": res["graph_profiled"][1],
            "graph_profiled_families_ms": res["graph_profiled"][2],
            "smi": _smi_phases(smi_out, phases)}


def child_bert_step(tree):
    """Phase 5's BERT fine-tune step (the tree's `bert_throughput`)."""
    import numpy as np
    import torch

    smoke = importlib.import_module("chip_smoke")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = smoke.bert_throughput(torch, np, 12, 20, 0)
    return {"tree": tree, "what": "bert_step", "step_ms": res["step_ms"],
            "sequences_per_s": res["sequences_per_s"], "mfu": res["mfu"]}


DISPATCH_CALLS = 2000


def child_dispatch(tree):
    """µs of host time a call of the two wrappers (see the docstring)."""
    import time

    import torch

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    wo = importlib.import_module("paddle_tpu_torch.ops.weight_only")
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(1, 128, 3, 12, 64, device="cuda", generator=g,
                      dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    x = torch.randn(128, 768, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    qw = torch.randint(-127, 128, (2304, 768), device="cuda", generator=g,
                       dtype=torch.int8)
    sc = torch.rand(2304, device="cuda", generator=g) / 100
    calls = {"flash_attention_fwd":
             lambda: fa.flash_attention_fwd(q, k, v, causal=False),
             "weight_only_matmul":
             lambda: wo.weight_only_matmul(x, qw, sc, "int8")}
    res = {"tree": tree, "what": "dispatch", "calls": DISPATCH_CALLS}
    for name, fn in calls.items():
        runs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS)
        res[f"{name}_us"] = _pct(runs[1:], 0.5)
    return res


TRACE_WINDOW_S = 1.5
TRACE_REQUESTS = 256


def child_trace(tree):
    """Tracing's cost on an exported bert_base request and on run (b)'s
    decode step (see the docstring)."""
    import tempfile
    import time

    import numpy as np
    import torch

    try:
        tr = importlib.import_module("paddle_tpu_torch.obs.trace")
    except ImportError:
        tr = None
    modes = ("on", "off", "on", "off") if tr is not None else ("-",) * 4

    def set_mode(mode):
        if tr is not None:
            (tr.enable if mode == "on" else tr.disable)()

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import Config, ServingPool
    from paddle_tpu_torch.models import bert_for_sequence_classification

    smoke = importlib.import_module("chip_smoke")
    res = {"tree": tree, "what": "trace", "tracing": tr is not None,
           "request_ms": [], "decode_step_ms": []}
    bert = bert_for_sequence_classification(
        "bert_base", device="cuda", seed=0).to(torch.bfloat16).eval()
    feeds = smoke._pred_feeds(np, bert.cfg.vocab_size, TRACE_REQUESTS, 0)
    with tempfile.TemporaryDirectory(prefix="port_ab_trace-") as work:
        path = os.path.join(work, "bert")
        jit.save(bert, path, input_spec=[((1, 128), torch.int64)] * 2)
        pool = ServingPool(config=Config(path), size=2,
                           default_timeout=60.0)
        try:
            for f in feeds[:16]:
                pool.infer(f)
            for mode in modes:
                set_mode(mode)
                ms = []
                for f in feeds:
                    t0 = time.perf_counter()
                    if mode == "on":
                        with tr.root_span("port_ab.request"):
                            pool.infer(f)
                    else:
                        pool.infer(f)
                    ms.append((time.perf_counter() - t0) * 1e3)
                res["request_ms"].append([mode, _pct(ms, 0.5),
                                          _pct(ms, 0.9)])
        finally:
            pool.shutdown(drain_timeout=10.0)
    del bert, pool
    torch.cuda.empty_cache()
    set_mode("on")
    torch, np, smoke, model, eng, streams = _run_b_engine()
    for mode in modes:
        set_mode(mode)
        s0, t0 = eng.stats()["steps"], time.perf_counter()
        time.sleep(TRACE_WINDOW_S)
        s1, t1 = eng.stats()["steps"], time.perf_counter()
        res["decode_step_ms"].append([mode, (t1 - t0) * 1e3 / (s1 - s0)])
    if any(st.done() for st in streams):
        raise AssertionError("a stream finished inside the windows")
    eng.shutdown()
    set_mode("on")
    return res


def _child(what, tree):
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    res = {"flash": child_flash, "decode": child_decode,
           "short": child_short,
           "weight_only": child_weight_only,
           "dense_decode": child_dense_decode,
           "sparse": child_sparse, "ring": child_ring,
           "gemv": child_gemv, "decode_busy": child_decode_busy,
           "resblock": child_resblock, "pair": child_pair,
           "bgmv": child_bgmv, "tenants": child_tenants,
           "decode_step": child_decode_step,
           "step_device": child_step_device,
           "bert_step": child_bert_step,
           "dispatch": child_dispatch, "trace": child_trace}[what](tree)
    print("AB " + json.dumps(res), flush=True)


def _run(argv, label):
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True)
    try:
        out, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SystemExit(f"{label}: no result in {CHILD_TIMEOUT_S} s")
    if proc.returncode != 0:
        raise SystemExit(f"{label}: exit {proc.returncode}")
    return out


def _ptxas_lines(lines):
    """kernel (mangled name, the anonymous namespace's hash, which differs
    between the two trees' paths, left out) -> its ptxas register and
    spill lines, whitespace collapsed."""
    out, cur = {}, None
    for ln in lines:
        ln = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N_", ln)
        ln = " ".join(re.sub(r"(_GLOBAL__N_\d+_\w+?_cu_)[0-9a-f]{8}", r"\1",
                             ln).split())
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), [])
        elif cur is not None and ("registers" in ln or "spill" in ln):
            cur.append(ln)
    return out


def _ptxas_diff(parent, change):
    """The kernels whose register or spill lines differ between two
    builds' ptxas logs, and those built in one tree only."""
    a, b = _ptxas_lines(parent), _ptxas_lines(change)
    return {"what": "ptxas", "kernels": [len(a), len(b)],
            "differ": {k: [a[k], b[k]] for k in sorted(set(a) & set(b))
                       if a[k] != b[k]},
            "parent_only": sorted(set(a) - set(b)),
            "change_only": {k: b[k] for k in sorted(set(b) - set(a))}}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--what", default="decode,flash")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args.child, args.parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # a fresh build in each tree (its stamp removed first), so that both
    # print their ptxas lines
    build = ("import json, os; from paddle_tpu_torch.ops import _build; "
             "stamp = os.path.join(_build.BUILD_DIR, _build.LIB_NAME) + "
             "'.sha256'; os.path.exists(stamp) and os.remove(stamp); "
             "_build.build(); "
             "print('PTXAS ' + json.dumps(_build.build_info['ptxas']))")
    builds = [subprocess.Popen([sys.executable, "-c", build], cwd=t,
                               stdout=subprocess.PIPE, text=True)
              for t in (args.parent, args.change)]
    ptxas = []
    for t, p in zip((args.parent, args.change), builds):
        out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
        if p.returncode != 0:
            raise SystemExit(f"kernel build failed in {t}")
        ptxas.append(next((json.loads(ln[6:]) for ln in out.splitlines()
                           if ln.startswith("PTXAS ")), []))
    print(json.dumps(_ptxas_diff(*ptxas)), flush=True)
    for what in args.what.split(","):
        for _ in range(args.rounds):
            trees = (args.change,) if what in CHANGE_ONLY else (
                args.parent, args.change, args.change, args.parent)
            for tree in trees:
                out = _run([sys.executable, os.path.abspath(__file__),
                            tree, tree, "--child", what], f"{what} {tree}")
                for line in out.splitlines():
                    if line.startswith("AB "):
                        print(line[3:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
