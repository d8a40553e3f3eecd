#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # the full run
    python3 chip_smoke.py --quick    # short: fewer timing repeats, 2 layers
    python3 chip_smoke.py --cp-only  # phases 1, 2's ring checks, and 7
    python3 chip_smoke.py --recipes-only   # phases 1 and 9
    python3 chip_smoke.py --lora-only      # phases 1, 2's BGMV checks, 10

Phases (any failure exits non-zero and prints no result line):

1. device line (nvidia-smi name and power limit) and the kernel build
   (nvcc for sm_90a, from the sources in the checkout) with its time;
2. each hand-written kernel against its plain PyTorch version on the GPU,
   with the tolerance stated per kernel, and timed (CUDA events, median
   after warm-up) beside the plain version, one PyTorch library call
   computing the same function (a yardstick only; the port never calls
   it) and the bound: the larger of bytes moved / 3.35 TB/s and
   operations / 989 TFLOP/s (H100 SXM bf16 dense; 67 TFLOP/s, the f32
   non-tensor peak, for BGMV's f32 work). Serving kernels at the
   llama2_7b shapes of the decode path (the weight-only matmul at every
   decode bucket and two prefill chunks, each case naming the route it
   launched (the wrapper's route counts) — the main path's int8 gate_up
   at m = 8 and 256 held to the decode GEMV and the wgmma GEMM — and the
   decode rows bit-equal across m; BGMV at the qkv_proj and out_proj
   shapes of a multi-tenant batch, each case naming its body, the decode
   cases held to the cluster body, beside the torch.bmm pair's call and
   device time); the FlashAttention-2 forward (the
   route it launched named, the gpt_base case held to the Hopper body,
   each causal Hopper case launched hundreds of times in one CUDA graph
   and held bit-equal to its eager launch), dq and dkv kernels at the gpt_base and llama2_7b
   training shapes, causal and not, a ragged S, a padded head dim, bf16
   and f32; the short-attention
   forward and backward kernels (attention dropout drawn inside them) at
   the bert_base fine-tune shape (B=128, S=128, H=12, D=64, p=0.1) and
   beside it p=0, causal, f32, S=512, S=136 and D=40, with the kernel's own
   keep bits read out against 1 - p and against the plain stream, each
   case naming its forward and backward routes (the bf16 bert_base and
   S=512 cases held to the Hopper bodies); the paged decode kernel at the
   decode path's shapes (B = 8, BS = 16, ragged positions) on bf16 and
   int8 pools, held to the ring body, beside the first body; the
   fused bottleneck forward and backward kernels at ResNet-50's four stage
   shapes (N=128, bf16) against their plain versions (the backward on the
   kernels' residuals; every forward product held to its Hopper body by
   the wrapper's route counts), timed beside the plain versions and the
   per-op route of the same block (cuDNN convolutions and batch norm),
   with both directions' device time by launch from a child; the
   ring-step (position-masked) flash kernels at gpt_base's cp = 2 ring
   steps (ranks 0 and 1, own and visiting shard), a llama2_7b-width
   shard, a contiguous shard whose keys all lie in its future, f32 and no
   mask, timed beside SDPA with the boolean position mask; the serial
   ring (n = 2, 4 shards in one process through the pos kernels and the
   merge) against the whole-sequence flash kernels; the row-stable bf16
   GEMV of the decode buckets at the llama2_7b Linears (rows bit-equal
   across m, timed beside cuBLAS); the block-sparse flash kernel on
   tables of BigBird's pattern ([4*12, 4096, 64] bf16, f32, D = 128, a
   query block that lists nothing), timed beside SDPA with the dense tile
   mask; the dense decode kernel at llama2_7b's decode width (B = 8, T =
   4096, int8 and bf16 caches, pos 4095 and 2000, GQA 4:1, f32 query),
   beside SDPA with the position mask and the first body, and what a
   one-entry block table costs each body; the coupled pair of bottleneck
   blocks at the four stage shapes, beside two one-block calls and the
   per-op route;
3. serving end to end: llama2_7b at full width (random weights from a
   seed) served by `DecodeEngine` on its step programs, CUDA graphs built
   by `warmup()` (every decode step a replay: replays equal steps) —
   (a) bf16 weights with a bf16 KV pool, (b) int8 weights with an int8
   KV pool, (c) int4 weights, one short wave — with launch counts of both
   kernels set to 0 before and read after each run (every paged launch
   on the ring body, counted on replays), tokens/s, time to first token,
   mean decode step ms, the block-pool
   conservation check, the engine's first decode-step logits against a
   dense `model.forward` recompute, solo-vs-batched token equality (held:
   every float decode Linear goes through the row-stable GEMV), the same
   prompts through eager steps (`_eager_steps`, half the tokens) held
   bit-equal to the graphs' tokens for (a) and (b), and a
   torch.profiler window over decode steps (device-busy time per step
   and kernel time by family); then (d) multi-tenant serving on run (b)'s
   int8 model: LoRA adapters through BGMV (every launch on its cluster
   body), a shared system prompt through
   the prefix cache with copy-on-write, sampled and greedy requests, a
   stop sequence — tokens held against a private-copy engine on eager
   steps — and its decode step under torch.profiler in a child process;
   and (e) speculative decoding on run (a)'s bf16 model, K = 4, over run
   (a)'s prompts, drafted by the target itself and by a 4-layer draft
   of its first blocks: every propose and verify step a replay, the
   tokens held equal to run (a)'s, the acceptance counters and both
   block pools checked;
4. training end to end: gpt_base at full width and depth (f32 masters,
   bf16 compute) through `distributed.parallelize` with AdamW and global
   grad-norm clipping — a throughput run on one fixed batch from
   `--seed` (step ms, tokens/s, MFU, the loss trajectory, flash launch
   counts set to 0 before and read after), a parity run of the same
   weights through the kernels and through the plain attention, and a
   torch.profiler window over 3 steps in a child process (device-busy
   share and kernel time by family);
5. BERT fine-tuning end to end: bert_base at full width and depth (f32
   masters, bf16 compute, attention and hidden dropout 0.1 from a seeded
   CUDA generator) through `distributed.parallelize` with AdamW lr 2e-5 on
   one fixed [128, 128] batch from `--seed` (bench.py's row) — 20 steps
   (step ms, sequences/s, MFU over bench.py's matmul parameters, launch
   counts set to 0 before and read after, every forward on its Hopper
   body and every backward launch on the Hopper bodies), a parity run of
   the same
   weights and generator seed through the kernels, again through the
   kernels (bit for bit) and through the plain composed route, in bf16
   and in f32 compute, with a planted fault (the kernels without their
   dropout) that the f32 gates must catch, one `eval_batch` with dropout
   off (the flash forward), and a torch.profiler window over 3 steps in a
   child process;
6. ResNet-50 training end to end: resnet50 at full size (1000 classes,
   NHWC, f32 masters, bf16 compute) through `distributed.parallelize`
   with Momentum 0.1 / 0.9 on one fixed batch of 128 random 224 px images
   and labels from `--seed` (bench.py's TPU row) — 20 steps on the per-op
   route and on the fused route (``PADDLE_TPU_FUSED_RESBLOCK=1``: the 12
   stride-1 identity blocks through the fused kernels), each with the
   fused calls set to 0 before and read after (12 + 12 a step, and none;
   every forward launch on its body),
   step ms, images/s, MFU, peak memory; a 3-step parity run at B=32 in
   bf16 and f32 compute, gated on its first step (loss and grad norm
   against the plain fused route, the whole gradient against the plain
   backward on the kernels' forward), with a bit-equal rerun, the
   per-op route's gap, and a planted fault (the BN backward's m2 term
   dropped) that the f32 gates must catch; a torch.profiler child per
   route;
7. context-parallel training: two ranks started by the script
   (``--cp-rank``) share cuda:0 over gloo, K/V and gradients staged
   through pinned host memory (NCCL takes one rank per device), and train
   gpt_base at full width and depth at cp = 2 on one fixed [8, 1024]
   batch (phase 4's configuration, the sequence zigzag-split): two bf16
   3-step runs (bit-equal), 20 bf16 steps after 2 warm-up steps (step
   ms, global tokens/s, MFU over the one card, the exchange's ms and
   bytes per step, launch counts set to 0 before and read after: 24 of
   each ring-step kernel per rank per step), 3 f32 steps against the
   single-device engine on the same weights (loss 1e-4, grad norm 1e-3,
   the first step's qkv gradient normwise 1e-3), the same with a planted
   fault (the merge's weight of the visiting partial dropped) that must
   fail those gates, and one Ulysses step (reported);
8. CSR-pattern attention: `nn.functional.sparse_attention` at
   BigBird-base's width (H = 12, D = 64, S = 4096) on BigBird's ITC
   pattern of 128-token blocks (window, two global blocks, three random
   blocks from `--seed`), the CSR a user passes, in bf16 and f32: forward
   and backward of sum(out * g) through the block route (the block-sparse
   launch count set to 0 before and read after: one a forward), forward
   and backward ms, the output against a dense masked f32 recompute, the
   gradients against the plain route and the dense recompute, a
   planted fault (the kernel visits block_cnt - 1 blocks) that the gates
   must catch; the SDDMM route (S = 1024, a pattern per head, both masks)
   against the dense recompute; the dense decode kernel and the coupled
   pair, which no model calls, driven with their counts set to 0;
9. training recipes, at phases 4 and 5's configurations: (a) gpt_base
   pretraining under AdamW at LinearWarmup(CosineAnnealingDecay) with
   global-norm clipping — 2 + 20 micro-steps through `train_batches`
   (step ms and tokens/s beside phase 4's constant rate, flash launches
   counted, all on the Hopper bodies) bit-equal to `train_batch` with
   the scheduler stepped by hand, a `snapshot()` after step 10 restored
   twice and replayed bit for bit, `state_dict()` into a freshly built
   engine continuing bit for bit, and 5 steps under ClipGradByNorm;
   (b) BERT-base fine-tuning under AMP O2 (BASELINE config 2) as a
   dygraph loop — `decorate` to bf16, AdamW with decay off for biases
   and norm weights under LinearWarmup(PolynomialDecay), `auto_cast`,
   `GradScaler` — 20 steps (sequences/s and MFU beside phase 5's, every
   short-attention launch on its Hopper body, falling losses), a planted
   inf step skipped with the scale halved, 3 steps through the kernels
   twice (bit for bit) and through the plain route (loss 1e-2); (c) the
   fp16 GradScaler on a small MLP: planted overflows skipped, the scale
   halved and grown back; then, in a child process, (b)'s loop beside
   phase 5's engine (engine, O2, O2, engine, 10 steps each) and under
   torch.profiler;
10. LoRA fine-tuning and inference (BASELINE config 5): llama2_7b at full
   width and depth (bf16 weights from a seed) with r = 8 adapters on
   qkv_proj and out_proj (`nn.lora.apply_lora`), (a) fine-tuned through
   `distributed.parallelize` (bf16 compute, AdamW over `lora_parameters`
   at LinearWarmup(CosineAnnealingDecay(3e-4)), global-norm clip 1.0) on
   one fixed [4, 1024] batch from `--seed`: 2 + 20 steps (step ms,
   tokens/s, MFU over `lora_flops_per_token`, peak memory, falling
   losses, flash launches set to 0 before and read after, all on the
   Hopper bodies), every adapter moved and every base tensor bit-equal
   to a fresh build of the seed, and a 2-layer parity run through the
   kernels and the plain attention; (b) `generate` with the adapters
   live at bench.py's LoRA decode shape (bs 8, 16 + 128 tokens): greedy
   (tokens/s), sampled (a rerun bit-equal, another seed different),
   merged (equal to the unmerged tokens up to the first near-tie) and on
   int8 weights (every weight-only launch on its route); (c) the
   exported adapter in an `AdapterPool` over the fresh build, served on
   CUDA graphs beside adapter-free requests: the tenant's tokens equal
   (b)'s up to the first near-tie, its first-token logits close to (b)'s,
   every BGMV, paged and GEMV launch on its body, replays equal steps,
   the block pool conserved;
11. the kernels' JSON line, the nvidia-smi line, then the last line
   ``{"ok": true, "device": {...}}``.

TF32 is switched off for matmuls and cuDNN, so every float32 product in
the plain versions is a full float32 product.
"""
from __future__ import annotations

import faulthandler
import gc
import json
import os
import subprocess
import sys
import time
import weakref

HERE = os.path.dirname(os.path.abspath(__file__))
WATCHDOG_S = 1140                  # inside the 1200 s a run may take
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12                # H100 SXM f32 peak outside the tensor cores
LLAMA_LINEARS = {                # (n, k) of the llama2_7b serving path
    "qkv": (12288, 4096), "o_proj": (4096, 4096),
    "gate_up": (22016, 4096), "down": (4096, 11008),
    "lm_head": (32000, 4096)}
WO_ROWS = (1, 2, 4, 8, 16, 100, 256)   # m of the weight-only checks
# flash-attention checks: (label, B, S, H, D, dtype, causal, timed); the
# first is the gpt_base training shape, the one the kernels' line reports
FLASH_CASES = (
    ("gpt_base", 16, 1024, 12, 64, "bfloat16", True, True),
    ("gpt_base", 16, 1024, 12, 64, "bfloat16", False, True),
    ("llama2_7b", 4, 2048, 32, 128, "bfloat16", True, True),
    ("llama2_7b", 4, 2048, 32, 128, "bfloat16", False, True),
    ("gpt_base", 16, 1024, 12, 64, "float32", True, True),
    ("ragged S", 4, 1000, 12, 64, "bfloat16", True, False),
    ("ragged S", 4, 1000, 12, 64, "float32", False, False),
    ("padded D", 2, 1024, 8, 80, "bfloat16", True, False),
    ("padded D", 2, 1000, 8, 80, "float32", False, False),
)
# dtype -> (O max abs error, each gradient's normwise relative error)
FLASH_TOL = {"bfloat16": (2e-2, 1e-3), "float32": (1e-4, 1e-5)}
TRAIN_BATCH, TRAIN_SEQ = 16, 1024
# short-attention checks: (label, B, S, H, D, dtype, causal, p); the first
# is the bert_base fine-tune shape, the one the kernels' line reports
SHORT_CASES = (
    ("bert_base", 128, 128, 12, 64, "bfloat16", False, 0.1),
    ("bert_base p=0", 128, 128, 12, 64, "bfloat16", False, 0.0),
    ("bert_base causal", 128, 128, 12, 64, "bfloat16", True, 0.1),
    ("bert_base f32", 128, 128, 12, 64, "float32", False, 0.1),
    ("S=512", 16, 512, 12, 64, "bfloat16", False, 0.1),
    ("S=136", 32, 136, 12, 64, "bfloat16", False, 0.1),
    ("D=40", 32, 128, 12, 40, "bfloat16", False, 0.1),
)
BERT_BATCH, BERT_SEQ = 128, 128     # bench.py's bert_base fine-tune row
# context parallelism (phase 7): gpt_base on one fixed [8, 1024] batch,
# the sequence split over two ranks that share the card
CP_WORLD, CP_BATCH, CP_SEQ = 2, 8, 1024
CP_TIMEOUT = 900                    # seconds for the two ranks together
# ring-step kernel checks: (label, B, H, s, D, dtype, q's rank, k's rank,
# zigzag, causal, timed) at cp = 2: the first four are the gpt_base ring
# steps of the main path (the kernels' line reports their mean)
FLASH_POS_CASES = (
    ("gpt_base r0 own", 8, 12, 512, 64, "bfloat16", 0, 0, True, True, True),
    ("gpt_base r0 visiting", 8, 12, 512, 64, "bfloat16", 0, 1, True, True,
     True),
    ("gpt_base r1 own", 8, 12, 512, 64, "bfloat16", 1, 1, True, True, True),
    ("gpt_base r1 visiting", 8, 12, 512, 64, "bfloat16", 1, 0, True, True,
     True),
    ("llama2_7b r0 own", 1, 32, 2048, 128, "bfloat16", 0, 0, True, True,
     True),
    ("llama2_7b r0 visiting", 1, 32, 2048, 128, "bfloat16", 0, 1, True,
     True, True),
    ("gpt_base contiguous r0, keys all in its future", 8, 12, 512, 64,
     "bfloat16", 0, 1, False, True, False),
    # zigzag runs of 192 (S = 768): the middle 128-row tile holds rows
    # that see no key of the visiting shard beside rows that see them all
    ("gpt_base-width r0 visiting, runs of 192", 8, 12, 384, 64, "bfloat16",
     0, 1, True, True, False),
    ("llama2_7b-width r0 visiting, runs of 192", 1, 32, 384, 128,
     "bfloat16", 0, 1, True, True, False),
    ("gpt_base r0 visiting", 8, 12, 512, 64, "float32", 0, 1, True, True,
     False),
    ("gpt_base r0 visiting", 8, 12, 512, 64, "bfloat16", 0, 1, True, False,
     False),
)


def log(msg):
    print(msg, flush=True)


def log_phase(t_start, title):
    log(f"{title} (at {time.perf_counter() - t_start:.0f} s)")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters, warmup=3):
    """Median of per-call CUDA-event times after warm-up."""
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
    times.sort()
    return times[len(times) // 2]


def graph_mismatches(torch, fn, ref, budget=2 << 30, reps=3):
    """`fn`'s launches back to back in one CUDA graph, as many as `budget`
    bytes of outputs hold (at most 256), the graph replayed `reps` times:
    (launches, launches whose outputs differ from the tensors `ref` bit for
    bit). A kernel whose CTAs race shows it here first."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    calls = max(8, min(256, budget // sum(t.nbytes for t in ref)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(calls)]
    bad = 0
    for _ in range(reps):
        graph.replay()
        torch.cuda.synchronize()
        bad += sum(not all(torch.equal(a, b) for a, b in zip(o, ref))
                   for o in outs)
    del graph, outs
    return calls * reps, bad


def time_graph_ms(torch, fns, calls=32, reps=7):
    """Device time of one call, host overhead left out: `calls` calls
    (cycling through `fns`) captured in one CUDA graph, the graph replayed
    `reps` times after a warm-up replay; the median replay time over
    `calls`. Cycling through inputs larger than the 50 MB L2 between
    calls makes each call read its inputs from HBM, as the decode step's
    layer after layer does."""
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
    times.sort()
    del graph
    return times[len(times) // 2]


def bound(nbytes, flops, peak=BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


GEMM_NAMES = ("gemm", "gemv", "nvjet", "cutlass", "xmma")


def device_events(prof):
    """The profile's device activity (kernels, copies) by name. CPU ops
    and user annotations are left out: their device time is their
    kernels' time, which would count twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and not getattr(e, "is_user_annotation", False)]


def kernel_families(prof, families):
    """Device time (us) of a torch.profiler window by kernel family: the
    first family whose name fragments match a kernel's name, else
    "other"."""
    fam = {name: 0.0 for name, _ in families}
    fam["other"] = 0.0
    for evt in device_events(prof):
        us = evt.self_device_time_total
        name = evt.key.lower()
        key = next((f for f, frags in families
                    if any(w in name for w in frags)), "other")
        fam[key] += us
    return fam


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def top_kernels(prof, steps, n=15):
    """The n kernels with the most device time, ms per step."""
    evts = sorted(device_events(prof), key=lambda e: -e.self_device_time_total)
    return [(e.key[:120], e.count / steps, e.self_device_time_total / 1e3
             / steps) for e in evts[:n]]


WO_ROUTE_NAMES = {0: "gemv (CUDA cores)", 1: "decode (mma.sync GEMV)",
                  2: "prefill (wgmma)"}


def zero_routes(wrapper):
    """Set each route's launch count of `wrapper` (`.routes`) to 0."""
    for r in wrapper.routes:
        wrapper.routes[r] = 0


def launched_route(wrapper, names):
    """The name of the one route `wrapper` launched since its counts were
    set to 0 (`zero_routes`); fails unless it made exactly one launch."""
    took = {r: c for r, c in wrapper.routes.items() if c}
    if sum(took.values()) != 1:
        raise AssertionError(f"{wrapper.__name__}: route launches "
                             f"{wrapper.routes}, expected one")
    return names[next(iter(took))]


def check_weight_only(torch, iters):
    """Every llama2_7b Linear in int8 and int4 at every decode bucket and
    two prefill chunks (a ragged one and a full one), each against the
    plain version (2 bf16 ulps of the largest output), timed beside the
    plain version and `torch.matmul` on the dequantized bf16 weight; each
    row names the kernel route it launched, read from the wrapper's route
    counts around the checked call. The decode rows of one weight come
    from the first rows of one x, so a row computed at m < 16 must equal
    the m = 16 call's bit for bit (the row-stable contract)."""
    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.weight_only import (
        unpack_int4, weight_only_matmul, weight_only_matmul_ref)

    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for lname, (n, k) in LLAMA_LINEARS.items():
        w = torch.randn(n, k, device="cuda", generator=g) * 0.02
        for wdt in ("int8", "int4"):
            qw, sc = weight_quantize(w.t(), f"weight_only_{wdt}")
            q_full = unpack_int4(qw) if wdt == "int4" else qw
            w_deq = (q_full.float() * sc[:, None]).to(torch.bfloat16)
            X = torch.randn(max(WO_ROWS), k, device="cuda",
                            generator=g).to(torch.bfloat16)
            decode = {}
            for m in WO_ROWS:
                x = X[:m]
                zero_routes(weight_only_matmul)
                got = weight_only_matmul(x, qw, sc, wdt)
                route = launched_route(weight_only_matmul, WO_ROUTE_NAMES)
                ref = weight_only_matmul_ref(x, qw, sc, wdt)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                # both round an f32 sum to bf16: two bf16 ulps at the
                # largest |output| covers rounding plus summation order
                tol = 2 * 2.0 ** -8 * ref.float().abs().max().item()
                ok = err <= tol and bool(torch.isfinite(got).all())
                if m <= 16:
                    decode[m] = got
                ms = time_ms(torch, lambda: weight_only_matmul(
                    x, qw, sc, wdt), iters)
                plain = time_ms(torch, lambda: weight_only_matmul_ref(
                    x, qw, sc, wdt), max(3, iters // 4))
                lib = time_ms(torch, lambda: torch.matmul(x, w_deq.t()),
                              iters)
                nbytes = x.numel() * 2 + qw.numel() + sc.numel() * 4 \
                    + m * n * 2
                bms, by = bound(nbytes, 2.0 * m * n * k)
                row = dict(case=f"{wdt} m={m} {lname} n={n} k={k}",
                           wdt=wdt, m=m, layer=lname, route=route,
                           max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                           library_ms=lib, bound_ms=bms, bound_by=by)
                rows.append(row)
                log(f"  weight_only {row['case']} [{route}]: err {err:.3g} "
                    f"(tol {tol:.3g}) kernel {ms:.4f} ms plain {plain:.4f} "
                    f"ms library {lib:.4f} ms bound {bms:.4f} ms ({by})")
                if not ok:
                    raise AssertionError(f"weight_only {row['case']}: "
                                         f"max abs err {err} > {tol}")
            top = max(decode)
            for m, out in decode.items():
                if not torch.equal(out, decode[top][:m]):
                    raise AssertionError(
                        f"weight_only {wdt} {lname}: the rows of m={m} "
                        f"differ from the first rows of m={top}")
        del w
    return rows


def _paged_case(torch, g, B, H, Hkv, D, BS, pos, int8):
    """A [N, BS, Hkv, D] pool with garbage everywhere (block 0 included),
    distinct random tables, tails pointing at block 0."""
    NB = max(p // BS + 1 for p in pos)
    used = sum(p // BS + 1 for p in pos)
    N = used + 1
    perm = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(
        B + H + Hkv)) + 1).tolist()
    tables = torch.zeros(B, NB, dtype=torch.int32)
    for b, p in enumerate(pos):
        nb = p // BS + 1
        tables[b, :nb] = torch.tensor([perm.pop() for _ in range(nb)])
    q = torch.randn(B, 1, H, D, device="cuda", generator=g).to(
        torch.bfloat16)
    k = torch.randn(N, BS, Hkv, D, device="cuda", generator=g)
    v = torch.randn(N, BS, Hkv, D, device="cuda", generator=g)
    if int8:
        from paddle_tpu_torch.models.gpt import _quant_kv

        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        pool = (kq, ks, vq, vs)
    else:
        pool = (k.to(torch.bfloat16), None, v.to(torch.bfloat16), None)
    return q, pool, tables.cuda(), torch.tensor(pos, dtype=torch.int32,
                                                device="cuda")


PAGED_ROUTE_NAMES = {0: "first body (paged_decode)",
                     1: "ring body (paged_decode_ring)"}


def check_paged(torch, iters):
    """The paged kernel at llama2_7b's decode width (B = 8, H = 32, D =
    128, BS = 16, ragged positions 0..2000) on bf16 and int8 pools, MHA
    and GQA 4:1, against its plain version (1e-2 abs, bf16 output): the
    route each case launched (the main path's pools must take the ring
    body), a call's time, its device time from a CUDA graph, and beside
    them the first body on the same inputs, the plain version, SDPA over
    the gathered cache and the bound."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import decode_attn as da
    from paddle_tpu_torch.ops.decode_attn import (
        paged_decode_attention, paged_decode_attention_ref)

    g = torch.Generator(device="cuda").manual_seed(2)
    B, D, BS = 8, 128, 16
    pos = [0, 7, 150, 511, 900, 1333, 1700, 2000]   # ragged, mid-block
    rows = []
    for name, H, Hkv, int8 in (("bf16 MHA", 32, 32, False),
                               ("int8 MHA", 32, 32, True),
                               ("bf16 GQA", 32, 8, False)):
        q, (kp, ksp, vp, vsp), tables, pos_t = _paged_case(
            torch, g, B, H, Hkv, D, BS, pos, int8)
        # the engine's view: permute the [N, BS, Hkv, D] pool, no copy
        args = (q, kp.permute(0, 2, 1, 3),
                None if ksp is None else ksp.permute(0, 2, 1),
                vp.permute(0, 2, 1, 3),
                None if vsp is None else vsp.permute(0, 2, 1), tables, pos_t)
        zero_routes(paged_decode_attention)
        got = paged_decode_attention(*args)
        route = launched_route(paged_decode_attention, PAGED_ROUTE_NAMES)
        ref = paged_decode_attention_ref(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        # bf16 output: two ulps at |out| <= 1 plus f32 summation order
        tol = 1e-2
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"paged_decode {name}: max abs err {err} "
                                 f"> {tol}")
        if route != PAGED_ROUTE_NAMES[1]:
            raise AssertionError(f"paged_decode {name}: took {route}, not "
                                 f"the ring body")
        ms = time_ms(torch, lambda: paged_decode_attention(*args), iters)
        dev = time_graph_ms(torch, [lambda: paged_decode_attention(*args)])

        def first():
            return da._launch_paged(*args, paged_decode_attention,
                                    da.PAGED_SCALAR)
        first_err = (first().float() - ref.float()).abs().max().item()
        first_ms = time_ms(torch, first, iters)
        first_dev = time_graph_ms(torch, [first])
        plain = time_ms(torch, lambda: paged_decode_attention_ref(*args),
                        max(3, iters // 4))
        # yardstick: SDPA over the cache gathered (and dequantized) ahead
        T = tables.shape[1] * BS

        def dense(pool, sc):
            gth = pool[tables.long()].reshape(B, T, Hkv, D)
            if sc is not None:
                gth = gth.float() * sc[tables.long()].reshape(B, T, Hkv,
                                                              1)
            return gth.to(torch.bfloat16).transpose(1, 2)

        kd, vd = dense(kp, ksp), dense(vp, vsp)
        mask = (torch.arange(T, device="cuda")[None, :]
                <= pos_t[:, None].long())[:, None, None, :]
        qd = q.transpose(1, 2)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=Hkv != H), iters)
        toks = sum(p + 1 for p in pos)
        elt = 1 if int8 else 2
        nbytes = 2 * toks * Hkv * D * elt + (2 * toks * Hkv * 4 if int8
                                             else 0) \
            + 2 * q.numel() * 2 + tables.numel() * 4 + B * 4
        bms, by = bound(nbytes, 4.0 * H * D * toks)
        row = dict(case=f"{name} B={B} H={H} Hkv={Hkv} D={D} BS={BS} "
                        f"pos={pos[0]}..{pos[-1]}", max_abs_err=err, tol=tol,
                   route=route, ms=ms, device_ms=dev, plain_ms=plain,
                   library_ms=lib, bound_ms=bms, bound_by=by,
                   first_body_ms=first_ms, first_body_device_ms=first_dev,
                   first_body_max_abs_err=first_err)
        rows.append(row)
        log(f"  paged_decode {row['case']} [{route}]: err {err:.3g} (tol "
            f"{tol}) kernel {ms:.4f} ms device {dev:.4f} ms (first body "
            f"{first_ms:.4f} / {first_dev:.4f}) plain {plain:.4f} ms "
            f"library {lib:.4f} ms bound {bms:.4f} ms ({by})")
    return rows


# BGMV checks: (label, d_in, d_out, rank, batch, s, x dtype); slots 8.
# The first is the decode path's qkv_proj launch, the kernels line's case.
BGMV_CASES = (
    ("qkv_proj", 4096, 12288, 16, 8, 1, "bfloat16"),
    ("out_proj", 4096, 4096, 16, 8, 1, "bfloat16"),
    ("qkv_proj", 4096, 12288, 16, 8, 1, "float32"),
    ("out_proj", 4096, 4096, 16, 8, 1, "float32"),
    ("qkv_proj prefill", 4096, 12288, 16, 2, 256, "bfloat16"),
    ("out_proj rank 64", 4096, 4096, 64, 8, 1, "bfloat16"),
    # the rank phase 10 serves (its fine-tuned adapter)
    ("qkv_proj rank 8", 4096, 12288, 8, 8, 1, "bfloat16"),
    ("out_proj rank 8", 4096, 4096, 8, 8, 1, "bfloat16"),
    ("ragged d_out", 4096, 5000, 16, 8, 1, "bfloat16"),
)
BGMV_IDS = (0, 1, 1, 2, 3, 0, 5, 7)   # slot 0, a repeat, distinct slots
BGMV_ROUTE_NAMES = {0: "two launches (bgmv_shrink, bgmv_expand)",
                    1: "cluster body (bgmv_cluster, one launch)"}


def check_bgmv(torch, iters):
    """BGMV against its plain version (f32 gather + two einsums):
    max abs error <= 1e-5 x max |ref| + 1e-6 (f32 sums in another order);
    each row of the first case bitwise equal alone and in the batch; each
    case names the body it launched (`lora_delta.routes`), every decode
    case (s = 1) held to the cluster body. `ms` is one wrapper call
    between CUDA events (the host's share included, as for the other
    kernels); `device_ms` the kernels alone (`time_graph_ms`, cycling
    through 16 copies of the slot stacks). Library yardstick:
    torch.bmm(torch.bmm(x.float(), A[ids]), B[ids]), a call and on the
    device the same way (`library_device_ms`).
    Bound: x read once, each distinct slot's A and B once, the output
    written once over 3.35 TB/s; 2*b*s*r*(d_in + d_out) f32 operations
    over 67 TFLOP/s."""
    from paddle_tpu_torch.ops.bgmv import lora_delta, lora_delta_ref

    g = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for label, d_in, d_out, r, b, s, dt in BGMV_CASES:
        x = torch.randn(b, s, d_in, device="cuda", generator=g).to(
            getattr(torch, dt))
        A = torch.randn(8, d_in, r, device="cuda", generator=g) * 0.02
        B = torch.randn(8, r, d_out, device="cuda", generator=g) * 0.02
        A[0] = 0.0
        B[0] = 0.0
        ids = torch.tensor(BGMV_IDS[:b], dtype=torch.int32, device="cuda")
        zero_routes(lora_delta)
        got = lora_delta(x, A, B, ids)
        route = launched_route(lora_delta, BGMV_ROUTE_NAMES)
        ref = lora_delta_ref(x, A, B, ids)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item() + 1e-6
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"bgmv {label} {dt}: max abs err {err} > "
                                 f"{tol}")
        row = dict(case=f"{label} d_in={d_in} d_out={d_out} r={r} b={b} "
                        f"s={s} {dt} slots=8", max_abs_err=err, tol=tol,
                   route=route)
        if s == 1 and route != BGMV_ROUTE_NAMES[1]:
            raise AssertionError(f"bgmv {row['case']} took {route}")
        if not rows:
            solo = [lora_delta(x[i:i + 1], A, B, ids[i:i + 1])
                    for i in range(b)]
            same = sum(bool(torch.equal(o, got[i:i + 1]))
                       for i, o in enumerate(solo))
            row["solo_vs_batched_bitwise"] = f"{same}/{b}"
            if same != b:
                raise AssertionError(f"bgmv rows not batch-invariant: "
                                     f"{same}/{b} equal")
        row["ms"] = time_ms(torch, lambda: lora_delta(x, A, B, ids), iters)
        copies = [(A.clone(), B.clone()) for _ in range(16)]
        row["device_ms"] = time_graph_ms(torch, [
            lambda a=a, b_=b_: lora_delta(x, a, b_, ids)
            for a, b_ in copies])
        del copies
        row["plain_ms"] = time_ms(torch, lambda: lora_delta_ref(x, A, B,
                                                                ids),
                                  max(3, iters // 4))
        row["library_ms"] = time_ms(torch, lambda: torch.bmm(torch.bmm(
            x.float(), A[ids.long()]), B[ids.long()]), iters)
        copies = [(A.clone(), B.clone()) for _ in range(16)]
        row["library_device_ms"] = time_graph_ms(torch, [
            lambda a=a, b_=b_: torch.bmm(torch.bmm(x.float(), a[ids.long()]),
                                         b_[ids.long()])
            for a, b_ in copies])
        del copies
        distinct = len(set(BGMV_IDS[:b]))
        nbytes = x.numel() * x.element_size() + distinct * (
            d_in * r + r * d_out) * 4 + b * s * d_out * 4 + b * 4
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 2.0 * b * s * r * (d_in + d_out), F32_FLOPS)
        rows.append(row)
        log(f"  bgmv {row['case']} [{route}]: err {err:.3g} (tol "
            f"{tol:.3g}) kernel {row['ms']:.4f} ms (device "
            f"{row['device_ms']:.4f}) plain {row['plain_ms']:.4f} ms "
            f"library {row['library_ms']:.4f} ms (device "
            f"{row['library_device_ms']:.4f}) bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']})")
        del x, A, B, got, ref
    return rows


def _flash_mod():
    import importlib

    return importlib.import_module("paddle_tpu_torch.ops.flash_attention")


def flash_counts():
    fa = _flash_mod()
    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_dq": fa.flash_attention_bwd_dq.launches,
            "flash_attention_dkv": fa.flash_attention_bwd_dkv.launches}


def reset_flash_counts():
    fa = _flash_mod()
    for w in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv):
        w.launches = 0
        zero_routes(w)


FLASH_ROUTE_NAMES = {0: "mma.sync body", 3: "Hopper body (TMA + wgmma)"}
# the backward's bodies (`flash_bwd_route`'s codes), dQ and dK/dV alike
FLASH_BWD_ROUTE_NAMES = {0: "mma.sync body", 1: "Hopper body (TMA + wgmma)"}
# the cases whose forward and backward must take the Hopper bodies: the
# main paths' shapes
FLASH_HOPPER_CASES = ("gpt_base", "llama2_7b")


def flash_route_counts():
    """Launches by route name of the three flash wrappers since their
    counts were set to 0."""
    fa = _flash_mod()
    return {"fwd": {FLASH_ROUTE_NAMES[r]: c for r, c in
                    fa.flash_attention_fwd.routes.items()},
            "dq": {FLASH_BWD_ROUTE_NAMES[r]: c for r, c in
                   fa.flash_attention_bwd_dq.routes.items()},
            "dkv": {FLASH_BWD_ROUTE_NAMES[r]: c for r, c in
                    fa.flash_attention_bwd_dkv.routes.items()}}


def check_flash(torch, iters):
    """Forward, dq and dkv kernels against the plain versions on the same
    inputs (the backward kernels and the plain backward both take the
    plain forward's lse and delta, so each kernel is held alone).
    Tolerances (FLASH_TOL): O max abs error <= 2e-2 in bf16, 1e-4 in
    f32; each gradient's normwise error ||got - ref|| / ||ref|| <= 1e-3
    in bf16, 1e-5 in f32 (about 5x and 25x the largest readings on an
    H100: 1.9e-4 and 3.9e-7). The largest error relative to max |grad|
    is reported beside it. q, k, v are views of one [B, S, 3, H, D] tensor,
    as the model's fused QKV gives them. Each case names the forward's and
    the backward's route (the dQ and dK/dV wrappers' route counts); the
    bf16 cases of FLASH_HOPPER_CASES must take the Hopper bodies, and each
    causal case on a Hopper body is replayed in a CUDA graph
    (`graph_mismatches`), forward and backward alike."""
    import torch.nn.functional as F

    fa = _flash_mod()
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for label, B, S, H, D, dt, causal, timed in FLASH_CASES:
        dtype = getattr(torch, dt)
        qkv = torch.randn(B, S, 3, H, D, device="cuda", generator=g).to(
            dtype)
        q, k, v = qkv.unbind(2)
        do = torch.randn(B, S, H, D, device="cuda", generator=g).to(dtype)
        zero_routes(fa.flash_attention_fwd)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        route = launched_route(fa.flash_attention_fwd, FLASH_ROUTE_NAMES)
        ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
        delta = fa.attention_delta(ref, do)
        bwd_args = (q, k, v, do, lse_ref, delta)
        zero_routes(fa.flash_attention_bwd_dq)
        zero_routes(fa.flash_attention_bwd_dkv)
        dq = fa.flash_attention_bwd_dq(*bwd_args, causal=causal)
        dk, dv = fa.flash_attention_bwd_dkv(*bwd_args, causal=causal)
        bwd_route = launched_route(fa.flash_attention_bwd_dq,
                                   FLASH_BWD_ROUTE_NAMES)
        if launched_route(fa.flash_attention_bwd_dkv,
                          FLASH_BWD_ROUTE_NAMES) != bwd_route:
            raise AssertionError(f"flash dq and dkv took different routes: "
                                 f"{fa.flash_attention_bwd_dkv.routes}")
        rdq, rdk, rdv = fa.flash_attention_bwd_ref(*bwd_args, causal=causal)
        torch.cuda.synchronize()
        o_tol, grad_tol = FLASH_TOL[dt]

        def abs_err(a, b):
            return (a.float() - b.float()).abs().max().item()

        def norm_err(a, b):
            b = b.float()
            return ((a.float() - b).norm() / b.norm()).item()

        grads = {"dq": ((dq, rdq),), "dkv": ((dk, rdk), (dv, rdv))}
        err = {"fwd": abs_err(out, ref),
               **{n: max(abs_err(a, b) for a, b in p)
                  for n, p in grads.items()}}
        rel = {n: max(norm_err(a, b) for a, b in p)
               for n, p in grads.items()}
        of_max = {n: max(abs_err(a, b) / b.float().abs().max().item()
                         for a, b in p) for n, p in grads.items()}
        finite = all(bool(torch.isfinite(t).all())
                     for t in (out, lse, dq, dk, dv))
        case = (f"{label} {dt} {'causal' if causal else 'full'} B={B} "
                f"S={S} H={H} D={D}")
        row = dict(case=case, dtype=dt, causal=causal, route=route,
                   bwd_route=bwd_route, max_abs_err=err, grad_norm_rel_err=rel,
                   grad_err_of_max=of_max, o_tol=o_tol, grad_tol=grad_tol)
        if not (finite and err["fwd"] <= o_tol and rel["dq"] <= grad_tol
                and rel["dkv"] <= grad_tol):
            raise AssertionError(f"flash {case}: errors {err}, normwise "
                                 f"gradient errors {rel}, tolerances "
                                 f"{o_tol} / {grad_tol}, finite={finite}")
        hopper = FLASH_ROUTE_NAMES[3]
        if (label in FLASH_HOPPER_CASES and dt == "bfloat16"
                and (route, bwd_route) != (hopper, hopper)):
            raise AssertionError(f"flash {case}: forward on {route}, "
                                 f"backward on {bwd_route}; expected the "
                                 f"Hopper bodies")
        if route == hopper and causal:
            # the Hopper body's causal skips, launch after launch
            row["graph_launches"], row["graph_mismatches"] = \
                graph_mismatches(torch, lambda: fa.flash_attention_fwd(
                    q, k, v, causal=True), (out, lse))
            if row["graph_mismatches"]:
                raise AssertionError(
                    f"flash {case}: {row['graph_mismatches']} of "
                    f"{row['graph_launches']} forwards in a CUDA graph "
                    f"differ from the eager launch")
        if bwd_route == hopper and causal:
            row["bwd_graph_launches"], row["bwd_graph_mismatches"] = \
                graph_mismatches(torch, lambda: (
                    fa.flash_attention_bwd_dq(*bwd_args, causal=True),
                    *fa.flash_attention_bwd_dkv(*bwd_args, causal=True)),
                    (dq, dk, dv))
            if row["bwd_graph_mismatches"]:
                raise AssertionError(
                    f"flash {case}: {row['bwd_graph_mismatches']} of "
                    f"{row['bwd_graph_launches']} backward calls in a CUDA "
                    f"graph differ from the eager launches")
        del ref, lse_ref, rdq, rdk, rdv, dq, dk, dv, out
        if timed:
            row.update(_time_flash(torch, F, fa, q, k, v, do, lse, delta,
                                   causal, iters))
        rows.append(row)
        log(f"  flash {case} [forward: {route}; backward: {bwd_route}]: "
            f"err {err} normwise {rel} "
            f"of max {of_max} "
            f"(tol {o_tol} / {grad_tol})"
            + ("".join(f" {n} {t:.4f} ms" for n, t in row.items()
                       if n.endswith("_ms")) if timed else ""))
        del qkv, q, k, v, do, lse, delta
        torch.cuda.empty_cache()
    return rows


def _time_flash(torch, F, fa, q, k, v, do, lse, delta, causal, iters):
    """Kernel (a call, and its device time from a CUDA graph), plain and
    library times with the bounds of the three kernels. Operations: the forward's two products, 4 B H S^2 D (half
    when causal); dq recomputes S and dP and forms dQ (3 products, 1.5x),
    dkv recomputes S and dP and forms dK and dV (4 products, 2x); the
    FA-2 count of the backward as a whole is 2.5x. Bytes: each input read
    once, each output written once."""
    B, S, H, D = q.shape
    elt = q.element_size()
    tensor = B * S * H * D * elt
    rows_f32 = B * H * S * 4
    fwd_flops = 4.0 * B * H * S * S * D * (0.5 if causal else 1.0)
    kw = dict(causal=causal)
    bwd = (q, k, v, do, lse, delta)
    slow = max(3, iters // 4)
    res = {
        "fwd_ms": time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                                **kw),
                          iters),
        "dq_ms": time_ms(torch, lambda: fa.flash_attention_bwd_dq(*bwd, **kw),
                         iters),
        "dkv_ms": time_ms(torch, lambda: fa.flash_attention_bwd_dkv(*bwd,
                                                                    **kw),
                          iters),
        "fwd_plain_ms": time_ms(torch, lambda: fa.flash_attention_ref(
            q, k, v, **kw), slow, warmup=1),
        "dq_plain_ms": time_ms(torch, lambda: fa.flash_attention_bwd_dq_ref(
            *bwd, **kw), slow, warmup=1),
        "dkv_plain_ms": time_ms(torch, lambda: fa.flash_attention_bwd_dkv_ref(
            *bwd, **kw), slow, warmup=1)}
    # device time, host work left out: calls in one CUDA graph
    for part in ("fwd", "dq", "dkv"):
        fn = {"fwd": lambda: fa.flash_attention_fwd(q, k, v, **kw),
              "dq": lambda: fa.flash_attention_bwd_dq(*bwd, **kw),
              "dkv": lambda: fa.flash_attention_bwd_dkv(*bwd, **kw)}[part]
        res[f"{part}_dev_ms"] = time_graph_ms(torch, [fn], calls=16, reps=5)
    # yardstick: SDPA on [B, H, S, D] views, forward, and its backward
    # (one autograd call that forms dq, dk and dv together)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    res["fwd_library_ms"] = time_ms(
        torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal),
        iters)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    res["bwd_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), iters)
    for name, nbytes, flops in (
            ("fwd", 4 * tensor + rows_f32, fwd_flops),
            ("dq", 5 * tensor + 2 * rows_f32, 1.5 * fwd_flops),
            ("dkv", 6 * tensor + 2 * rows_f32, 2.0 * fwd_flops),
            ("bwd", 8 * tensor + 2 * rows_f32, 2.5 * fwd_flops)):
        res[f"{name}_bound_ms"], res[f"{name}_bound_by"] = bound(nbytes,
                                                                 flops)
    return res


def _short_mod():
    import importlib

    return importlib.import_module("paddle_tpu_torch.ops.short_attention")


def short_counts():
    sa = _short_mod()
    return {"short_attention_fwd": sa.short_attention_fwd.launches,
            "short_attention_bwd": sa.short_attention_bwd.launches}


def reset_short_counts():
    sa = _short_mod()
    sa.short_attention_fwd.launches = 0
    sa.short_attention_bwd.launches = 0
    zero_routes(sa.short_attention_fwd)
    zero_routes(sa.short_attention_bwd)


SHORT_ROUTE_NAMES = {0: "mma.sync body",
                     3: "Hopper body (TMA + wgmma, dropout drawn inside)"}
SHORT_BWD_ROUTE_NAMES = {
    0: "mma.sync bodies (sa_dq, sa_dkv)",
    1: "Hopper bodies (sa_dq_sm90, sa_dkv_sm90: TMA + wgmma, dropout "
       "replayed inside)"}


def short_route_counts():
    """Forward launches by route name since the counts were set to 0."""
    return {SHORT_ROUTE_NAMES[r]: c
            for r, c in _short_mod().short_attention_fwd.routes.items()}


def short_bwd_route_counts():
    """Backward launches (two a call) by route name since the counts were
    set to 0."""
    return {SHORT_BWD_ROUTE_NAMES[r]: c
            for r, c in _short_mod().short_attention_bwd.routes.items()}


def kernel_keep_share(torch, B, S, H, p, seed, dtype):
    """The forward kernel's own keep bits, read out exactly for every key:
    with q = k = 0 every probability is 1/S, and with V[j, j - c] = 1 for
    the keys j in [c, c + D) the output's (i, d) entry is nonzero exactly
    where (i, c + d) is kept; one call per D keys. In the case's dtype, so
    the bits come from the bodies its forward takes: in bf16 both
    instantiations of the Hopper body, D = 64 (64-key blocks, one keep
    word a draw, two CTAs an SM: BERT's) and D = 128 (128-key blocks, two
    words); in f32 the mma.sync body at D = 256. Returns (kept share of
    each D's readout, bits equal to the plain stream's at every D, the
    routes launched, the widths D)."""
    from paddle_tpu_torch.ops import _dropout_rng

    sa = _short_mod()
    widths = (64, 128) if dtype == torch.bfloat16 else (256,)
    want = _dropout_rng.keep_mask(seed, B, H, S, S, p)
    shares, same, routes = [], True, set()
    for D in widths:
        q = torch.zeros(B, S, H, D, device="cuda", dtype=dtype)
        kept = torch.empty(B, H, S, S, dtype=torch.bool, device="cuda")
        for c in range(0, S, D):
            w = min(D, S - c)
            v = torch.zeros(S, D, device="cuda", dtype=dtype)
            v[c:c + w, :w] = torch.eye(w, device="cuda", dtype=dtype)
            v = v[None, :, None, :].expand(B, S, H, D).contiguous()
            zero_routes(sa.short_attention_fwd)
            out, _ = sa.short_attention_fwd(q, q, v, seed, p)
            routes.add(launched_route(sa.short_attention_fwd,
                                      SHORT_ROUTE_NAMES))
            kept[..., c:c + w] = (out[..., :w] != 0).permute(0, 2, 1, 3)
            del out, v
        shares.append(kept.double().mean().item())
        same = same and bool(torch.equal(kept, want))
        del q, kept
    return shares, same, sorted(routes), widths


def check_short_attention(torch, iters):
    """Forward and backward kernels against the plain versions with the
    same seed, so the same mask. The backward kernels take the forward
    kernel's lse, as on the training path; the plain backward the plain
    forward's. Tolerances as the flash kernels' (FLASH_TOL): O max abs
    error, each gradient's normwise error ||got - ref|| / ||ref||; lse
    max abs error <= 1e-2 (bf16) / 1e-4 (f32). q, k, v are views of one [B, S, 3, H, D]
    tensor, as BERT's fused QKV gives them. For p > 0, the kernel's own
    keep bits (`kernel_keep_share`, on the case's route) against 1 - p
    and against the plain stream. Each case names the forward's and the
    backward's routes; the bf16 bert_base and S=512 cases must take the
    Hopper bodies, forward and backward."""
    import torch.nn.functional as F

    sa = _short_mod()
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for label, B, S, H, D, dt, causal, p in SHORT_CASES:
        dtype = getattr(torch, dt)
        qkv = torch.randn(B, S, 3, H, D, device="cuda", generator=g).to(
            dtype)
        q, k, v = qkv.unbind(2)
        do = torch.randn(B, S, H, D, device="cuda", generator=g).to(dtype)
        seed = torch.randint(0, 2 ** 62, (1,), device="cuda", generator=g)
        zero_routes(sa.short_attention_fwd)
        out, lse = sa.short_attention_fwd(q, k, v, seed, p, causal)
        route = launched_route(sa.short_attention_fwd, SHORT_ROUTE_NAMES)
        if (dt == "bfloat16" and (label.startswith("bert_base")
                                  or label == "S=512")
                and route != SHORT_ROUTE_NAMES[3]):
            raise AssertionError(f"short attention {label}: forward on "
                                 f"{route}, expected the Hopper body")
        ref, lse_ref = sa.short_attention_ref(q, k, v, seed, p, causal)
        zero_routes(sa.short_attention_bwd)
        grads = sa.short_attention_bwd(q, k, v, do, lse, seed, p, causal)
        took = {r: c for r, c in sa.short_attention_bwd.routes.items() if c}
        if list(took.values()) != [2]:
            raise AssertionError(f"short attention {label}: backward "
                                 f"launches {took}, expected two of one "
                                 f"route")
        bwd_route = SHORT_BWD_ROUTE_NAMES[next(iter(took))]
        if (dt == "bfloat16" and (label.startswith("bert_base")
                                  or label == "S=512")
                and bwd_route != SHORT_BWD_ROUTE_NAMES[1]):
            raise AssertionError(f"short attention {label}: backward on "
                                 f"{bwd_route}, expected the Hopper bodies")
        refs = sa.short_attention_bwd_ref(q, k, v, do, lse_ref, seed, p,
                                          causal)
        torch.cuda.synchronize()
        o_tol, grad_tol = FLASH_TOL[dt]
        lse_tol = 1e-2 if dt == "bfloat16" else 1e-4
        err = {"fwd": (out.float() - ref.float()).abs().max().item(),
               "lse": (lse - lse_ref).abs().max().item()}
        rel = {}
        for name, a, b in zip(("dq", "dk", "dv"), grads, refs):
            err[name] = (a.float() - b.float()).abs().max().item()
            rel[name] = ((a.float() - b.float()).norm()
                         / b.float().norm()).item()
        finite = all(bool(torch.isfinite(t).all())
                     for t in (out, lse, *grads))
        case = (f"{label} {dt} {'causal' if causal else 'full'} p={p} "
                f"B={B} S={S} H={H} D={D}")
        row = dict(case=case, dtype=dt, causal=causal, p=p, route=route,
                   bwd_route=bwd_route,
                   max_abs_err=err, grad_norm_rel_err=rel, o_tol=o_tol,
                   lse_tol=lse_tol, grad_tol=grad_tol)
        ok = (finite and err["fwd"] <= o_tol and err["lse"] <= lse_tol
              and max(rel.values()) <= grad_tol)
        if p > 0:
            shares, same, keep_routes, widths = kernel_keep_share(
                torch, B, S, H, p, seed, dtype)
            sigma = (p * (1 - p) / (B * H * S * S)) ** 0.5
            row.update(kept_share=shares[0], kept_shares=shares,
                       kept_widths=widths, kept_expected=1 - p,
                       kept_sigma=sigma, kernel_mask_equals_plain=same,
                       kept_route=keep_routes)
            ok = (ok and same
                  and all(abs(x - (1 - p)) <= 4 * sigma for x in shares)
                  and (dt != "bfloat16"
                       or keep_routes == [SHORT_ROUTE_NAMES[3]]))
        if not ok:
            raise AssertionError(f"short attention {case}: {row}, "
                                 f"finite={finite}")
        del ref, lse_ref, refs, grads, out
        row.update(_time_short(torch, F, sa, q, k, v, do, lse, seed, p,
                               causal, iters))
        rows.append(row)
        log(f"  short attention {case} [forward: {route}; backward: "
            f"{bwd_route}]: err {err} "
            f"normwise {rel}"
            + (f" kept {row['kept_share']:.5f}" if p > 0 else "")
            + "".join(f" {n} {t:.4f}" for n, t in row.items()
                      if n.endswith("_ms")))
        del qkv, q, k, v, do, lse
        torch.cuda.empty_cache()
    return rows


def _time_short(torch, F, sa, q, k, v, do, lse, seed, p, causal, iters):
    """Kernel (a call, and its device time from a CUDA graph), plain and
    library times with the bounds. Operations: the forward's two
    products, 4 B H S^2 D (half when causal); the backward 2.5x that (the
    FA-2 count of what the function needs; the kernels also recompute S
    and dP once more for the row term). Bytes: each input read once, each
    output written once (forward q, k, v, O and lse; backward q, k, v,
    dO, lse, dQ, dK, dV)."""
    B, S, H, D = q.shape
    tensor = B * S * H * D * q.element_size()
    rows_f32 = B * H * S * 4
    fwd_flops = 4.0 * B * H * S * S * D * (0.5 if causal else 1.0)
    slow = max(3, iters // 4)
    res = {
        "fwd_ms": time_ms(torch, lambda: sa.short_attention_fwd(
            q, k, v, seed, p, causal), iters),
        "bwd_ms": time_ms(torch, lambda: sa.short_attention_bwd(
            q, k, v, do, lse, seed, p, causal), iters),
        "fwd_plain_ms": time_ms(torch, lambda: sa.short_attention_ref(
            q, k, v, seed, p, causal), slow, warmup=1),
        "bwd_plain_ms": time_ms(torch, lambda: sa.short_attention_bwd_ref(
            q, k, v, do, lse, seed, p, causal), slow, warmup=1),
        # device time, host work left out: calls in one CUDA graph
        "fwd_dev_ms": time_graph_ms(torch, [lambda: sa.short_attention_fwd(
            q, k, v, seed, p, causal)], calls=16, reps=5),
        "bwd_dev_ms": time_graph_ms(torch, [lambda: sa.short_attention_bwd(
            q, k, v, do, lse, seed, p, causal)], calls=16, reps=5)}
    # yardstick: SDPA with the same dropout on [B, H, S, D] views, forward,
    # and its backward (one autograd call forms dq, dk and dv)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    res["fwd_library_ms"] = time_ms(
        torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, dropout_p=p, is_causal=causal), iters)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, dropout_p=p,
                                             is_causal=causal)
    dot = do.transpose(1, 2)
    res["bwd_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), iters)
    for name, nbytes, flops in (
            ("fwd", 4 * tensor + rows_f32, fwd_flops),
            ("bwd", 7 * tensor + rows_f32, 2.5 * fwd_flops)):
        res[f"{name}_bound_ms"], res[f"{name}_bound_by"] = bound(nbytes,
                                                                 flops)
    res["fwd_bytes"], res["bwd_bytes"] = (4 * tensor + rows_f32,
                                          7 * tensor + rows_f32)
    res["fwd_flops"], res["bwd_flops"] = fwd_flops, 2.5 * fwd_flops
    return res


# ---------------------------------------------------------------------------
# phase 3: end to end
# ---------------------------------------------------------------------------

PROMPT_LENS = (16, 100, 230, 400, 700, 50, 310, 560)


def _prompts(np, vocab, lens):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, (n,)).astype(np.int64) for n in lens]


def time_steps(eng):
    """Time every decode step of `eng` on the host clock (a step ends
    with its tokens on the host, so the device's work is inside): wraps
    the engine's step dispatch; returns the list the times (ms) go to."""
    # the engine is held weakly: no reference cycle keeps it (its pools)
    # alive past its run
    times, ref, dispatch = [], weakref.ref(eng), type(eng)._dispatch_decode

    def timed(active):
        t0 = time.perf_counter()
        out = dispatch(ref(), active)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    eng._dispatch_decode = timed
    return times


def programs(st, step_ms=None):
    """The step programs of an engine's stats: built, whether every one is
    a CUDA graph, replays by kind, and whether the decode programs'
    replays equal the decode steps (and, with speculation on, the propose
    and verify replays, summed over buckets, equal the speculation
    rounds); the isolation rounds and speculation fallbacks, which must
    both be 0: a step program that raises is caught by the engine and its
    sequences re-run as plain bucket-1 steps, whose tokens are plain
    greedy's too, so no token check sees it; with `step_ms`, the mean
    step."""
    by_kind = {}
    for name, p in st["step_programs"].items():
        kind = name.split("-b")[0]
        by_kind[kind] = by_kind.get(kind, 0) + p["replays"]
    sp = st["speculative"]
    equal = by_kind.get("greedy", 0) + by_kind.get("sampled", 0) \
        == st["steps"]
    if sp["enabled"]:
        equal = equal and by_kind.get("verify", 0) \
            == sp["verify_dispatches"] == sp["rounds"] \
            == by_kind.get("propose", 0) \
            == sp["draft_dispatches"] - sp["catchup_chunks"]
    out = {"programs_built": st["compiles"]["built"],
           "all_graphs": all(p["graph"]
                             for p in st["step_programs"].values()),
           "replays": by_kind, "replays_equal_steps": equal,
           "isolation_rounds": st["isolation_rounds"],
           "spec_fallbacks": sp["fallbacks"]}
    if step_ms:
        out["step_ms_mean"] = sum(step_ms) / len(step_ms)
        out["step_ms_median"] = sorted(step_ms)[len(step_ms) // 2]
    return out


def graph_gate(label, res, graphs=True):
    """Fail unless every step of the run was a replay of a CUDA graph
    (`graphs`) or an eager run of its program (not `graphs`)."""
    if res["all_graphs"] != graphs or not res["replays_equal_steps"] \
            or res["isolation_rounds"] or res["spec_fallbacks"]:
        raise AssertionError(f"{label}: step programs {res}, expected "
                             f"every step {'a replay' if graphs else 'eager'}"
                             f" and no isolation round or fallback")


def serve(torch, np, model, quant, lens, new_tokens, label, check_dense,
          eager=False):
    """Serve the prompts of `lens` in two waves; `eager`: on eager steps
    (`_eager_steps`) instead of CUDA graphs. The result holds the tokens
    under "outputs"."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.ops.decode_attn import paged_decode_attention
    from paddle_tpu_torch.ops.weight_only import row_gemv, weight_only_matmul

    prompts = _prompts(np, model.cfg.vocab_size, lens)
    max_length = 4096 if model.cfg.num_layers <= 2 else 1024
    eng = DecodeEngine(model, max_length=max_length, block_size=16,
                       decode_buckets=(1, 2, 4, 8), prefill_chunk=256,
                       quant=quant, default_timeout=600.0,
                       device=model.device, _eager_steps=eager)
    # warm-up, outside the measured window: the step programs (graphs),
    # then one short request
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    eng.generate(prompts[0][:8], 2)
    step_ms = time_steps(eng)
    paged_decode_attention.launches = 0
    zero_routes(paged_decode_attention)
    weight_only_matmul.launches = 0
    zero_routes(weight_only_matmul)
    row_gemv.launches = 0
    zero_routes(row_gemv)
    half = (len(prompts) + 1) // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = [eng.submit(p, new_tokens, keep_logits=2)
               for p in prompts[:half]]
    next(iter(streams[0]))        # wave 1 is running: wave 2 joins it
    streams += [eng.submit(p, new_tokens) for p in prompts[half:]]
    outs = [s.result() for s in streams]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "weight_only_matmul": weight_only_matmul.launches,
                "row_gemv": row_gemv.launches}
    wo_routes = {WO_ROUTE_NAMES[r]: c
                 for r, c in weight_only_matmul.routes.items()}
    paged_routes = {PAGED_ROUTE_NAMES[r]: c
                    for r, c in paged_decode_attention.routes.items()}
    gemv_routes = {ROW_ROUTE_NAMES[r]: c for r, c in row_gemv.routes.items()}
    st = eng.stats()
    ttft = sorted(s.ttft for s in streams)
    res = {"run": label, "tokens": sum(map(len, outs)), "wall_s": wall,
           "tokens_per_s": sum(map(len, outs)) / wall,
           "ttft_p50_s": ttft[len(ttft) // 2],
           "ttft_p95_s": ttft[min(len(ttft) - 1, int(0.95 * len(ttft)))],
           "steps": st["steps"], "prefill_chunks": st["prefill_chunks"],
           "occupancy": st["occupancy"], "launches": launches,
           "weight_only_routes": wo_routes, "paged_routes": paged_routes,
           "gemv_routes": gemv_routes, "warmup_s": warmup_s,
           **programs(st, step_ms)}
    graph_gate(label, res, graphs=not eager)
    if any(len(o) != new_tokens for o in outs) or any(
            not 0 <= t < model.cfg.vocab_size for o in outs for t in o):
        raise AssertionError(f"{label}: malformed token output")
    if check_dense:
        # held: every decode row is row-stable (float Linears through the
        # GEMV), so a sequence decodes the same tokens alone
        solo = [eng.generate(p, new_tokens) for p in prompts]
        res["solo_vs_batched_agree"] = sum(a == b for a, b in zip(solo, outs))
        res["sequences"] = len(outs)
        if res["solo_vs_batched_agree"] != len(outs):
            raise AssertionError(
                f"{label}: {res['solo_vs_batched_agree']} of {len(outs)} "
                f"sequences decode the same tokens alone as in a batch")
    drained = eng.shutdown()
    blocks = eng.stats()["blocks"]
    res["blocks_after_shutdown"] = {k: blocks[k] for k in
                                    ("total", "allocated", "free",
                                     "reserved", "peak_allocated")}
    if not drained or blocks["allocated"] != 0 or \
            blocks["allocated"] + blocks["free"] + blocks["reserved"] \
            != blocks["total"]:
        raise AssertionError(f"{label}: block pool not conserved/drained: "
                             f"{blocks}")
    if check_dense:
        res.update(dense_check(torch, np, model, prompts[0], outs[0][0],
                               streams[0].logits[1]))
    log(f"  e2e {json.dumps(res)}")
    res["outputs"] = outs
    return res


def eager_vs_graphs(torch, np, model, quant, run, new_tokens):
    """The prompts of graph run `run` through eager steps, `new_tokens`
    each: every sequence's tokens must be the graphs' first `new_tokens`
    bit for bit (greedy decoding is causal). Returns both runs' rates."""
    label = f"{run['run']}, eager steps"
    r = serve(torch, np, model, quant, PROMPT_LENS, new_tokens, label,
              check_dense=False, eager=True)
    outs = r.pop("outputs")
    equal = sum(o == g[:new_tokens] for o, g in zip(outs, run["outputs"]))
    res = {"run": label, "sequences_equal": f"{equal}/{len(outs)}",
           "eager_tokens_per_s": r["tokens_per_s"],
           "graphs_tokens_per_s": run["tokens_per_s"],
           "eager_step_ms_mean": r["step_ms_mean"],
           "graphs_step_ms_mean": run["step_ms_mean"],
           "eager_step_ms_median": r["step_ms_median"],
           "graphs_step_ms_median": run["step_ms_median"],
           "device": nvidia_smi_line()}
    log(f"  eager vs graphs {json.dumps(res)}")
    if equal != len(outs):
        raise AssertionError(f"{label}: {equal} of {len(outs)} sequences "
                             f"decode the graphs' tokens")
    return res


def dense_check(torch, np, model, prompt, first_token, eng_logits):
    """The engine's first decode step (paged kernel path, bf16) against a
    dense full-sequence forward of the same position in float32 and in
    bf16. Both bf16 paths carry rounding noise through 32 layers; the
    engine must be no further from the float32 forward than three times
    the bf16 dense forward is (or 2% of the largest |logit|, whichever is
    larger)."""
    import copy

    ids = torch.as_tensor(np.concatenate([prompt, [first_token]]),
                          device=model.device)[None]
    with torch.no_grad():
        dense16 = model(ids)[0, -1].float().cpu()
        ref = copy.deepcopy(model).float()
        dense32 = ref(ids)[0, -1].cpu()
    del ref
    torch.cuda.empty_cache()
    err = (eng_logits - dense32).abs().max().item()
    err16 = (dense16 - dense32).abs().max().item()
    tol = max(3 * err16, 0.02 * dense32.abs().max().item())
    out = {"dense_f32_logits_max_abs_err": err,
           "dense_bf16_vs_f32_max_abs_err": err16, "dense_logits_tol": tol,
           "dense_argmax_equal": int(eng_logits.argmax())
           == int(dense32.argmax())}
    if not (err <= tol and bool(torch.isfinite(eng_logits).all())):
        raise AssertionError(f"engine logits vs dense f32 forward: max abs "
                             f"err {err} > {tol}")
    return out


def profile_decode(torch, np, model, quant, label, steps=12, pool=None):
    """Where a decode step's time goes: 8 sequences of 300 prompt tokens
    are prefilled, then `steps` batched decode steps run under
    torch.profiler. The sequences may grow to max_length 1024 (4096 for a
    model of 2 layers or fewer, `--quick`'s, whose steps are fast enough
    to finish 700 tokens while the profiler starts). The engine's step
    programs are built first (`warmup()`: CUDA graphs, so each step is a
    replay). Reports the host-clock step time, the device-busy time per
    step (the sum of kernel times; the rest is the GPU idling on the
    host: the scheduler's Python, the staging, the token copy) and the
    kernel time by family. With an adapter
    `pool`, the sequences go round-robin over {none, a1..a6} and the odd
    ones are sampled, as in run (d)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import DecodeEngine, SamplingParams

    max_length = 4096 if model.cfg.num_layers <= 2 else 1024
    eng = DecodeEngine(model, max_length=max_length, block_size=16,
                       decode_buckets=(1, 2, 4, 8), prefill_chunk=256,
                       quant=quant, default_timeout=600.0, adapters=pool,
                       device=model.device)
    eng.warmup()
    # no object of an earlier run (a CUDA graph among them) is left for
    # the collector to free inside the profiled window
    gc.collect()

    def opts(i):
        if pool is None:
            return {}
        return {"adapter": None if i % 7 == 0 else f"a{i % 7}",
                "sampling": SamplingParams(**SAMPLED, seed=1000 + i)
                if i % 2 else None}

    # as many new tokens as max_length allows, so that no sequence
    # finishes before the window ends: the engine's thread decodes on
    # while the profiler starts (seconds on some hosts); the rest is
    # cancelled after it
    streams = [eng.submit(p, max_length - 300, **opts(i)) for i, p in
               enumerate(_prompts(np, model.cfg.vocab_size, (300,) * 8))]
    for st in streams:
        next(iter(st))                      # every prompt is prefilled
    give_up = time.perf_counter() + 120.0
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    between_rounds(eng, prof.__enter__)
    try:
        s0 = eng.stats()["steps"]
        t0 = time.perf_counter()
        while eng.stats()["steps"] < s0 + steps:
            if time.perf_counter() > give_up or all(st.done()
                                                    for st in streams):
                raise AssertionError(
                    f"{label}: decode stalled under the profiler: "
                    f"{eng.stats()['steps'] - s0} of {steps} steps, "
                    f"streams {[st.status for st in streams]}, tokens "
                    f"{[len(st.tokens) for st in streams]}")
            time.sleep(0.0005)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st_end = eng.stats()
        done = st_end["steps"] - s0
    finally:
        between_rounds(eng, lambda: prof.__exit__(None, None, None))
    for st in streams:
        st.cancel()
    eng.shutdown()
    fam = kernel_families(prof, (
        ("paged_decode_attention", ("paged_decode", "merge_splits")),
        ("weight_only_matmul", ("wo_gemv", "wo_mma_gemv", "wo_wgmma")),
        ("bgmv", ("bgmv_",)),
        ("library_gemm", GEMM_NAMES)))
    busy_ms = sum(fam.values()) / 1e3 / done
    res = {"run": label, "steps": done, "step_ms": wall * 1e3 / done,
           "graphs": all(p["graph"] for p in st_end["step_programs"]
                         .values()),
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": max(0.0, 1 - busy_ms / (wall * 1e3 / done)),
           "kernel_ms_per_step": {k: v / 1e3 / done for k, v in fam.items()},
           **host_ops(prof, done)}
    log(f"  profile {json.dumps(res)}")
    return res


def between_rounds(eng, fn):
    """Run `fn` on this thread while `eng`'s scheduler waits between two
    rounds, so that no step of it is in flight: the profiler is started
    and stopped so (a graph replay in flight while torch.profiler stopped
    hung the run)."""
    import threading

    held, release = threading.Event(), threading.Event()

    def hold():
        held.set()
        release.wait()

    waiter = threading.Thread(target=eng._on_scheduler, args=(hold,))
    waiter.start()
    if not held.wait(60.0):
        raise AssertionError("the engine's scheduler took no call in 60 s")
    try:
        return fn()
    finally:
        release.set()
        waiter.join()


def host_ops(prof, steps, n=12):
    """The host side of a profiled window: the summed self CPU time of
    every recorded host event (CUDA runtime calls such as
    cudaLaunchKernel; aten ops issued from the engine's scheduler thread
    are not recorded) and the n with the most, as (name, calls per step,
    ms per step)."""
    from torch.autograd import DeviceType

    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)]
    top = sorted(evts, key=lambda e: -e.self_cpu_time_total)[:n]
    return {"host_op_self_ms_per_step": sum(e.self_cpu_time_total
                                            for e in evts) / 1e3 / steps,
            "top_host_ops_ms_per_step": [
                (e.key[:60], e.count / steps,
                 e.self_cpu_time_total / 1e3 / steps) for e in top]}


SYSTEM_LEN = 256
TAIL_LENS = (16, 40, 90, 150, 200, 260, 300)   # + a resubmission of [0]
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)


def _adapter_weights(torch, pool, seed, scale=0.02):
    dev = pool.device
    g = torch.Generator(device=dev).manual_seed(seed)
    return {name: (torch.randn(i, pool.rank, device=dev, generator=g)
                   * scale,
                   torch.randn(pool.rank, o, device=dev, generator=g)
                   * scale)
            for name, (i, o) in sorted(pool.layers.items())}


def _tenant_requests(np, vocab):
    """8 requests over one 256-token system prefix: unique tails of
    16-300 tokens, adapters round-robin over {none, a1..a6}, the odd ones
    sampled (distinct seeds), and an exact resubmission of request 0
    (greedy: a full-prompt hit)."""
    rng = np.random.RandomState(1)
    system = rng.randint(0, vocab, (SYSTEM_LEN,))
    reqs = []
    for i, t in enumerate(TAIL_LENS):
        prompt = np.concatenate([system, rng.randint(0, vocab, (t,))])
        tenant = None if i % 7 == 0 else f"a{i % 7}"
        sampling = dict(SAMPLED, seed=1000 + i) if i % 2 else None
        reqs.append((prompt.astype(np.int64), tenant, sampling))
    reqs.append((reqs[0][0].copy(), reqs[0][1], None))
    return reqs


def _serve_tenants(eng, reqs, new_tokens, stop=None):
    """Request 0 first; once it streams (its prompt's chunk-boundary and
    full-prompt entries are published by then) the other seven together,
    the resubmission of request 0 among them. `stop` = (index, stop
    sequence) gives that sampled request a stop sequence."""
    from paddle_tpu_torch.inference import SamplingParams

    def submit(i):
        prompt, tenant, sampling = reqs[i]
        sp = None
        if sampling is not None:
            extra = {"stop_sequences": [stop[1]]} \
                if stop and stop[0] == i else {}
            sp = SamplingParams(**sampling, **extra)
        return eng.submit(prompt, new_tokens, adapter=tenant, sampling=sp)

    streams = [submit(0)]
    next(iter(streams[0]))
    streams += [submit(i) for i in range(1, len(reqs))]
    return streams, [s.result() for s in streams]


def bucket_invariance(torch, model):
    """Row stability of the plain reductions of a decode step, reported,
    not held: for n in 1, 2, 4, how many of the first n rows of an 8-row
    input keep their bits in a call of n rows — a plain f32 mean and the
    norms' two-stage `_row_mean` of [8, 4096] squares, a softmax,
    PyTorch's cumsum and the sampler's row-grouped cumsum of [8, 32000].
    (The decode step's kernels are held to it in phase 2 and in
    tests/test_torch_cuda.py.)"""
    from paddle_tpu_torch.inference.sampling import _row_cumsum
    from paddle_tpu_torch.nn.functional.norm import _row_mean

    g = torch.Generator(device="cuda").manual_seed(5)
    sq = torch.randn(8, model.cfg.hidden_size, device="cuda",
                     generator=g).square()
    z = torch.randn(8, model.cfg.vocab_size, device="cuda", generator=g)
    p = torch.softmax(z, -1)

    def same(fn, t):
        full, out = fn(t), {}
        for n in (1, 2, 4):
            part = fn(t[:n])
            eq = sum(bool(torch.equal(part[i], full[i])) for i in range(n))
            out[n] = f"{eq}/{n}"
        return out

    return {"rows_equal_in_fewer": {
        "mean_f32": same(lambda t: t.mean(-1), sq),
        "row_mean_f32": same(_row_mean, sq),
        "softmax": same(lambda t: torch.softmax(t, -1), z),
        "cumsum": same(lambda t: torch.cumsum(t, -1), p),
        "sampler_cumsum": same(_row_cumsum, p)}}


def _count_equal(outs, ref, idx):
    return f"{sum(outs[i] == ref[i] for i in idx)}/{len(idx)}"


def multi_tenant(torch, np, model, new_tokens):
    """Run (d): llama2_7b int8 weights + int8 KV serving 8 requests for
    6 LoRA adapters (rank 16, slots 8, qkv_proj and out_proj) through
    BGMV, with the prefix cache sharing a 256-token system prompt
    (prefill_chunk=256 publishes the boundary) and half the requests
    sampled, on the decode buckets (1, 2, 4, 8). The private-copy engine
    (prefix_cache=False) runs the same requests first; with int8 weights
    every decode product is row-stable, so each greedy sequence must match
    it exactly. The private engine runs eager steps (`_eager_steps`) and
    the sharing engine CUDA graphs, so the same gates hold the graphs to
    the eager steps. The sampled request with a stop sequence stops where
    the private run's tokens say it must; a sampled request resubmitted
    alone (bucket 1) reproduces its tokens from the batch (buckets 8 down
    to 2)."""
    from paddle_tpu_torch.inference import (AdapterPool, DecodeEngine,
                                            SamplingParams)
    from paddle_tpu_torch.ops.bgmv import lora_delta
    from paddle_tpu_torch.ops.decode_attn import paged_decode_attention
    from paddle_tpu_torch.ops.weight_only import weight_only_matmul

    pool = AdapterPool(model, rank=16, slots=8, device=model.device)
    for k in range(1, 7):
        pool.load(f"a{k}", _adapter_weights(torch, pool, 100 + k))
    stack_gb = sum(a.numel() + b.numel()
                   for a, b in pool.stacks().values()) * 4 / 1e9
    reqs = _tenant_requests(np, model.cfg.vocab_size)
    geo = dict(max_length=1024, block_size=16, decode_buckets=(1, 2, 4, 8),
               prefill_chunk=256, quant="int8", default_timeout=600.0,
               adapters=pool, device=model.device)
    try:
        with DecodeEngine(model, prefix_cache=False, _eager_steps=True,
                          **geo) as priv:
            priv.warmup()
            priv.generate(reqs[0][0][:8], 2)          # warm-up
            priv_ms = time_steps(priv)
            _, ref = _serve_tenants(priv, reqs, new_tokens)
            priv_progs = programs(priv.stats(), priv_ms)
        # the stop: the first bigram of sampled request 3's private run
        # whose first occurrence is past position 0
        toks = ref[3]
        idx, stop = next((i, tuple(toks[i:i + 2]))
                         for i in range(1, len(toks) - 1)
                         if tuple(toks[i:i + 2]) not in
                         {tuple(toks[j:j + 2]) for j in range(i)})
        eng = DecodeEngine(model, **geo)
        eng.warmup()
        eng.generate(reqs[1][0][:8], 2)               # warm-up
        step_ms = time_steps(eng)
        for w in (lora_delta, paged_decode_attention, weight_only_matmul):
            w.launches = 0
        zero_routes(lora_delta)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams, outs = _serve_tenants(eng, reqs, new_tokens,
                                       stop=(3, stop))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bgmv_routes = {BGMV_ROUTE_NAMES[r]: c
                       for r, c in lora_delta.routes.items()}
        launches = {"lora_delta": lora_delta.launches,
                    "paged_decode_attention": paged_decode_attention.launches,
                    "weight_only_matmul": weight_only_matmul.launches}
        st = eng.stats()
        progs = programs(st, step_ms)
        quiesced = st["blocks"]["allocated"] \
            - st["prefix_cache"]["physical_blocks"]
        prompt, tenant, sampling = reqs[5]
        alone = eng.generate(prompt, new_tokens, adapter=tenant,
                             sampling=SamplingParams(**sampling))
        drained = eng.shutdown()
        blocks = eng.stats()["blocks"]
        refs = pool.stats()["refs"]
    finally:
        pool.detach()
    greedy = [i for i, r in enumerate(reqs) if r[2] is None]
    sampled = [i for i, r in enumerate(reqs) if r[2] is not None and i != 3]
    ttft = sorted(s.ttft for s in streams)
    pc = st["prefix_cache"]
    res = {"run": "d: multi-tenant, int8 weights + KV, 6 adapters",
           "requests": len(reqs), "tokens": sum(map(len, outs)),
           "wall_s": wall, "tokens_per_s": sum(map(len, outs)) / wall,
           "ttft_p50_s": ttft[len(ttft) // 2],
           "ttft_p95_s": ttft[min(len(ttft) - 1, int(0.95 * len(ttft)))],
           "steps": st["steps"], "prefill_chunks": st["prefill_chunks"],
           "occupancy": st["occupancy"], "launches": launches,
           "bgmv_routes": bgmv_routes, "adapter_stacks_gb": stack_gb,
           "prefix_hits": pc["hits"], "prefix_full_hits": pc["full_hits"],
           "prefix_hit_rate": st["prefix_hit_rate"],
           "tokens_reused": pc["tokens_reused"],
           "cow_copies": st["cow_copies"],
           "greedy_equal_private": _count_equal(outs, ref, greedy),
           "sampled_equal_private": _count_equal(outs, ref, sampled),
           "stop_truncated_at": idx, "stop_hits": st["stop_hits"],
           "sampled_alone_equal": alone == outs[5],
           "adapter_refs_after": refs, "quiesced_extra_blocks": quiesced,
           **progs, "private_eager": priv_progs,
           **bucket_invariance(torch, model),
           "blocks_after_shutdown": {k: blocks[k] for k in (
               "total", "allocated", "free", "reserved", "allocs",
               "frees")}}
    log(f"  e2e {json.dumps(res)}")
    graph_gate("run (d)", progs)
    graph_gate("run (d), private", priv_progs, graphs=False)
    fails = []
    if launches["lora_delta"] == 0:
        fails.append("lora_delta never launched")
    # the engine's prefill passes a scalar id (no kernel): every launch is
    # a batched decode step (s = 1), on the cluster body
    if bgmv_routes[BGMV_ROUTE_NAMES[1]] != launches["lora_delta"]:
        fails.append(f"bgmv launches by body {bgmv_routes}: expected all "
                     f"{launches['lora_delta']} on the cluster body")
    if pc["hits"] < 1 or pc["full_hits"] < 1 or st["cow_copies"] < 1:
        fails.append(f"prefix cache: hits {pc['hits']}, full hits "
                     f"{pc['full_hits']}, cow copies {st['cow_copies']}")
    if any(outs[i] != ref[i] for i in greedy):
        fails.append(f"greedy tokens differ from the private engine: "
                     f"{res['greedy_equal_private']} equal")
    if outs[3] != ref[3][:idx]:
        fails.append(f"stop sequence {stop}: got {outs[3]}, expected "
                     f"{ref[3][:idx]}")
    if alone != outs[5]:
        fails.append("sampled request resubmitted alone differs")
    if refs != 0 or quiesced != 0 or not drained \
            or blocks["allocated"] != 0 or blocks["allocs"] != blocks["frees"]:
        fails.append(f"conservation: adapter refs {refs}, quiesced extra "
                     f"blocks {quiesced}, blocks {blocks}")
    if any(len(o) != new_tokens for i, o in enumerate(outs) if i != 3) \
            or any(not 0 <= t < model.cfg.vocab_size for o in outs
                   for t in o):
        fails.append("malformed token output")
    if fails:
        raise AssertionError(f"run (d): {'; '.join(fails)}")
    return res


SPEC_K = 4
DRAFT_LAYERS = 4


def _draft_of(torch, model, layers):
    """A llama2_7b-width draft of `layers` layers holding copies of the
    target's embeddings, first `layers` blocks, final norm and head."""
    from paddle_tpu_torch.models import gpt

    draft = gpt("llama2_7b", dtype="bfloat16", device="cuda", seed=1,
                num_layers=layers)
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in draft.named_parameters():
            p.copy_(own[name])
    return draft


def speculative(torch, np, model, run_a, new_tokens):
    """Run (e): run (a)'s prompts through speculative decoding (K = 4) on
    run (a)'s bf16 model and pool, once drafted by the target itself and
    once by a 4-layer draft of its first blocks, each with the launch
    counts set to 0 before and read after. Gates: every propose and
    verify step (and every plain step) a graph replay; every sequence's
    tokens equal to run (a)'s plain greedy tokens; proposed == accepted +
    rejected; the self-draft accepts every proposal; both pools drained
    and conserved after shutdown."""
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.ops.decode_attn import paged_decode_attention
    from paddle_tpu_torch.ops.weight_only import row_gemv

    prompts = _prompts(np, model.cfg.vocab_size, PROMPT_LENS)
    max_length = 4096 if model.cfg.num_layers <= 2 else 1024
    out = []
    for name in ("self", "draft"):
        draft = model if name == "self" else _draft_of(
            torch, model, min(DRAFT_LAYERS, model.cfg.num_layers))
        eng = DecodeEngine(model, max_length=max_length, block_size=16,
                           decode_buckets=(1, 2, 4, 8), prefill_chunk=256,
                           default_timeout=600.0, draft_model=draft,
                           speculate_k=SPEC_K, device=model.device)
        t0 = time.perf_counter()
        eng.warmup()
        warmup_s = time.perf_counter() - t0
        eng.generate(prompts[0][:8], 2)
        step_ms = time_steps(eng)
        for w in (paged_decode_attention, row_gemv):
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = [eng.submit(p, new_tokens) for p in prompts]
        outs = [s.result() for s in streams]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"paged_decode_attention": paged_decode_attention.launches,
                    "row_gemv": row_gemv.launches}
        st = eng.stats()
        drained = eng.shutdown()
        after = eng.stats()
        sp = st["speculative"]
        equal = sum(o == r for o, r in zip(outs, run_a["outputs"]))
        res = {"run": f"e: speculative, K = {SPEC_K}, draft = "
                      f"{'the target' if name == 'self' else f'{DRAFT_LAYERS} layers'}",
               "tokens": sum(map(len, outs)), "wall_s": wall,
               "tokens_per_s": sum(map(len, outs)) / wall,
               "plain_tokens_per_s": run_a["tokens_per_s"],
               "warmup_s": warmup_s, "launches": launches,
               "equal_plain_greedy": f"{equal}/{len(outs)}",
               "acceptance_rate": sp["acceptance_rate"],
               # a verify dispatch serves every ready sequence; a
               # sequence's round commits accepted + 1 tokens at most
               "committed_per_sequence_round":
                   sp["committed"] * SPEC_K / max(1, sp["proposed"]),
               "committed_per_verify_dispatch": sp["accepted_per_dispatch"],
               **{k: sp[k] for k in ("rounds", "proposed", "accepted",
                                     "rejected", "bonus", "committed",
                                     "verify_dispatches", "catchup_chunks",
                                     "fallbacks")},
               "plain_steps": st["steps"], **programs(st, step_ms),
               "blocks_after_shutdown": after["blocks"]["allocated"],
               "draft_blocks_after_shutdown":
                   after["draft_blocks"]["allocated"]}
        log(f"  e2e {json.dumps(res)}")
        graph_gate(res["run"], res)
        fails = []
        if equal != len(outs):
            fails.append(f"{equal} of {len(outs)} sequences equal run "
                         f"(a)'s greedy tokens")
        if sp["proposed"] != sp["accepted"] + sp["rejected"] \
                or sp["proposed"] == 0:
            fails.append(f"counters {sp}")
        if name == "self" and sp["acceptance_rate"] != 1.0:
            fails.append(f"self-draft acceptance {sp['acceptance_rate']}")
        for key in ("blocks", "draft_blocks"):
            b = after[key]
            if b["allocated"] != 0 or b["allocated"] + b["free"] \
                    + b["reserved"] != b["total"]:
                fails.append(f"{key} not conserved or drained: {b}")
        if not drained or min(launches.values()) == 0:
            fails.append(f"drained {drained}, launches {launches}")
        if fails:
            raise AssertionError(f"{res['run']}: {'; '.join(fails)}")
        out.append(res)
        del draft, eng
    return out


def end_to_end(torch, np, layers, new_tokens):
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn.quant import quantize_for_inference

    def build():
        torch.cuda.empty_cache()
        return gpt("llama2_7b", dtype="bfloat16", device="cuda", seed=0,
                   num_layers=layers)

    runs, eager = [], []
    model = build()
    r = serve(torch, np, model, None, PROMPT_LENS, new_tokens,
              "a: bf16 weights, bf16 KV", check_dense=True)
    if r["launches"]["paged_decode_attention"] == 0 \
            or r["launches"]["row_gemv"] == 0:
        raise AssertionError(f"run a: a kernel never launched: "
                             f"{r['launches']}")
    # every float Linear of the bf16 decode steps on the tensor-core body
    if r["gemv_routes"][ROW_ROUTE_NAMES[1]] != r["launches"]["row_gemv"]:
        raise AssertionError(f"run a: row_gemv launches by body "
                             f"{r['gemv_routes']}, expected all on "
                             f"{ROW_ROUTE_NAMES[1]}")
    runs.append(r)
    eager.append(eager_vs_graphs(torch, np, model, None, r,
                                 new_tokens // 2))
    spec = speculative(torch, np, model, r, new_tokens)
    quantize_for_inference(model, "int8")
    torch.cuda.empty_cache()
    r = serve(torch, np, model, "int8", PROMPT_LENS, new_tokens,
              "b: int8 weights, int8 KV", check_dense=False)
    runs.append(r)
    eager.append(eager_vs_graphs(torch, np, model, "int8", r,
                                 new_tokens // 2))
    # one profiler session per process: a second one in the same process
    # recorded no device activity on the card
    profiles = [profile_decode(torch, np, model, "int8",
                               "b: int8 + int8 KV, bs 8")]
    runs.append(multi_tenant(torch, np, model, new_tokens))
    del model
    model = build()
    quantize_for_inference(model, "int4")
    torch.cuda.empty_cache()
    r = serve(torch, np, model, "int8", PROMPT_LENS[:4], new_tokens // 2,
              "c: int4 weights, int8 KV, one wave", check_dense=False)
    runs.append(r)
    del model
    for r in runs:
        r.pop("outputs", None)
    for r in runs[1:]:
        if min(v for k, v in r["launches"].items() if k != "row_gemv") == 0:
            raise AssertionError(f"{r['run']}: a kernel never launched: "
                                 f"{r['launches']}")
    for r in (r for r in runs if "paged_routes" in r):
        # llama2_7b's bf16 and int8 pools (D = 128) are the ring body's
        if r["paged_routes"][PAGED_ROUTE_NAMES[1]] \
                != r["launches"]["paged_decode_attention"]:
            raise AssertionError(f"{r['run']}: paged launches "
                                 f"{r['paged_routes']}, expected all "
                                 f"{r['launches']['paged_decode_attention']}"
                                 f" on the ring body")
    return runs, profiles, eager, spec


# ---------------------------------------------------------------------------
# phase 4: training end to end
# ---------------------------------------------------------------------------

def _train_engine(torch, layers):
    """gpt_base at full width (f32 masters from seed 0), AdamW lr 1e-4 with
    ClipGradByGlobalNorm(1.0), bf16 compute: the JAX package's pretrain
    configuration (bench.py's gpt row)."""
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.empty_cache()
    model = gpt("gpt_base", dtype="float32", device="cuda", seed=0,
                num_layers=layers)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    return model, parallelize(model, opt, compute_dtype="bfloat16")


def _train_batch(torch, vocab, batch, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (batch, TRAIN_SEQ), generator=g).cuda()


def _run_steps(torch, eng, ids, steps):
    losses, norms = [], []
    for _ in range(steps):
        losses.append(eng.train_batch(ids))
        norms.append(eng.last_grad_norm)
    return (torch.stack(losses).float().cpu().tolist(),
            torch.stack(norms).float().cpu().tolist())


def train_throughput(torch, layers, steps, seed):
    """20 steps on one fixed [16, 1024] batch after 2 warm-up steps; the
    flash launch counts (each wrapper's by route too) are set to 0 just
    before and read just after, and every forward, dQ and dK/dV launch
    must have been on its Hopper body."""
    import math

    from paddle_tpu_torch.models import flops_per_token

    model, eng = _train_engine(torch, layers)
    ids = _train_batch(torch, model.cfg.vocab_size, TRAIN_BATCH, seed)
    _run_steps(torch, eng, ids, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    t0 = time.perf_counter()
    losses, norms = _run_steps(torch, eng, ids, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_counts()
    routes = flash_route_counts()
    tokens = TRAIN_BATCH * TRAIN_SEQ * steps
    fpt = flops_per_token(model.cfg, TRAIN_SEQ)
    res = {"layers": layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": steps, "step_ms": wall * 1e3 / steps,
           "tokens_per_s": tokens / wall,
           "mfu": tokens / wall * fpt / BF16_FLOPS,
           "ideal_step_ms": TRAIN_BATCH * TRAIN_SEQ * fpt / BF16_FLOPS * 1e3,
           "flops_per_token": fpt, "losses": losses, "grad_norms": norms,
           "launches": launches, "routes": routes,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  train {json.dumps(res)}")
    per_run = layers * steps
    if any(n != per_run for n in launches.values()):
        raise AssertionError(f"flash launches {launches}, expected "
                             f"{per_run} each ({layers} layers x {steps} "
                             f"steps)")
    if any(r[FLASH_ROUTE_NAMES[3]] != per_run for r in routes.values()):
        raise AssertionError(f"flash routes {routes}: expected all "
                             f"{per_run} launches of each kernel on its "
                             f"Hopper body")
    if not all(math.isfinite(x) for x in losses + norms) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not progress: losses {losses}")
    del model, eng
    return res


def train_parity(torch, layers, seed, steps=5, batch=4):
    """The same weights and batch through the flash kernels and through
    the plain attention (for the plain run, the routing predicate in
    `nn.functional.attention` is patched to admit no shape): loss within
    1e-2 and pre-clip grad norm within 5e-2, relative."""
    from paddle_tpu_torch.nn.functional import attention

    supported = attention.flash_attention_supported
    runs = {}
    for route in ("kernels", "plain"):
        if route == "plain":
            attention.flash_attention_supported = lambda shape, causal: False
        try:
            model, eng = _train_engine(torch, layers)
            ids = _train_batch(torch, model.cfg.vocab_size, batch, seed + 1)
            reset_flash_counts()
            losses, norms = _run_steps(torch, eng, ids, steps)
            runs[route] = {"losses": losses, "grad_norms": norms,
                           "launches": flash_counts()}
        finally:
            attention.flash_attention_supported = supported
        del model, eng
    k, p = runs["kernels"], runs["plain"]
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(k["losses"], p["losses"]))
    norm_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(k["grad_norms"], p["grad_norms"]))
    res = {"batch": batch, "steps": steps, "runs": runs,
           "loss_max_rel_err": loss_rel, "grad_norm_max_rel_err": norm_rel}
    log(f"  parity {json.dumps(res)}")
    if not (loss_rel <= 1e-2 and norm_rel <= 5e-2):
        raise AssertionError(f"kernel vs plain training: loss rel err "
                             f"{loss_rel} (tol 1e-2), grad norm rel err "
                             f"{norm_rel} (tol 5e-2)")
    if min(k["launches"].values()) == 0 or any(p["launches"].values()):
        raise AssertionError(f"routing: kernel run {k['launches']}, plain "
                             f"run {p['launches']}")
    return res


def profile_train(torch, layers, seed, steps=3):
    """Profile `steps` training steps (after 2 warm-up steps) under
    torch.profiler; device-busy share and kernel time by family. Runs in
    a child process of its own (`--profile-train`): only a process's first
    profiler session recorded device kernels on the card."""
    from torch.profiler import ProfilerActivity, profile

    model, eng = _train_engine(torch, layers)
    ids = _train_batch(torch, model.cfg.vocab_size, TRAIN_BATCH, seed)
    _run_steps(torch, eng, ids, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _run_steps(torch, eng, ids, steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = kernel_families(prof, (
        ("flash", ("flash_fwd", "flash_dq", "flash_dkv")),
        ("gemm", GEMM_NAMES),
        ("optimizer", ("foreach", "multi_tensor"))))
    busy_ms = sum(fam.values()) / 1e3
    return {"layers": layers, "steps": steps, "step_ms": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_busy_share": busy_ms / wall_ms,
            "kernel_ms_per_step": {k: v / 1e3 / steps
                                   for k, v in fam.items()},
            "top_kernels_ms_per_step": top_kernels(prof, steps)}


def profile_tenants(torch, np, layers):
    """Run (d)'s decode step under torch.profiler, in a child process of
    its own (`--profile-tenants`; one profiler session per process): the
    int8 llama2_7b of run (b) with run (d)'s six adapters."""
    from paddle_tpu_torch.inference import AdapterPool
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn.quant import quantize_for_inference

    model = gpt("llama2_7b", dtype="bfloat16", device="cuda", seed=0,
                num_layers=layers)
    quantize_for_inference(model, "int8")
    torch.cuda.empty_cache()
    pool = AdapterPool(model, rank=16, slots=8, device=model.device)
    for k in range(1, 7):
        pool.load(f"a{k}", _adapter_weights(torch, pool, 100 + k))
    return profile_decode(torch, np, model, "int8",
                          "d: 6 adapters, half sampled, bs 8", pool=pool)


def run_child(flag, layers, seed, report, *extra):
    """Run one `--profile-*` phase in a child process (`extra`: more of
    its arguments); returns its result."""
    path = f"{report}.{flag.strip('-')}.json"
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), flag, path,
         "--layers", str(layers), "--seed", str(seed), *extra],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{flag} child failed:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(path) as f:
        res = json.load(f)
    os.remove(path)
    return res


def profile_train_child(torch, layers, seed, report):
    """Run `profile_train` in a child process; returns its result."""
    res = run_child("--profile-train", layers, seed, report)
    log(f"  train profile {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# phase 5: BERT fine-tuning end to end
# ---------------------------------------------------------------------------

def _bert_engine(torch, layers, gseed=0, compute_dtype="bfloat16"):
    """bert_base at full width (f32 masters from seed 0, dropout 0.1 from
    a CUDA generator seeded `gseed`), 2-class head, AdamW lr 2e-5, bf16
    compute, bench.py's loss_fn: the JAX package's fine-tune row
    (bench.py:283-341). `compute_dtype=None` computes in f32."""
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.models import bert_for_sequence_classification
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(gseed)
    model = bert_for_sequence_classification(
        "bert_base", device="cuda", seed=0, generator=gen, num_labels=2,
        num_hidden_layers=layers)
    opt = AdamW(learning_rate=2e-5, parameters=model.parameters())

    def loss_fn(m, ids, labels):
        return TF.cross_entropy(m(ids), labels).mean()

    return model, parallelize(model, opt, loss_fn=loss_fn,
                              compute_dtype=compute_dtype)


def _bert_batch(torch, np, vocab, seed):
    """One fixed batch as bench.py makes it: ids and 2-class labels from
    numpy's RandomState(seed)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (BERT_BATCH, BERT_SEQ)).astype("int32")
    labels = rng.randint(0, 2, (BERT_BATCH,)).astype("int64")
    return (torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda())


def _bert_steps(torch, eng, batch, steps):
    losses, norms = [], []
    for _ in range(steps):
        losses.append(eng.train_batch(*batch))
        norms.append(eng.last_grad_norm)
    return (torch.stack(losses).float().cpu().tolist(),
            torch.stack(norms).float().cpu().tolist())


def bert_throughput(torch, np, layers, steps, seed):
    """20 steps on one fixed [128, 128] batch after 2 warm-up steps; the
    short-attention and flash launch counts (the short forward's and
    backward's by route too) are set to 0 just before and read just after:
    every forward must have launched the Hopper body and every backward
    launch (dQ, dK/dV) the Hopper bodies. MFU counts bench.py's
    matmul-bearing parameters."""
    import math

    from paddle_tpu_torch.models.bert import n_matmul_params

    model, eng = _bert_engine(torch, layers)
    batch = _bert_batch(torch, np, model.cfg.vocab_size, seed)
    _bert_steps(torch, eng, batch, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_short_counts()
    reset_flash_counts()
    t0 = time.perf_counter()
    losses, norms = _bert_steps(torch, eng, batch, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**short_counts(), **flash_counts()}
    fwd_routes = short_route_counts()
    bwd_routes = short_bwd_route_counts()
    n_matmul = n_matmul_params(model.cfg)
    seqs = BERT_BATCH * steps / wall
    res = {"layers": layers, "batch": BERT_BATCH, "seq": BERT_SEQ,
           "steps": steps, "step_ms": wall * 1e3 / steps,
           "sequences_per_s": seqs, "tokens_per_s": seqs * BERT_SEQ,
           "n_matmul": n_matmul,
           "mfu": seqs * 6.0 * n_matmul * BERT_SEQ / BF16_FLOPS,
           "losses": losses, "grad_norms": norms, "launches": launches,
           "fwd_routes": fwd_routes, "bwd_routes": bwd_routes,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  bert train {json.dumps(res)}")
    per_run = layers * steps
    if (launches["short_attention_fwd"] != per_run
            or launches["short_attention_bwd"] != 2 * per_run
            or any(launches[k] for k in flash_counts())):
        raise AssertionError(f"launches {launches}, expected {per_run} "
                             f"short-attention forward and {2 * per_run} "
                             f"backward launches ({layers} layers x {steps} "
                             f"steps) and no flash launch")
    if fwd_routes[SHORT_ROUTE_NAMES[3]] != per_run:
        raise AssertionError(f"short-attention forward routes {fwd_routes}:"
                             f" expected all {per_run} on the Hopper body")
    if bwd_routes[SHORT_BWD_ROUTE_NAMES[1]] != 2 * per_run:
        raise AssertionError(f"short-attention backward routes "
                             f"{bwd_routes}: expected all {2 * per_run} on "
                             f"the Hopper bodies")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"BERT training not finite: losses {losses}")
    del model, eng
    return res


# (loss, grad norm) relative gates of the kernel-vs-plain BERT parity, by
# compute dtype
BERT_PARITY_TOL = {"bfloat16": (1e-2, 5e-2), "float32": (1e-4, 1e-3)}


def _bert_route_run(torch, np, layers, seed, steps, compute_dtype, route):
    """`steps` steps of the parity's weights, batch and generator seed on
    one attention route: "kernels"; "plain", the composed route (the
    routing predicate in `nn.functional.attention` admits no shape; the
    mask is the same stream's); or "mask dropped", a planted fault: the
    kernels called with p = 0, so neither the keep mask nor the 1/(1-p)
    scale reaches them. Returns the run, the model and its engine."""
    from paddle_tpu_torch.nn.functional import attention

    supported, kernel = (attention.short_attention_supported,
                         attention.short_attention)
    if route == "plain":
        attention.short_attention_supported = lambda *a: False
    elif route == "mask dropped":
        attention.short_attention = (
            lambda q, k, v, seed_, p, causal: kernel(q, k, v, seed_, 0.0,
                                                     causal))
    try:
        model, eng = _bert_engine(torch, layers, gseed=seed + 1,
                                  compute_dtype=compute_dtype)
        batch = _bert_batch(torch, np, model.cfg.vocab_size, seed)
        reset_short_counts()
        losses, norms = _bert_steps(torch, eng, batch, steps)
    finally:
        attention.short_attention_supported = supported
        attention.short_attention = kernel
    return ({"losses": losses, "grad_norms": norms,
             "launches": short_counts()}, model, eng, batch)


def _rel_gaps(a, b):
    return (max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                    b["losses"])),
            max(abs(x - y) / abs(y) for x, y in zip(a["grad_norms"],
                                                    b["grad_norms"])))


def bert_parity(torch, np, layers, seed, steps=3):
    """The same weights, batch and dropout generator seed through the
    short-attention kernels and through the plain composed route, in bf16
    compute and in f32 compute: loss and grad norm within
    BERT_PARITY_TOL, relative. A second bf16 kernel run must equal the
    first bit for bit. The planted fault ("mask dropped") must break the
    f32 gates, which shows they see the dropout inside the kernels; what
    it reads against the bf16 gates is recorded. Then one `eval_batch` in
    eval mode (dropout off), which takes the flash forward: one launch a
    layer."""
    import math

    res = {"batch": BERT_BATCH, "steps": steps, "tol": BERT_PARITY_TOL}
    failures = []
    for dt, cd in (("bfloat16", "bfloat16"), ("float32", None)):
        routes = (("kernels", "kernels again", "plain", "mask dropped")
                  if dt == "bfloat16" else
                  ("kernels", "plain", "mask dropped"))
        runs = {}
        for route in routes:
            runs[route], model, eng, batch = _bert_route_run(
                torch, np, layers, seed, steps, cd, route)
            if dt == "bfloat16" and route == "kernels":
                model.eval()
                reset_flash_counts()
                reset_short_counts()
                eval_loss = float(eng.eval_batch(*batch))
                eval_launches = {**flash_counts(), **short_counts()}
                res.update(eval_loss=eval_loss, eval_launches=eval_launches)
            del model, eng
        loss_tol, norm_tol = BERT_PARITY_TOL[dt]
        k, p = runs["kernels"], runs["plain"]
        loss_rel, norm_rel = _rel_gaps(k, p)
        fault_loss, fault_norm = _rel_gaps(runs["mask dropped"], p)
        row = {"runs": runs, "loss_max_rel_err": loss_rel,
               "grad_norm_max_rel_err": norm_rel,
               "mask_dropped_loss_rel_err": fault_loss,
               "mask_dropped_grad_norm_rel_err": fault_norm,
               "mask_dropped_caught": (fault_loss > loss_tol
                                       or fault_norm > norm_tol)}
        if not (loss_rel <= loss_tol and norm_rel <= norm_tol):
            failures.append(f"{dt}: loss rel err {loss_rel} (tol "
                            f"{loss_tol}), grad norm rel err {norm_rel} "
                            f"(tol {norm_tol})")
        if dt == "bfloat16":
            row["rerun_bitwise_equal"] = (
                k["losses"] == runs["kernels again"]["losses"]
                and k["grad_norms"] == runs["kernels again"]["grad_norms"])
            if not row["rerun_bitwise_equal"]:
                failures.append("bf16 kernel rerun not bit-equal")
        elif not row["mask_dropped_caught"]:
            failures.append(f"f32 gates miss the planted fault: loss "
                            f"{fault_loss}, grad norm {fault_norm}")
        if (min(k["launches"].values()) == 0
                or any(p["launches"].values())):
            failures.append(f"{dt} routing: kernel run {k['launches']}, "
                            f"plain run {p['launches']}")
        res[dt] = row
    log(f"  bert parity {json.dumps(res)}")
    if failures:
        raise AssertionError("BERT kernel vs plain: " + "; ".join(failures))
    if (res["eval_launches"]["flash_attention_fwd"] != layers
            or res["eval_launches"]["short_attention_fwd"]
            or not math.isfinite(res["eval_loss"])):
        raise AssertionError(f"eval_batch: launches {res['eval_launches']},"
                             f" loss {res['eval_loss']}")
    return res


def profile_bert(torch, np, layers, seed, steps=3):
    """Profile `steps` BERT fine-tune steps (after 2 warm-up steps) under
    torch.profiler, in a child process of its own (`--profile-bert`):
    device-busy share and kernel time by family."""
    from torch.profiler import ProfilerActivity, profile

    model, eng = _bert_engine(torch, layers)
    batch = _bert_batch(torch, np, model.cfg.vocab_size, seed)
    _bert_steps(torch, eng, batch, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _bert_steps(torch, eng, batch, steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = kernel_families(prof, (
        ("short_attention", ("sa_fwd", "sa_dq", "sa_dkv")),
        ("gemm", GEMM_NAMES),
        ("optimizer", ("foreach", "multi_tensor")),
        ("elementwise", ("elementwise",))))
    busy_ms = sum(fam.values()) / 1e3
    launches = sum(e.count for e in device_events(prof))
    return {"layers": layers, "steps": steps, "step_ms": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_busy_share": busy_ms / wall_ms,
            "device_launches_per_step": launches / steps,
            "kernel_ms_per_step": {k: v / 1e3 / steps
                                   for k, v in fam.items()},
            "top_kernels_ms_per_step": top_kernels(prof, steps)}


# ---------------------------------------------------------------------------
# phase 2 (continued) and phase 6: ResNet-50 training
# ---------------------------------------------------------------------------

# ResNet-50's stride-1 identity bottleneck blocks at N = 128: (stage, H = W,
# C, blocks of the stage that take the fused route a step)
RESNET_STAGES = (("layer1", 56, 64, 2), ("layer2", 28, 128, 3),
                 ("layer3", 14, 256, 5), ("layer4", 7, 512, 2))
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 128, 224, 1000


def _rb_mod():
    import importlib

    return importlib.import_module("paddle_tpu_torch.ops.fused_resblock")


def resblock_counts(what="launches"):
    """The fused families' kernel launches (or, with "calls", calls)."""
    rb = _rb_mod()
    return {"fused_bottleneck_fwd": getattr(rb.fused_bottleneck_fwd, what),
            "fused_bottleneck_bwd": getattr(rb.fused_bottleneck_bwd, what)}


def resblock_routes(wrapper):
    """A fused family's launches by body, by name (`ROUTE_NAMES`)."""
    names = _rb_mod().ROUTE_NAMES
    return {names[r]: c for r, c in wrapper.routes.items()}


def reset_resblock_counts():
    rb = _rb_mod()
    for f in (rb.fused_bottleneck_fwd, rb.fused_bottleneck_bwd):
        f.launches = f.calls = 0
        if hasattr(f, "routes"):     # not a plain version patched in
            zero_routes(f)


def fwd_routes_expected(calls):
    """The forward's launches by body for `calls` calls: F1, F3 and F4 on
    rb_wg, F2 on rb_wg_conv (the Hopper bodies), relu(bn2(r2)) formed once
    a call, three BN reductions a call; nothing else."""
    rb = _rb_mod()
    want = dict.fromkeys(rb.ROUTE_NAMES, 0)
    want.update({rb.ROUTE_ROWS: 3 * calls, rb.ROUTE_CONV: calls,
                 rb.ROUTE_FORM: calls, rb.ROUTE_REDUCE: 3 * calls})
    return {rb.ROUTE_NAMES[r]: c for r, c in want.items()}


def _block_inputs(torch, N, H, C, g):
    """x, w1 [4C, C], w2 [3, 3, C, C], w3 [C, 4C] (He-scaled), the BN
    vectors near 1 / 0, and dy: bf16 activations on the card."""
    C4 = 4 * C
    x = torch.randn(N, H, H, C4, device="cuda", generator=g).to(
        torch.bfloat16)
    ws = [torch.randn(*s, device="cuda", generator=g) * (2.0 / fan) ** 0.5
          for s, fan in (((C4, C), C4), ((3, 3, C, C), 9 * C),
                         ((C, C4), C))]
    vecs = [1.0 + 0.1 * torch.randn(c, device="cuda", generator=g)
            if i % 2 == 0 else 0.1 * torch.randn(c, device="cuda",
                                                 generator=g)
            for i, c in enumerate((C, C, C, C, C4, C4))]
    dy = torch.randn(N, H, H, C4, device="cuda", generator=g).to(
        torch.bfloat16)
    return [x, *ws, *vecs], dy


def _normwise(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _per_op_block(torch, args, C):
    """The per-op route of a block with the kernels' weights (args from
    `_block_inputs`): a BottleneckBlock in mode "0", NHWC through
    channels-last views, f32 masters and buffers, and bf16 copies of its
    parameters for functional_call, as the engine runs it."""
    from paddle_tpu_torch.models.resnet import BottleneckBlock

    blk = BottleneckBlock(4 * C, C, data_format="NHWC", device="cuda")
    with torch.no_grad():
        blk.conv1.weight.copy_(args[1].t()[:, :, None, None])
        blk.conv2.weight.copy_(args[2].permute(3, 2, 0, 1))
        blk.conv3.weight.copy_(args[3].t()[:, :, None, None])
    params = {n: p.detach().to(torch.bfloat16).requires_grad_()
              for n, p in blk.named_parameters()}
    return blk, params


def check_fused_resblock(torch, iters):
    """The fused bottleneck kernels against their plain versions at the
    four ResNet-50 stage shapes (N = 128, bf16), and timed beside the
    plain versions and the per-op route of the same block (cuDNN
    convolutions and batch norm, channels-last; no single PyTorch call
    computes the block, so there is no library time). Gates: y within 2
    bf16 ulps of max |y| or 1e-2 abs; r1, r2 and the BN vectors normwise
    <= 1e-2 and the six statistics <= 1e-3; the backward kernels against
    the plain backward on the kernels' residuals (as training runs
    them), each of the ten gradients normwise <= 1e-2; the forward's
    launches held to their bodies (`fwd_routes_expected`: every product on
    the Hopper bodies). The end-to-end gap
    (each side on its own residuals) is reported: a residual one bf16 ulp
    apart flips relu mask elements. Times a call, and on the device (8
    calls in a CUDA graph; the per-op backward's device time is the
    captured forward + backward less the forward). The backward's split
    by product comes from a child process (`block_products`). Bound:
    forward x, y, r1, r2 = 10 M C bf16 elements and 34 M C^2 operations;
    backward dy, y, x, r1, r2, dx = 18 M C elements and 68 M C^2
    operations."""
    rb = _rb_mod()
    g = torch.Generator(device="cuda").manual_seed(11)
    names = "dx dw1 dw2 dw3 dg1 dbe1 dg2 dbe2 dg3 dbe3".split()
    rows = []
    for stage, H, C, blocks in RESNET_STAGES:
        N, M = RESNET_BATCH, RESNET_BATCH * H * H
        args, dy = _block_inputs(torch, N, H, C, g)
        zero_routes(rb.fused_bottleneck_fwd)
        y, res, stats = rb.fused_bottleneck_fwd(*args)
        fwd_routes = resblock_routes(rb.fused_bottleneck_fwd)
        grads = rb.fused_bottleneck_bwd(res, dy)
        y_ref, res_ref, stats_ref = rb.fused_bottleneck_fwd_ref(*args)
        same = rb.fused_bottleneck_bwd_ref(res, dy)
        own = rb.fused_bottleneck_bwd_ref(res_ref, dy)
        torch.cuda.synchronize()
        y_tol = max(2 * 2.0 ** -8 * y_ref.float().abs().max().item(), 1e-2)
        err = {"y": (y.float() - y_ref.float()).abs().max().item(),
               "dx": (grads[0].float() - same[0].float()).abs().max().item()}
        resid = {n: _normwise(a, b) for n, a, b in zip(
            ("r1", "r2", "bn1", "bn2", "bn3"), res[1:3] + res[7:10],
            res_ref[1:3] + res_ref[7:10])}
        stat = max(_normwise(a, b) for p, q in zip(stats, stats_ref)
                   for a, b in zip(p, q))
        rel = {n: _normwise(a, b) for n, a, b in zip(names, grads, same)}
        e2e = {n: _normwise(a, b) for n, a, b in zip(names, grads, own)}
        finite = all(bool(torch.isfinite(t).all()) for t in (y, *grads))
        case = f"{stage} bf16 N={N} H=W={H} C={C} 4C={4 * C}"
        row = dict(case=case, stage=stage, blocks_per_step=blocks,
                   max_abs_err=err, y_tol=y_tol, residuals_normwise=resid,
                   stats_normwise=stat, grad_normwise=rel,
                   grad_normwise_end_to_end=e2e, finite=finite,
                   fwd_routes=fwd_routes)
        if fwd_routes != fwd_routes_expected(1):
            raise AssertionError(f"fused bottleneck {case}: forward "
                                 f"launches by body {fwd_routes}")
        if not (finite and err["y"] <= y_tol and stat <= 1e-3
                and max(resid.values()) <= 1e-2
                and max(rel.values()) <= 1e-2):
            raise AssertionError(f"fused bottleneck {case}: {row}")
        del y_ref, res_ref, stats_ref, same, own, grads
        slow = max(3, iters // 4)
        row["fwd_ms"] = time_ms(torch, lambda: rb.fused_bottleneck_fwd(
            *args), iters)
        row["bwd_ms"] = time_ms(torch, lambda: rb.fused_bottleneck_bwd(
            res, dy), iters)
        row["fwd_plain_ms"] = time_ms(
            torch, lambda: rb.fused_bottleneck_fwd_ref(*args), slow,
            warmup=1)
        row["bwd_plain_ms"] = time_ms(
            torch, lambda: rb.fused_bottleneck_bwd_ref(res, dy), slow,
            warmup=1)
        row["fwd_dev_ms"] = time_graph_ms(
            torch, [lambda: rb.fused_bottleneck_fwd(*args)], calls=8)
        row["bwd_dev_ms"] = time_graph_ms(
            torch, [lambda: rb.fused_bottleneck_bwd(res, dy)], calls=8)
        blk, params = _per_op_block(torch, args, C)
        xin = args[0].detach().requires_grad_()
        leaves = [xin, *params.values()]

        def per_op():
            return torch.func.functional_call(blk, params, (xin,))

        with _route(None):
            # captured before any autograd graph of these leaves is kept
            # alive (its AccumulateGrad nodes would break the capture), on
            # an emptied cache (a capture may not free cached blocks)
            torch.cuda.empty_cache()
            try:
                row["fwd_per_op_dev_ms"] = time_graph_ms(torch, [per_op],
                                                         calls=4)
                row["bwd_per_op_dev_ms"] = time_graph_ms(
                    torch,
                    [lambda: torch.autograd.grad(per_op(), leaves, dy)],
                    calls=4) - row["fwd_per_op_dev_ms"]
            except RuntimeError as e:   # a refused capture: not measured
                row["fwd_per_op_dev_ms"] = row["bwd_per_op_dev_ms"] = None
                row["per_op_dev_error"] = str(e)[:300]
            row["fwd_per_op_ms"] = time_ms(torch, per_op, iters)
            out = per_op()
            row["bwd_per_op_ms"] = time_ms(
                torch, lambda: torch.autograd.grad(out, leaves, dy,
                                                   retain_graph=True), iters)
        del out, blk, xin, params, leaves
        elems = M * C
        for part, nbytes, flops in (
                ("fwd", 10 * elems * 2, 34.0 * M * C * C),
                ("bwd", 18 * elems * 2, 68.0 * M * C * C)):
            row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = bound(nbytes,
                                                                     flops)
            row[f"{part}_bytes"], row[f"{part}_flops"] = nbytes, flops
        rows.append(row)
        log(f"  fused bottleneck {case}: y err {err['y']:.4g} (tol "
            f"{y_tol:.4g}), stats {stat:.3g}, grads normwise "
            f"{max(rel.values()):.3g} (end to end {max(e2e.values()):.3g})"
            + "".join(f" {n} {t:.4f}" for n, t in row.items()
                      if n.endswith("_ms")))
        del args, dy, res, y
        torch.cuda.empty_cache()
    return rows


def block_products(torch):
    """`--profile-resblock`'s child: the fused forward's and backward's
    device time by launch at each stage shape (port_ab.py's
    `resblock_products`, one torch.profiler pass: only the first profiling
    session of a process records device kernels)."""
    import port_ab

    return port_ab.resblock_products(torch, _rb_mod(),
                                     sys.modules[__name__])


def _resnet_engine(torch, compute_dtype="bfloat16"):
    """resnet50 at full size (1000 classes, NHWC, f32 masters from seed 0),
    Momentum 0.1 / 0.9, hard-label cross-entropy, bf16 compute: the JAX
    package's TPU row (bench.py:221-280)."""
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.optimizer import Momentum

    torch.cuda.empty_cache()
    model = resnet50(num_classes=RESNET_CLASSES, data_format="NHWC",
                     device="cuda", seed=0)
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.parameters())

    def loss_fn(m, x, y):
        return TF.cross_entropy(m(x), y).mean()

    return model, parallelize(model, opt, loss_fn=loss_fn,
                              compute_dtype=compute_dtype)


def _resnet_batch(torch, np, seed, batch=RESNET_BATCH):
    """Random NHWC images and labels from numpy's RandomState(seed)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, RESNET_SIZE, RESNET_SIZE, 3).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, (batch,)).astype(np.int64)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


class _route:
    """PADDLE_TPU_FUSED_RESBLOCK for a with-block ("per-op": unset), put
    back afterwards."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        self.prev = os.environ.pop("PADDLE_TPU_FUSED_RESBLOCK", None)
        if self.mode is not None:
            os.environ["PADDLE_TPU_FUSED_RESBLOCK"] = self.mode

    def __exit__(self, *exc):
        os.environ.pop("PADDLE_TPU_FUSED_RESBLOCK", None)
        if self.prev is not None:
            os.environ["PADDLE_TPU_FUSED_RESBLOCK"] = self.prev


RESNET_ROUTES = {"per-op": None, "fused": "1"}


def resnet_throughput(torch, np, steps, seed):
    """20 steps on each route on one fixed batch after 2 warm-up steps,
    the fused-kernel counts set to 0 just before and read just after
    each route's run: ms a step, images/s, MFU (3 x the forward's conv
    and fc FLOPs a image, 2 per multiply-add, over 989e12), peak memory,
    losses (they must fall); 12 forward and 12 backward fused calls a step
    on the fused route, every forward launch on its body
    (`fwd_routes_expected`), none on the per-op route."""
    import math

    from paddle_tpu_torch.models import train_flops_per_image

    res = {}
    for route, mode in RESNET_ROUTES.items():
        with _route(mode):
            model, eng = _resnet_engine(torch)
            batch = _resnet_batch(torch, np, seed)
            _bert_steps(torch, eng, batch, 2)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_resblock_counts()
            t0 = time.perf_counter()
            losses, norms = _bert_steps(torch, eng, batch, steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, calls = resblock_counts(), resblock_counts("calls")
            fwd_routes = resblock_routes(_rb_mod().fused_bottleneck_fwd)
        fpi = train_flops_per_image(model, RESNET_SIZE)
        ips = RESNET_BATCH * steps / wall
        row = {"route": route, "batch": RESNET_BATCH, "size": RESNET_SIZE,
               "steps": steps, "step_ms": wall * 1e3 / steps,
               "images_per_s": ips, "train_flops_per_image": fpi,
               "mfu": ips * fpi / BF16_FLOPS, "losses": losses,
               "grad_norms": norms, "launches": launches, "calls": calls,
               "fwd_routes": fwd_routes,
               "launches_per_step": {k: v / steps
                                     for k, v in launches.items()},
               "launches_per_call": {k: v / max(calls[k], 1)
                                     for k, v in launches.items()},
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"  resnet50 {route} {json.dumps(row)}")
        want = 12 * steps if route == "fused" else 0
        if any(v != want for v in calls.values()) \
                or any((v > 0) != (want > 0) for v in launches.values()):
            raise AssertionError(f"resnet50 {route}: fused calls {calls}, "
                                 f"launches {launches}, expected {want} "
                                 f"calls each")
        if fwd_routes != fwd_routes_expected(want):
            raise AssertionError(f"resnet50 {route}: forward launches by "
                                 f"body {fwd_routes}")
        if not all(math.isfinite(v) for v in losses + norms) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"resnet50 {route}: losses {losses}")
        res[route] = row
        del model, eng, batch
    return res


# Gates of the ResNet-50 parity, by compute dtype: the first step's loss
# and grad norm, kernels against the plain fused route (relative), and the
# first step's whole gradient, kernels against the plain backward on the
# kernels' own forward (normwise). Set from the first measurement (H100,
# f32 compute): loss 9.0e-4, grad norm 5.0e-3, gradient 1.01e-2 (the
# blocks' 1e-3 grown through the backward above them), against 1.02e-1
# for the planted fault: the gradient gate sits 3x above the noise and
# 3.4x below the fault.
RESNET_PARITY_TOL = {"bfloat16": {"loss": 1e-2, "grad_norm": 5e-2,
                                  "grads": 5e-2},
                     "float32": {"loss": 5e-3, "grad_norm": 2e-2,
                                 "grads": 3e-2}}


def _resnet_route_run(torch, np, seed, steps, compute_dtype, route):
    """`steps` steps of the same weights and batch (B = 32) on one route:
    "kernels" (the fused kernels; mode "1" in bf16, "force" in f32, where
    the input is f32); "plain" (the fused route through the kernels'
    plain versions, patched in here and restored); "plain backward" (the
    forward kernels, then the plain backward on their residuals);
    "per-op"; or "m2 dropped", a planted fault: the backward kernels with
    the BN backward's xhat-dependence (m2) set to 0. Returns the losses,
    grad norms and fused calls, and the first step's gradients."""
    rb = _rb_mod()
    fwd, bwd, stats = (rb.fused_bottleneck_fwd, rb.fused_bottleneck_bwd,
                       rb._Launcher.stats)
    mode = "force" if compute_dtype is None else "1"
    if route == "per-op":
        mode = None
    if route == "plain":
        rb.fused_bottleneck_fwd = rb.fused_bottleneck_fwd_ref
    if route in ("plain", "plain backward"):
        rb.fused_bottleneck_bwd = rb.fused_bottleneck_bwd_ref
    elif route == "m2 dropped":
        def dropped(self, kind, *a, **kw):
            out = stats(self, kind, *a, **kw)
            if kind == rb._BN_BWD:
                out[4].zero_()
            return out
        rb._Launcher.stats = dropped
    try:
        with _route(mode):
            model, eng = _resnet_engine(torch, compute_dtype)
            batch = _resnet_batch(torch, np, seed + 1, 32)
            reset_resblock_counts()
            losses, norms = _bert_steps(torch, eng, batch, 1)
            first = torch.cat([p.grad.float().flatten()
                               for p in model.parameters()])
            more = _bert_steps(torch, eng, batch, steps - 1)
            launches = resblock_counts()
    finally:
        rb.fused_bottleneck_fwd, rb.fused_bottleneck_bwd = fwd, bwd
        rb._Launcher.stats = stats
    del model, eng
    return ({"losses": losses + more[0], "grad_norms": norms + more[1],
             "launches": launches}, first)


def resnet_parity(torch, np, seed, steps=3):
    """resnet50 at B = 32 from the same weights and batch, in bf16 and in
    f32 compute. Gated (RESNET_PARITY_TOL), on the first step: the fused
    kernels against the plain fused route, loss and grad norm; and the
    whole first-step gradient of the kernels against the plain backward
    on the kernels' own forward, normwise. The planted fault ("m2
    dropped") must break the f32 gradient gate; a second bf16 kernel run
    must equal the first bit for bit. Steps 2 and 3 of every route and
    the per-op route's gap are reported, not gated: at initialisation
    this network is chaotic — a one-bf16-ulp change of one r1 element
    grows to gradients that differ by tens of percent normwise (PERF.md's
    ResNet findings) — so a trajectory's later steps measure that, not the
    kernels.
    """
    res = {"batch": 32, "steps": steps, "tol": RESNET_PARITY_TOL}
    failures = []
    for dt, cd in (("bfloat16", "bfloat16"), ("float32", None)):
        routes = ["kernels", "plain", "plain backward", "per-op"]
        routes += (["kernels again"] if dt == "bfloat16"
                   else ["m2 dropped"])
        runs, grads = {}, {}
        for r in routes:
            runs[r], grads[r] = _resnet_route_run(torch, np, seed, steps,
                                                  cd, r)
        tol = RESNET_PARITY_TOL[dt]
        k, p = runs["kernels"], runs["plain"]
        ref = grads["plain backward"]

        def gap(route):
            return ((grads[route] - ref).norm() / ref.norm()).item()

        row = {"runs": runs,
               "loss_rel_err": abs(k["losses"][0] - p["losses"][0])
               / abs(p["losses"][0]),
               "grad_norm_rel_err": abs(k["grad_norms"][0]
                                        - p["grad_norms"][0])
               / abs(p["grad_norms"][0]),
               "grads_normwise": gap("kernels"),
               "grads_normwise_full_plain_route": gap("plain"),
               "grads_normwise_per_op_route": gap("per-op"),
               "later_steps_loss_max_rel_err": _rel_gaps(k, p)[0],
               "per_op_vs_fused_loss_max_rel": _rel_gaps(runs["per-op"],
                                                         k)[0]}
        for key, name in (("loss_rel_err", "loss"),
                          ("grad_norm_rel_err", "grad_norm"),
                          ("grads_normwise", "grads")):
            if not row[key] <= tol[name]:
                failures.append(f"{dt}: {key} {row[key]} (tol "
                                f"{tol[name]})")
        if min(k["launches"].values()) == 0 or any(
                p["launches"].values()) or any(
                runs["per-op"]["launches"].values()):
            failures.append(f"{dt} routing: kernel run {k['launches']}, "
                            f"plain run {p['launches']}, per-op run "
                            f"{runs['per-op']['launches']}")
        if dt == "bfloat16":
            again = runs["kernels again"]
            row["rerun_bitwise_equal"] = (
                k["losses"] == again["losses"]
                and k["grad_norms"] == again["grad_norms"]
                and torch.equal(grads["kernels"], grads["kernels again"]))
            if not row["rerun_bitwise_equal"]:
                failures.append("bf16 kernel rerun not bit-equal")
        else:
            row["m2_dropped_grads_normwise"] = gap("m2 dropped")
            row["m2_dropped_caught"] = (row["m2_dropped_grads_normwise"]
                                        > tol["grads"])
            if not row["m2_dropped_caught"]:
                failures.append(f"f32 gates miss the planted fault: "
                                f"{row['m2_dropped_grads_normwise']}")
        res[dt] = row
        del grads, ref
        torch.cuda.empty_cache()
    log(f"  resnet50 parity {json.dumps(res)}")
    if failures:
        raise AssertionError("ResNet-50 kernels vs plain: "
                             + "; ".join(failures))
    return res


TRANSPOSE_NAMES = ("nchwtonhwc", "nhwctonchw", "transpose", "permute")


def profile_resnet(torch, np, route, seed, steps=3):
    """Profile `steps` ResNet-50 steps of one route (after 2 warm-up
    steps) under torch.profiler, in a child process of its own
    (`--profile-resnet OUT --route ROUTE`): device-busy share, ms a step
    by family, launches a step and the layout-transpose kernels a
    step."""
    from torch.profiler import ProfilerActivity, profile

    with _route(RESNET_ROUTES[route]):
        model, eng = _resnet_engine(torch)
        batch = _resnet_batch(torch, np, seed)
        _bert_steps(torch, eng, batch, 2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _bert_steps(torch, eng, batch, steps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    fam = kernel_families(prof, (
        ("fused_bottleneck", ("rb_wg", "rb_form", "rb_sum", "rb_bn")),
        ("batch_norm", ("batch_norm", "bn_fw", "bn_bw", "welford")),
        ("conv", ("conv", "cudnn", "implicit", "xmma", "fprop", "dgrad",
                  "wgrad", "nchw", "nhwc", *GEMM_NAMES)),
        ("optimizer", ("foreach", "multi_tensor")),
        ("elementwise", ("elementwise", "reduce", "copy", "fill")),
        ("pool", ("pool",))))
    busy_ms = sum(fam.values()) / 1e3
    evts = device_events(prof)
    transposes = [(e.key[:120], e.count / steps) for e in evts
                  if any(w in e.key.lower() for w in TRANSPOSE_NAMES)]
    return {"route": route, "steps": steps, "step_ms": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_busy_share": busy_ms / wall_ms,
            "device_launches_per_step": sum(e.count for e in evts) / steps,
            "layout_transposes_per_step": sum(c for _, c in transposes),
            "layout_transpose_kernels": transposes,
            "kernel_ms_per_step": {k: v / 1e3 / steps
                                   for k, v in fam.items()},
            "top_kernels_ms_per_step": top_kernels(prof, steps)}


def resnet_phase(torch, np, args):
    """Phase 6: throughput on both routes, parity, and a profile child per
    route. 20 steps on each route, `--quick` too: the loss gate was set
    for 20 (five steps at lr 0.1 do not lower the loss)."""
    run = {"throughput": resnet_throughput(torch, np, 20, args.seed),
           "parity": resnet_parity(torch, np, args.seed)}
    run["profile"] = {r: run_child("--profile-resnet", 0, args.seed,
                                   args.report, "--route", r)
                      for r in RESNET_ROUTES}
    for route, prof in run["profile"].items():
        log(f"  resnet50 profile {json.dumps(prof)}")
        prof["device_busy_share_unprofiled"] = (
            prof["device_busy_ms_per_step"]
            / run["throughput"][route]["step_ms"])
    return run


def resblock_kernel_rows(rows, resnet_run):
    """The two fused families' entries of the kernels line: times, bounds
    and per-op times summed over the 12 fused blocks of a ResNet-50 step
    (each stage's shape times its blocks), kernel launches and launches
    a call from phase 6's fused-route run."""
    fused = resnet_run["throughput"]["fused"]
    out = []
    for name, part, line in (("fused_bottleneck_fwd", "fwd", 141),
                             ("fused_bottleneck_bwd", "bwd", 192)):
        def step(key):
            vals = [r.get(key) for r in rows]
            if None in vals:            # a stage not measured
                return None
            return sum(v * r["blocks_per_step"] for v, r in zip(vals, rows))

        share = {}
        for r in rows:
            share[r[f"{part}_bound_by"]] = share.get(
                r[f"{part}_bound_by"], 0.0) + (r[f"{part}_bound_ms"]
                                               * r["blocks_per_step"])
        out.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/fused_resblock.cu",
            replaces=f"paddle_tpu/ops/pallas/fused_resblock.py:{line}",
            launches=fused["launches"][name],
            max_abs_err=max(r["max_abs_err"]["y" if part == "fwd" else "dx"]
                            for r in rows),
            ms=step(f"{part}_ms"), plain_ms=step(f"{part}_plain_ms"),
            bound_ms=step(f"{part}_bound_ms"),
            bound_by=max(share, key=share.get), library_ms=None,
            device_ms=step(f"{part}_dev_ms"),
            per_op_ms=step(f"{part}_per_op_ms"),
            per_op_device_ms=step(f"{part}_per_op_dev_ms"),
            path=("rb_wg, rb_wg_conv, rb_wg_wgrad (TMA, wgmma)"
                  if part == "bwd" else
                  "rb_wg (F1, F3, F4), rb_wg_conv (F2) (TMA, wgmma); "
                  "rb_form; rb_bn"),
            **({"routes": fused["fwd_routes"]} if part == "fwd" else {}),
            launches_per_call=fused["launches_per_call"][name],
            case="ResNet-50 step: 12 identity blocks at N=128, bf16 "
                 "(2 x layer1 + 3 x layer2 + 5 x layer3 + 2 x layer4)",
            by_stage={r["stage"]: {k: r.get(k) for k in (
                f"{part}_ms", f"{part}_dev_ms", f"{part}_plain_ms",
                f"{part}_per_op_ms", f"{part}_per_op_dev_ms",
                f"{part}_bound_ms", f"{part}_bound_by",
                f"{part}_products_ms")}
                for r in rows}))
    return out


# ---------------------------------------------------------------------------
# phase 2 (ring attention): the position-masked kernels, the serial ring
# and the row-stable GEMV
# ---------------------------------------------------------------------------

def _cp_mod():
    import importlib

    return importlib.import_module(
        "paddle_tpu_torch.distributed.context_parallel")


def _pos_wrappers():
    fa = _flash_mod()
    return {"flash_fwd_pos": fa.flash_fwd_pos,
            "flash_dq_pos": fa.flash_bwd_pos_dq,
            "flash_dkv_pos": fa.flash_bwd_pos_dkv}


def flash_pos_counts():
    return {n: w.launches for n, w in _pos_wrappers().items()}


def flash_pos_route_counts():
    """Launches by route name of the three ring-step wrappers since their
    counts were set to 0 (`flash_pos_route`'s codes)."""
    return {n: {(FLASH_ROUTE_NAMES if n == "flash_fwd_pos"
                 else FLASH_BWD_ROUTE_NAMES)[r]: c
                for r, c in w.routes.items()}
            for n, w in _pos_wrappers().items()}


def reset_flash_pos_counts():
    for w in _pos_wrappers().values():
        w.launches = 0
        zero_routes(w)


def _errs(torch, got, ref):
    """max abs error, and normwise ||got - ref|| / ||ref|| (0 when both
    are all zero; inf when only ref is)."""
    g, r = got.float(), ref.float()
    if r.numel() == 0:
        return 0.0, 0.0
    abs_err = (g - r).abs().max().item()
    rn = r.norm().item()
    if rn == 0:
        return abs_err, 0.0 if g.abs().max().item() == 0 else float("inf")
    return abs_err, ((g - r).norm() / rn).item()


def _pos_fwd_errs(torch, out, lse, ref, lse_ref, seen):
    """The forward's errors on the rows that see a key, and whether every
    row that sees none came out O == 0 exactly with lse <= -1e29."""
    err = {"fwd": _errs(torch, out[:, seen], ref[:, seen])[0],
           "lse": _errs(torch, lse[..., seen], lse_ref[..., seen])[0]}
    masked_ok = bool((out[:, ~seen] == 0).all()) and bool(
        (lse[..., ~seen] <= -1e29).all())
    return err, masked_ok


def check_flash_pos(torch, iters):
    """flash_fwd_pos, flash_dq_pos and flash_dkv_pos against their plain
    versions on the same inputs (the backward kernels on the plain
    forward's lse and delta), at the ring steps of gpt_base at cp = 2
    (rank 0 and 1, own and visiting shard, zigzag), a llama2_7b-width
    shard, a contiguous shard whose keys all lie in its future, f32 and
    no mask. Tolerances are the flash kernels' (FLASH_TOL; the lse of a
    row that sees a key 1e-2 / 1e-4, as phase 2's flash rows); a row that
    sees no key must come out O == 0 exactly with lse <= -1e29. Each case
    names the forward's and the backward's route (the wrappers' route
    counts); the bf16 cases must take the Hopper bodies, and each causal
    case on them is replayed in a CUDA graph (`graph_mismatches`),
    forward and backward. A planted fault must fail the forward's gate on
    each timed case: the Hopper forward handed k_pos shifted by one key
    block. The timed cases record kernel, plain and library times (SDPA
    with the boolean position mask, forward and backward), device times
    and the bound of the pairs the mask keeps."""
    import torch.nn.functional as F

    fa, cpm = _flash_mod(), _cp_mod()
    g = torch.Generator(device="cuda").manual_seed(6)
    hopper = FLASH_ROUTE_NAMES[3]
    rows = []
    for label, B, H, s, D, dt, rq, rk, zigzag, causal, timed in \
            FLASH_POS_CASES:
        dtype = getattr(torch, dt)
        qp = cpm._local_positions(rq, CP_WORLD, s, zigzag, "cuda")
        kp = cpm._local_positions(rk, CP_WORLD, s, zigzag, "cuda")
        q, k, v, do = (torch.randn(B, s, H, D, device="cuda",
                                   generator=g).to(dtype) for _ in range(4))
        reset_flash_pos_counts()
        out, lse = fa.flash_fwd_pos(q, k, v, qp, kp, causal=causal)
        route = launched_route(fa.flash_fwd_pos, FLASH_ROUTE_NAMES)
        ref, lse_ref = fa.flash_fwd_pos_ref(q, k, v, qp, kp, causal=causal)
        keep = qp[:, None].long() >= kp[None, :].long()
        seen = keep.any(1) if causal else torch.ones_like(keep[:, 0])
        delta = fa.attention_delta(ref, do)
        bwd = (q, k, v, do, lse_ref, delta, qp, kp)
        got = fa.flash_bwd_pos(*bwd, causal=causal)
        bwd_route = launched_route(fa.flash_bwd_pos_dq, FLASH_BWD_ROUTE_NAMES)
        if launched_route(fa.flash_bwd_pos_dkv,
                          FLASH_BWD_ROUTE_NAMES) != bwd_route:
            raise AssertionError(f"flash pos dq and dkv took different "
                                 f"routes: {fa.flash_bwd_pos_dkv.routes}")
        refs = fa.flash_bwd_pos_ref(*bwd, causal=causal)
        torch.cuda.synchronize()
        o_tol, grad_tol = FLASH_TOL[dt]
        lse_tol = 1e-2 if dt == "bfloat16" else 1e-4
        err, masked_ok = _pos_fwd_errs(torch, out, lse, ref, lse_ref, seen)
        rel = {}
        for name, pairs in (("dq", ((got[0], refs[0]),)),
                            ("dkv", ((got[1], refs[1]), (got[2], refs[2])))):
            e = [_errs(torch, a, b) for a, b in pairs]
            err[name], rel[name] = max(x[0] for x in e), max(x[1] for x in e)
        finite = all(bool(torch.isfinite(t).all()) for t in (out, lse, *got))
        kept = int(keep.sum()) if causal else s * s
        case = (f"{label} {dt} {'causal' if causal else 'full'} B={B} "
                f"s={s} H={H} D={D}")
        row = dict(case=case, dtype=dt, route=route, bwd_route=bwd_route,
                   max_abs_err=err, grad_norm_rel_err=rel, o_tol=o_tol,
                   lse_tol=lse_tol, grad_tol=grad_tol,
                   rows_seeing_no_key=int((~seen).sum()),
                   kept_pair_share=kept / (s * s))
        if not (finite and masked_ok and err["fwd"] <= o_tol
                and err["lse"] <= lse_tol
                and rel["dq"] <= grad_tol and rel["dkv"] <= grad_tol):
            raise AssertionError(
                f"flash pos {case} [{route} / {bwd_route}]: errors {err}, "
                f"normwise gradient errors {rel}, tolerances {o_tol} / "
                f"{lse_tol} / {grad_tol}, finite={finite}, masked rows "
                f"O=0/lse<=-1e29: {masked_ok}")
        if dt == "bfloat16" and (route, bwd_route) != (hopper, hopper):
            raise AssertionError(f"flash pos {case}: forward on {route}, "
                                 f"backward on {bwd_route}; expected the "
                                 f"Hopper bodies")
        if route == hopper and causal:
            row["graph_launches"], row["graph_mismatches"] = \
                graph_mismatches(torch, lambda: fa.flash_fwd_pos(
                    q, k, v, qp, kp), (out, lse))
            row["bwd_graph_launches"], row["bwd_graph_mismatches"] = \
                graph_mismatches(torch, lambda: fa.flash_bwd_pos(*bwd),
                                 got)
            if row["graph_mismatches"] or row["bwd_graph_mismatches"]:
                raise AssertionError(
                    f"flash pos {case}: {row['graph_mismatches']} of "
                    f"{row['graph_launches']} forwards and "
                    f"{row['bwd_graph_mismatches']} of "
                    f"{row['bwd_graph_launches']} backward calls in a CUDA "
                    f"graph differ from the eager launches")
        if timed and route == hopper:
            # the planted fault: k_pos shifted by one key block
            block = 64 if D <= 64 else 128
            zero_routes(fa.flash_fwd_pos)
            bad, bad_lse = fa.flash_fwd_pos(q, k, v, qp, kp + block)
            if launched_route(fa.flash_fwd_pos, FLASH_ROUTE_NAMES) != hopper:
                raise AssertionError(f"flash pos {case}: the fault's "
                                     f"forward left the Hopper body")
            bad_err, bad_masked = _pos_fwd_errs(torch, bad, bad_lse, ref,
                                                lse_ref, seen)
            row["fault_k_pos_shifted_err"] = bad_err
            if (bad_masked and bad_err["fwd"] <= o_tol
                    and bad_err["lse"] <= lse_tol):
                raise AssertionError(f"flash pos {case}: the planted fault "
                                     f"(k_pos shifted by {block}) passed the "
                                     f"gate: {bad_err}")
            del bad, bad_lse
        del ref, refs, got, out
        if timed:
            row.update(_time_flash_pos(torch, F, fa, q, k, v, do, lse_ref,
                                       delta, qp, kp, keep, kept, causal,
                                       iters))
        rows.append(row)
        log(f"  flash pos {case} [forward: {route}; backward: {bwd_route}]: "
            f"err {err} normwise {rel} kept {row['kept_pair_share']:.3f}"
            + ("".join(f" {n} {t:.4f} ms" for n, t in row.items()
                       if n.endswith("_ms")) if timed else ""))
        del q, k, v, do, lse, lse_ref, delta
        torch.cuda.empty_cache()
    return rows


def _time_flash_pos(torch, F, fa, q, k, v, do, lse, delta, qp, kp, keep,
                    kept, causal, iters):
    """Times and bounds of the three ring-step kernels. Operations count
    the pairs the mask keeps (from the positions): forward 4 B H D per
    pair, dq 1.5x, dkv 2x (as for the whole-sequence kernels); bytes each
    input read once and each output written once."""
    B, s, H, D = q.shape
    tensor = B * s * H * D * q.element_size()
    rows_f32 = B * H * s * 4
    fwd_flops = 4.0 * B * H * kept * D
    kw = dict(causal=causal)
    bwd = (q, k, v, do, lse, delta, qp, kp)
    slow = max(3, iters // 4)
    res = {
        "fwd_ms": time_ms(torch, lambda: fa.flash_fwd_pos(q, k, v, qp, kp,
                                                          **kw), iters),
        "dq_ms": time_ms(torch, lambda: fa.flash_bwd_pos_dq(*bwd, **kw),
                         iters),
        "dkv_ms": time_ms(torch, lambda: fa.flash_bwd_pos_dkv(*bwd, **kw),
                          iters),
        "fwd_plain_ms": time_ms(torch, lambda: fa.flash_fwd_pos_ref(
            q, k, v, qp, kp, **kw), slow, warmup=1),
        "bwd_plain_ms": time_ms(torch, lambda: fa.flash_bwd_pos_ref(
            *bwd, **kw), slow, warmup=1)}
    # the plain backward forms dq, dk and dv in one call; each kernel's
    # plain time is that call's, split in the kernels' operation shares
    res["dq_plain_ms"] = res["bwd_plain_ms"] * 1.5 / 3.5
    res["dkv_plain_ms"] = res["bwd_plain_ms"] * 2.0 / 3.5
    # yardstick: SDPA with the boolean position mask, forward and backward
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    mask = keep if causal else None
    lib = {"fwd": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         attn_mask=mask)}
    res["fwd_library_ms"] = time_ms(torch, lib["fwd"], iters)
    lib_out = lib["fwd"]()
    dot = do.transpose(1, 2)
    lib["bwd"] = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                             retain_graph=True)
    res["bwd_library_ms"] = time_ms(torch, lib["bwd"], iters)
    # device times, host work left out: calls in one CUDA graph, the
    # kernels' and SDPA's alike. SDPA's backward is captured with its
    # forward, on leaves of its own (autograd runs a backward on its
    # forward's stream and accumulates on the leaves' first one, which a
    # capture cannot join), and its device time is the pair's less the
    # forward's.
    qg, kg, vg = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))

    def lib_pair():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        return torch.autograd.grad(out, (qg, kg, vg), dot)

    for part, fn in (
            ("fwd", lambda: fa.flash_fwd_pos(q, k, v, qp, kp, **kw)),
            ("dq", lambda: fa.flash_bwd_pos_dq(*bwd, **kw)),
            ("dkv", lambda: fa.flash_bwd_pos_dkv(*bwd, **kw)),
            ("fwd_library", lib["fwd"]), ("fwd_bwd_library", lib_pair)):
        res[f"{part}_dev_ms"] = time_graph_ms(torch, [fn], calls=16, reps=5)
    res["bwd_library_dev_ms"] = (res["fwd_bwd_library_dev_ms"]
                                 - res["fwd_library_dev_ms"])
    for name, nbytes, flops in (
            ("fwd", 4 * tensor + rows_f32, fwd_flops),
            ("dq", 5 * tensor + 2 * rows_f32, 1.5 * fwd_flops),
            ("dkv", 6 * tensor + 2 * rows_f32, 2.0 * fwd_flops),
            ("bwd", 8 * tensor + 2 * rows_f32, 2.5 * fwd_flops)):
        res[f"{name}_bound_ms"], res[f"{name}_bound_by"] = bound(nbytes,
                                                                 flops)
    return res


def check_serial_ring(torch):
    """The ring's n steps (n = 2, 4) of every rank run in one process
    through the pos kernels and `_merge_partial` (`ring_serial`) on
    gpt_base's sequence: against the same ring through the kernels' plain
    versions to FLASH_TOL (its backward kernels on the plain ring's
    forward statistics, each held alone), and against the whole-sequence
    flash kernels —
    O to FLASH_TOL, gradients normwise to n + 1 roundings of the input
    dtype (2**-9 for bf16, 2**-24 for f32, at least f32's 1e-5): each
    step's dq, dk, dv is rounded to the input dtype (the TPU kernel's out
    dtype) before the f32 sum, where the whole-sequence kernel rounds
    once. The same ring with a planted fault (the visiting partial's merge
    weight dropped, `_dropped_weight_merge`) must fail that gate in its
    gradients, so that the gate still tells a wrong ring from a sound
    one."""
    fa, cpm = _flash_mod(), _cp_mod()
    g = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for n, dt, causal, balanced in ((2, "bfloat16", True, True),
                                    (4, "bfloat16", True, True),
                                    (2, "bfloat16", True, False),
                                    (2, "bfloat16", False, False),
                                    (2, "float32", True, True)):
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn(CP_BATCH, CP_SEQ, 12, 64, device="cuda",
                                   generator=g).to(dtype) for _ in range(4))
        kw = dict(causal=causal, balanced=balanced)
        got, _ = cpm.ring_serial(q, k, v, do, n, **kw)
        plain, stats = cpm.ring_serial(q, k, v, do, n,
                                       fwd=fa.flash_fwd_pos_ref,
                                       bwd=fa.flash_bwd_pos_ref, **kw)
        # the backward kernels on the plain ring's forward statistics, so
        # that they are held alone (the forward's roundings move delta)
        alone, _ = cpm.ring_serial(q, k, v, do, n, stats=stats, **kw)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        delta = fa.attention_delta(out, do)
        want = (out, fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                               causal=causal),
                *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                            causal=causal))
        torch.cuda.synchronize()
        o_tol, grad_tol = FLASH_TOL[dt]
        ring_tol = max(grad_tol, (n + 1) * 2.0 ** (
            -9 if dt == "bfloat16" else -24))
        e = [_errs(torch, got[0], plain[0])] + [
            _errs(torch, a, b) for a, b in zip(alone[1:], plain[1:])]
        w = [_errs(torch, a, b) for a, b in zip(got, want)]
        merge = cpm._merge_partial
        cpm._merge_partial = _dropped_weight_merge(torch)
        try:
            bad, _ = cpm.ring_serial(q, k, v, do, n, **kw)
        finally:
            cpm._merge_partial = merge
        fault = max(_errs(torch, a, b)[1] for a, b in zip(bad[1:], want[1:]))
        row = {"case": f"n={n} {dt} {'causal' if causal else 'full'} "
                       f"{'zigzag' if balanced else 'contiguous'} B="
                       f"{CP_BATCH} S={CP_SEQ} H=12 D=64",
               "vs_plain_ring": {"out_max_abs_err": e[0][0],
                                 "grad_norm_rel_err": {
                                     "dq": e[1][1], "dk": e[2][1],
                                     "dv": e[3][1]}},
               "vs_whole_sequence": {"out_max_abs_err": w[0][0],
                                     "grad_norm_rel_err": {
                                         "dq": w[1][1], "dk": w[2][1],
                                         "dv": w[3][1]}},
               "fault_vs_whole_sequence_grad_norm_rel_err": fault,
               "tol": {"out": o_tol, "grad_vs_plain": grad_tol,
                       "grad_vs_whole_sequence": ring_tol}}
        rows.append(row)
        log(f"  serial ring {json.dumps(row)}")
        if not (e[0][0] <= o_tol and max(x[1] for x in e[1:]) <= grad_tol
                and w[0][0] <= o_tol
                and max(x[1] for x in w[1:]) <= ring_tol
                and fault > ring_tol):
            raise AssertionError(f"serial ring {row['case']}: {row}")
        del q, k, v, do, got, plain, stats, alone, want, out, lse, delta, bad
        torch.cuda.empty_cache()
    return rows


ROW_ROUTE_NAMES = {0: "CUDA-core body (row_gemv)",
                   1: "tensor-core body (row_mma_gemv)"}


def check_row_gemv(torch, iters):
    """The row-stable float GEMV at the llama2_7b decode Linears (bf16
    weights, m = 1..16), each call on the tensor-core body (k % 64 == 0;
    the route read from `row_gemv.routes`): against its plain version (2
    bf16 ulps of the largest output), the first rows of a call of 16
    equal to calls of 1, 2, 4 and 8 bit for bit, and timed (m = 1 and 8)
    a call and on the device (32 calls in a CUDA graph cycling through 4
    copies of the weight, so each reads it from HBM) beside cuBLAS
    (`torch.nn.functional.linear`, the yardstick) and the bound (the
    weight bytes); with the body's CTAs a multiprocessor
    (`ptt_row_gemv_occupancy`)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.weight_only import row_gemv, row_gemv_ref

    g = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for lname, (n, k) in LLAMA_LINEARS.items():
        w = (torch.randn(n, k, device="cuda", generator=g) * 0.02).to(
            torch.bfloat16)
        x = torch.randn(16, k, device="cuda", generator=g).to(torch.bfloat16)
        copies = [w] + [w.clone() for _ in range(3)]
        full = row_gemv(x, w)
        for m in (1, 2, 4, 8, 16):
            zero_routes(row_gemv)
            got = row_gemv(x[:m], w)
            route = launched_route(row_gemv, ROW_ROUTE_NAMES)
            ref = row_gemv_ref(x[:m], w)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            tol = 2 * 2.0 ** -8 * ref.float().abs().max().item()
            stable = bool(torch.equal(got, full[:m]))
            row = dict(case=f"bf16 m={m} {lname} n={n} k={k}", m=m,
                       layer=lname, route=route, max_abs_err=err, tol=tol,
                       rows_equal_in_batch_of_16=stable)
            if m in (1, 8):
                xm = x[:m]
                row["ms"] = time_ms(torch, lambda: row_gemv(xm, w), iters)
                row["plain_ms"] = time_ms(torch, lambda: row_gemv_ref(xm, w),
                                          max(3, iters // 4))
                row["library_ms"] = time_ms(torch, lambda: F.linear(xm, w),
                                            iters)
                row["device_ms"] = time_graph_ms(
                    torch, [lambda c=c: row_gemv(xm, c) for c in copies])
                row["library_device_ms"] = time_graph_ms(
                    torch, [lambda c=c: F.linear(xm, c) for c in copies])
                row["ctas_per_sm"] = _build.lib().ptt_row_gemv_occupancy(
                    _build.dtype_code(torch.bfloat16), m)
                row["bound_ms"], row["bound_by"] = bound(
                    (n * k + m * k + m * n) * 2, 2.0 * m * n * k)
            rows.append(row)
            log(f"  row_gemv {json.dumps(row)}")
            if not (err <= tol and stable and route == ROW_ROUTE_NAMES[1]
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"row_gemv {row['case']}: {row}")
        del w, x, copies
    return rows


# ---------------------------------------------------------------------------
# phase 7: gpt_base trains at cp = 2, two ranks on one card over gloo
# ---------------------------------------------------------------------------

def _dropped_weight_merge(torch):
    """The planted fault: the ring's merge without the visiting partial's
    weight exp(lse_blk - lse_new)."""
    def merge(out, lse, o_blk, lse_blk):
        lse_new = torch.logaddexp(lse, lse_blk)
        w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
        return out * w_old + o_blk.float(), lse_new
    return merge


def _cp_engine(torch, mesh, compute_dtype, mode="ring"):
    """gpt_base at full width and depth (f32 masters from seed 0), AdamW
    1e-4 with ClipGradByGlobalNorm(1.0), phase 4's configuration, as this
    rank's part of a cp mesh (None: one device)."""
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.empty_cache()
    model = gpt("gpt_base", dtype="float32", device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    return model, parallelize(model, opt, mesh=mesh,
                              context_parallel=mode,
                              compute_dtype=compute_dtype)


def cp_rank(torch, args):
    """One rank of phase 7 (`--cp-rank R --cp-dir DIR`): joins the gloo
    job through DIR's file store, builds its cp mesh on cuda:0 and runs,
    in order, two bf16 3-step runs (bit-equal), the bf16 throughput run,
    3 f32 steps (parity), 3 f32 steps with the planted fault, one f32
    Ulysses step, and on rank 0 the single-device f32 reference; writes
    DIR/rank{R}.json."""
    import datetime

    import torch.distributed as dist
    from paddle_tpu_torch.models import flops_per_token
    from paddle_tpu_torch.sharding import MeshConfig

    rank, steps = args.cp_rank, (5 if args.quick else 20)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(args.cp_dir, "store"),
        rank=rank, world_size=CP_WORLD,
        timeout=datetime.timedelta(seconds=CP_TIMEOUT))
    mesh = MeshConfig(cp=CP_WORLD).build(device="cuda:0")
    tr = mesh.transport
    cpm = _cp_mod()
    g = torch.Generator().manual_seed(args.seed)
    ids = torch.randint(0, 50304, (CP_BATCH, CP_SEQ), generator=g).cuda()
    res = {"rank": rank, "mesh": repr(mesh), "backend": tr.backend,
           "staged": tr.staged, "batch": CP_BATCH, "seq": CP_SEQ,
           "layers": 12}

    def run(compute_dtype, n, mode="ring"):
        model, eng = _cp_engine(torch, mesh, compute_dtype, mode)
        out = _run_steps(torch, eng, ids, n)
        del model, eng
        return out

    def run_f32(mesh_or_none):
        """3 f32 steps; also the first step's (clipped) gradient of every
        layer's qkv_proj weight, flat, kept on the card."""
        model, eng = _cp_engine(torch, mesh_or_none, None)
        first = _run_steps(torch, eng, ids, 1)
        grad = torch.cat([p.grad.reshape(-1) for n_, p in
                          model.named_parameters() if "qkv_proj.weight" in n_])
        rest = _run_steps(torch, eng, ids, 2)
        del model, eng
        return [first[0] + rest[0], first[1] + rest[1]], grad

    reruns = [run("bfloat16", 3) for _ in range(2)]
    res["bf16_reruns"] = reruns
    res["bf16_reruns_bit_equal"] = reruns[0] == reruns[1]

    model, eng = _cp_engine(torch, mesh, "bfloat16")
    _run_steps(torch, eng, ids, 2)
    torch.cuda.synchronize()
    dist.barrier()
    reset_flash_pos_counts()
    reset_flash_counts()
    tr.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, norms = _run_steps(torch, eng, ids, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = CP_BATCH * CP_SEQ * steps
    fpt = flops_per_token(model.cfg, CP_SEQ)
    res["throughput"] = {
        "steps": steps, "step_ms": wall * 1e3 / steps,
        "global_tokens_per_s": tokens / wall,
        "mfu_one_card": tokens / wall * fpt / BF16_FLOPS,
        "losses": losses, "grad_norms": norms,
        "launches": {**flash_pos_counts(), **flash_counts()},
        "routes": flash_pos_route_counts(),
        "exchange_per_step": {k: {"bytes": v["bytes"] / steps,
                                  "ms": v["ms"] / steps,
                                  "calls": v["calls"] / steps}
                              for k, v in tr.stats.items()},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, eng

    res["f32"], grad = run_f32(mesh)
    merge = cpm._merge_partial
    cpm._merge_partial = _dropped_weight_merge(torch)
    try:
        res["f32_fault_merge_weight_dropped"], grad_bad = run_f32(mesh)
    finally:
        cpm._merge_partial = merge
    res["f32_ulysses"] = run(None, 1, mode="ulysses")
    if rank == 0:
        res["f32_single_device"], ref = run_f32(None)
        # the gradients are summed over the mesh: every rank holds these
        res["f32_qkv_grad_rel_err"] = ((grad - ref).norm()
                                       / ref.norm()).item()
        res["f32_fault_qkv_grad_rel_err"] = ((grad_bad - ref).norm()
                                             / ref.norm()).item()
    del grad, grad_bad
    dist.barrier()
    with open(os.path.join(args.cp_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _rel_err(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def cp_phase(torch, args):
    """Phase 7: start the two ranks (`--cp-rank`), each on cuda:0 over
    gloo with host staging (NCCL takes one rank per device), join them
    within CP_TIMEOUT (killed on expiry), and hold what they report."""
    import math
    import shutil

    # absolute: a file:// store URL takes its first part as a host name
    cp_dir = os.path.abspath(f"{args.report}.cp")
    shutil.rmtree(cp_dir, ignore_errors=True)
    os.makedirs(cp_dir)
    logs = [open(os.path.join(cp_dir, f"rank{r}.log"), "w")
            for r in range(CP_WORLD)]
    extra = ["--quick"] if args.quick else []
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cp-rank", str(r),
         "--cp-dir", cp_dir, "--seed", str(args.seed), *extra],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(CP_WORLD)]
    t0 = time.perf_counter()
    failed = None
    for r, p in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, CP_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            failed = f"rank {r} still running after {CP_TIMEOUT} s"
            break
        if p.returncode != 0:
            failed = f"rank {r} exited with {p.returncode}"
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in logs:
        f.close()
    if failed:
        tails = []
        for r in range(CP_WORLD):
            with open(os.path.join(cp_dir, f"rank{r}.log")) as f:
                tails.append(f.read()[-3000:])
        raise AssertionError(f"cp training: {failed}\n" + "\n---\n".join(
            tails))
    ranks = []
    for r in range(CP_WORLD):
        with open(os.path.join(cp_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(cp_dir, ignore_errors=True)
    r0 = ranks[0]
    steps = r0["throughput"]["steps"]
    single_l, single_n = r0["f32_single_device"]
    cp_l, cp_n = r0["f32"]
    bad_l, bad_n = r0["f32_fault_merge_weight_dropped"]
    # f32 gates: losses, grad norms, and the first step's qkv gradient
    # normwise (attention is what the ring changes)
    gate = {"loss_rel": 1e-4, "grad_norm_rel": 1e-3, "qkv_grad_rel": 1e-3}
    parity = {"loss_rel_err": _rel_err(cp_l, single_l),
              "grad_norm_rel_err": _rel_err(cp_n, single_n),
              "qkv_grad_rel_err": r0["f32_qkv_grad_rel_err"]}
    fault = {"loss_rel_err": _rel_err(bad_l, single_l),
             "grad_norm_rel_err": _rel_err(bad_n, single_n),
             "qkv_grad_rel_err": r0["f32_fault_qkv_grad_rel_err"]}

    def passes(x):
        return (x["loss_rel_err"] <= gate["loss_rel"]
                and x["grad_norm_rel_err"] <= gate["grad_norm_rel"]
                and x["qkv_grad_rel_err"] <= gate["qkv_grad_rel"])

    fault["caught"] = not passes(fault)
    uly = r0["f32_ulysses"][0][0]
    run = {"ranks": ranks, "gate": gate, "f32_parity": parity,
           "f32_fault_merge_weight_dropped": fault,
           "ulysses_step1_loss": uly,
           "ulysses_step1_loss_rel_err": abs(uly - single_l[0])
           / abs(single_l[0]),
           "step_ms": max(x["throughput"]["step_ms"] for x in ranks),
           "global_tokens_per_s": min(x["throughput"]["global_tokens_per_s"]
                                      for x in ranks),
           "mfu_one_card": min(x["throughput"]["mfu_one_card"]
                               for x in ranks),
           "launches_per_rank_per_step": [
               {k: v / steps for k, v in x["throughput"]["launches"].items()}
               for x in ranks],
           "routes_per_rank": [x["throughput"]["routes"] for x in ranks],
           "exchange_per_step": [x["throughput"]["exchange_per_step"]
                                 for x in ranks]}
    log(f"  cp {json.dumps({k: v for k, v in run.items() if k != 'ranks'})}")
    per_step = 2 * 12          # 12 layers, n = 2 ring steps
    hopper = FLASH_ROUTE_NAMES[3]
    for x in ranks:
        launches = x["throughput"]["launches"]
        want = {k: per_step * steps if k.endswith("_pos") else 0
                for k in launches}
        if launches != want:
            raise AssertionError(f"cp rank {x['rank']}: launches "
                                 f"{launches}, expected {want}")
        # every ring-step launch on the Hopper bodies (bf16, D = 64)
        for name, routes in x["throughput"]["routes"].items():
            if {r: c for r, c in routes.items() if c} != {
                    hopper: per_step * steps}:
                raise AssertionError(f"cp rank {x['rank']}: {name} "
                                     f"launches by route {routes}, expected "
                                     f"all {per_step * steps} on {hopper}")
        losses = x["throughput"]["losses"] + x["throughput"]["grad_norms"]
        if not all(math.isfinite(v) for v in losses) or not (
                x["throughput"]["losses"][-1] < x["throughput"]["losses"][0]):
            raise AssertionError(f"cp rank {x['rank']}: training did not "
                                 f"progress: {x['throughput']['losses']}")
        if not x["bf16_reruns_bit_equal"]:
            raise AssertionError(f"cp rank {x['rank']}: bf16 reruns differ: "
                                 f"{x['bf16_reruns']}")
    for key in ("f32", "bf16_reruns"):
        if ranks[0][key] != ranks[1][key]:
            raise AssertionError(f"cp: the ranks report different {key}: "
                                 f"{ranks[0][key]} / {ranks[1][key]}")
    if ranks[0]["throughput"]["losses"] != ranks[1]["throughput"]["losses"]:
        raise AssertionError("cp: the ranks report different losses")
    if not passes(parity):
        raise AssertionError(f"cp f32 parity against one device: {parity} "
                             f"(gate {gate})")
    if not fault["caught"]:
        raise AssertionError(f"cp: the planted fault passed the f32 gate: "
                             f"{fault}")
    return run


# ---------------------------------------------------------------------------
# phase 2 (slice 7) and phase 8: block-sparse attention, dense decode
# attention and the coupled bottleneck pair
# ---------------------------------------------------------------------------

# BigBird-base's width (google/bigbird-roberta-base: 12 heads of 64) at
# S = 4096, on the 128-token tiles of the op's block route. BigBird's own
# blocks are 64 tokens, which are no union of 128 x 128 tiles and would
# take the SDDMM route.
BIGBIRD_HEADS, BIGBIRD_D, BIGBIRD_SEQ = 12, 64, 4096
SPARSE_BLOCK = 128
BIGBIRD_RANDOM = 3              # random key blocks of a query block
# O max abs error. A row attending N keys has |O| of about sqrt(e / N),
# 0.026 to 0.05 here, so the bf16 gate is set from the card's reading
# (1.95e-3, one bf16 ulp of the largest outputs), not the flash rows'
# 2e-2; the planted fault reads 0.31.
BS_TOL = {"bfloat16": 8e-3, "float32": 1e-4}
# gradients normwise: against the plain route (the backward is its vjp, so
# this is a route check) and against the dense f32 recompute (bf16 reading
# 5.3e-3, the bf16 rounding of q, k, v, out and the gradients)
BS_GRAD_TOL = {"bfloat16": 1e-3, "float32": 1e-5}
BS_DENSE_GRAD_TOL = {"bfloat16": 1.5e-2, "float32": 1e-4}
SDDMM_SEQ, SDDMM_DENSITY = 1024, 0.1
# llama2_7b's decode width: B = 8, H = 32, D = 128, a 4096-token cache
DECODE_B, DECODE_H, DECODE_D, DECODE_T = 8, 32, 128, 4096


def _bs_mod():
    import importlib

    return importlib.import_module(
        "paddle_tpu_torch.ops.block_sparse_attention")


# the block-sparse kernel's bodies (`block_sparse_route`'s codes 0, 1)
BS_ROUTE_NAMES = ("bs_fwd (mma.sync)",
                  "bs_fwd_sm90 (flash Hopper body, BlockTable policy)")


def bigbird_blocks(np, nb, seed):
    """BigBird's ITC pattern on nb key blocks, [nb, nb] bool: query block
    i attends its window {i - 1, i, i + 1}, the global blocks {0, nb - 1}
    and BIGBIRD_RANDOM other blocks drawn from `seed` (one draw for every
    head); the global query blocks attend every block."""
    rng = np.random.default_rng(seed)
    i = np.arange(nb)
    bm = np.abs(i[:, None] - i[None, :]) <= 1
    bm[:, [0, nb - 1]] = True
    keys = rng.random((nb, nb))
    keys[bm] = 2.0                      # draw among the blocks not listed
    bm[i[:, None], np.argsort(keys, axis=1)[:, :BIGBIRD_RANDOM]] = True
    bm[[0, nb - 1]] = True
    return bm


def block_csr(np, bm, bs):
    """The token pattern of a block mask and its CSR (offset [S + 1],
    columns [nnz], int32), by broadcasting: no loop over the nonzeros."""
    tok = np.repeat(np.repeat(bm, bs, 0), bs, 1)
    cols = np.nonzero(tok)[1].astype(np.int32)
    off = np.concatenate([[0], np.cumsum(tok.sum(1))]).astype(np.int32)
    return tok, off, cols


def _block_tables(torch, np, bm):
    """block_idx, block_cnt on the card, made by the op's own
    `csr_to_block_tables` from the pattern's CSR."""
    tok, off, cols = block_csr(np, bm, SPARSE_BLOCK)
    idx, cnt, exact = _bs_mod().csr_to_block_tables(off, cols, tok.shape[0],
                                                    SPARSE_BLOCK)
    if not exact:
        raise AssertionError("a block pattern's CSR is not exact")
    return (torch.from_numpy(idx).cuda(), torch.from_numpy(cnt).cuda(),
            torch.from_numpy(tok).cuda())


def check_block_sparse(torch, np, iters, seed):
    """Row 11: the block-sparse kernel against its plain version on the
    card, on tables of the BigBird pattern: [B*H = 4*12, 4096, 64] bf16
    (the kernels line's case) and f32, D = 128, and a table whose query
    block 5 lists nothing (O = 0 there exactly). O max abs error <= 8e-3
    (bf16) / 1e-4 (f32), BS_TOL. Each case names the body its launch
    took (`.routes`) and fails on another than `block_sparse_route`'s:
    bf16 at D = 64 and 128 the Hopper body, f32 `bs_fwd`. Timed also
    with the query blocks permuted longest first on the host (the
    kernel's own order should match it; the output rows must move with
    them bit for bit), and on the device (a CUDA graph). Bound:
    4 BH (listed tiles) 128^2 D operations (over the bf16 or f32 peak), or
    q, k, v, o once; library: SDPA with the dense boolean tile mask."""
    import torch.nn.functional as F

    bsa = _bs_mod()
    nb = BIGBIRD_SEQ // SPARSE_BLOCK
    bm = bigbird_blocks(np, nb, seed)
    holed = bm.copy()
    holed[5] = False
    g = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for label, B, D, dt, pattern, timed in (
            ("bigbird_base", 4, BIGBIRD_D, "bfloat16", bm, True),
            ("bigbird_base", 4, BIGBIRD_D, "float32", bm, True),
            ("D=128", 1, 128, "bfloat16", bm, True),
            ("query block 5 lists nothing", 1, BIGBIRD_D, "bfloat16", holed,
             False)):
        dtype = getattr(torch, dt)
        H, S = BIGBIRD_HEADS, BIGBIRD_SEQ
        BH = B * H
        idx, cnt, tok = _block_tables(torch, np, pattern)
        q, k, v = (torch.randn(BH, S, D, device="cuda", generator=g).to(
            dtype) for _ in range(3))
        scale = D ** -0.5
        want = bsa.block_sparse_route(q, k, v, scale)
        zero_routes(bsa.block_sparse_attention)
        got = bsa.block_sparse_attention(q, k, v, idx, cnt, scale,
                                         SPARSE_BLOCK)
        routes = dict(bsa.block_sparse_attention.routes)
        ref = bsa.block_sparse_attention_ref(q, k, v, idx, cnt, scale,
                                             SPARSE_BLOCK)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = BS_TOL[dt]
        rows5 = got[:, 5 * SPARSE_BLOCK:6 * SPARSE_BLOCK]
        zero = pattern is not holed or not rows5.any().item()
        finite = bool(torch.isfinite(got).all())
        case = (f"{label} {dt} B*H={B}*{H} S={S} D={D}, "
                f"{int(pattern.sum())} of {nb * nb} tiles")
        row = dict(case=case, dtype=dt, max_abs_err=err, tol=tol,
                   empty_rows_zero=zero, listed_tiles=int(pattern.sum()),
                   max_blocks_per_row=int(cnt.max()),
                   mean_blocks_per_row=float(cnt.float().mean()),
                   route=BS_ROUTE_NAMES[want], routes=routes)
        want_hopper = dt == "bfloat16" and 32 < D <= 128
        if not (finite and err <= tol and zero) or routes != {
                bsa.BS_MMA: int(want == bsa.BS_MMA),
                bsa.BS_WGMMA: int(want == bsa.BS_WGMMA)} or (
                    want == bsa.BS_WGMMA) != want_hopper:
            raise AssertionError(f"block_sparse {case}: {row}")
        del ref
        if timed:
            elt = q.element_size()
            flops = 4.0 * BH * int(cnt.sum()) * SPARSE_BLOCK ** 2 * D
            nbytes = 4 * BH * S * D * elt + 4 * (idx.numel() + cnt.numel())
            row["bound_ms"], row["bound_by"] = bound(
                nbytes, flops, BF16_FLOPS if dt == "bfloat16"
                else F32_FLOPS)
            row["ms"] = time_ms(torch, lambda: bsa.block_sparse_attention(
                q, k, v, idx, cnt, scale, SPARSE_BLOCK), iters)
            row["device_ms"] = time_graph_ms(
                torch, [lambda: bsa.block_sparse_attention(
                    q, k, v, idx, cnt, scale, SPARSE_BLOCK)], calls=16)
            # the kernel's own order (longest rows first) against the same
            # work with the query blocks permuted longest first on the
            # host (q's row blocks and the tables' rows; the output rows
            # move with them, bit for bit): the times should agree
            perm = torch.argsort(cnt, descending=True, stable=True)
            blocks = (BH, S // SPARSE_BLOCK, SPARSE_BLOCK, D)
            qp = q.view(blocks)[:, perm].reshape(BH, S, D)
            idxp, cntp = idx[perm].contiguous(), cnt[perm].contiguous()
            outp = bsa.block_sparse_attention(qp, k, v, idxp, cntp, scale,
                                              SPARSE_BLOCK)
            if not torch.equal(outp.view(blocks), got.view(blocks)[:, perm]):
                raise AssertionError(f"block_sparse {case}: the permuted "
                                     f"query blocks' output differs")
            row["longest_first_ms"] = time_ms(
                torch, lambda: bsa.block_sparse_attention(
                    qp, k, v, idxp, cntp, scale, SPARSE_BLOCK), iters)
            del qp, outp
            row["plain_ms"] = time_ms(
                torch, lambda: bsa.block_sparse_attention_ref(
                    q, k, v, idx, cnt, scale, SPARSE_BLOCK),
                max(3, iters // 4), warmup=1)
            q4, k4, v4 = (t.view(B, H, S, D) for t in (q, k, v))
            row["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=tok, scale=scale), iters)
            row["bytes"], row["flops"] = nbytes, flops
        rows.append(row)
        log(f"  block_sparse {case}: err {err:.3g} (tol {tol})"
            + "".join(f" {n} {t:.4f}" for n, t in row.items()
                      if n.endswith("_ms")))
        del q, k, v, idx, cnt, tok, got
        torch.cuda.empty_cache()
    return rows


def _decode_cache(torch, g, H, Hkv, pos, cache):
    """q [B, 1, H, D] and a contiguous [B, Hkv, T, D] cache (int8 with its
    per-row scales, or float with unit scales); rows past pos hold 1e4, so
    a read past pos shows."""
    from paddle_tpu_torch.models.gpt import _quant_kv

    B, D, T = DECODE_B, DECODE_D, DECODE_T
    q = torch.randn(B, 1, H, D, device="cuda", generator=g)
    kv = []
    for _ in range(2):
        t = torch.randn(B, Hkv, T, D, device="cuda", generator=g)
        t[:, :, pos + 1:] = 1e4
        if cache == "int8":
            tq, ts = _quant_kv(t)
            kv.append((tq, ts[..., None]))
        else:
            kv.append((t.to(getattr(torch, cache)),
                       torch.ones(B, Hkv, T, 1, device="cuda")))
    return q, kv


def check_decode_attention(torch, iters):
    """Row 3: the dense decode kernel (the paged kernel, table b -> b)
    against `decode_attention_ref` at llama2_7b's decode width, B = 8,
    H = 32, D = 128, T = 4096: int8 and bf16 caches at pos 4095 and 2000,
    GQA 4:1, and an f32 query. Gates: 2e-3 abs with a bf16 query (|O| is
    about 0.03 at 4096 keys; the card read 2.4e-4, one bf16 ulp of the
    largest outputs), 1e-5 with an f32 query. Bound: the bytes of the
    rows <= pos (K, V
    and their f32 scales, read once) and q, out. Library: SDPA with the
    boolean position mask on a float cache; "dequant + SDPA" for int8 (no
    single call takes the int8 cache). Each case names its route (every
    case here is the ring body's), a call's time and its device time (a
    CUDA graph), and the first body's on the same inputs."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import decode_attn as da
    from paddle_tpu_torch.ops.decode_attn import (decode_attention,
                                                  decode_attention_ref)

    g = torch.Generator(device="cuda").manual_seed(17)
    B, D, T = DECODE_B, DECODE_D, DECODE_T
    H = DECODE_H
    rows = []
    for label, Hkv, pos, cache, qdt in (
            ("int8 MHA", H, T - 1, "int8", "bfloat16"),
            ("int8 MHA", H, 2000, "int8", "bfloat16"),
            ("bf16 MHA", H, T - 1, "bfloat16", "bfloat16"),
            ("bf16 MHA", H, 2000, "bfloat16", "bfloat16"),
            ("int8 GQA 4:1", H // 4, T - 1, "int8", "bfloat16"),
            ("bf16 GQA 4:1", H // 4, T - 1, "bfloat16", "bfloat16"),
            ("int8 MHA, f32 query", H, T - 1, "int8", "float32"),
            ("f32 GQA 4:1, f32 query", H // 4, 2000, "float32",
             "float32")):
        q, ((kq, ks), (vq, vs)) = _decode_cache(torch, g, H, Hkv, pos, cache)
        q = q.to(getattr(torch, qdt))
        args = (q, kq, ks, vq, vs)
        zero_routes(decode_attention)
        got = decode_attention(*args, pos)
        route = launched_route(decode_attention, PAGED_ROUTE_NAMES)
        ref = decode_attention_ref(*args, pos)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = 2e-3 if qdt == "bfloat16" else 1e-5
        finite = bool(torch.isfinite(got).all())
        case = (f"{label} {cache} cache B={B} H={H} Hkv={Hkv} D={D} T={T} "
                f"pos={pos} q {qdt}")
        row = dict(case=case, max_abs_err=err, tol=tol, finite=finite,
                   route=route)
        if not (finite and err <= tol and route == PAGED_ROUTE_NAMES[1]):
            raise AssertionError(f"decode_attention {case}: {row}")
        del ref
        row["ms"] = time_ms(torch, lambda: decode_attention(*args, pos),
                            iters)
        row["device_ms"] = time_graph_ms(
            torch, [lambda: decode_attention(*args, pos)])
        ks3, vs3 = (x.reshape(B, Hkv, T) for x in (ks, vs))

        def first():
            return da._launch_paged(q, kq, ks3, vq, vs3, None, pos,
                                    decode_attention, da.PAGED_SCALAR)
        row["first_body_ms"] = time_ms(torch, first, iters)
        row["first_body_device_ms"] = time_graph_ms(torch, [first])
        row["plain_ms"] = time_ms(
            torch, lambda: decode_attention_ref(*args, pos),
            max(3, iters // 4), warmup=1)
        live = (torch.arange(T, device="cuda") <= pos)[None, None, None]
        qd = q.transpose(1, 2)
        if cache == "int8":
            def lib():
                kd = (kq.float() * ks).to(q.dtype)
                vd = (vq.float() * vs).to(q.dtype)
                return F.scaled_dot_product_attention(
                    qd, kd, vd, attn_mask=live, enable_gqa=Hkv != H)
            row["library_kind"] = "dequant + SDPA (boolean position mask)"
        else:
            kd, vd = kq.to(q.dtype), vq.to(q.dtype)

            def lib():
                return F.scaled_dot_product_attention(
                    qd, kd, vd, attn_mask=live, enable_gqa=Hkv != H)
            row["library_kind"] = "SDPA (boolean position mask)"
        row["library_ms"] = time_ms(torch, lib, iters)
        rows_live = (min(pos, T - 1) + 1) * B * Hkv
        nbytes = (2 * rows_live * D * kq.element_size() + 2 * rows_live * 4
                  + 2 * q.numel() * q.element_size())
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 4.0 * B * H * (pos + 1) * D, F32_FLOPS)
        row["bytes"] = nbytes
        rows.append(row)
        log(f"  decode_attention {case}: err {err:.3g} (tol {tol})"
            + "".join(f" {n} {t:.4f}" for n, t in row.items()
                      if n.endswith("_ms")))
        del args, q, kq, ks, vq, vs, got
        torch.cuda.empty_cache()
    return rows


def decode_table_cost(torch):
    """What a block table costs the decode kernel: row 3's bf16 case (B =
    8, H = 32, D = 128, T = 4096, pos 4095) launched with no table
    (sequence b reads block b) and with a one-entry table b -> b (the
    same rows, found through the table), on the ring body (which stages
    the split's table entries in shared memory) and on the first body
    (which reads the table per token): device times from CUDA graphs.
    Within a body the outputs must be bit-equal."""
    from paddle_tpu_torch.ops import decode_attn as da

    g = torch.Generator(device="cuda").manual_seed(19)
    B, H, T, pos = DECODE_B, DECODE_H, DECODE_T, DECODE_T - 1
    q, ((kq, ks), (vq, vs)) = _decode_cache(torch, g, H, H, pos, "bfloat16")
    q = q.to(torch.bfloat16)
    ks3, vs3 = ks.reshape(B, H, T), vs.reshape(B, H, T)
    table = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    pos_t = torch.full((B,), pos, dtype=torch.int32, device="cuda")

    def call(tab, route):
        return da._launch_paged(q, kq, ks3, vq, vs3, tab,
                                pos if tab is None else pos_t,
                                da.decode_attention, route)

    res = {"case": f"bf16 MHA B={B} H={H} D={DECODE_D} T={T} pos={pos}"}
    for label, route, tab in (
            ("ring, no table", da.PAGED_RING, None),
            ("ring, table staged", da.PAGED_RING, table),
            ("first body, no table", da.PAGED_SCALAR, None),
            ("first body, table read per token", da.PAGED_SCALAR, table)):
        out = call(tab, route)
        if tab is None:
            base = out
        elif not torch.equal(out, base):
            raise AssertionError(f"decode table cost: {label} differs from "
                                 f"the same body without a table")
        res[f"{label} device_ms"] = time_graph_ms(
            torch, [lambda tab=tab, route=route: call(tab, route)])
    log(f"  decode table cost {json.dumps(res)}")
    return res


def check_fused_pair(torch, iters):
    """Row 12c: two chained identity blocks with block 1's k4 and block
    2's k1 in the coupled kernel, at ResNet-50's four stage shapes (N =
    128, bf16), against the plain version: y2 within 2 bf16 ulps of
    max |y2| or 1e-2 abs (row 12a's gate); its difference from two chained
    row-12a calls is reported. Timed beside those two calls (the question
    the reference left open: does the coupling win?), the plain version
    and the per-op route of the two blocks (cuDNN convolutions and batch
    norm; no single PyTorch call computes them). Bound: x read once and
    y2 written once, 8 M C bf16 elements, and 68 M C^2 operations. Its
    launches by body are held: the coupled rb_wg_k41 once a call, every
    other product on the Hopper bodies. The coupled kernel's device time
    alone is read beside F4 + F1 of a row-12a call on the same operands
    (`_coupled_vs_12a`)."""
    rb = _rb_mod()
    g = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    for stage, H, C, _ in RESNET_STAGES:
        N, M = RESNET_BATCH, RESNET_BATCH * H * H
        a1, _ = _block_inputs(torch, N, H, C, g)
        a2, _ = _block_inputs(torch, N, H, C, g)
        x, p1, p2 = a1[0], a1[1:], a2[1:]
        zero_routes(rb.fused_bottleneck2_fwd)
        y2 = rb.fused_bottleneck2_fwd(x, p1, p2)
        routes = resblock_routes(rb.fused_bottleneck2_fwd)
        ref = rb.fused_bottleneck2_fwd_ref(x, p1, p2)

        def chained():
            return rb.fused_bottleneck_fwd(
                rb.fused_bottleneck_fwd(x, *p1)[0], *p2)[0]

        two = chained()
        again = rb.fused_bottleneck2_fwd(x, p1, p2)
        torch.cuda.synchronize()
        tol = max(2 * 2.0 ** -8 * ref.float().abs().max().item(), 1e-2)
        err = (y2.float() - ref.float()).abs().max().item()
        case = f"{stage} bf16 N={N} H=W={H} C={C} 4C={4 * C}"
        row = dict(case=case, stage=stage, max_abs_err=err, tol=tol,
                   rerun_bit_equal=torch.equal(y2, again), routes=routes,
                   vs_two_12a_max_abs=(y2.float() - two.float()).abs().max()
                   .item(), vs_two_12a_normwise=_normwise(y2, two))
        want = dict.fromkeys(rb.ROUTE_NAMES, 0)
        want.update({rb.ROUTE_ROWS: 4, rb.ROUTE_CONV: 2, rb.ROUTE_FORM: 2,
                     rb.ROUTE_REDUCE: 6, rb.ROUTE_K41: 1})
        if not (bool(torch.isfinite(y2).all()) and err <= tol
                and row["rerun_bit_equal"]) or routes != {
                    rb.ROUTE_NAMES[r]: c for r, c in want.items()}:
            raise AssertionError(f"fused pair {case}: {row}")
        del ref, two, again, y2
        row["ms"] = time_ms(torch, lambda: rb.fused_bottleneck2_fwd(
            x, p1, p2), iters)
        row["two_12a_ms"] = time_ms(torch, chained, iters)
        row["plain_ms"] = time_ms(
            torch, lambda: rb.fused_bottleneck2_fwd_ref(x, p1, p2),
            max(3, iters // 4), warmup=1)
        (b1, q1), (b2, q2) = (_per_op_block(torch, a, C) for a in (a1, a2))

        def per_op():
            with torch.no_grad():
                y = torch.func.functional_call(b1, q1, (x,))
                return torch.func.functional_call(b2, q2, (y,))

        with _route(None):
            row["per_op_ms"] = time_ms(torch, per_op, iters)
        row.update(_coupled_vs_12a(torch, rb, x, p1, p2))
        row["bound_ms"], row["bound_by"] = bound(8 * M * C * 2,
                                                 68.0 * M * C * C)
        rows.append(row)
        log(f"  fused pair {case}: err {err:.4g} (tol {tol:.4g}), vs two "
            f"12a calls {row['vs_two_12a_max_abs']:.4g}"
            + "".join(f" {n} {t:.4f}" for n, t in row.items()
                      if n.endswith("_ms")))
        del a1, a2, x, p1, p2, b1, b2, q1, q2
        torch.cuda.empty_cache()
    return rows


def _coupled_vs_12a(torch, rb, x, p1, p2):
    """Row 12c's coupled kernel alone against what it replaces, in device
    ms (each launch alone in a CUDA graph, `time_graph_ms`): block 1's head
    run once for a2 = relu(bn2(r2)) and bn3, then the coupled launch (y1
    and block 2's r1 with its sums), row 12a's F4 (y1) and F1 (block 2's
    r1 from y1) on the same operands. The launches count on a scratch
    counter, not on the pair's."""
    import types

    N, H, W, C4 = x.shape
    C, M = p1[0].shape[1], N * H * W
    sink = types.SimpleNamespace(launches=0,
                                 routes=dict.fromkeys(rb.ROUTE_NAMES, 0))
    xa = rb._aligned(x)
    c1, c2 = rb._cuda_operands(p1), rb._cuda_operands(p2)
    wt1, wt2 = rb._fwd_weights(*c1[:3]), rb._fwd_weights(*c2[:3])

    def launcher():       # on the current stream (a graph's, in capture)
        return rb._Launcher(sink, xa, M, H, W)

    _, _, a2, _, _, bn3 = rb._block_head_cuda(
        launcher(), "probe", rb._opnd(xa, C=C4), C4, C, wt1, *c1[3:], 1e-5)
    y1 = torch.empty(M, C4, dtype=x.dtype, device=x.device)
    r1 = torch.empty(M, C, dtype=rb.MATMUL_DTYPE, device=x.device)
    sums_k41 = launcher().sums(C, rb._K41_ROWS)
    sums_f1 = launcher().sums(C)
    a2op, y1op = rb._opnd(a2, C=C), rb._opnd(y1, C=C4)
    launches = {
        "coupled": lambda: launcher().gemm(
            rb._F41, "coupled", a2op, C4, w=wt1[2], e0=xa, ebn=bn3, out=y1,
            part=sums_k41, w_next=wt2[0], out_next=r1),
        "f4": lambda: launcher().gemm(rb._F4, "f4", a2op, C4, w=wt1[2],
                                      e0=xa, ebn=bn3, out=y1),
        "f1": lambda: launcher().gemm(rb._F1, "f1", y1op, C, w=wt2[0],
                                      out=r1, part=sums_f1)}
    res = {f"{name}_device_ms": time_graph_ms(torch, [fn], calls=8)
           for name, fn in launches.items()}
    res["f4_f1_device_ms"] = res["f4_device_ms"] + res["f1_device_ms"]
    return res


def _dense_masked(torch, q, k, v, keep, gout, bias=None):
    """The dense f32 recompute in plain matmuls: softmax over the kept
    keys of q k^T / sqrt(D) (+ bias), times V; with gout also the
    gradients of sum(out * gout). Returns (out, [dq, dk, dv])."""
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    s = leaves[0] @ leaves[1].transpose(-1, -2) * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    out = p @ leaves[2]
    (out * gout.float()).sum().backward()
    return out.detach(), [t.grad for t in leaves]


def _fault_fewer_blocks(bsa):
    """The planted fault: the kernel visits block_cnt - 1 blocks."""
    launch = bsa._launch

    def faulty(q, k, v, idx, cnt, scale, block_size):
        return launch(q, k, v, idx, (cnt - 1).clamp_min(0), scale,
                      block_size)
    return launch, faulty


def _sparse_route(torch, bsa, dt, offset, columns, tables, keep, g, steps,
                  iters):
    """One dtype of phase 8's block route: `steps` forward and backward
    calls of the public op (loss sum(out * gout)), launches counted from
    0, then the gates, the planted fault and the kernel's own time on
    these tables."""
    from paddle_tpu_torch.nn.functional import sparse_attention

    dtype = getattr(torch, dt)
    H, S, D = BIGBIRD_HEADS, BIGBIRD_SEQ, BIGBIRD_D
    q, k, v, gout = (torch.randn(1, H, S, D, device="cuda", generator=g).to(
        dtype) for _ in range(4))
    dense, dense_grads = _dense_masked(torch, q, k, v, keep, gout)
    fwd, bwd = [], []
    bsa.block_sparse_attention.launches = 0
    zero_routes(bsa.block_sparse_attention)
    for _ in range(steps):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sparse_attention(*leaves, offset, columns)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (out.float() * gout.float()).sum().backward()
        torch.cuda.synchronize()
        fwd.append((t1 - t0) * 1e3)
        bwd.append((time.perf_counter() - t1) * 1e3)
    launches = bsa.block_sparse_attention.launches
    routes = dict(bsa.block_sparse_attention.routes)
    # every bf16 launch on the Hopper body, every f32 one on bs_fwd
    body = bsa.BS_WGMMA if dt == "bfloat16" else bsa.BS_MMA
    grads = [t.grad for t in leaves]
    # the plain route: the block-sparse plain version, autograd
    idx, cnt = tables
    plain = [t.detach().requires_grad_() for t in (q, k, v)]
    po = bsa.block_sparse_attention_ref(
        *(t.view(H, S, D) for t in plain), idx, cnt, D ** -0.5,
        SPARSE_BLOCK)
    (po.float() * gout.view(H, S, D).float()).sum().backward()
    err = (out.float() - dense).abs().max().item()
    plain_err = (out.float() - po.float().view(1, H, S, D)).abs().max().item()
    rel_plain = max(_normwise(a, b.grad) for a, b in zip(grads, plain))
    rel_dense = max(_normwise(a, b) for a, b in zip(grads, dense_grads))
    kern, faulty = _fault_fewer_blocks(bsa)
    bsa._launch = faulty
    try:
        bad = sparse_attention(q, k, v, offset, columns)
    finally:
        bsa._launch = kern
    fault_err = (bad.float() - dense).abs().max().item()
    fwd.sort()
    bwd.sort()
    qf, kf, vf = (t.view(H, S, D) for t in (q, k, v))
    kernel_ms = time_ms(torch, lambda: bsa.block_sparse_attention(
        qf, kf, vf, idx, cnt, D ** -0.5, SPARSE_BLOCK), iters)
    res = dict(dtype=dt, steps=steps, launches=launches,
               routes={BS_ROUTE_NAMES[r]: c for r, c in routes.items()},
               kernel_ms=kernel_ms,
               max_abs_err_vs_dense=err, max_abs_err_vs_plain=plain_err,
               tol=BS_TOL[dt], grad_normwise_vs_plain=rel_plain,
               grad_tol=BS_GRAD_TOL[dt], grad_normwise_vs_dense=rel_dense,
               dense_grad_tol=BS_DENSE_GRAD_TOL[dt],
               fault_max_abs_err=fault_err, fault_caught=fault_err > BS_TOL[
                   dt], fwd_ms=fwd[len(fwd) // 2], bwd_ms=bwd[len(bwd) // 2],
               finite=bool(torch.isfinite(out).all()
                           and all(torch.isfinite(t).all() for t in grads)))
    ok = (res["finite"] and launches == steps and routes[body] == steps
          and err <= BS_TOL[dt]
          and rel_plain <= BS_GRAD_TOL[dt] and res["fault_caught"]
          and rel_dense <= BS_DENSE_GRAD_TOL[dt])
    if not ok:
        raise AssertionError(f"sparse_attention block route {dt}: {res}")
    return res


def _sddmm_route(torch, np, seed, g):
    """The SDDMM route at S = 1024, H = 12, D = 64, f32: a random pattern
    per head (about 10 % dense, the diagonal always), a key_padding_mask
    and an attn_mask, against the dense f32 recompute (out 1e-4 abs,
    gradients 1e-4 normwise); no block-sparse launch."""
    from paddle_tpu_torch.nn.functional import sparse_attention

    bsa = _bs_mod()
    H, S, D = BIGBIRD_HEADS, SDDMM_SEQ, BIGBIRD_D
    rng = np.random.default_rng(seed + 1)
    pat = rng.random((H, S, S)) < SDDMM_DENSITY
    pat |= np.eye(S, dtype=bool)
    counts = pat.sum(2)
    per_head = counts.sum(1)
    offset = np.concatenate([np.zeros((H, 1), np.int64),
                             np.cumsum(counts, 1)], 1)[None]
    hh, _, cc = np.nonzero(pat)
    start = np.concatenate([[0], np.cumsum(per_head)[:-1]])
    columns = np.zeros((1, H, int(per_head.max())), np.int64)
    columns[0, hh, np.arange(hh.size) - start[hh]] = cc
    kpm = np.where(rng.random((1, S)) < 0.1, -1e4, 0.0).astype(np.float32)
    am = (0.5 * rng.standard_normal((S, S))).astype(np.float32)
    kpm_t, am_t = torch.from_numpy(kpm).cuda(), torch.from_numpy(am).cuda()
    q, k, v, gout = (torch.randn(1, H, S, D, device="cuda", generator=g)
                     for _ in range(4))
    dense, dense_grads = _dense_masked(
        torch, q, k, v, torch.from_numpy(pat).cuda()[None], gout,
        bias=kpm_t[:, None, None, :] + am_t)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = bsa.block_sparse_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sparse_attention(*leaves, torch.from_numpy(offset),
                           torch.from_numpy(columns), key_padding_mask=kpm_t,
                           attn_mask=am_t)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (out * gout).sum().backward()
    torch.cuda.synchronize()
    res = dict(case=f"f32 B=1 H={H} S={S} D={D}, {int(per_head.sum())} "
                    f"pairs ({per_head.sum() / (H * S * S):.4f} dense), "
                    "key_padding_mask and attn_mask",
               max_abs_err_vs_dense=(out - dense).abs().max().item(),
               grad_normwise_vs_dense=max(
                   _normwise(t.grad, d) for t, d in zip(leaves, dense_grads)),
               block_launches=bsa.block_sparse_attention.launches - before,
               fwd_ms=(t1 - t0) * 1e3,
               bwd_ms=(time.perf_counter() - t1) * 1e3)
    if not (res["max_abs_err_vs_dense"] <= 1e-4
            and res["grad_normwise_vs_dense"] <= 1e-4
            and res["block_launches"] == 0):
        raise AssertionError(f"sparse_attention SDDMM route: {res}")
    return res


def _drive_unwired(torch, steps):
    """Rows 3 and 12c, which no model calls in the reference either, each
    driven as a caller would drive it, its count set to 0 before and read
    after: `decode_attention` for `steps` decode steps (pos 4064 on) over
    one llama2_7b layer's contiguous int8 cache at B = 8; and
    `fused_bottleneck2_fwd` as tools/bench_resstage.py runs it, `steps`
    calls at layer3 (N = 128, 14 x 14, C = 256)."""
    from paddle_tpu_torch.ops.decode_attn import decode_attention

    rb = _rb_mod()
    g = torch.Generator(device="cuda").manual_seed(23)
    q, ((kq, ks), (vq, vs)) = _decode_cache(torch, g, DECODE_H, DECODE_H,
                                            DECODE_T - 1, "int8")
    q = q.to(torch.bfloat16)
    decode_attention.launches = 0
    for i in range(steps):
        decode_attention(q, kq, ks, vq, vs, DECODE_T - steps + i)
    torch.cuda.synchronize()
    dec = decode_attention.launches
    del q, kq, ks, vq, vs
    args, _ = _block_inputs(torch, RESNET_BATCH, 14, 256, g)
    a2, _ = _block_inputs(torch, RESNET_BATCH, 14, 256, g)
    pair = rb.fused_bottleneck2_fwd
    pair.launches = pair.calls = 0
    for _ in range(steps):
        pair(args[0], args[1:], a2[1:])
    torch.cuda.synchronize()
    run = {"decode_attention": dec, "fused_bottleneck2_fwd": pair.launches,
           "fused_bottleneck2_fwd_calls": pair.calls}
    if dec != steps or pair.calls != steps or pair.launches < steps:
        raise AssertionError(f"rows 3 and 12c driven {steps} calls each: "
                             f"{run}")
    return run


def sparse_phase(torch, np, args):
    """Phase 8: `nn.functional.sparse_attention` at BigBird-base's width
    (B = 1, H = 12, S = 4096, D = 64) on its ITC pattern from `--seed`,
    through the public op with the CSR a user passes ([1, 12, 5.0M] int32
    columns), in bf16 and f32: the block route (one block-sparse launch a
    forward), forward and backward ms, the output against the dense
    masked f32 recompute, gradients against the plain route and the dense
    recompute, and the planted fault; then the SDDMM route; then
    rows 3 and 12c driven (`_drive_unwired`)."""
    bsa = _bs_mod()
    H, S = BIGBIRD_HEADS, BIGBIRD_SEQ
    nb = S // SPARSE_BLOCK
    steps = 3 if args.quick else 5
    bm = bigbird_blocks(np, nb, args.seed)
    tok, off, cols = block_csr(np, bm, SPARSE_BLOCK)
    offset = torch.from_numpy(off).expand(1, H, -1)
    columns = torch.from_numpy(cols).expand(1, H, -1)
    t0 = time.perf_counter()
    idx, cnt, _ = bsa.csr_to_block_tables(off, cols, S, SPARSE_BLOCK)
    tables_ms = (time.perf_counter() - t0) * 1e3
    tables = (torch.from_numpy(idx).cuda(), torch.from_numpy(cnt).cuda())
    keep = torch.from_numpy(tok).cuda()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    run = {"pattern": dict(blocks=nb, listed_tiles=int(bm.sum()),
                           blocks_per_row=cnt.tolist(),
                           nnz_per_head=int(cols.size),
                           columns_bytes=int(cols.size) * 4 * H),
           "tables_ms": tables_ms}
    for dt in ("bfloat16", "float32"):
        run[dt] = _sparse_route(torch, bsa, dt, offset, columns, tables,
                                keep, g, steps, 5 if args.quick else 20)
        log(f"  sparse_attention block route {json.dumps(run[dt])}")
    run["launches"] = {"block_sparse_attention": run["bfloat16"]["launches"]}
    run["sddmm"] = _sddmm_route(torch, np, args.seed, g)
    log(f"  sparse_attention SDDMM route {json.dumps(run['sddmm'])}")
    run["unwired_launches"] = _drive_unwired(torch, 32)
    log(f"  unwired kernels driven: {run['unwired_launches']}")
    return run


def slice7_kernel_rows(bs_rows, dec_rows, pair_rows, sparse_run,
                       table_cost):
    """The kernels line's entries of rows 11, 3 and 12c. Row 11's launches
    are phase 8's bf16 block route (one a forward); rows 3 and 12c, which
    no model calls, count phase 8's driven runs."""
    bs_main, dec_main = bs_rows[0], dec_rows[0]
    pair_main = next(r for r in pair_rows if r["stage"] == "layer3")
    unwired = sparse_run["unwired_launches"]

    def pick(row, *keys):
        return {k: row[k] for k in keys}

    common = ("ms", "plain_ms", "bound_ms", "bound_by", "case")
    return [
        dict(name="block_sparse_attention", route="cuda",
             source="paddle_tpu_torch/csrc/block_sparse_attention.cu",
             replaces="paddle_tpu/ops/pallas/block_sparse_attention.py:101",
             launches=sparse_run["launches"]["block_sparse_attention"],
             max_abs_err=max(r["max_abs_err"] for r in bs_rows),
             library_ms=bs_main["library_ms"], path=bs_main["route"],
             cuda_kernels=["bs_order", "bs_fwd_sm90"],
             body_source="paddle_tpu_torch/csrc/attention_sm90.cuh",
             device_ms=bs_main["device_ms"], **pick(bs_main, *common)),
        dict(name="decode_attention", route="cuda",
             source="paddle_tpu_torch/csrc/paged_decode_attn.cu",
             replaces="paddle_tpu/ops/pallas/decode_attn.py:50",
             launches=unwired["decode_attention"],
             max_abs_err=max(r["max_abs_err"] for r in dec_rows),
             library_ms=dec_main["library_ms"],
             library_kind=dec_main["library_kind"],
             device_ms=dec_main["device_ms"], path=dec_main["route"],
             cuda_kernels=["paged_decode_ring", "merge_splits"],
             first_body_ms=dec_main["first_body_ms"],
             first_body_device_ms=dec_main["first_body_device_ms"],
             table_cost=table_cost, **pick(dec_main, *common)),
        dict(name="fused_bottleneck2_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/fused_resblock.cu",
             replaces="paddle_tpu/ops/pallas/fused_resblock.py:593",
             launches=unwired["fused_bottleneck2_fwd"],
             max_abs_err=max(r["max_abs_err"] for r in pair_rows),
             library_ms=None, two_12a_ms=pair_main["two_12a_ms"],
             per_op_ms=pair_main["per_op_ms"],
             cuda_kernels=["rb_wg_k41", "rb_wg", "rb_wg_conv", "rb_form",
                           "rb_bn"],
             coupled_device_ms=pair_main["coupled_device_ms"],
             f4_f1_device_ms=pair_main["f4_f1_device_ms"],
             launches_per_call=(unwired["fused_bottleneck2_fwd"]
                                / unwired["fused_bottleneck2_fwd_calls"]),
             **pick(pair_main, *common)),
    ]


# ---------------------------------------------------------------------------
# phase 9: training recipes (schedules, clips, rewinds, AMP O2, GradScaler)
# ---------------------------------------------------------------------------

RECIPE_STEPS = 20
# (b)'s kernels-vs-plain bound on the unscaled gradients' global norm, a
# step (relative): ≈ 3.5x the largest reading on an H100 (2.9e-3, the
# same dropout bits, bf16 rounding apart); an overflow reads inf or NaN
O2_NORM_TOL = 1e-2


def _recipe_engine(torch, layers, clip="global"):
    """Phase 4's gpt_base engine (f32 masters from seed 0, bf16 compute)
    under the pretraining recipe: AdamW at LinearWarmup(CosineAnnealing
    Decay(1e-4, T_max=40), warmup_steps=10, 0 -> 1e-4), clipped by
    ClipGradByGlobalNorm(1.0) (or ClipGradByNorm(1.0), `clip="norm"`).
    Returns (model, scheduler, engine)."""
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    torch.cuda.empty_cache()
    model = gpt("gpt_base", dtype="float32", device="cuda", seed=0,
                num_layers=layers)
    sched = LinearWarmup(CosineAnnealingDecay(1e-4, T_max=40),
                         warmup_steps=10, start_lr=0.0, end_lr=1e-4)
    clip_fn = (ClipGradByGlobalNorm if clip == "global" else
               ClipGradByNorm)(1.0)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                grad_clip=clip_fn)
    return model, sched, parallelize(model, opt, compute_dtype="bfloat16")


def _sched_steps(torch, eng, sched, ids, steps):
    """`steps` train_batch calls, the scheduler stepped by hand after
    each; returns (losses, grad norms) as floats."""
    losses, norms = [], []
    for _ in range(steps):
        losses.append(eng.train_batch(ids))
        norms.append(eng.last_grad_norm)
        sched.step()
    return (torch.stack(losses).float().cpu().tolist(),
            torch.stack(norms).float().cpu().tolist())


def _params_equal(torch, model, ref):
    return all(torch.equal(p, ref[n]) for n, p in model.named_parameters())


def _param_copy(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def gpt_recipe(torch, layers, seed, phase4):
    """(a) gpt_base pretraining under the schedule and the clip: 2 + 20
    micro-steps through `train_batches` (the 20 timed; flash launches set
    to 0 before and read after, all on the Hopper bodies) against 22
    `train_batch` calls with the scheduler stepped by hand, bit for bit;
    a snapshot after step 10 replayed twice over steps 11-15; the
    engine's `state_dict` into a freshly built engine, 5 steps on both,
    bit for bit; 5 steps under ClipGradByNorm(1.0) from the end of the
    warm-up."""
    import math

    from paddle_tpu_torch.models import flops_per_token

    failures = []
    res = {"layers": layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": RECIPE_STEPS}
    # the fused run: train_batches steps the scheduler per micro-step
    model, sched, eng = _recipe_engine(torch, layers)
    ids = _train_batch(torch, model.cfg.vocab_size, TRAIN_BATCH, seed)
    warm = eng.train_batches([(ids,)] * 2)
    warm_norms = eng.last_grad_norms
    torch.cuda.synchronize()
    reset_flash_counts()
    t0 = time.perf_counter()
    losses = eng.train_batches([(ids,)] * RECIPE_STEPS)
    norms = eng.last_grad_norms
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = flash_counts(), flash_route_counts()
    fused = (torch.cat([warm, losses]).float().cpu().tolist(),
             torch.cat([warm_norms, norms]).float().cpu().tolist())
    fused_epoch = sched.last_epoch
    fpt = flops_per_token(model.cfg, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ * RECIPE_STEPS
    res.update(step_ms=wall * 1e3 / RECIPE_STEPS,
               tokens_per_s=tokens / wall,
               mfu=tokens / wall * fpt / BF16_FLOPS,
               losses=fused[0], grad_norms=fused[1], launches=launches,
               routes=routes, lr_last=sched())
    del model, eng
    per_run = layers * RECIPE_STEPS
    if any(n != per_run for n in launches.values()) or any(
            r[FLASH_ROUTE_NAMES[3]] != per_run for r in routes.values()):
        failures.append(f"flash launches {launches} routes {routes}: "
                        f"expected {per_run} each, all on the Hopper body")
    if not all(math.isfinite(x) for x in fused[0] + fused[1]) \
            or not fused[0][-1] < fused[0][0]:
        failures.append(f"recipe did not progress: losses {fused[0]}")

    # the same 2 + 20 steps by hand, with a snapshot after step 10
    model, sched, eng = _recipe_engine(torch, layers)
    first = _sched_steps(torch, eng, sched, ids, 10)
    snap, sched_state = eng.snapshot(), sched.state_dict()
    after = _sched_steps(torch, eng, sched, ids, 5)
    at15 = _param_copy(model)
    rest = _sched_steps(torch, eng, sched, ids, RECIPE_STEPS - 13)
    by_hand = (first[0] + after[0] + rest[0], first[1] + after[1] + rest[1])
    res["hand_stepped_bitwise_equal"] = by_hand == fused
    res["last_epoch"] = {"train_batches": fused_epoch,
                         "by_hand": sched.last_epoch}
    if by_hand != fused or fused_epoch != sched.last_epoch:
        failures.append(f"train_batches {fused} (epoch {fused_epoch}) != "
                        f"hand-stepped train_batch {by_hand} (epoch "
                        f"{sched.last_epoch})")
    replays = []
    for _ in range(2):
        eng.restore(snap)
        sched.set_state_dict(sched_state)
        again = _sched_steps(torch, eng, sched, ids, 5)
        replays.append(again == after and _params_equal(torch, model,
                                                        at15))
    res["restore_replays_bitwise_equal"] = replays
    if not all(replays):
        failures.append(f"snapshot replays bit-equal: {replays}")
    del snap, at15
    # the engine's state into a freshly built engine
    tree_sched = sched.state_dict()
    model2, sched2, eng2 = _recipe_engine(torch, layers)
    eng2.load_state_dict(eng.state_dict())
    sched2.set_state_dict(tree_sched)
    a = _sched_steps(torch, eng, sched, ids, 5)
    b = _sched_steps(torch, eng2, sched2, ids, 5)
    res["state_dict_continues_bitwise"] = (
        a == b and _params_equal(torch, model2, _param_copy(model)))
    if not res["state_dict_continues_bitwise"]:
        failures.append(f"state_dict into a fresh engine: {a} != {b}")
    del model, eng, model2, eng2
    # ClipGradByNorm, from the end of the warm-up: the first steps' rates
    # (0, 1e-5, ...) move the bf16 loss by less than its rounding
    model, sched, eng = _recipe_engine(torch, layers, clip="norm")
    for _ in range(10):
        sched.step()
    cl, cn = _sched_steps(torch, eng, sched, ids, 5)
    res["clip_by_norm"] = {"losses": cl, "grad_norms": cn}
    if not (all(math.isfinite(x) for x in cl + cn) and cl[-1] < cl[0]):
        failures.append(f"ClipGradByNorm run: losses {cl}")
    del model, eng
    if phase4 is not None:
        res["phase4_step_ms"] = phase4["step_ms"]
        res["phase4_tokens_per_s"] = phase4["tokens_per_s"]
        res["schedule_cost_ms"] = res["step_ms"] - phase4["step_ms"]
    log(f"  gpt recipe {json.dumps(res)}")
    if failures:
        raise AssertionError("gpt_base recipe: " + "; ".join(failures))
    return res


def _bert_o2(torch, layers, gseed):
    """bert_base (f32 weights from seed 0, dropout 0.1 from a CUDA
    generator seeded `gseed`), 2 labels, decorated O2 bf16; AdamW with
    weight decay 0.01 on every parameter but the biases and norm weights
    (the 1-D ones: PaddleNLP's fine-tune recipe) under LinearWarmup(
    PolynomialDecay(2e-5, decay_steps=20, end_lr=0), warmup_steps=2,
    0 -> 2e-5); GradScaler at its defaults. Returns (model, scheduler,
    optimizer, scaler)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import bert_for_sequence_classification
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import LinearWarmup, PolynomialDecay

    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(gseed)
    model = bert_for_sequence_classification(
        "bert_base", device="cuda", seed=0, generator=gen, num_labels=2,
        num_hidden_layers=layers)
    amp.decorate(model, level="O2", dtype="bfloat16")
    decay = {n for n, p in model.named_parameters() if p.dim() > 1}
    sched = LinearWarmup(PolynomialDecay(2e-5, decay_steps=20, end_lr=0.0),
                         warmup_steps=2, start_lr=0.0, end_lr=2e-5)
    opt = AdamW(learning_rate=sched, weight_decay=0.01,
                parameters=model.named_parameters(),
                apply_decay_param_fun=lambda n: n in decay)
    return model, sched, opt, amp.GradScaler()


def _o2_steps(torch, model, sched, opt, scaler, batch, steps, norms=None,
              cast=True):
    """The dygraph O2 loop: forward and loss under auto_cast, the scaled
    backward, the scaler's step and update, clear_grad, the schedule.
    With a list `norms`, each step unscales first and appends the global
    L2 norm of the unscaled gradients (f32, on the device) before the
    update. `scaler=None` (backward and the optimizer's step alone) and
    `cast=False` (no auto_cast) are the profile child's variants."""
    import contextlib

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as TF

    losses = []
    for _ in range(steps):
        with (amp.auto_cast(level="O2", dtype="bfloat16") if cast
              else contextlib.nullcontext()):
            loss = TF.cross_entropy(model(batch[0]), batch[1]).mean()
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss).backward()
            if norms is not None:
                scaler.unscale_(opt)
                grads = [p.grad for p in model.parameters()
                         if p.grad is not None]
                norms.append(torch.linalg.vector_norm(torch.stack(
                    torch._foreach_norm(grads, 2, dtype=torch.float32))))
            scaler.step(opt)
            scaler.update()
        opt.clear_grad()
        sched.step()
        losses.append(loss.detach())
    return torch.stack(losses).float().cpu().tolist()


def bert_o2_recipe(torch, np, layers, seed, phase5):
    """(b) BASELINE config 2, BERT-base fine-tune under AMP O2, as a
    dygraph loop: 20 steps after 2 warm-up steps (timed; short-attention
    launches set to 0 before and read after, every one on its Hopper
    body), falling finite losses, every step taken (the optimizer's step
    count) at the initial scale; 3 steps through the kernels twice (bit
    for bit, losses and gradient norms) and through the plain composed
    route (every step taken at the initial scale in each; loss within
    1e-2, the unscaled gradients' global norm within O2_NORM_TOL, so the
    backward kernels, fed the scaled dO, are held to the plain route);
    a step whose gradient a hook makes inf is skipped with the
    parameters bit-equal and the scale halved."""
    import math

    from paddle_tpu_torch.models.bert import n_matmul_params
    from paddle_tpu_torch.nn.functional import attention

    failures = []
    model, sched, opt, scaler = _bert_o2(torch, layers, seed + 1)
    scale0 = scaler.get_init_loss_scaling()
    batch = _bert_batch(torch, np, model.cfg.vocab_size, seed)
    _o2_steps(torch, model, sched, opt, scaler, batch, 2)
    torch.cuda.synchronize()
    reset_short_counts()
    reset_flash_counts()
    t0 = time.perf_counter()
    losses = _o2_steps(torch, model, sched, opt, scaler, batch,
                       RECIPE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**short_counts(), **flash_counts()}
    fwd_routes, bwd_routes = short_route_counts(), short_bwd_route_counts()
    seqs = BERT_BATCH * RECIPE_STEPS / wall
    n_matmul = n_matmul_params(model.cfg)
    res = {"layers": layers, "batch": BERT_BATCH, "seq": BERT_SEQ,
           "steps": RECIPE_STEPS, "step_ms": wall * 1e3 / RECIPE_STEPS,
           "sequences_per_s": seqs,
           "mfu": seqs * 6.0 * n_matmul * BERT_SEQ / BF16_FLOPS,
           "losses": losses, "launches": launches,
           "fwd_routes": fwd_routes, "bwd_routes": bwd_routes,
           "loss_scale": scaler.get_init_loss_scaling(),
           "optimizer_steps": opt._step_count,
           "param_dtypes": sorted({str(p.dtype)
                                   for p in model.parameters()}),
           "moment_dtype": str(opt.state_dict()["moment1_0"].dtype)}
    per_run = layers * RECIPE_STEPS
    if (launches["short_attention_fwd"] != per_run
            or launches["short_attention_bwd"] != 2 * per_run
            or fwd_routes[SHORT_ROUTE_NAMES[3]] != per_run
            or bwd_routes[SHORT_BWD_ROUTE_NAMES[1]] != 2 * per_run
            or any(launches[k] for k in flash_counts())):
        failures.append(f"launches {launches}, routes {fwd_routes} / "
                        f"{bwd_routes}: expected {per_run} forward and "
                        f"{2 * per_run} backward launches on the Hopper "
                        f"bodies")
    if not (all(math.isfinite(x) for x in losses)
            and sum(losses[-5:]) < sum(losses[:5])):
        failures.append(f"O2 losses not finite and falling: {losses}")
    # a skipped step would leave the losses to dropout's noise
    if (opt._step_count != 2 + RECIPE_STEPS
            or scaler.get_init_loss_scaling() != scale0):
        failures.append(f"O2 steps taken {opt._step_count} of "
                        f"{2 + RECIPE_STEPS}, scale "
                        f"{scaler.get_init_loss_scaling()} (was {scale0})")
    # a planted inf: the step is skipped and the scale halves
    scale = scaler.get_init_loss_scaling()
    before = _param_copy(model)
    w = model.classifier.weight
    hook = w.register_hook(lambda g: g.index_fill(0, g.new_tensor(
        [0], dtype=torch.long), float("inf")))
    step_count = opt._step_count
    try:
        _o2_steps(torch, model, sched, opt, scaler, batch, 1)
    finally:
        hook.remove()
    res["inf_step"] = {
        "skipped_params_bitwise_equal": _params_equal(torch, model, before),
        "scale_before": scale, "scale_after": scaler.get_init_loss_scaling(),
        "optimizer_step_unchanged": opt._step_count == step_count}
    if not (res["inf_step"]["skipped_params_bitwise_equal"]
            and res["inf_step"]["scale_after"] == scale / 2
            and res["inf_step"]["optimizer_step_unchanged"]):
        failures.append(f"planted inf step: {res['inf_step']}")
    del model, opt, before
    # parity: kernels, kernels again, plain composed route
    supported = attention.short_attention_supported
    runs = {}
    for route in ("kernels", "kernels again", "plain"):
        if route == "plain":
            attention.short_attention_supported = lambda *a: False
        try:
            model, sched, opt, scaler = _bert_o2(torch, layers, seed + 2)
            reset_short_counts()
            norms = []
            losses = _o2_steps(torch, model, sched, opt, scaler, batch, 3,
                               norms)
            runs[route] = {"losses": losses,
                           "grad_norms": torch.stack(norms).cpu().tolist(),
                           "launches": short_counts(),
                           "optimizer_steps": opt._step_count,
                           "loss_scale": scaler.get_init_loss_scaling()}
        finally:
            attention.short_attention_supported = supported
        del model, opt
        if (runs[route]["optimizer_steps"] != 3
                or runs[route]["loss_scale"] != scale0):
            failures.append(f"O2 parity run '{route}': steps taken "
                            f"{runs[route]['optimizer_steps']} of 3, scale "
                            f"{runs[route]['loss_scale']} (was {scale0})")
    k, p = runs["kernels"], runs["plain"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"]))
    norm_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(k["grad_norms"], p["grad_norms"]))
    again = runs["kernels again"]
    res["parity"] = {"runs": runs, "loss_max_rel_err": rel,
                     "grad_norm_max_rel_err": norm_rel,
                     "rerun_bitwise_equal":
                         k["losses"] == again["losses"]
                         and k["grad_norms"] == again["grad_norms"]}
    if rel > 1e-2:
        failures.append(f"O2 kernels vs plain: loss rel err {rel} (tol "
                        f"1e-2)")
    if not norm_rel <= O2_NORM_TOL:
        failures.append(f"O2 kernels vs plain: gradient norm rel err "
                        f"{norm_rel} (tol {O2_NORM_TOL})")
    if not res["parity"]["rerun_bitwise_equal"]:
        failures.append("O2 kernel rerun not bit-equal")
    if min(k["launches"].values()) == 0 or any(p["launches"].values()):
        failures.append(f"O2 routing: kernels {k['launches']}, plain "
                        f"{p['launches']}")
    if phase5 is not None:
        res["phase5_step_ms"] = phase5["step_ms"]
        res["phase5_sequences_per_s"] = phase5["sequences_per_s"]
        res["phase5_mfu"] = phase5["mfu"]
    log(f"  bert O2 {json.dumps(res)}")
    if failures:
        raise AssertionError("BERT O2 recipe: " + "; ".join(failures))
    return res


def profile_bert_o2(torch, np, layers, seed, steps=3, timed=10):
    """In a child process of its own (`--profile-bert-o2`, run when phase 9
    is given `--o2-profile`): phase 5's bf16 engine and (b)'s O2 loop in
    three forms on the same batch: whole ("o2"), without the GradScaler
    (backward and the optimizer's step: no unscale, no finite check, no
    host read; "o2_no_scaler") and without auto_cast (the decorated bf16
    model and the scaler, no policy mode or casts; "o2_no_autocast").
    Each is timed over `timed` steps after 2 warm-up steps (host clock,
    synchronized) in the order engine, o2, o2_no_scaler, o2_no_autocast,
    then backwards, and then run `steps` steps under torch.profiler:
    device busy ms and launches a step (kernel time by family for
    "o2"). The step's excess over its busy time is its host share."""
    from torch.profiler import ProfilerActivity, profile

    def timed_ms(run):
        run(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(timed)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / timed

    model, eng = _bert_engine(torch, layers, gseed=seed + 1)
    batch = _bert_batch(torch, np, model.cfg.vocab_size, seed)
    m, sched, opt, scaler = _bert_o2(torch, layers, seed + 1)
    runs = {
        "engine": lambda n: _bert_steps(torch, eng, batch, n),
        "o2": lambda n: _o2_steps(torch, m, sched, opt, scaler, batch, n),
        "o2_no_scaler": lambda n: _o2_steps(torch, m, sched, opt, None,
                                            batch, n),
        "o2_no_autocast": lambda n: _o2_steps(torch, m, sched, opt, scaler,
                                              batch, n, cast=False)}
    order = list(runs) + list(runs)[::-1]
    times = {name: [] for name in runs}
    for name in order:
        times[name].append(timed_ms(runs[name]))
    res = {"layers": layers, "timed_steps": timed, "order": order,
           "step_ms": times, "profiled_steps": steps, "profiled": {}}
    for name, run in runs.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(steps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        fam = kernel_families(prof, (
            ("short_attention", ("sa_fwd", "sa_dq", "sa_dkv")),
            ("gemm", GEMM_NAMES),
            ("optimizer", ("foreach", "multi_tensor")),
            ("elementwise", ("elementwise",))))
        busy = sum(fam.values()) / 1e3 / steps
        res["profiled"][name] = {
            "step_ms": wall_ms / steps, "device_busy_ms_per_step": busy,
            "device_launches_per_step": sum(
                e.count for e in device_events(prof)) / steps,
            "kernel_ms_per_step": {k: v / 1e3 / steps
                                   for k, v in fam.items()}}
        if name == "o2":
            res["profiled"][name]["top_kernels_ms_per_step"] = top_kernels(
                prof, steps)
    return res


FP16_PLANTED = (3, 4)              # the steps whose loss is made to overflow


def fp16_scaler(torch):
    """(c) GradScaler in fp16 on the card: a 1024-4096-1024 MLP decorated
    O2 fp16, SGD, GradScaler(2**16, incr_every_n_steps=2), 10 steps under
    auto_cast O2 fp16. On FP16_PLANTED steps the loss is multiplied by
    1e6 before scaling, so the fp16 gradients overflow: those steps must
    be skipped (parameters bit-equal) and the scale must halve on each,
    then double after every two good steps."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import SGD

    g = torch.Generator(device="cuda").manual_seed(0)
    mlp = torch.nn.Sequential(torch.nn.Linear(1024, 4096), torch.nn.GELU(),
                              torch.nn.Linear(4096, 1024)).cuda()
    amp.decorate(mlp, level="O2", dtype="float16")
    opt = SGD(learning_rate=1e-2, parameters=mlp.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 16,
                            incr_every_n_steps=2)
    x = torch.randn(256, 1024, generator=g, device="cuda")
    y = torch.randn(256, 1024, generator=g, device="cuda")
    scales, skipped_equal, losses = [], [], []
    for i in range(10):
        before = [p.detach().clone() for p in mlp.parameters()]
        with amp.auto_cast(level="O2", dtype="float16"):
            loss = torch.nn.functional.mse_loss(mlp(x), y)
        planted = loss * 1e6 if i in FP16_PLANTED else loss
        scaler.scale(planted).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        scales.append(scaler.get_init_loss_scaling())
        losses.append(float(loss.detach()))
        if i in FP16_PLANTED:
            skipped_equal.append(all(torch.equal(p, q) for p, q in
                                     zip(mlp.parameters(), before)))
    want, s, good = [], 2.0 ** 16, 0
    for i in range(10):
        if i in FP16_PLANTED:
            s, good = max(s / 2, 1.0), 0
        else:
            good += 1
            if good == 2:
                s, good = s * 2, 0
        want.append(s)
    res = {"scales": scales, "expected": want, "losses": losses,
           "skipped_params_bitwise_equal": skipped_equal,
           "optimizer_steps": opt._step_count,
           "param_dtype": str(next(mlp.parameters()).dtype)}
    log(f"  fp16 scaler {json.dumps(res)}")
    if (scales != want or not all(skipped_equal)
            or opt._step_count != 10 - len(FP16_PLANTED)):
        raise AssertionError(f"fp16 GradScaler: {res}")
    return res


def recipes_phase(torch, np, args, phase4=None, phase5=None):
    """Phase 9: (a) gpt_base pretraining recipe, (b) BERT-base O2
    fine-tune, (c) the fp16 GradScaler; with `--o2-profile`, then (b)'s
    loop and its variants beside phase 5's engine and under
    torch.profiler in a child process."""
    layers = 2 if args.quick else 12
    t0 = time.perf_counter()
    res = {"gpt": gpt_recipe(torch, layers, args.seed, phase4),
           "bert_o2": bert_o2_recipe(torch, np, layers, args.seed, phase5),
           "fp16_scaler": fp16_scaler(torch)}
    if args.o2_profile:
        res["bert_o2_profile"] = run_child("--profile-bert-o2", layers,
                                           args.seed, args.report)
        log(f"  bert O2 profile {json.dumps(res['bert_o2_profile'])}")
    res["seconds"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# phase 10: LoRA fine-tuning and inference (BASELINE config 5)
# ---------------------------------------------------------------------------

# (a): one fixed [4, 1024] batch, 2 warm-up and 20 timed steps
LORA_BATCH, LORA_SEQ, LORA_STEPS = 4, 1024, 20
LORA_CFG = dict(r=8, lora_alpha=16, target_modules=("qkv", "out"))
# (b), (c): bench.py's bench_lora_decode shape (bs 8, a 16-token prompt,
# 128 new tokens)
LORA_GEN_BATCH, LORA_PROMPT, LORA_NEW = 8, 16, 128
LORA_SAMPLED = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9)
# (b)'s sampled rerun and other seed: the first tokens of the stream (a
# draw is causal, so they are the first tokens of a longer run's)
LORA_SAMPLED_RERUN = 32
# logits of two bf16 routes of the same weights (merged against unmerged,
# the first new token and every position teacher-forced; (c)'s engine
# against (b)'s unmerged run, the first new token): max abs error, 3x the
# largest read on an H100 (0.67, merged teacher-forced over 8 x 128
# positions; phase 3's dense check allows 3x the bf16 forward's distance
# from f32: 0.91 at llama2_7b's first decode step on an H100)
LORA_LOGITS_TOL = 2.0
# a near-tie: a step whose top-2 logit gap in (b)'s unmerged run is under
# this, where two bf16 routes may pick either token (a gap moves by up to
# twice the logits' error; bf16 logits of ~8 are 0.03-0.06 apart)
LORA_TIE = 0.5


def _lora_model(torch, layers, seed):
    """llama2_7b at full width (bf16 weights from seed 0) with r = 8
    adapters on qkv_proj and out_proj, A drawn from a CUDA generator
    seeded `seed`."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn.lora import LoRAConfig, apply_lora

    torch.cuda.empty_cache()
    model = gpt("llama2_7b", dtype="bfloat16", device="cuda", seed=0,
                num_layers=layers)
    apply_lora(model, LoRAConfig(**LORA_CFG),
               generator=torch.Generator(device="cuda").manual_seed(seed))
    return model


def _lora_engine(torch, model):
    """AdamW over the adapters at LinearWarmup(CosineAnnealingDecay(3e-4,
    T_max=22), 4 steps from 0), ClipGradByGlobalNorm(1.0), bf16 compute.
    Returns (scheduler, engine)."""
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.lora import lora_parameters
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    sched = LinearWarmup(CosineAnnealingDecay(3e-4, T_max=22),
                         warmup_steps=4, start_lr=0.0, end_lr=3e-4)
    opt = AdamW(learning_rate=sched, parameters=lora_parameters(model),
                grad_clip=ClipGradByGlobalNorm(1.0))
    return sched, parallelize(model, opt, compute_dtype="bfloat16")


def lora_flops_per_token(torch, model, seq):
    """Training FLOPs a token of a LoRA model: 4 N over the frozen
    Linears (forward and the input gradient; lm_head included, the
    embedding lookup not), 6 N over the adapters (forward, input and
    weight gradients) and `flops_per_token`'s attention term 12 L h S."""
    from paddle_tpu_torch.nn.lora import lora_parameters

    frozen = sum(m.weight.numel() for m in model.modules()
                 if isinstance(m, torch.nn.Linear))
    adapters = sum(p.numel() for p in lora_parameters(model))
    cfg = model.cfg
    return (4.0 * frozen + 6.0 * adapters
            + 12.0 * cfg.num_layers * cfg.hidden_size * seq)


def _lora_run(torch, eng, ids, steps):
    """`steps` micro-steps through `train_batches` (the scheduler stepped
    a micro-step); (losses, grad norms) as floats."""
    losses = eng.train_batches([(ids,)] * steps)
    return (losses.float().cpu().tolist(),
            eng.last_grad_norms.float().cpu().tolist())


def lora_parity(torch, seed, steps=3):
    """2 layers at full width, 3 steps on one [4, 1024] batch through the
    flash kernels and through the plain attention (the routing predicate
    patched to admit no shape): loss within 1e-2 and the adapters'
    pre-clip grad norm within 5e-2, relative (phase 4's bounds)."""
    from paddle_tpu_torch.nn.functional import attention

    supported = attention.flash_attention_supported
    runs = {}
    for route in ("kernels", "plain"):
        if route == "plain":
            attention.flash_attention_supported = lambda shape, causal: False
        try:
            model = _lora_model(torch, 2, seed)
            _, eng = _lora_engine(torch, model)
            ids = _train_batch(torch, model.cfg.vocab_size, LORA_BATCH,
                               seed + 1)[:, :LORA_SEQ]
            reset_flash_counts()
            losses, norms = _lora_run(torch, eng, ids, steps)
            runs[route] = {"losses": losses, "grad_norms": norms,
                           "launches": flash_counts()}
        finally:
            attention.flash_attention_supported = supported
        del model, eng
    k, p = runs["kernels"], runs["plain"]
    res = {"layers": 2, "steps": steps, "runs": runs,
           "loss_max_rel_err": max(abs(a - b) / abs(b) for a, b in
                                   zip(k["losses"], p["losses"])),
           "grad_norm_max_rel_err": max(abs(a - b) / abs(b) for a, b in
                                        zip(k["grad_norms"],
                                            p["grad_norms"]))}
    log(f"  lora parity {json.dumps(res)}")
    if not (res["loss_max_rel_err"] <= 1e-2
            and res["grad_norm_max_rel_err"] <= 5e-2):
        raise AssertionError(f"LoRA kernels vs plain: {res}")
    if min(k["launches"].values()) == 0 or any(p["launches"].values()):
        raise AssertionError(f"routing: kernel run {k['launches']}, plain "
                             f"run {p['launches']}")
    return res


def lora_finetune(torch, layers, seed):
    """(a) 2 warm-up and 20 timed steps of the LoRA fine-tune on one fixed
    [4, 1024] batch from `seed`: step ms, tokens/s, MFU over
    `lora_flops_per_token`, peak memory, the loss trajectory (must
    fall), flash launches set to 0 before the timed steps and read after
    (every one on its Hopper body), and every adapter moved. Returns
    (model, result, exported adapters)."""
    import math

    from paddle_tpu_torch.nn.lora import export_lora_weights, lora_parameters

    model = _lora_model(torch, layers, seed)
    start = [p.detach().clone() for p in lora_parameters(model)]
    sched, eng = _lora_engine(torch, model)
    ids = _train_batch(torch, model.cfg.vocab_size, LORA_BATCH,
                       seed)[:, :LORA_SEQ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = _lora_run(torch, eng, ids, 2)
    torch.cuda.synchronize()
    reset_flash_counts()
    t0 = time.perf_counter()
    losses, norms = _lora_run(torch, eng, ids, LORA_STEPS)
    wall = time.perf_counter() - t0
    launches, routes = flash_counts(), flash_route_counts()
    losses, norms = warm[0] + losses, warm[1] + norms
    fpt = lora_flops_per_token(torch, model, LORA_SEQ)
    tokens = LORA_BATCH * LORA_SEQ * LORA_STEPS
    moved = sum(not torch.equal(a, p.detach())
                for a, p in zip(start, lora_parameters(model)))
    res = {"layers": layers, "batch": LORA_BATCH, "seq": LORA_SEQ,
           "steps": LORA_STEPS, "step_ms": wall * 1e3 / LORA_STEPS,
           "tokens_per_s": tokens / wall,
           "mfu": tokens / wall * fpt / BF16_FLOPS,
           "flops_per_token": fpt,
           "ideal_step_ms": LORA_BATCH * LORA_SEQ * fpt / BF16_FLOPS * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "grad_norms": norms, "lr_last": sched(),
           "launches": launches, "routes": routes,
           "adapters": len(start), "adapters_moved": moved,
           "adapter_params": sum(a.numel() for a in start)}
    weights = export_lora_weights(model)
    del eng, start
    log(f"  lora fine-tune {json.dumps(res)}")
    fails = []
    per_run = layers * LORA_STEPS
    if any(n != per_run for n in launches.values()) or any(
            r.get(FLASH_ROUTE_NAMES[3]) != per_run for r in routes.values()):
        fails.append(f"flash launches {launches} routes {routes}: expected "
                     f"{per_run} each, all on the Hopper body")
    if not all(math.isfinite(x) for x in losses + norms) \
            or not losses[-1] < losses[0]:
        fails.append(f"fine-tune did not progress: losses {losses}")
    if moved != res["adapters"]:
        fails.append(f"{moved} of {res['adapters']} adapters moved")
    if fails:
        raise AssertionError("LoRA fine-tune: " + "; ".join(fails))
    return model, res, weights


def _base_unchanged(torch, model, base):
    """Every frozen tensor of the trained LoRA `model` bit-equal to the
    same tensor of `base`, a fresh build of the same seed without
    wrappers (``...qkv_proj.base.weight`` is ``...qkv_proj.weight``)."""
    own = dict(base.named_parameters())
    frozen = [(n, p) for n, p in model.named_parameters()
              if not p.requires_grad]
    equal = sum(bool(torch.equal(p, own[n.replace(".base.", ".")]))
                for n, p in frozen)
    return {"base_tensors": len(frozen), "base_bit_unchanged": equal,
            "base_params": sum(p.numel() for _, p in frozen)}


def _recording(model):
    """Record the next-token logits (f32) of every `decode_step` of
    `model` into the returned list; `del model.decode_step` stops it."""
    rec, step = [], model.decode_step

    def recorded(ids, caches, pos):
        logits, caches = step(ids, caches, pos)
        rec.append(logits[:, -1].float())
        return logits, caches

    model.decode_step = recorded
    return rec


def _top2_gaps(torch, rec):
    """[steps, B] top-2 logit gaps of recorded next-token logits."""
    top = torch.topk(torch.stack(rec), 2, dim=-1).values      # [n, B, 2]
    return (top[..., 0] - top[..., 1]).cpu()


def _first_ties(gap):
    """Per sequence, the first new token whose logits' top-2 gap is under
    LORA_TIE (the length when none is)."""
    tie = gap < LORA_TIE
    return [int(tie[:, b].nonzero()[0]) if tie[:, b].any() else len(gap)
            for b in range(gap.shape[1])]


def _agree_to_tie(new, ref, ties):
    """Whether each sequence of `new` equals `ref` up to its first
    near-tie; the tokens that check covers; and each sequence's first
    token that differs (its length when none does)."""
    ok = all(new[b][:t] == ref[b][:t] for b, t in enumerate(ties))
    first = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                  len(a)) for a, b in zip(new, ref)]
    return ok, sum(ties), first


def _forced_logits(torch, model, prompts, tokens):
    """f32 next-token logits of each new token of `tokens` [B, n] after
    `prompts` [B, s], from one forward over the whole sequence (teacher
    forcing): [B, n, V]."""
    full = torch.cat([torch.as_tensor(prompts),
                      torch.as_tensor(tokens)], 1)[:, :-1]
    with torch.no_grad():
        logits = model(full.to(model.device))
    return logits[:, prompts.shape[1] - 1:].float()


def lora_inference(torch, np, model, seed):
    """(b) `generate` with the adapters live, on bench_lora_decode's shape:
    greedy on the unmerged model (tokens/s; its logits recorded), sampled
    (tokens/s; a rerun bit-equal, another seed different), merged (tokens
    equal the unmerged ones up to the first near-tie, the first token's
    logits within LORA_LOGITS_TOL of the unmerged; and, teacher-forced on
    the unmerged tokens in one forward each, every position's logits
    within LORA_LOGITS_TOL and the same argmax wherever the unmerged
    top-2 gap is at least LORA_TIE), then int8
    weights under the live adapters (weight-only launches counted: every
    prefill launch on the wgmma GEMM, every decode launch on the decode
    GEMV). The trained f32 adapters are cast to the base's bf16 first: a
    bf16 Linear does not take the f32 activations the f32 adapters would
    promote to. Returns (result, prompts, unmerged tokens, near-ties,
    first-token logits)."""
    from paddle_tpu_torch.models import GenerationConfig, generate
    from paddle_tpu_torch.nn.lora import LoRALinear, merge_lora
    from paddle_tpu_torch.nn.quant import quantize_for_inference
    from paddle_tpu_torch.ops.weight_only import (ROUTE_DECODE,
                                                  ROUTE_PREFILL,
                                                  weight_only_matmul)

    model.to(torch.bfloat16)
    model.eval()
    prompts = np.random.RandomState(seed).randint(
        0, 256, (LORA_GEN_BATCH, LORA_PROMPT)).astype(np.int64)
    greedy = GenerationConfig(max_new_tokens=LORA_NEW)

    def run(cfg=greedy, record=False):
        rec = _recording(model) if record else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(model, prompts, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if record:
            del model.decode_step
        return out[:, LORA_PROMPT:].cpu().tolist(), wall, rec

    res = {"batch": LORA_GEN_BATCH, "prompt": LORA_PROMPT,
           "new_tokens": LORA_NEW}
    ref, wall, rec = run(record=True)
    gap = _top2_gaps(torch, rec)
    ties = _first_ties(gap)
    res.update(unmerged_tokens_per_s=LORA_GEN_BATCH * LORA_NEW / wall,
               unmerged_wall_s=wall, first_near_tie=ties,
               min_top2_gap=float(gap.min()),
               median_top2_gap=float(gap.median()))
    first_logits = rec[0].cpu()
    del rec
    fails = []
    forced = _forced_logits(torch, model, prompts, ref)
    sampled = [run(GenerationConfig(max_new_tokens=n, seed=s,
                                    **LORA_SAMPLED))
               for n, s in ((LORA_NEW, seed), (LORA_SAMPLED_RERUN, seed),
                            (LORA_SAMPLED_RERUN, seed + 1))]
    head = [o[:LORA_SAMPLED_RERUN] for o in sampled[0][0]]
    res.update(sampled_tokens_per_s=LORA_GEN_BATCH * LORA_NEW
               / sampled[0][1],
               sampled_rerun_equal=head == sampled[1][0],
               sampled_other_seed_differs=head != sampled[2][0])
    if not res["sampled_rerun_equal"] or \
            not res["sampled_other_seed_differs"]:
        fails.append("sampled: rerun equal "
                     f"{res['sampled_rerun_equal']}, another seed differs "
                     f"{res['sampled_other_seed_differs']}")
    merge_lora(model)
    fm = _forced_logits(torch, model, prompts, ref)
    top = torch.topk(forced, 2, dim=-1).values
    decided = (top[..., 0] - top[..., 1]) >= LORA_TIE
    flips = int((decided & (fm.argmax(-1) != forced.argmax(-1))).sum())
    ferr = float((fm - forced).abs().max())
    res.update(forced_decisions_checked=int(decided.sum()),
               forced_decisions_flipped=flips,
               forced_logits_max_abs_err=ferr,
               forced_logits_mean_abs_err=float((fm - forced).abs().mean()))
    del fm, forced, top
    if flips or not ferr <= LORA_LOGITS_TOL:
        fails.append(f"merged, teacher-forced: {flips} decisions flipped, "
                     f"logits max abs err {ferr} (tol {LORA_LOGITS_TOL})")
    merged, wall, mrec = run(record=True)
    ok, covered, first_diff = _agree_to_tie(merged, ref, ties)
    err = float((mrec[0].cpu() - first_logits).abs().max())
    res.update(merged_tokens_per_s=LORA_GEN_BATCH * LORA_NEW / wall,
               merged_equal_to_near_tie=ok, merged_tokens_gated=covered,
               merged_first_difference=first_diff,
               merged_sequences_equal=sum(a == b for a, b in zip(merged,
                                                                 ref)),
               merged_first_logits_max_abs_err=err)
    del mrec
    if not ok:
        fails.append(f"merged tokens differ before a near-tie: first "
                     f"differences {first_diff}, near-ties at {ties}")
    if not err <= LORA_LOGITS_TOL:
        fails.append(f"merged first-token logits max abs err {err} > "
                     f"{LORA_LOGITS_TOL}")
    for m in model.modules():
        if isinstance(m, LoRALinear):
            m.unmerge()
    quantize_for_inference(model, "int8")
    torch.cuda.empty_cache()
    weight_only_matmul.launches = 0
    zero_routes(weight_only_matmul)
    int8, wall, _ = run()
    routes = {WO_ROUTE_NAMES[r]: c
              for r, c in weight_only_matmul.routes.items()}
    linears = 4 * model.cfg.num_layers + 1
    want = {WO_ROUTE_NAMES[ROUTE_PREFILL]: linears,
            WO_ROUTE_NAMES[ROUTE_DECODE]: linears * (LORA_NEW - 1)}
    res.update(int8_tokens_per_s=LORA_GEN_BATCH * LORA_NEW / wall,
               int8_launches=weight_only_matmul.launches,
               int8_routes=routes,
               int8_sequences_equal_bf16=sum(a == b for a, b in zip(int8,
                                                                    ref)),
               int8_tokens_equal_bf16=sum(x == y for a, b in zip(int8, ref)
                                          for x, y in zip(a, b)))
    if {k: v for k, v in routes.items() if v} != want:
        fails.append(f"int8 weight-only launches by route {routes}, "
                     f"expected {want}")
    if any(len(o) != LORA_NEW or not all(0 <= t < model.cfg.vocab_size
                                         for t in o)
           for o in ref + merged + int8 + sampled[0][0]) \
            or any(len(o) != LORA_SAMPLED_RERUN
                   for o in sampled[1][0] + sampled[2][0]):
        fails.append("malformed token output")
    log(f"  lora inference {json.dumps(res)}")
    if fails:
        raise AssertionError("LoRA inference: " + "; ".join(fails))
    return res, prompts, ref, ties, first_logits


def lora_serve(torch, np, base, weights, prompts, ref, ties, first_logits):
    """(c) the exported adapter loaded into an `AdapterPool` (rank 8,
    alpha 16, qkv_proj and out_proj) over `base`, the same base weights
    without wrappers (a fresh build from the seed), served by a
    `DecodeEngine` on CUDA graphs: (b)'s prompts as the tenant's
    requests, alternating with the same prompts without the adapter.
    Gates: the tenant's greedy tokens equal (b)'s unmerged tokens up to
    the first near-tie, its first-token logits within LORA_LOGITS_TOL of
    (b)'s, every BGMV launch on the cluster body, every paged launch on
    the ring body, every GEMV launch on the tensor-core body, replays
    equal steps, the block pool conserved."""
    from paddle_tpu_torch.inference import AdapterPool, DecodeEngine
    from paddle_tpu_torch.ops.bgmv import lora_delta
    from paddle_tpu_torch.ops.decode_attn import paged_decode_attention
    from paddle_tpu_torch.ops.weight_only import row_gemv

    pool = AdapterPool(base, rank=LORA_CFG["r"], slots=2,
                       alpha=LORA_CFG["lora_alpha"], device=base.device)
    pool.load("tuned", weights)
    wrappers = (lora_delta, paged_decode_attention, row_gemv)
    try:
        eng = DecodeEngine(base, max_length=256, block_size=16,
                           decode_buckets=(1, 2, 4, 8), default_timeout=600.0,
                           adapters=pool, device=base.device)
        t0 = time.perf_counter()
        eng.warmup()
        warmup_s = time.perf_counter() - t0
        eng.generate(prompts[0][:8], 2, adapter="tuned")     # warm-up
        step_ms = time_steps(eng)
        for w in wrappers:
            w.launches = 0
            zero_routes(w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = []
        for p in prompts:
            streams.append(eng.submit(p, LORA_NEW, adapter="tuned",
                                      keep_logits=1))
            streams.append(eng.submit(p, LORA_NEW))
        outs = [s.result() for s in streams]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        routes = {"bgmv": {BGMV_ROUTE_NAMES[r]: c
                           for r, c in lora_delta.routes.items()},
                  "paged": {PAGED_ROUTE_NAMES[r]: c for r, c in
                            paged_decode_attention.routes.items()},
                  "gemv": {ROW_ROUTE_NAMES[r]: c
                           for r, c in row_gemv.routes.items()}}
        st = eng.stats()
        drained = eng.shutdown()
        blocks = eng.stats()["blocks"]
        refs = pool.stats()["refs"]
    finally:
        pool.detach()
    tenant, plain = outs[0::2], outs[1::2]
    ok, covered, first_diff = _agree_to_tie(tenant, ref, ties)
    logits = torch.stack([streams[i].logits[0] for i in
                          range(0, len(streams), 2)])
    err = float((logits - first_logits).abs().max())
    res = {"requests": len(streams), "tokens": sum(map(len, outs)),
           "wall_s": wall, "tokens_per_s": sum(map(len, outs)) / wall,
           "warmup_s": warmup_s, "steps": st["steps"],
           "launches": launches, "routes": routes,
           "tenant_equal_to_near_tie": ok, "tenant_tokens_gated": covered,
           "tenant_first_difference": first_diff,
           "tenant_sequences_equal_unmerged": sum(
               a == b for a, b in zip(tenant, ref)),
           "adapter_free_sequences_equal_tenant": sum(
               a == b for a, b in zip(plain, tenant)),
           "first_logits_max_abs_err": err,
           "first_logits_tol": LORA_LOGITS_TOL, "adapter_refs_after": refs,
           **programs(st, step_ms),
           "blocks_after_shutdown": {k: blocks[k] for k in (
               "total", "allocated", "free", "reserved", "allocs",
               "frees")}}
    log(f"  lora serve {json.dumps(res)}")
    graph_gate("phase 10 (c)", res)
    fails = []
    if not ok:
        fails.append(f"tenant tokens differ from (b)'s before a near-tie: "
                     f"first differences {first_diff}, near-ties at {ties}")
    if not err <= LORA_LOGITS_TOL:
        fails.append(f"first-token logits max abs err {err} > "
                     f"{LORA_LOGITS_TOL}")
    for name, body in (("bgmv", BGMV_ROUTE_NAMES[1]),
                       ("paged", PAGED_ROUTE_NAMES[1]),
                       ("gemv", ROW_ROUTE_NAMES[1])):
        n = sum(routes[name].values())
        if n == 0 or routes[name].get(body) != n:
            fails.append(f"{name} launches by body {routes[name]}: "
                         f"expected all on {body}")
    if refs != 0 or not drained or blocks["allocated"] != 0 \
            or blocks["allocs"] != blocks["frees"] \
            or blocks["allocated"] + blocks["free"] + blocks["reserved"] \
            != blocks["total"]:
        fails.append(f"conservation: adapter refs {refs}, blocks {blocks}")
    if any(len(o) != LORA_NEW for o in outs):
        fails.append("malformed token output")
    if fails:
        raise AssertionError("LoRA serving: " + "; ".join(fails))
    return res


def lora_phase(torch, np, args):
    """Phase 10: the LoRA parity run, then (a) the fine-tune, the base
    checked against a fresh build of the seed, (b) inference with the
    adapters live on the trained model, (c) the exported adapter served
    over the fresh build. Frees its models before it returns."""
    from paddle_tpu_torch.models import gpt

    layers = 2 if args.quick else 32
    t0 = time.perf_counter()
    res = {"parity": lora_parity(torch, args.seed)}
    model, res["finetune"], weights = lora_finetune(torch, layers, args.seed)
    torch.cuda.empty_cache()
    base = gpt("llama2_7b", dtype="bfloat16", device="cuda", seed=0,
               num_layers=layers)
    res["finetune"].update(_base_unchanged(torch, model, base))
    if res["finetune"]["base_bit_unchanged"] \
            != res["finetune"]["base_tensors"]:
        raise AssertionError(f"LoRA fine-tune moved the frozen base: "
                             f"{res['finetune']}")
    res["inference"], prompts, ref, ties, first = lora_inference(
        torch, np, model, args.seed)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    res["serve"] = lora_serve(torch, np, base, weights, prompts, ref, ties,
                              first)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    res["device"] = nvidia_smi_line()
    log(f"  phase 10: {res['seconds']:.1f} s")
    return res


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="few timing repeats and a 2-layer model")
    ap.add_argument("--report", default=os.path.join(
        HERE, "results", "chip_smoke.json"),
                    help="where to write the detailed JSON report")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the training batches")
    # internal: the training profile's child process
    ap.add_argument("--profile-train", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--profile-tenants", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--profile-bert", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--profile-bert-o2", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--profile-resnet", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--profile-resblock", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--route", choices=sorted(RESNET_ROUTES),
                    help=argparse.SUPPRESS)
    ap.add_argument("--recipes-only", action="store_true",
                    help="the build and phase 9 (training recipes) only")
    ap.add_argument("--o2-profile", action="store_true",
                    help="phase 9 also times (b)'s O2 loop, without its "
                         "scaler and without auto_cast, beside phase 5's "
                         "engine and profiles each in a child (about 40 s)")
    ap.add_argument("--lora-only", action="store_true",
                    help="the build, phase 2's BGMV checks and phase 10 "
                         "(LoRA fine-tune and inference) only")
    ap.add_argument("--cp-only", action="store_true",
                    help="phases 1, 2's ring-attention and GEMV checks and "
                         "7 (cp training) only")
    # internal: one rank of phase 7
    ap.add_argument("--cp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--cp-dir", help=argparse.SUPPRESS)
    ap.add_argument("--layers", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch/ not found beside this script "
              "— run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.cp_rank is not None:
        return cp_rank(torch, args)
    if args.profile_train:
        res = profile_train(torch, args.layers, args.seed)
        with open(args.profile_train, "w") as f:
            json.dump(res, f)
        return 0
    if args.profile_tenants:
        res = profile_tenants(torch, np, args.layers)
        with open(args.profile_tenants, "w") as f:
            json.dump(res, f)
        return 0
    if args.profile_bert:
        res = profile_bert(torch, np, args.layers, args.seed)
        with open(args.profile_bert, "w") as f:
            json.dump(res, f)
        return 0
    if args.profile_bert_o2:
        res = profile_bert_o2(torch, np, args.layers, args.seed)
        with open(args.profile_bert_o2, "w") as f:
            json.dump(res, f)
        return 0
    if args.profile_resnet:
        res = profile_resnet(torch, np, args.route, args.seed)
        with open(args.profile_resnet, "w") as f:
            json.dump(res, f)
        return 0
    if args.profile_resblock:
        res = block_products(torch)
        with open(args.profile_resblock, "w") as f:
            json.dump(res, f)
        return 0
    t_start = time.perf_counter()
    # a hang prints every thread's stack and exits non-zero before the
    # run's time limit
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    # the report's directory also holds the training profile child's file
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    smi = nvidia_smi_line()
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    # the kernels' first launch calls build() again (a cache hit), which
    # rewrites build_info: keep this build's record
    build_rec = dict(_build.build_info)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(cached={build_rec.get('cached')}; ptxas -v lines in the report)")

    if args.recipes_only:
        log_phase(t_start, "phase 9: training recipes")
        return finish(args, torch, smi, build_rec, t_start, [],
                      {"recipes": recipes_phase(torch, np, args)})
    iters = 5 if args.quick else 20
    if args.lora_only:
        log_phase(t_start, "phase 2: BGMV vs its plain version")
        bg_rows = check_bgmv(torch, iters)
        log_phase(t_start, "phase 10: LoRA fine-tune and inference")
        return finish(args, torch, smi, build_rec, t_start, [],
                      {"bgmv": bg_rows, "lora": lora_phase(torch, np, args)})
    log_phase(t_start, "phase 2: kernels vs plain versions")
    fp_rows = check_flash_pos(torch, iters)
    ring_rows = check_serial_ring(torch)
    gv_rows = check_row_gemv(torch, iters)
    if args.cp_only:
        log_phase(t_start, "phase 7: gpt_base training at cp = 2")
        cp_run = cp_phase(torch, args)
        return finish(args, torch, smi, build_rec, t_start,
                      cp_kernel_rows(fp_rows, cp_run) + [gemv_row(gv_rows)],
                      {"flash_pos": fp_rows, "serial_ring": ring_rows,
                       "row_gemv": gv_rows, "cp": cp_run})
    wo_rows = check_weight_only(torch, iters)
    pd_rows = check_paged(torch, iters)
    bg_rows = check_bgmv(torch, iters)
    fa_rows = check_flash(torch, iters)
    sa_rows = check_short_attention(torch, iters)
    rb_rows = check_fused_resblock(torch, iters)
    products = run_child("--profile-resblock", 0, args.seed, args.report)
    log(f"  fused forward and backward by launch {json.dumps(products)}")
    for r in rb_rows:
        for part in ("fwd", "bwd"):
            r[f"{part}_products_ms"] = (products.get(r["stage"])
                                        or {}).get(part)
    bs_rows = check_block_sparse(torch, np, iters, args.seed)
    dec_rows = check_decode_attention(torch, iters)
    table_cost = decode_table_cost(torch)
    pair_rows = check_fused_pair(torch, iters)

    log_phase(t_start, "phase 3: llama2_7b end to end through DecodeEngine")
    serve_layers = 2 if args.quick else 32
    runs, profiles, eager, spec = end_to_end(torch, np, serve_layers,
                                             8 if args.quick else 32)
    profiles.append(run_child("--profile-tenants", serve_layers, args.seed,
                              args.report))
    log(f"  profile {json.dumps(profiles[-1])}")

    log_phase(t_start, "phase 4: gpt_base training through parallelize")
    layers = 2 if args.quick else 12
    train = {"throughput": train_throughput(torch, layers, 20, args.seed),
             "parity": train_parity(torch, layers, args.seed),
             "profile": profile_train_child(torch, layers, args.seed,
                                            args.report)}

    log_phase(t_start, "phase 5: bert_base fine-tuning through parallelize")
    bert_run = {"throughput": bert_throughput(torch, np, layers, 20,
                                              args.seed),
                "parity": bert_parity(torch, np, layers, args.seed)}
    bert_run["profile"] = run_child("--profile-bert", layers, args.seed,
                                    args.report)
    # the profiler's own host cost stretches its window's step; the device
    # time it records against the unprofiled step is the busy share a run
    # without it sees
    bert_run["device_busy_share_unprofiled"] = (
        bert_run["profile"]["device_busy_ms_per_step"]
        / bert_run["throughput"]["step_ms"])
    log(f"  bert profile {json.dumps(bert_run['profile'])}; device busy "
        f"{bert_run['device_busy_share_unprofiled']:.4f} of the unprofiled "
        f"step")

    log_phase(t_start, "phase 6: resnet50 training through parallelize")
    resnet_run = resnet_phase(torch, np, args)

    log_phase(t_start, "phase 7: gpt_base training at cp = 2, two ranks "
                       "on one card")
    cp_run = cp_phase(torch, args)

    log_phase(t_start, "phase 8: sparse attention at bigbird_base width")
    sparse_run = sparse_phase(torch, np, args)

    log_phase(t_start, "phase 9: training recipes (schedule, clips, "
                       "rewinds, AMP O2, GradScaler)")
    recipes_run = recipes_phase(torch, np, args, train["throughput"],
                                bert_run["throughput"])

    log_phase(t_start, "phase 10: LoRA fine-tune and inference "
                       "(llama2_7b, BASELINE config 5)")
    lora_run = lora_phase(torch, np, args)

    launches = {k: sum(r["launches"].get(k, 0) for r in runs)
                for k in runs[0]["launches"]}
    tenant_run = next(r for r in runs if "lora_delta" in r["launches"])
    wo_main, wo_prefill = main_route_rows(wo_rows, fa_rows)
    pd_main = pd_rows[0]
    kernels = [
        dict(name="weight_only_matmul", route="cuda",
             source="paddle_tpu_torch/csrc/weight_only.cu",
             replaces="paddle_tpu/ops/pallas/weight_only.py:34",
             launches=launches["weight_only_matmul"],
             max_abs_err=max(r["max_abs_err"] for r in wo_rows),
             ms=wo_main["ms"], plain_ms=wo_main["plain_ms"],
             bound_ms=wo_main["bound_ms"], bound_by=wo_main["bound_by"],
             library_ms=wo_main["library_ms"], case=wo_main["case"],
             path=wo_main["route"],
             # the prefill chunk of the same serving path, on its own route
             prefill_ms=wo_prefill["ms"],
             prefill_plain_ms=wo_prefill["plain_ms"],
             prefill_library_ms=wo_prefill["library_ms"],
             prefill_bound_ms=wo_prefill["bound_ms"],
             prefill_bound_by=wo_prefill["bound_by"],
             prefill_case=wo_prefill["case"],
             prefill_path=wo_prefill["route"],
             lora_launches=lora_run["inference"]["int8_launches"],
             lora_routes=lora_run["inference"]["int8_routes"]),
        dict(name="paged_decode_attention", route="cuda",
             source="paddle_tpu_torch/csrc/paged_decode_attn.cu",
             replaces="paddle_tpu/ops/pallas/decode_attn.py:133",
             launches=launches["paged_decode_attention"],
             max_abs_err=max(r["max_abs_err"] for r in pd_rows),
             ms=pd_main["ms"], plain_ms=pd_main["plain_ms"],
             bound_ms=pd_main["bound_ms"], bound_by=pd_main["bound_by"],
             library_ms=pd_main["library_ms"], case=pd_main["case"],
             device_ms=pd_main["device_ms"], path=pd_main["route"],
             cuda_kernels=["paged_decode_ring", "merge_splits"],
             routes=runs[1]["paged_routes"],
             first_body_ms=pd_main["first_body_ms"],
             first_body_device_ms=pd_main["first_body_device_ms"],
             lora_launches=lora_run["serve"]["launches"][
                 "paged_decode_attention"],
             lora_routes=lora_run["serve"]["routes"]["paged"]),
    ]
    bg_main = bg_rows[0]
    kernels.append(dict(
        name="bgmv", route="cuda", source="paddle_tpu_torch/csrc/bgmv.cu",
        replaces="paddle_tpu/ops/pallas/bgmv.py:46",
        launches=tenant_run["launches"]["lora_delta"],
        max_abs_err=max(r["max_abs_err"] for r in bg_rows),
        ms=bg_main["ms"], plain_ms=bg_main["plain_ms"],
        bound_ms=bg_main["bound_ms"], bound_by=bg_main["bound_by"],
        library_ms=bg_main["library_ms"], device_ms=bg_main["device_ms"],
        library_device_ms=bg_main["library_device_ms"], case=bg_main["case"],
        path=bg_main["route"], cuda_kernels=["bgmv_cluster"],
        routes=tenant_run["bgmv_routes"],
        lora_launches=lora_run["serve"]["launches"]["lora_delta"],
        lora_routes=lora_run["serve"]["routes"]["bgmv"]))
    fa_main = fa_rows[0]
    # No PyTorch call forms dq alone or dk, dv alone: SDPA's backward forms
    # all three, so it stands beside the pair (pair_ms = dq + dkv), and
    # each backward kernel's own library_ms is null.
    pair = dict(pair_ms=fa_main["dq_ms"] + fa_main["dkv_ms"],
                pair_library_ms=fa_main["bwd_library_ms"],
                pair_bound_ms=fa_main["bwd_bound_ms"])
    for name, line, part in (("flash_attention_fwd", 84, "fwd"),
                             ("flash_attention_dq", 181, "dq"),
                             ("flash_attention_dkv", 224, "dkv")):
        kernels.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/flash_attention.cu",
            replaces=f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            launches=train["throughput"]["launches"][name],
            max_abs_err=max(r["max_abs_err"][part] for r in fa_rows),
            ms=fa_main[f"{part}_ms"], plain_ms=fa_main[f"{part}_plain_ms"],
            bound_ms=fa_main[f"{part}_bound_ms"],
            bound_by=fa_main[f"{part}_bound_by"],
            library_ms=(fa_main["fwd_library_ms"] if part == "fwd"
                        else None),
            case=fa_main["case"], device_ms=fa_main[f"{part}_dev_ms"],
            # the body the checked call took, and the training run's
            # launches by body
            path=fa_main["route" if part == "fwd" else "bwd_route"],
            routes=train["throughput"]["routes"][part],
            lora_launches=lora_run["finetune"]["launches"][name],
            lora_routes=lora_run["finetune"]["routes"][part],
            **({} if part == "fwd" else pair)))
    sa_main = sa_rows[0]
    for name, line, part in (("short_attention_fwd", 73, "fwd"),
                             ("short_attention_bwd", 87, "bwd")):
        errs = [v for r in sa_rows for n, v in r["max_abs_err"].items()
                if n in (("fwd",) if part == "fwd" else ("dq", "dk", "dv"))]
        kernels.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/short_attention.cu",
            replaces=f"paddle_tpu/ops/pallas/short_attention.py:{line}",
            launches=bert_run["throughput"]["launches"][name],
            max_abs_err=max(errs), ms=sa_main[f"{part}_ms"],
            plain_ms=sa_main[f"{part}_plain_ms"],
            bound_ms=sa_main[f"{part}_bound_ms"],
            bound_by=sa_main[f"{part}_bound_by"],
            library_ms=sa_main[f"{part}_library_ms"],
            # a backward call is two launches (dQ, then dK/dV), both
            # counted; ms is the call's
            case=sa_main["case"], device_ms=sa_main[f"{part}_dev_ms"],
            **(dict(path=sa_main["route"], cuda_kernels=["sa_fwd_sm90"],
                    routes=bert_run["throughput"]["fwd_routes"])
               if part == "fwd" else
               dict(path=sa_main["bwd_route"],
                    cuda_kernels=["sa_dq_sm90", "sa_dkv_sm90"],
                    routes=bert_run["throughput"]["bwd_routes"]))))
    kernels.extend(resblock_kernel_rows(rb_rows, resnet_run))
    kernels.extend(cp_kernel_rows(fp_rows, cp_run))
    kernels.append(gemv_row(gv_rows, runs[0]["launches"]["row_gemv"],
                            runs[0]["gemv_routes"]))
    kernels[-1].update(lora_launches=lora_run["serve"]["launches"][
        "row_gemv"], lora_routes=lora_run["serve"]["routes"]["gemv"])
    kernels.extend(slice7_kernel_rows(bs_rows, dec_rows, pair_rows,
                                      sparse_run, table_cost))
    return finish(args, torch, smi, build_rec, t_start, kernels, {
        "weight_only": wo_rows, "paged_decode": pd_rows, "bgmv": bg_rows,
        "flash_attention": fa_rows, "short_attention": sa_rows,
        "e2e": runs, "profiles": profiles, "eager_vs_graphs": eager,
        "speculative": spec, "train": train, "bert": bert_run,
        "fused_resblock": rb_rows, "resnet": resnet_run,
        "flash_pos": fp_rows, "serial_ring": ring_rows, "row_gemv": gv_rows,
        "cp": cp_run, "block_sparse": bs_rows, "decode_attention": dec_rows,
        "decode_table_cost": table_cost,
        "fused_pair": pair_rows, "sparse": sparse_run,
        "recipes": recipes_run, "lora": lora_run})


def main_route_rows(wo_rows, fa_rows):
    """The main-path rows of the two kernels this slice redesigned, each
    held to its new route (the route each row's checked call launched,
    from the wrappers' route counts): int8 gate_up at m = 8 (a decode step at bs 8)
    on the decode GEMV and at m = 256 (a prefill chunk) on the wgmma GEMM;
    the gpt_base causal forward and backward on the Hopper bodies. Returns
    the two weight-only rows (decode, prefill)."""
    picked = []
    for m, want in ((8, WO_ROUTE_NAMES[1]), (256, WO_ROUTE_NAMES[2])):
        row = next(r for r in wo_rows if r["wdt"] == "int8" and r["m"] == m
                   and r["layer"] == "gate_up")
        if row["route"] != want:
            raise AssertionError(f"weight_only {row['case']} took "
                                 f"{row['route']}, not {want}")
        picked.append(row)
    if (fa_rows[0]["route"], fa_rows[0]["bwd_route"]) != (
            FLASH_ROUTE_NAMES[3], FLASH_BWD_ROUTE_NAMES[1]):
        raise AssertionError(f"flash {fa_rows[0]['case']} took "
                             f"{fa_rows[0]['route']} / "
                             f"{fa_rows[0]['bwd_route']}")
    return picked


def cp_kernel_rows(fp_rows, cp_run):
    """The ring-step kernels' entries of the kernels line: the mean of the
    four gpt_base ring steps of phase 2 (ranks 0 and 1, own and visiting
    shard), launches summed over both ranks of phase 7's timed steps, the
    body the checked calls took (`path`) and phase 7's launches by body
    (`routes`, both ranks)."""
    main = fp_rows[:4]

    def mean(key):
        return sum(r[key] for r in main) / len(main)

    out = []
    for name, part, line in (("flash_fwd_pos", "fwd", 411),
                             ("flash_dq_pos", "dq", 499),
                             ("flash_dkv_pos", "dkv", 531)):
        routes = {}
        for x in cp_run["ranks"]:
            for r, c in x["throughput"]["routes"][name].items():
                routes[r] = routes.get(r, 0) + c
        out.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/flash_attention.cu",
            replaces=f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            launches=sum(x["throughput"]["launches"][name]
                         for x in cp_run["ranks"]),
            max_abs_err=max(r["max_abs_err"][part] for r in fp_rows),
            ms=mean(f"{part}_ms"), plain_ms=mean(f"{part}_plain_ms"),
            bound_ms=mean(f"{part}_bound_ms"),
            bound_by=main[0][f"{part}_bound_by"],
            library_ms=mean("fwd_library_ms") if part == "fwd" else None,
            device_ms=mean(f"{part}_dev_ms"),
            library_device_ms=(mean("fwd_library_dev_ms") if part == "fwd"
                               else None),
            path=main[0]["route" if part == "fwd" else "bwd_route"],
            routes=routes,
            launches_per_rank_per_step=cp_run["launches_per_rank_per_step"][
                0][name],
            case="gpt_base cp=2 ring step (B=8, s=512, H=12, D=64, bf16, "
                 "zigzag), mean of ranks 0-1 x own / visiting shard",
            **({} if part == "fwd" else dict(
                pair_ms=mean("dq_ms") + mean("dkv_ms"),
                pair_device_ms=mean("dq_dev_ms") + mean("dkv_dev_ms"),
                pair_library_ms=mean("bwd_library_ms"),
                pair_library_device_ms=mean("bwd_library_dev_ms"),
                pair_bound_ms=mean("bwd_bound_ms")))))
    return out


def gemv_row(gv_rows, launches=None, routes=None):
    """The row-stable GEMV's entry: bf16 gate_up at m = 8; launches and
    launches by body from run (a)'s decode (None when phase 3 did not
    run)."""
    main = next(r for r in gv_rows if r["layer"] == "gate_up"
                and r["m"] == 8)
    return dict(name="row_gemv", route="cuda",
                source="paddle_tpu_torch/csrc/weight_only.cu",
                replaces="none: not a TPU kernel; keeps the bit-identity "
                         "across batch sizes of paddle_tpu/inference/decode/"
                         "engine.py:87 for float weights",
                launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in gv_rows),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], device_ms=main["device_ms"],
                library_device_ms=main["library_device_ms"],
                path=main["route"], routes=routes, case=main["case"])


def finish(args, torch, smi, build_rec, t_start, kernels, parts):
    """Write the report; print the kernels line, the device line and the
    result line."""
    report = {"device": smi, "quick": args.quick, "build": build_rec,
              **parts, "seconds": time.perf_counter() - t_start}
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
