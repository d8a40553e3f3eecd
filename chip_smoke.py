#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # the full run
    python3 chip_smoke.py --quick    # short: fewer timing repeats, 2 layers

Phases (any failure exits non-zero and prints no result line):

1. device line (nvidia-smi name and power limit) and the kernel build
   (nvcc for sm_90a, from the sources in the checkout) with its time;
2. each hand-written kernel against its plain PyTorch version on the GPU,
   with the tolerance stated per kernel, and timed (CUDA events, median
   after warm-up) beside the plain version, one PyTorch library call
   computing the same function (a yardstick only; the port never calls
   it) and the bound: the larger of bytes moved / 3.35 TB/s and
   operations / 989 TFLOP/s (H100 SXM bf16 dense). Serving kernels at the
   llama2_7b shapes of the decode path; the FlashAttention-2 forward, dq
   and dkv kernels at the gpt_base and llama2_7b training shapes, causal
   and not, a ragged S, a padded head dim, bf16 and f32;
3. serving end to end: llama2_7b at full width (random weights from a
   seed) served by `DecodeEngine` — (a) bf16 weights with a bf16 KV pool,
   (b) int8 weights with an int8 KV pool, (c) int4 weights, one short
   wave — with launch counts of both kernels set to 0 before and read
   after each run, tokens/s, time to first token, the block-pool
   conservation check, the engine's first decode-step logits against a
   dense `model.forward` recompute, solo-vs-batched token agreement, and a
   torch.profiler window over decode steps (device-busy time per step
   and kernel time by family);
4. training end to end: gpt_base at full width and depth (f32 masters,
   bf16 compute) through `distributed.parallelize` with AdamW and global
   grad-norm clipping — a throughput run on one fixed batch from
   `--seed` (step ms, tokens/s, MFU, the loss trajectory, flash launch
   counts set to 0 before and read after), a parity run of the same
   weights through the kernels and through the plain attention, and a
   torch.profiler window over 3 steps in a child process (device-busy
   share and kernel time by family);
5. the kernels' JSON line, the nvidia-smi line, then the last line
   ``{"ok": true, "device": {...}}``.

TF32 is switched off for matmuls and cuDNN, so every float32 product in
the plain versions is a full float32 product.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
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


def log(msg):
    print(msg, flush=True)


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


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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


def check_weight_only(torch, iters):
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
            # every decode bucket (GEMV row-blocks of 1, 2, 4, 8 and two
            # of 8), a ragged prefill chunk and a full one (tensor cores)
            for m in WO_ROWS:
                x = torch.randn(m, k, device="cuda", generator=g).to(
                    torch.bfloat16)
                got = weight_only_matmul(x, qw, sc, wdt)
                ref = weight_only_matmul_ref(x, qw, sc, wdt)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                # both round an f32 sum to bf16: two bf16 ulps at the
                # largest |output| covers rounding plus summation order
                tol = 2 * 2.0 ** -8 * ref.float().abs().max().item()
                ok = err <= tol and bool(torch.isfinite(got).all())
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
                           wdt=wdt, m=m, layer=lname, max_abs_err=err,
                           tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=by)
                rows.append(row)
                log(f"  weight_only {row['case']}: err {err:.3g} (tol "
                    f"{tol:.3g}) kernel {ms:.4f} ms plain {plain:.4f} ms "
                    f"library {lib:.4f} ms bound {bms:.4f} ms ({by})")
                if not ok:
                    raise AssertionError(f"weight_only {row['case']}: "
                                         f"max abs err {err} > {tol}")
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


def check_paged(torch, iters):
    import torch.nn.functional as F
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
        got = paged_decode_attention(*args)
        ref = paged_decode_attention_ref(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        # bf16 output: two ulps at |out| <= 1 plus f32 summation order
        tol = 1e-2
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"paged_decode {name}: max abs err {err} "
                                 f"> {tol}")
        ms = time_ms(torch, lambda: paged_decode_attention(*args), iters)
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
                   ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                   bound_by=by)
        rows.append(row)
        log(f"  paged_decode {row['case']}: err {err:.3g} (tol {tol}) "
            f"kernel {ms:.4f} ms plain {plain:.4f} ms library {lib:.4f} ms "
            f"bound {bms:.4f} ms ({by})")
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


def check_flash(torch, iters):
    """Forward, dq and dkv kernels against the plain versions on the same
    inputs (the backward kernels and the plain backward both take the
    plain forward's lse and delta, so each kernel is held alone).
    Tolerances (FLASH_TOL): O max abs error <= 2e-2 in bf16, 1e-4 in
    f32; each gradient's normwise error ||got - ref|| / ||ref|| <= 1e-3
    in bf16, 1e-5 in f32 (about 5x and 25x the largest readings on an
    H100: 1.9e-4 and 3.9e-7). The largest error relative to max |grad|
    is reported beside it. q, k, v are views of one [B, S, 3, H, D] tensor,
    as the model's fused QKV gives them."""
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
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
        delta = fa.attention_delta(ref, do)
        bwd_args = (q, k, v, do, lse_ref, delta)
        dq = fa.flash_attention_bwd_dq(*bwd_args, causal=causal)
        dk, dv = fa.flash_attention_bwd_dkv(*bwd_args, causal=causal)
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
        row = dict(case=case, dtype=dt, causal=causal, max_abs_err=err,
                   grad_norm_rel_err=rel, grad_err_of_max=of_max,
                   o_tol=o_tol, grad_tol=grad_tol)
        if not (finite and err["fwd"] <= o_tol and rel["dq"] <= grad_tol
                and rel["dkv"] <= grad_tol):
            raise AssertionError(f"flash {case}: errors {err}, normwise "
                                 f"gradient errors {rel}, tolerances "
                                 f"{o_tol} / {grad_tol}, finite={finite}")
        del ref, lse_ref, rdq, rdk, rdv, dq, dk, dv, out
        if timed:
            row.update(_time_flash(torch, F, fa, q, k, v, do, lse, delta,
                                   causal, iters))
        rows.append(row)
        log(f"  flash {case}: err {err} normwise {rel} of max {of_max} "
            f"(tol {o_tol} / {grad_tol})"
            + ("".join(f" {n} {t:.4f} ms" for n, t in row.items()
                       if n.endswith("_ms")) if timed else ""))
        del qkv, q, k, v, do, lse, delta
        torch.cuda.empty_cache()
    return rows


def _time_flash(torch, F, fa, q, k, v, do, lse, delta, causal, iters):
    """Kernel, plain and library times with the bounds of the three
    kernels. Operations: the forward's two products, 4 B H S^2 D (half
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


# ---------------------------------------------------------------------------
# phase 3: end to end
# ---------------------------------------------------------------------------

PROMPT_LENS = (16, 100, 230, 400, 700, 50, 310, 560)


def _prompts(np, vocab, lens):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, (n,)).astype(np.int64) for n in lens]


def serve(torch, np, model, quant, lens, new_tokens, label, check_dense):
    from paddle_tpu_torch.inference import DecodeEngine
    from paddle_tpu_torch.ops.decode_attn import paged_decode_attention
    from paddle_tpu_torch.ops.weight_only import weight_only_matmul

    prompts = _prompts(np, model.cfg.vocab_size, lens)
    eng = DecodeEngine(model, max_length=1024, block_size=16,
                       decode_buckets=(1, 2, 4, 8), prefill_chunk=256,
                       quant=quant, default_timeout=600.0,
                       device=model.device)
    # warm-up: one short request, outside the measured window
    eng.generate(prompts[0][:8], 2)
    paged_decode_attention.launches = 0
    weight_only_matmul.launches = 0
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
                "weight_only_matmul": weight_only_matmul.launches}
    st = eng.stats()
    ttft = sorted(s.ttft for s in streams)
    res = {"run": label, "tokens": sum(map(len, outs)), "wall_s": wall,
           "tokens_per_s": sum(map(len, outs)) / wall,
           "ttft_p50_s": ttft[len(ttft) // 2],
           "ttft_p95_s": ttft[min(len(ttft) - 1, int(0.95 * len(ttft)))],
           "steps": st["steps"], "prefill_chunks": st["prefill_chunks"],
           "occupancy": st["occupancy"], "launches": launches}
    if any(len(o) != new_tokens for o in outs) or any(
            not 0 <= t < model.cfg.vocab_size for o in outs for t in o):
        raise AssertionError(f"{label}: malformed token output")
    if check_dense:
        solo = [eng.generate(p, new_tokens) for p in prompts]
        res["solo_vs_batched_agree"] = sum(a == b for a, b in zip(solo, outs))
        res["sequences"] = len(outs)
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


def profile_decode(torch, np, model, quant, label, steps=12):
    """Where a decode step's time goes: 8 sequences of 300 prompt tokens
    are prefilled, then `steps` batched decode steps run under
    torch.profiler. Reports the host-clock step time, the device-busy time
    per step (the sum of kernel times; the rest is the GPU idling on the
    eager host loop) and the kernel time by family."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import DecodeEngine

    eng = DecodeEngine(model, max_length=1024, block_size=16,
                       decode_buckets=(1, 2, 4, 8), prefill_chunk=256,
                       quant=quant, default_timeout=600.0,
                       device=model.device)
    # enough new tokens that no sequence finishes inside the window; the
    # rest is cancelled after it
    streams = [eng.submit(p, 4 * steps + 16) for p in
               _prompts(np, model.cfg.vocab_size, (300,) * 8)]
    for st in streams:
        next(iter(st))                      # every prompt is prefilled
    give_up = time.perf_counter() + 120.0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = eng.stats()["steps"]
        t0 = time.perf_counter()
        while eng.stats()["steps"] < s0 + steps:
            if time.perf_counter() > give_up or all(st.done()
                                                    for st in streams):
                raise AssertionError(f"{label}: decode stalled under the "
                                     f"profiler")
            time.sleep(0.0005)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = eng.stats()["steps"] - s0
    for st in streams:
        st.cancel()
    eng.shutdown()
    fam = kernel_families(prof, (
        ("paged_decode_attention", ("paged_decode", "merge_splits")),
        ("weight_only_matmul", ("wo_gemv", "wo_wmma")),
        ("library_gemm", GEMM_NAMES)))
    busy_ms = sum(fam.values()) / 1e3 / done
    res = {"run": label, "steps": done, "step_ms": wall * 1e3 / done,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": max(0.0, 1 - busy_ms / (wall * 1e3 / done)),
           "kernel_ms_per_step": {k: v / 1e3 / done for k, v in fam.items()}}
    log(f"  profile {json.dumps(res)}")
    return res


def end_to_end(torch, np, layers, new_tokens):
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn.quant import quantize_for_inference

    def build():
        torch.cuda.empty_cache()
        return gpt("llama2_7b", dtype="bfloat16", device="cuda", seed=0,
                   num_layers=layers)

    runs = []
    model = build()
    r = serve(torch, np, model, None, PROMPT_LENS, new_tokens,
              "a: bf16 weights, bf16 KV", check_dense=True)
    if r["launches"]["paged_decode_attention"] == 0:
        raise AssertionError("paged_decode_attention never launched")
    runs.append(r)
    quantize_for_inference(model, "int8")
    torch.cuda.empty_cache()
    r = serve(torch, np, model, "int8", PROMPT_LENS, new_tokens,
              "b: int8 weights, int8 KV", check_dense=False)
    runs.append(r)
    # one profiler session per process: a second one in the same process
    # recorded no device activity on the card
    profiles = [profile_decode(torch, np, model, "int8",
                               "b: int8 + int8 KV, bs 8")]
    del model
    model = build()
    quantize_for_inference(model, "int4")
    torch.cuda.empty_cache()
    r = serve(torch, np, model, "int8", PROMPT_LENS[:4], new_tokens // 2,
              "c: int4 weights, int8 KV, one wave", check_dense=False)
    runs.append(r)
    del model
    for r in runs[1:]:
        if min(r["launches"].values()) == 0:
            raise AssertionError(f"{r['run']}: a kernel never launched: "
                                 f"{r['launches']}")
    return runs, profiles


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
    flash launch counts are set to 0 just before and read just after."""
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
    tokens = TRAIN_BATCH * TRAIN_SEQ * steps
    fpt = flops_per_token(model.cfg, TRAIN_SEQ)
    res = {"layers": layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": steps, "step_ms": wall * 1e3 / steps,
           "tokens_per_s": tokens / wall,
           "mfu": tokens / wall * fpt / BF16_FLOPS,
           "ideal_step_ms": TRAIN_BATCH * TRAIN_SEQ * fpt / BF16_FLOPS * 1e3,
           "flops_per_token": fpt, "losses": losses, "grad_norms": norms,
           "launches": launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  train {json.dumps(res)}")
    per_run = layers * steps
    if any(n != per_run for n in launches.values()):
        raise AssertionError(f"flash launches {launches}, expected "
                             f"{per_run} each ({layers} layers x {steps} "
                             f"steps)")
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


def profile_train_child(torch, layers, seed, report):
    """Run `profile_train` in a child process; returns its result."""
    path = report + ".profile_train.json"
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--profile-train", path,
         "--layers", str(layers), "--seed", str(seed)],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"training profile child failed:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(path) as f:
        res = json.load(f)
    os.remove(path)
    log(f"  train profile {json.dumps(res)}")
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
    if args.profile_train:
        res = profile_train(torch, args.layers, args.seed)
        with open(args.profile_train, "w") as f:
            json.dump(res, f)
        return 0
    t_start = time.perf_counter()
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

    iters = 5 if args.quick else 20
    log("phase 2: kernels vs plain versions")
    wo_rows = check_weight_only(torch, iters)
    pd_rows = check_paged(torch, iters)
    fa_rows = check_flash(torch, iters)

    log("phase 3: llama2_7b end to end through DecodeEngine")
    runs, profiles = end_to_end(torch, np, 2 if args.quick else 32,
                                8 if args.quick else 32)

    log("phase 4: gpt_base training through parallelize")
    layers = 2 if args.quick else 12
    train = {"throughput": train_throughput(torch, layers, 20, args.seed),
             "parity": train_parity(torch, layers, args.seed),
             "profile": profile_train_child(torch, layers, args.seed,
                                            args.report)}

    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    wo_main = next(r for r in wo_rows if r["wdt"] == "int8"
                   and r["m"] == 8 and r["layer"] == "gate_up")
    pd_main = pd_rows[0]
    kernels = [
        dict(name="weight_only_matmul", route="cuda",
             source="paddle_tpu_torch/csrc/weight_only.cu",
             replaces="paddle_tpu/ops/pallas/weight_only.py:34",
             launches=launches["weight_only_matmul"],
             max_abs_err=max(r["max_abs_err"] for r in wo_rows),
             ms=wo_main["ms"], plain_ms=wo_main["plain_ms"],
             bound_ms=wo_main["bound_ms"], bound_by=wo_main["bound_by"],
             library_ms=wo_main["library_ms"], case=wo_main["case"]),
        dict(name="paged_decode_attention", route="cuda",
             source="paddle_tpu_torch/csrc/paged_decode_attn.cu",
             replaces="paddle_tpu/ops/pallas/decode_attn.py:133",
             launches=launches["paged_decode_attention"],
             max_abs_err=max(r["max_abs_err"] for r in pd_rows),
             ms=pd_main["ms"], plain_ms=pd_main["plain_ms"],
             bound_ms=pd_main["bound_ms"], bound_by=pd_main["bound_by"],
             library_ms=pd_main["library_ms"], case=pd_main["case"]),
    ]
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
            case=fa_main["case"], **({} if part == "fwd" else pair)))
    report = {"device": smi, "quick": args.quick,
              "build": build_rec,
              "weight_only": wo_rows, "paged_decode": pd_rows,
              "flash_attention": fa_rows,
              "e2e": runs, "profiles": profiles, "train": train,
              "seconds": time.perf_counter() - t_start}
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
