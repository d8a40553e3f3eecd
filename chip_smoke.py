#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # the full run (kernels + LLaMA-2-7B)
    python3 chip_smoke.py --quick    # short: fewer timing repeats, 2 layers

Phases (any failure exits non-zero and prints no result line):

1. device line (nvidia-smi name and power limit) and the kernel build
   (nvcc for sm_90a, from the sources in the checkout) with its time;
2. each hand-written kernel against its plain PyTorch version on the GPU
   at the llama2_7b shapes of the serving path, with the tolerance stated
   per kernel, and timed (CUDA events, median after warm-up) beside the
   plain version, one PyTorch library call computing the same function
   (a yardstick only; the port never calls it) and the bound: the larger
   of bytes moved / 3.35 TB/s and operations / 989 TFLOP/s (H100 SXM
   bf16 dense);
3. end to end: llama2_7b at full width (random weights from a seed)
   served by `DecodeEngine` — (a) bf16 weights with a bf16 KV pool,
   (b) int8 weights with an int8 KV pool, (c) int4 weights, one short
   wave — with launch counts of both kernels set to 0 before and read
   after each run, tokens/s, time to first token, the block-pool
   conservation check, the engine's first decode-step logits against a
   dense `model.forward` recompute, solo-vs-batched token agreement, and a
   torch.profiler window over decode steps (device-busy time per step
   and kernel time by family);
4. the kernels' JSON line, the nvidia-smi line, then the last line
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


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

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
    fam = {"paged_decode_attention": 0.0, "weight_only_matmul": 0.0,
           "library_gemm": 0.0, "other": 0.0}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if not us:
            continue
        name = evt.key
        if "paged_decode" in name or "merge_splits" in name:
            fam["paged_decode_attention"] += us
        elif "wo_gemv" in name or "wo_wmma" in name:
            fam["weight_only_matmul"] += us
        elif any(w in name.lower() for w in ("gemm", "gemv", "nvjet")):
            fam["library_gemm"] += us
        else:
            fam["other"] += us
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


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="few timing repeats and a 2-layer model")
    ap.add_argument("--report", default=os.path.join(
        HERE, "results", "chip_smoke.json"),
                    help="where to write the detailed JSON report")
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
    t_start = time.perf_counter()
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
    log("phase 2: kernels vs plain versions at llama2_7b shapes")
    wo_rows = check_weight_only(torch, iters)
    pd_rows = check_paged(torch, iters)

    log("phase 3: llama2_7b end to end through DecodeEngine")
    runs, profiles = end_to_end(torch, np, 2 if args.quick else 32,
                                8 if args.quick else 32)

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
    report = {"device": smi, "quick": args.quick,
              "build": build_rec,
              "weight_only": wo_rows, "paged_decode": pd_rows,
              "e2e": runs, "profiles": profiles,
              "seconds": time.perf_counter() - t_start}
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
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
