"""Builds and loads the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with `ctypes`. The build
happens at first use (never at import), writes into
``paddle_tpu_torch/_build/`` (listed in ``.gitignore``) and is keyed by a
hash of the sources, so an edited kernel is rebuilt and an unchanged one is
loaded as it is. The sources compile in parallel, one ``nvcc`` each, and
are linked once.

It also holds what the attention wrappers share between their launches:
the operands' views (`attention_views`), the test of whether the Hopper
bodies take them (`hopper_plan`) and the packed sizes (`attention_dims`).
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import struct
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libpaddle_tpu_torch_kernels.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lib = None
#: what the last build did: {"seconds", "cached", "ptxas"} (ptxas -v
#: register, shared-memory and spill lines, its warnings and its notes
#: on wgmma serialization)
build_info = {}


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _source_hash():
    h = hashlib.sha256(ARCH.encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return path


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build():
    """Compile the kernels if the sources changed; returns the .so path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = lib_path + ".sha256"
    digest = _source_hash()
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib_path) \
                and os.path.exists(stamp) and open(stamp).read() == digest:
            build_info.update(seconds=0.0, cached=True, ptxas=[])
            return lib_path
        t0 = time.perf_counter()
        nvcc = _nvcc()
        cus = [s for s in sources() if s.endswith(".cu")]
        objs = [os.path.join(BUILD_DIR, os.path.basename(s) + ".o")
                for s in cus]
        flags = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-I", CSRC]
        with ThreadPoolExecutor(max_workers=max(1, len(cus))) as ex:
            logs = list(ex.map(
                lambda so: _run([nvcc, *flags, "-c", so[0], "-o", so[1]]),
                zip(cus, objs)))
        tmp = lib_path + f".tmp{os.getpid()}"
        # -ldl: the tensor-map encoder is looked up in libcuda with dlopen
        _run([nvcc, ARCH, "-shared", "-o", tmp, *objs, "-ldl"])
        os.replace(tmp, lib_path)
        with open(stamp, "w") as f:
            f.write(digest)
        ptxas = [ln.strip() for log in logs for ln in log.splitlines()
                 if ("ptxas info" in ln and ("registers" in ln
                                             or "Compiling" in ln))
                 or "spill" in ln or "warning" in ln
                 or "Performance" in ln]
        build_info.update(seconds=time.perf_counter() - t0, cached=False,
                          ptxas=ptxas)
        return lib_path


def _sig(fn, *argtypes):
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    handle = ctypes.CDLL(build())
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    # x, qweight, scale, out, m, n, k, x_dtype, int4, route, stream
    _sig(handle.ptt_weight_only_matmul, P, P, P, P, I, I, I, I, I, I, P)
    # q, kq, ks, vq, vs, tables, pos, out, split scratch, dims (16 int64:
    # B, H, Hkv, D, BS, NB, kv strides (n, h, t), scale strides (n, h, t),
    # q dtype, kv dtype, route, pos_all), softmax scale, stream
    _sig(handle.ptt_paged_decode_attention, P, P, P, P, P, P, P, P, P,
         ctypes.c_char_p, F, P)
    _sig(handle.ptt_paged_decode_splits, I, I)
    # kind, q, k, v, dout, lse, delta, out0, out1, lse_out, dims (16
    # int64: B, S, H, D, strides (b, s, h) of q, k, v, dout), dtype, scale,
    # causal, stream
    _sig(handle.ptt_flash_attention, I, P, P, P, P, P, P, P, P, P,
         ctypes.c_char_p, I, F, I, P)
    # the ring-step kernels: kind, the ten pointers as above, qpos, kpos,
    # dims as above (S: q's rows Sq), k's rows Sk, dtype, scale, causal,
    # stream
    _sig(handle.ptt_flash_attention_pos, I, P, P, P, P, P, P, P, P, P, P, P,
         ctypes.c_char_p, I, I, F, I, P)
    # x, w, bias, out, m, n, k, dtype, route, stream (the row-stable GEMV)
    _sig(handle.ptt_row_gemv, P, P, P, P, I, I, I, I, I, P)
    # dtype, m -> CTAs a multiprocessor of the tensor-core body
    _sig(handle.ptt_row_gemv_occupancy, I, I)
    # kind, q, k, v, dout, seed, lse, delta, out0, out1, dims (16 int64:
    # B, S, H, D, strides (b, s, h) of q, k, v, dout), dtype, scale, keep
    # scale, keep threshold, dropout, causal, stream
    _sig(handle.ptt_short_attention, I, P, P, P, P, P, P, P, P, P,
         ctypes.c_char_p, I, F, F, ctypes.c_uint, I, I, P)
    # x, x strides (b, s), A, B, ids, h scratch, out, batch, s, d_in, r,
    # d_out, slots, x_dtype, route, cluster size, rows and columns a CTA,
    # stream
    _sig(handle.ptt_bgmv, P, L, L, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
         I, I, P)
    # kind, &Args (ops/fused_resblock.py _Args), activation dtype, stream
    _sig(handle.ptt_resblock_gemm, I, P, I, P)
    # 4C -> the coupled kernel's row tile (0: not taken)
    _sig(handle.ptt_resblock_k41_rows, I)
    # mode, part, T, N, gamma, beta, bn, eps, n, out, stream
    _sig(handle.ptt_resblock_reduce, I, P, I, I, P, P, P, F, F, P, P)
    # q, k, v, block_idx, block_cnt, out, BH, S, D, max_nb, dtype, scale,
    # stream
    _sig(handle.ptt_block_sparse_attention, P, P, P, P, P, P, I, I, I, I, I,
         F, P)
    _sig(handle.ptt_cuda_error_string, I, ctypes.c_char_p, I)
    _lib = handle
    return _lib


def check(err, what):
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        buf = ctypes.create_string_buffer(256)
        lib().ptt_cuda_error_string(err, buf, 256)
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{buf.value.decode(errors='replace')}")


_CURRENT = contextlib.nullcontext()


def launch_on(device):
    """(context, stream) for a launch on CUDA `device`, as every wrapper
    makes it: a context that makes the device current (nothing to do when
    it already is) and its current stream as an int. Both cheap —
    torch.cuda.current_stream builds a Stream object and torch.cuda.device
    switches twice, microseconds each that every call of a kernel would
    pay on the host."""
    import torch

    ctx = (_CURRENT if torch._C._cuda_getDevice() == device.index
           else torch.cuda.device(device))
    return ctx, torch._C._cuda_getCurrentRawStream(device.index)


_CODES = {}


#: dtype codes shared with the C entry points
def dtype_code(dtype):
    if not _CODES:
        import torch

        _CODES.update({torch.float32: 0, torch.bfloat16: 1,
                       torch.float16: 2, torch.int8: 3})
    code = _CODES.get(dtype)
    if code is None:
        raise TypeError(f"unsupported dtype {dtype} for the CUDA kernels")
    return code


# --- attention operands ------------------------------------------------------

def attention_views(ops):
    """The attention operands [B, S, H, D] as a launch reads them: each with
    a unit stride along D (a copy only where the caller's has none), with
    its data pointer and (b, s, h, d) element strides, fetched once a
    call. Returns (ops, ptrs, strides)."""
    ops = [t if t.stride(-1) == 1 else t.contiguous() for t in ops]
    return ops, [t.data_ptr() for t in ops], [t.stride() for t in ops]


def hopper_plan(ops, scale):
    """`attention_views` of `ops` (q, k, v and dout where there is one),
    and whether the Hopper attention bodies take them: bf16 throughout,
    head dim 32 < D <= 128 with D % 8 == 0, a positive scale, and views
    TMA can describe (every stride but D's a multiple of 8 elements,
    16-byte aligned bases). Returns (hopper, ops, ptrs, strides)."""
    import torch

    ops, ptrs, strides = attention_views(ops)
    d = ops[0].shape[-1]
    if not (32 < d <= 128 and not d % 8 and scale > 0):
        return False, ops, ptrs, strides
    hopper = all(t.dtype == torch.bfloat16 and not (
        st[0] % 8 or st[1] % 8 or st[2] % 8 or ptr % 16)
        for t, ptr, st in zip(ops, ptrs, strides))
    return hopper, ops, ptrs, strides


_DIMS = struct.Struct("<16q")
_NO_DOUT = (0, 0, 0)


def attention_dims(shape, strides):
    """The packed sizes of an attention launch, as `ptt_flash_attention`
    and `ptt_short_attention` take them: B, S, H, D, then the (b, s, h)
    element strides of q, k, v and dout (0 without one)."""
    return _DIMS.pack(*shape, *strides[0][:3], *strides[1][:3],
                      *strides[2][:3],
                      *(strides[3][:3] if len(strides) > 3 else _NO_DOUT))
