"""Builds and loads the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with `ctypes`. The build
happens at first use (never at import), writes into
``paddle_tpu_torch/_build/`` (listed in ``.gitignore``) and is keyed by a
hash of the sources, so an edited kernel is rebuilt and an unchanged one is
loaded as it is. The sources compile in parallel, one ``nvcc`` each, and
are linked once.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
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
#: register, shared-memory and spill lines)
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
        _run([nvcc, ARCH, "-shared", "-o", tmp, *objs])
        os.replace(tmp, lib_path)
        with open(stamp, "w") as f:
            f.write(digest)
        ptxas = [ln.strip() for log in logs for ln in log.splitlines()
                 if ("ptxas info" in ln and ("registers" in ln
                                             or "Compiling" in ln))
                 or "spill" in ln]
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
    # x, qweight, scale, out, m, n, k, x_dtype, int4, stream
    _sig(handle.ptt_weight_only_matmul, P, P, P, P, I, I, I, I, I, P)
    # q, kq, ks, vq, vs, tables, pos, out, B, H, Hkv, D, BS, NB,
    # kv strides (n, h, t), scale strides (n, h, t), q_dtype, kv_dtype,
    # softmax scale, split scratch, stream
    _sig(handle.ptt_paged_decode_attention, P, P, P, P, P, P, P, P,
         I, I, I, I, I, I, L, L, L, L, L, L, I, I, F, P, P)
    _sig(handle.ptt_paged_decode_splits, I, I)
    # kind, q, k, v, dout, lse, delta, out0, out1, lse_out, B, S, H, D,
    # strides (b, s, h) of q, k, v, dout, dtype, scale, causal, stream
    _sig(handle.ptt_flash_attention, I, P, P, P, P, P, P, P, P, P,
         I, I, I, I, *([L] * 12), I, F, I, P)
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


#: dtype codes shared with the C entry points
def dtype_code(dtype):
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
             torch.int8: 3}
    if dtype not in codes:
        raise TypeError(f"unsupported dtype {dtype} for the CUDA kernels")
    return codes[dtype]
