"""Native (C++) host components of the port, built with the host C++
compiler and loaded with `ctypes` (counterpart of
paddle_tpu/native/__init__.py).

Each component is one ``native/<name>.cc`` compiled at first use (never
at import) into ``paddle_tpu_torch/_build/`` (listed in ``.gitignore``),
keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. The build takes a file
lock: several test workers, or two replica processes, may ask for it at
once. These sources are kept apart from the CUDA kernels (``csrc/``,
`ops._build`), which ``nvcc`` builds into their own library.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs = {}


def build(name):
    """Compile ``native/<name>.cc`` unless a build of the same source is
    cached; returns the shared library's path."""
    src = os.path.join(_DIR, name + ".cc")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = so + f".tmp{os.getpid()}"
            proc = subprocess.run(["g++", *FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"native build of {name} failed:\n"
                                   f"{proc.stderr}")
            os.replace(tmp, so)
    return so


def load(name):
    """The loaded library of ``native/<name>.cc`` (built on first call)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
