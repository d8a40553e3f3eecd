"""The port stands alone and runs on the GPU unless told otherwise:
`import paddle_tpu_torch` (every module of it) loads nothing of JAX or of
the JAX package, and the entry points raise instead of silently running
on the CPU when no GPU is visible."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.inference import DecodeEngine
from paddle_tpu_torch.models import gpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax_and_no_reference_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import paddle_tpu_torch
        for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                       "paddle_tpu_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n in ("jax", "jaxlib", "paddle_tpu")
                     or n.startswith(("jax.", "jaxlib.", "paddle_tpu.")))
        print("BAD", bad)
        print("N", sum(n.startswith("paddle_tpu_torch") for n in sys.modules))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("N ")[1].split()[0])
    assert n >= 15                      # every module was imported


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-GPU error path is not taken")


def test_resolve_device_defaults_to_cuda_and_raises_without_gpu():
    assert paddle_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    _no_gpu()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError):
        paddle_tpu_torch.resolve_device("cuda")


def test_model_constructor_raises_without_gpu():
    _no_gpu()
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt("gpt_tiny")


def test_engine_raises_without_gpu_and_checks_model_device():
    m = gpt("gpt_tiny", device="cpu")
    with pytest.raises(ValueError):
        DecodeEngine(m, max_length=16, device="meta")
    _no_gpu()
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(m, max_length=16)


def test_kernel_wrappers_have_launch_counters():
    from paddle_tpu_torch.ops import (paged_decode_attention,
                                      weight_only_matmul)

    assert isinstance(weight_only_matmul.launches, int)
    assert isinstance(paged_decode_attention.launches, int)
