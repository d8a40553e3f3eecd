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
    assert n >= 52                      # every module was imported


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


def test_resnet_constructors_raise_without_gpu():
    from paddle_tpu_torch.models import BottleneckBlock, ResNet, resnet50

    assert resnet50(num_classes=10, device="cpu").fc.weight.device.type \
        == "cpu"
    _no_gpu()
    with pytest.raises(RuntimeError, match="CUDA"):
        resnet50()
    with pytest.raises(RuntimeError, match="CUDA"):
        ResNet(BottleneckBlock, [1, 1, 1, 1], num_classes=10)


def test_block_pool_raises_without_gpu():
    from paddle_tpu_torch.inference.decode import BlockKVCache

    spec = (((2, 4), torch.float32),)
    assert BlockKVCache(4, 4, [spec], device="cpu").device.type == "cpu"
    _no_gpu()
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockKVCache(4, 4, [spec])


def test_engine_raises_without_gpu_and_checks_model_device():
    m = gpt("gpt_tiny", device="cpu")
    with pytest.raises(ValueError):
        DecodeEngine(m, max_length=16, device="meta")
    _no_gpu()
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(m, max_length=16)


def test_kernel_wrappers_have_launch_counters():
    from paddle_tpu_torch.ops import (flash_attention_bwd_dkv,
                                      flash_attention_bwd_dq,
                                      flash_attention_fwd,
                                      fused_bottleneck_bwd,
                                      fused_bottleneck_fwd, lora_delta,
                                      paged_decode_attention,
                                      short_attention_bwd,
                                      short_attention_fwd,
                                      weight_only_matmul)

    for wrapper in (weight_only_matmul, paged_decode_attention,
                    flash_attention_fwd, flash_attention_bwd_dq,
                    flash_attention_bwd_dkv, lora_delta,
                    short_attention_fwd, short_attention_bwd,
                    fused_bottleneck_fwd, fused_bottleneck_bwd):
        assert isinstance(wrapper.launches, int)


def test_adapter_pool_raises_without_gpu_and_checks_model_device():
    from paddle_tpu_torch.inference import AdapterPool

    m = gpt("gpt_tiny", device="cpu")
    with pytest.raises(ValueError, match="model is on"):
        AdapterPool(m, rank=2, device="meta")
    _no_gpu()
    with pytest.raises(RuntimeError, match="CUDA"):
        AdapterPool(m, rank=2)


def test_parallelize_trains_where_the_model_lives():
    """The engine never moves the model: it trains on the device the
    caller built it on (the CPU here only because the caller asked), and
    brings the batch there. A CPU step launches no kernel."""
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.ops import flash_attention_fwd
    from paddle_tpu_torch.optimizer import AdamW

    m = gpt("gpt_tiny", device="cpu")
    before = {n: p.data_ptr() for n, p in m.named_parameters()}
    eng = parallelize(m, AdamW(parameters=m.parameters()))
    launches = flash_attention_fwd.launches
    loss = eng.train_batch(torch.zeros(2, 128, dtype=torch.long).numpy())
    assert loss.device.type == "cpu" and eng.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in m.parameters())
    assert {n: p.data_ptr() for n, p in m.named_parameters()} == before
    assert eng.stats["device_puts"] == 0
    assert flash_attention_fwd.launches == launches
