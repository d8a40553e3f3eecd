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
        print("MODS", " ".join(sorted(n for n in sys.modules
                                      if n.startswith("paddle_tpu_torch"))))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("N ")[1].split()[0])
    assert n >= 64                      # every module was imported
    mods = set(out.stdout.split("MODS ")[1].split())
    # the serving runtime's modules among them
    assert {f"paddle_tpu_torch.{m}" for m in (
        "inference.serving", "inference.replica", "inference.router",
        "inference.decode.demo", "obs", "obs.metrics", "obs.export",
        "obs.slo", "obs.http", "obs.trace", "obs.flight", "native",
        "distributed.store",
        "distributed.checkpoint", "distributed.checkpoint.api")} <= mods
    # the export-and-predict path's modules among them
    assert {f"paddle_tpu_torch.{m}" for m in (
        "jit", "jit.save_load", "jit.aot", "inference.batching",
        "ops._library", "_graphs")} <= mods


def test_replica_main_and_native_store_load_no_jax():
    """The replica process's entry (``python -m
    paddle_tpu_torch.inference.replica``) and the native coordination
    store, built from the port's own source, load nothing of JAX."""
    code = textwrap.dedent("""
        import runpy, sys
        sys.argv = ["replica", "--help"]
        try:
            runpy.run_module("paddle_tpu_torch.inference.replica",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        from paddle_tpu_torch import native
        from paddle_tpu_torch.distributed.store import create_master_store
        s = create_master_store()
        s.set("k", b"v")
        assert s.get_nowait("k") == b"v"
        s.close()
        print("LIB", native.build("coord_store"))
        bad = sorted(n for n in sys.modules
                     if n in ("jax", "jaxlib", "paddle_tpu")
                     or n.startswith(("jax.", "jaxlib.", "paddle_tpu.")))
        print("BAD", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "--device" in out.stdout
    lib = out.stdout.split("LIB ")[1].split()[0]
    assert lib.startswith(os.path.join(REPO, "paddle_tpu_torch", "_build"))


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


def test_vision_constructors_raise_without_gpu():
    from paddle_tpu_torch.vision import models, ops

    assert models.vit_tiny(device="cpu").head.weight.device.type == "cpu"
    _no_gpu()
    for build in (models.ppyoloe_s, models.vit_tiny, models.LeNet,
                  models.squeezenet1_1):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.nms([[0.0, 0.0, 1.0, 1.0]])


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


def test_predictor_raises_without_gpu_and_runs_where_asked(tmp_path):
    """`jit.load` and `inference.Config` resolve to the GPU and raise
    without one; `device="cpu"` / `Config.disable_gpu()` run the exported
    program on the CPU (the kernel operators' plain versions: no launch)."""
    import numpy as np

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.ops import flash_attention_fwd

    m = torch.nn.Linear(4, 2)
    path = str(tmp_path / "m")
    jit.save(m, path, input_spec=[np.zeros((1, 4), np.float32)])
    cfg = Config(path)
    cfg.disable_gpu()
    launches = flash_attention_fwd.launches
    out, = create_predictor(cfg).run([np.ones((1, 4), np.float32)])
    assert out.shape == (1, 2) and flash_attention_fwd.launches == launches
    assert jit.load(path, device="cpu").device.type == "cpu"
    _no_gpu()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jit.load(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_predictor(Config(path))


def test_replica_process_raises_without_gpu_unless_asked_for_cpu(tmp_path):
    """A replica process serves on the GPU by default: without one it
    raises and exits non-zero before its first heartbeat (the handle
    raises `ReplicaDead`), and with ``device="cpu"`` it serves."""
    import numpy as np

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.distributed.store import create_master_store
    from paddle_tpu_torch.inference import ReplicaDead, SubprocessReplica

    _no_gpu()
    jit.save(torch.nn.Linear(4, 2), str(tmp_path / "model"),
             input_spec=[np.zeros((1, 4), np.float32)])
    store = create_master_store()
    reps = []
    try:
        with pytest.raises(ReplicaDead, match="exited with 1"):
            reps.append(SubprocessReplica("gpu", store, str(tmp_path),
                                          artifact_name="model",
                                          start_timeout=120.0))
        reps.append(SubprocessReplica("cpu", store, str(tmp_path),
                                      artifact_name="model",
                                      start_timeout=120.0, device="cpu"))
        out, = reps[-1].infer([np.ones((1, 4), np.float32)], timeout=60.0)
        assert out.shape == (1, 2)
    finally:
        for rep in reps:
            rep.kill()
        store.close()
