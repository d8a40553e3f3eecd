"""Port parity of the export-and-predict path (`paddle_tpu_torch.jit`
save / load, `inference.Config` / `create_predictor` / `Predictor` /
`PredictorPool`) against the JAX package's, the counterparts of
tests/test_inference_export.py.

Every test exports the same model in both packages: the JAX model is
built from a seed, saved with `paddle_tpu.jit.save`, and its parameter
archive is read into the port's model by
`convert.load_jax_artifact_params` before the port saves its own
artifact. Both `Predictor.run`s then take the same numpy inputs; f32
outputs agree to 1e-5 relative (1e-4 absolute for tiny BERT: the two
frameworks sum in other orders). The port's loaded program is held
bit-for-bit to the eager model it was exported from (the same torch ops
on the same device), and its bucket programs to its own single runs.
The port runs on the CPU (`Config.disable_gpu()`, ``device="cpu"``):
there its kernel operators compute their plain versions.
"""
import concurrent.futures
import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jcreate
from paddle_tpu.models import bert_for_sequence_classification as jbert_cls
from paddle_tpu.nn.quant import quantize_for_inference as jquantize

from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.convert import load_jax_artifact_params
from paddle_tpu_torch.inference import (Config, PredictorPool,
                                        create_predictor)
from paddle_tpu_torch.models import bert_for_sequence_classification
from paddle_tpu_torch.nn.quant import quantize_for_inference

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _private_compile_cache(tmp_path_factory):
    """The JAX side's persistent compile cache in this module's own
    directory: two JAX processes on one cache load each other's
    executables."""
    old = os.environ.get("PADDLE_TPU_COMPILE_CACHE")
    os.environ["PADDLE_TPU_COMPILE_CACHE"] = str(
        tmp_path_factory.mktemp("compile-cache"))
    yield
    if old is None:
        os.environ.pop("PADDLE_TPU_COMPILE_CACHE", None)
    else:
        os.environ["PADDLE_TPU_COMPILE_CACHE"] = old


def _jmodel():
    paddle.seed(0)
    return jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))


def _tmodel():
    return torch.nn.Sequential(torch.nn.Linear(8, 32), torch.nn.ReLU(),
                               torch.nn.Linear(32, 4))


def _export_both(tmp_path, shape, sub="m"):
    """The JAX model saved at <tmp>/<sub>/jax, the port's (with the JAX
    weights) at <tmp>/<sub>/port. Returns (jax prefix, port prefix, port
    model in eval mode)."""
    jm = _jmodel()
    jm.eval()
    jpath = str(tmp_path / sub / "jax")
    x = np.zeros(shape, np.float32)
    paddle.jit.save(jm, jpath, input_spec=[paddle.to_tensor(x)])
    tm = _tmodel()
    load_jax_artifact_params(tm, jpath)
    tm.eval()
    tpath = str(tmp_path / sub / "port")
    tjit.save(tm, tpath, input_spec=[x])
    return jpath, tpath, tm


def _cpu(path):
    cfg = Config(path)
    cfg.disable_gpu()
    return cfg


def _eager(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x)).numpy()


def test_save_load_executes_identically(tmp_path):
    x = np.random.RandomState(0).rand(2, 8).astype(np.float32)
    jpath, tpath, tm = _export_both(tmp_path, (2, 8))
    want = paddle.jit.load(jpath)(paddle.to_tensor(x)).numpy()
    loaded = tjit.load(tpath, device="cpu")
    got = loaded(x).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.array_equal(got, _eager(tm, x))
    assert "ExportedProgram" in loaded.program_text \
        and "def forward" in loaded.program_text
    assert loaded.input_spec[0]["shape"] == [2, 8]
    assert loaded.input_spec == paddle.jit.load(jpath).input_spec
    assert sorted(os.listdir(tmp_path / "m")) == sorted(
        ["jax.pdmodel", "jax.pdiparams", "jax.pdmodel.json",
         "jax.stablehlo.mlir", "port.pdmodel", "port.pdiparams",
         "port.pdmodel.json", "port.pdmodel.txt"])
    meta = json.load(open(tpath + ".pdmodel.json"))
    assert set(json.load(open(jpath + ".pdmodel.json"))) <= set(meta)
    assert meta["param_names"] == ["0.weight", "0.bias", "2.weight",
                                   "2.bias"]
    assert loaded.fingerprint == tjit.load(tpath, device="cpu").fingerprint


def test_loaded_layer_is_standalone(tmp_path):
    """Mutating the original must not affect the loaded artifact."""
    x = np.ones((1, 8), np.float32)
    jpath, tpath, tm = _export_both(tmp_path, (1, 8))
    want = _eager(tm, x)
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(0.0)
    np.testing.assert_array_equal(
        tjit.load(tpath, device="cpu")(x).numpy(), want)
    np.testing.assert_allclose(
        want, paddle.jit.load(jpath)(paddle.to_tensor(x)).numpy(), rtol=RTOL)


def test_predictor_api(tmp_path):
    x = np.random.RandomState(1).rand(4, 8).astype(np.float32)
    jpath, tpath, tm = _export_both(tmp_path, (4, 8))
    jpred = jcreate(JConfig(jpath + ".pdmodel"))
    pred = create_predictor(_cpu(tpath + ".pdmodel"))
    assert pred.get_input_names() == jpred.get_input_names() == ["input_0"]
    for p in (jpred, pred):
        p.get_input_handle("input_0").copy_from_cpu(x)
    want, = jpred.run()
    outs = pred.run()
    np.testing.assert_allclose(outs[0], want, rtol=RTOL)
    assert np.array_equal(outs[0], _eager(tm, x))
    oh = pred.get_output_handle("output_0")
    assert oh.copy_to_cpu().shape == (4, 4)


def test_predictor_output_names_before_run(tmp_path):
    jpath, tpath, _ = _export_both(tmp_path, (2, 8))
    assert create_predictor(_cpu(tpath)).get_output_names() \
        == jcreate(JConfig(jpath)).get_output_names() == ["output_0"]


def test_predictor_clone_and_pool_concurrent(tmp_path):
    """Clones share the loaded program and weights and own their handles;
    concurrent leased runs match the JAX predictor's outputs."""
    jpath, tpath, _ = _export_both(tmp_path, (2, 8), sub="pool")
    base = create_predictor(_cpu(tpath))
    c = base.clone()
    assert c._layer is base._layer
    assert c._inputs is not base._inputs

    pool = PredictorPool(_cpu(tpath), size=3)
    assert len(pool) == 3
    rng = np.random.RandomState(1)
    batches = [rng.rand(2, 8).astype(np.float32) for _ in range(24)]
    jpred = jcreate(JConfig(jpath))
    want = [jpred.run([b])[0] for b in batches]
    single = [base.run([b])[0] for b in batches]

    def serve(i):
        with pool.acquire() as p:
            h = p.get_input_handle(p.get_input_names()[0])
            h.copy_from_cpu(batches[i])
            (out,) = p.run()
        return i, out

    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as ex:
        for i, out in ex.map(serve, range(24)):
            np.testing.assert_allclose(out, want[i], rtol=RTOL,
                                       err_msg=f"request {i}")
            assert np.array_equal(out, single[i])
    assert pool.Retrieve(0) is pool.retrieve(0)
    with pytest.raises(IndexError):
        pool.retrieve(-1)
    with pytest.raises(IndexError):
        pool.retrieve(3)


def test_run_with_unset_handle_raises_naming_it(tmp_path):
    _, tpath, _ = _export_both(tmp_path, (1, 8), sub="unset")
    pred = create_predictor(_cpu(tpath))
    with pytest.raises(ValueError, match="input_0.*never set"):
        pred.run()
    pred.get_input_handle("input_0").copy_from_cpu(
        np.ones((1, 8), np.float32))
    assert pred.run()[0].shape == (1, 4)


def test_pool_release_after_exception_clears_handles(tmp_path):
    _, tpath, _ = _export_both(tmp_path, (2, 8), sub="dirty")
    pool = PredictorPool(_cpu(tpath), size=1)
    stale = np.full((2, 8), 123.0, np.float32)
    with pytest.raises(RuntimeError, match="request exploded"):
        with pool.acquire() as p:
            p.get_input_handle("input_0").copy_from_cpu(stale)
            raise RuntimeError("request exploded")
    with pool.acquire(timeout=1) as p:
        assert p.get_input_handle("input_0").copy_to_cpu() is None
        with pytest.raises(ValueError, match="never set"):
            p.run()
    s = pool.stats()
    assert s["dirty_releases"] == 1 and s["in_flight"] == 0
    assert s["leases_granted"] == 2


def test_handle_reshape_validates_against_input_spec(tmp_path):
    jpath, tpath, _ = _export_both(tmp_path, (2, 8), sub="rs")
    for pred in (jcreate(JConfig(jpath)), create_predictor(_cpu(tpath))):
        h = pred.get_input_handle("input_0")
        h.reshape([2, 8])
        h.reshape((2, 8))
        with pytest.raises(ValueError, match=r"\[4, 8\].*fixed input shape"):
            h.reshape([4, 8])
        with pytest.raises(ValueError, match="fixed input shape"):
            h.reshape([16])
        pred.get_output_handle("output_0").reshape([99])


def test_output_handle_is_stable_and_cleared_on_reset(tmp_path):
    jpath, tpath, _ = _export_both(tmp_path, (2, 8), sub="oh")
    pred = create_predictor(_cpu(tpath))
    jpred = jcreate(JConfig(jpath))
    oh = pred.get_output_handle("output_0")
    assert oh is pred.get_output_handle("output_0")
    assert oh.copy_to_cpu() is None
    x1 = np.random.RandomState(0).rand(2, 8).astype(np.float32)
    out1, = pred.run([x1])
    np.testing.assert_array_equal(oh.copy_to_cpu(), out1)
    np.testing.assert_allclose(out1, jpred.run([x1])[0], rtol=RTOL)
    x2 = np.random.RandomState(1).rand(2, 8).astype(np.float32)
    out2, = pred.run([x2])
    np.testing.assert_array_equal(oh.copy_to_cpu(), out2)
    pred.reset_handles()
    assert oh.copy_to_cpu() is None
    assert oh is pred.get_output_handle("output_0")


def test_pool_acquire_timeout(tmp_path):
    _, tpath, _ = _export_both(tmp_path, (1, 8), sub="t")
    pool = PredictorPool(_cpu(tpath), size=1)
    with pool.acquire():
        with pytest.raises(TimeoutError, match="in flight"):
            with pool.acquire(timeout=0.1):
                pass
    with pool.acquire(timeout=1) as p:
        assert p is pool.retrieve(0)


# ---------------------------------------------------------------------------
# tiny BERT: the kernel operators in the exported program
# ---------------------------------------------------------------------------

BERT_S = 128          # bert_tiny's positions; S >= 128 takes the flash op


def _bert_pair(root, quantize=False):
    """JAX bert_tiny (seeded, eval) exported with [1, 128] ids and token
    types, and the port's model with its archive's weights, exported the
    same way. Returns (jax prefix, port prefix, port model)."""
    paddle.seed(3)
    jm = jbert_cls("bert_tiny")
    tm = bert_for_sequence_classification("bert_tiny", device="cpu")
    if quantize:
        jquantize(jm, "int8", min_features=0)
        quantize_for_inference(tm, "int8", min_features=0)
    jm.eval()
    spec = np.zeros((1, BERT_S), np.int64)
    jpath = str(root / "jax")
    paddle.jit.save(jm, jpath, input_spec=[paddle.to_tensor(spec)] * 2)
    load_jax_artifact_params(tm, jpath)
    tm.eval()
    tpath = str(root / "port")
    tjit.save(tm, tpath, input_spec=[spec, spec])
    return jpath, tpath, tm


@pytest.fixture(scope="module")
def bert_artifacts(tmp_path_factory):
    """{quantize: (jax prefix, port prefix, port model)}, built once."""
    return {q: _bert_pair(tmp_path_factory.mktemp(f"bert{int(q)}"), q)
            for q in (False, True)}


def _bert_feeds(seed):
    r = np.random.RandomState(seed)
    return [r.randint(1, 1024, (1, BERT_S)).astype(np.int64),
            r.randint(0, 2, (1, BERT_S)).astype(np.int64)]


@pytest.mark.parametrize("quantize", [False, True])
def test_bert_tiny_predictor_matches_jax_and_names_the_ops(bert_artifacts,
                                                           quantize):
    """The exported program calls the flash forward operator (and, for an
    int8 model, the weight-only operator) and no aten attention op; its
    outputs equal JAX's predictor to 1e-4 and the eager port model's bit
    for bit, and every bucket program's rows equal single runs."""
    jpath, tpath, tm = bert_artifacts[quantize]
    pred = create_predictor(_cpu(tpath))
    ops = pred._layer.graph_ops
    assert "paddle_tpu_torch.flash_fwd.default" in ops
    assert not [o for o in ops if "attention" in o or "softmax" in o], ops
    assert ("paddle_tpu_torch.weight_only_matmul.default" in ops) \
        == quantize
    assert "flash_fwd" in pred._layer.program_text
    jpred = jcreate(JConfig(jpath))
    feeds = [_bert_feeds(s) for s in range(3)]
    singles = []
    for f in feeds:
        got, = pred.run(f)
        want, = jpred.run(f)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        with torch.no_grad():
            eager = tm(*(torch.from_numpy(a) for a in f)).numpy()
        assert np.array_equal(got, eager)
        singles.append(got)
    for bucket in (1, 2, 4):
        fn = pred._layer.batched_call(bucket)
        rows = [feeds[j % 3] for j in range(bucket)]
        out, = fn(*(np.stack(col) for col in zip(*rows)))
        for j in range(bucket):
            assert np.array_equal(out[j], singles[j % 3]), (bucket, j)


def _on_gpu(layer):
    """`layer` as `jit.aot.bucket_design` sees a GPU program: the same
    operators, the CUDA device."""
    return types.SimpleNamespace(device=torch.device("cuda"),
                                 _module=layer._module)


@pytest.mark.parametrize("quantize", [False, True])
def test_bert_tiny_fold_design_keeps_single_run_bits(bert_artifacts,
                                                     quantize):
    """The GPU's bucket body for bert_tiny ("fold": vmap of the program,
    the operators' vmap rules folding the stacked axis into their own, the
    products and reductions once per example), run on the CPU: every row
    of every bucket equals its single run bit for bit; int8, to f32
    rounding, because the weight-only operator's CPU implementation (the
    plain version, a CPU float32 product over the folded rows) changes its
    bits with the row count. The CPU's own body is the loop."""
    from paddle_tpu_torch.jit import aot

    _, tpath, _ = bert_artifacts[quantize]
    layer = tjit.load(tpath, device="cpu")
    assert aot.bucket_design(layer) == "loop"
    assert layer.batched_call(2).design == "loop"
    assert aot.bucket_design(_on_gpu(layer)) == "fold"
    feeds = [_bert_feeds(s) for s in range(5)]
    singles = [layer(*f).numpy() for f in feeds]
    for bucket in (1, 2, 5):
        prog = aot.compile_batched(layer, bucket, _design="fold")
        assert prog.design == "fold"
        out, = prog(*(np.stack(col) for col in zip(*feeds[:bucket])))
        for j in range(bucket):
            if quantize:
                np.testing.assert_allclose(out[j], singles[j], rtol=1e-5,
                                           atol=1e-6)
            else:
                assert np.array_equal(out[j], singles[j]), (bucket, j)


def test_fold_design_runs_products_and_reductions_per_example(tmp_path):
    """The "fold" body's module calls `per_example` for each product and
    reduction of the program (the exported program itself is unchanged),
    and a program with an operator outside `FOLDED` and `PER_EXAMPLE`
    gets the loop body on the GPU too."""
    from paddle_tpu_torch.jit import aot

    torch.manual_seed(0)
    path = str(tmp_path / "mlp")
    tjit.save(_tmodel().eval(), path, input_spec=[((1, 8), torch.float32)])
    layer = tjit.load(path, device="cpu")
    assert aot.bucket_design(_on_gpu(layer)) == "fold"
    prog = aot.compile_batched(layer, 3, _design="fold")
    targets = [n.target for n in layer._fold_module.graph.nodes
               if n.op == "call_function"]
    assert targets.count(aot.per_example) == 2
    assert "aten.linear.default" in layer.graph_ops
    rng = np.random.RandomState(0)
    xs = [rng.rand(1, 8).astype(np.float32) for _ in range(3)]
    out, = prog(np.stack(xs))
    for j, x in enumerate(xs):
        assert np.array_equal(out[j], layer(x).numpy())

    class Sorts(torch.nn.Module):
        def forward(self, x):
            return torch.sort(x, dim=-1).values

    spath = str(tmp_path / "sorts")
    tjit.save(Sorts(), spath, input_spec=[((1, 8), torch.float32)])
    sl = tjit.load(spath, device="cpu")
    assert aot.bucket_design(_on_gpu(sl)) == "loop"


# ---------------------------------------------------------------------------
# the port's own surface
# ---------------------------------------------------------------------------

def test_bf16_weights_round_trip_as_uint16_bits(tmp_path):
    """bf16 parameters are archived as their uint16 bits (numpy only, no
    ml_dtypes), with the dtype in the meta, and load bit for bit."""
    torch.manual_seed(0)
    tm = _tmodel().to(torch.bfloat16).eval()
    path = str(tmp_path / "bf16" / "m")
    tjit.save(tm, path, input_spec=[((2, 8), torch.bfloat16)])
    with open(path + ".pdiparams", "rb") as f:
        raw = pickle.load(f)
    assert all(a.dtype == np.uint16 for a in raw.values())
    meta = json.load(open(path + ".pdmodel.json"))
    assert meta["param_dtypes"] == {n: "bfloat16" for n in raw}
    assert meta["inputs"] == [{"shape": [2, 8], "dtype": "bfloat16"}]
    layer = tjit.load(path, device="cpu")
    for n, p in tm.named_parameters():
        assert torch.equal(layer.state_dict()[n], p.detach())
    x = torch.randn(2, 8).to(torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(layer(x), tm(x))


def test_jax_bf16_archive_is_refused_naming_ml_dtypes(tmp_path):
    jm = _jmodel()
    jm.bfloat16()
    jm.eval()
    jpath = str(tmp_path / "jbf16" / "m")
    paddle.jit.save(jm, jpath, input_spec=[
        paddle.to_tensor(np.zeros((1, 8), np.float32)).astype("bfloat16")])
    with pytest.raises(ValueError, match="ml_dtypes"):
        load_jax_artifact_params(_tmodel(), jpath)


def test_set_state_dict_serves_new_weights_in_place(tmp_path):
    _, tpath, tm = _export_both(tmp_path, (2, 8), sub="swap")
    layer = tjit.load(tpath, device="cpu")
    fn = layer.batched_call(2)
    x = np.random.RandomState(5).rand(2, 2, 8).astype(np.float32)
    before = fn(x)[0]
    ptrs = {n: t.data_ptr() for n, t in layer.state_dict().items()}
    layer.set_state_dict({n: t * 2 for n, t in layer.state_dict().items()})
    assert {n: t.data_ptr() for n, t in layer.state_dict().items()} == ptrs
    after = fn(x)[0]
    assert not np.array_equal(before, after)
    assert np.array_equal(after[1], layer(x[1]).numpy())
    with pytest.raises(ValueError, match="does not fit"):
        layer.set_state_dict({"0.weight": torch.zeros(3, 3)})


def test_program_moved_between_devices_by_torch_pass(tmp_path, monkeypatch):
    """An artifact recorded on another device goes through
    `move_to_device_pass` (never a new trace) and still runs."""
    import torch.export.passes as passes

    _, tpath, tm = _export_both(tmp_path, (2, 8), sub="mv")
    meta = json.load(open(tpath + ".pdmodel.json"))
    meta["device"] = "cuda"
    json.dump(meta, open(tpath + ".pdmodel.json", "w"))
    seen = []
    real = passes.move_to_device_pass
    monkeypatch.setattr(passes, "move_to_device_pass",
                        lambda ep, loc: seen.append(loc) or real(ep, loc))
    x = np.random.RandomState(2).rand(2, 8).astype(np.float32)
    layer = tjit.load(tpath, device="cpu")
    assert seen == [torch.device("cpu")]
    assert np.array_equal(layer(x).numpy(), _eager(tm, x))


def test_unported_jit_names_and_the_cache_refusal_name_their_reasons(
        tmp_path):
    from paddle_tpu_torch.jit import aot

    for name in ("to_static", "not_to_static", "enable_to_static"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            getattr(tjit, name)(lambda x: x)
    _, tpath, _ = _export_both(tmp_path, (1, 8), sub="ref")
    layer = tjit.load(tpath, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        layer.shard_(None)
    with pytest.raises(NotImplementedError, match="serialized form"):
        tjit.CompileCache()
    with pytest.raises(NotImplementedError, match="serialized form"):
        layer.batched_call(1, cache=object())
    with pytest.raises(ValueError, match="input_spec"):
        tjit.save(_tmodel(), str(tmp_path / "x"))


def test_config_resolves_to_the_gpu_unless_disabled(tmp_path):
    _, tpath, _ = _export_both(tmp_path, (1, 8), sub="cfg")
    for suffix in ("", ".pdmodel", ".pdiparams", ".pdmodel.json",
                   ".pdmodel.txt"):
        assert Config(tpath + suffix).model_prefix == tpath
    cfg = _cpu(tpath)
    assert not cfg.use_gpu() and cfg.device() == torch.device("cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_predictor(Config(tpath))
