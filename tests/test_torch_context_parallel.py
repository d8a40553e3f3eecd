"""Port parity of context parallelism (`paddle_tpu_torch.distributed.
context_parallel` and the engine's cp mesh) against the JAX package.

The same numpy inputs go to the JAX function and to its port:

* placement: `zigzag_permutation` and each rank's positions against the
  JAX ones (its `_local_positions` inside shard_map);
* the ring-step kernels' plain versions (`flash_fwd_pos_ref`,
  `flash_bwd_pos_ref`) against JAX `flash_fwd_pos` / `flash_bwd_pos`
  (Pallas, interpret mode), f32: O and the lse of rows that see a key
  <= 2e-5, a row that sees none O == 0 exactly and lse <= -1e29 on both
  sides, gradients <= 2e-4;
* ring (plain and flash bodies) and Ulysses, run by 2 and 4 gloo ranks
  on the CPU (tests/test_torch_cp_worker.py), against JAX
  `context_parallel_attention` on `MeshConfig(cp=n)` (the 8 virtual CPU
  devices): out <= 2e-5, gradients <= 2e-4 (JAX's own bounds,
  tests/test_context_parallel.py);
* the engine: gpt_tiny (2 layers, max_position_embeddings=256, S=256 so
  the shard of 128 passes the flash ring's shape rule) takes 3 AdamW
  steps at cp=2 on gloo, with both ring bodies; the losses match the JAX
  engine on `MeshConfig(cp=2)` with "ring" and the port's single-device
  engine to <= 1e-5, and both ranks report the same losses and norms.

Spawned ranks rendezvous through a file store under the test's temporary
directory (no TCP port: the suite runs several workers at once), each
spawn is joined with its own timeout and killed on expiry, and one spawn
per world size runs every check of that size.
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.context_parallel import (
    _local_positions as jax_local_positions)
from paddle_tpu.distributed.context_parallel import (
    zigzag_permutation as jax_zigzag)
from paddle_tpu.ops.pallas.flash_attention import (flash_bwd_pos as jfbp,
                                                   flash_fwd_pos as jffp)

from paddle_tpu_torch.distributed import context_parallel as cpm
from paddle_tpu_torch.ops.flash_attention import (flash_bwd_pos_ref,
                                                  flash_fwd_pos_ref)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_cp_worker.py")
SPAWN_TIMEOUT = 240          # seconds for one whole gloo job
OUT_TOL, GRAD_TOL = 2e-5, 2e-4


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,n", [(32, 4), (1024, 2)])
def test_zigzag_and_local_positions_equal_jax(seq, n):
    from paddle_tpu.compat import shard_map
    from paddle_tpu.sharding import MeshConfig, spec

    perm, inv = cpm.zigzag_permutation(seq, n)
    jperm, jinv = jax_zigzag(seq, n)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    mesh = MeshConfig(cp=n).build()
    for balanced in (True, False):
        fn = shard_map(lambda x: jax_local_positions("cp", seq // n,
                                                     balanced),
                       mesh=mesh, in_specs=(spec("cp"),),
                       out_specs=spec("cp"), check_vma=False)
        want = np.asarray(fn(jnp.zeros(seq)))
        got = np.concatenate([cpm._local_positions(r, n, seq // n, balanced)
                              .numpy() for r in range(n)])
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        if balanced:
            np.testing.assert_array_equal(got, perm)
    with pytest.raises(ValueError):
        cpm.zigzag_permutation(30, 4)


# ---------------------------------------------------------------------------
# the ring-step kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _bh(x):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _from_bh(x, b, h):
    bh, s, d = x.shape
    return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)


POS_CASES = {
    # rank 0 of a 2-way zigzag ring against its own and the other shard
    "zigzag causal, own shard": (True, (0, 127, 384, 511), (0, 127, 384, 511)),
    "zigzag causal, visiting": (True, (0, 127, 384, 511),
                                (128, 255, 256, 383)),
    # contiguous: rank 0 sees shard 1's keys, all in its future
    "contiguous causal, fully masked": (True, (0, 255), (256, 511)),
    "contiguous causal, visiting": (True, (256, 511), (0, 255)),
    "not causal": (False, (0, 255), (256, 511)),
}


def _positions(spans):
    return np.concatenate([np.arange(lo, hi + 1) for lo, hi in
                           zip(spans[::2], spans[1::2])]).astype(np.int32)


@pytest.mark.parametrize("case", sorted(POS_CASES))
def test_pos_kernels_plain_match_jax(case):
    causal, qspans, kspans = POS_CASES[case]
    q_pos, k_pos = _positions(qspans), _positions(kspans)
    rng = np.random.default_rng(len(case))
    b, h, d = 1, 2, 32
    q, do = (_randn(rng, b, len(q_pos), h, d) for _ in range(2))
    k, v = (_randn(rng, b, len(k_pos), h, d) for _ in range(2))
    scale = 1.0 / np.sqrt(d)
    jo, jlse = jffp(_bh(q), _bh(k), _bh(v), jnp.asarray(q_pos),
                    jnp.asarray(k_pos), scale=scale, causal=causal,
                    interpret=True)
    t = [torch.from_numpy(x) for x in (q, k, v, do, q_pos, k_pos)]
    out, lse = flash_fwd_pos_ref(t[0], t[1], t[2], t[4], t[5], causal=causal,
                                 scale=scale)
    jo, jlse = _from_bh(jo, b, h), np.asarray(jlse)[..., 0].reshape(b, h, -1)
    seen = (q_pos[:, None] >= k_pos[None, :]).any(1) if causal else \
        np.ones(len(q_pos), bool)
    np.testing.assert_allclose(out.numpy()[:, seen], jo[:, seen], rtol=0,
                               atol=OUT_TOL)
    np.testing.assert_allclose(lse.numpy()[..., seen], jlse[..., seen],
                               rtol=0, atol=OUT_TOL)
    assert (out.numpy()[:, ~seen] == 0).all() and (jo[:, ~seen] == 0).all()
    assert (lse.numpy()[..., ~seen] <= -1e29).all()
    assert (jlse[..., ~seen] <= -1e29).all()
    assert np.isfinite(lse.numpy()).all()
    # the backward from this step's own statistics (as a one-step ring)
    delta = (do * out.numpy()).sum(-1).transpose(0, 2, 1)
    jdq, jdk, jdv = jfbp(_bh(q), _bh(k), _bh(v), _bh(do),
                         jnp.asarray(lse.numpy().reshape(b * h, -1, 1)),
                         jnp.asarray(delta.reshape(b * h, -1, 1)),
                         jnp.asarray(q_pos), jnp.asarray(k_pos),
                         scale=scale, causal=causal, interpret=True)
    got = flash_bwd_pos_ref(t[0], t[1], t[2], t[3], lse,
                            torch.from_numpy(delta), t[4], t[5],
                            causal=causal, scale=scale)
    for name, g, jg in zip(("dq", "dk", "dv"), got, (jdq, jdk, jdv)):
        np.testing.assert_allclose(g.numpy(), _from_bh(jg, b, h), rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal,balanced", [(True, True), (True, False),
                                             (False, False)])
def test_serial_ring_matches_whole_sequence(n, causal, balanced):
    """The ring's n steps run in one process (`ring_serial`) through the
    pos kernels' plain versions and the merge equal the plain flash
    attention of the whole sequence, forward and backward (f32)."""
    from paddle_tpu_torch.ops.flash_attention import (attention_delta,
                                                      flash_attention_bwd_ref,
                                                      flash_attention_ref)

    rng = np.random.default_rng(n)
    q, k, v, do = (torch.from_numpy(_randn(rng, 2, 256, 2, 16))
                   for _ in range(4))
    got, _ = cpm.ring_serial(q, k, v, do, n, causal=causal,
                             balanced=balanced)
    out, lse = flash_attention_ref(q, k, v, causal=causal)
    want = (out, *flash_attention_bwd_ref(q, k, v, do, lse,
                                          attention_delta(out, do),
                                          causal=causal))
    for name, g, w, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (OUT_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=tol,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# ring and Ulysses across gloo ranks, and the engine
# ---------------------------------------------------------------------------

#: name -> (mode, impl, causal, balanced); Ulysses' rows arrive zigzag
#: placed when causal (the port's placement rule)
CP_CASES = {
    2: {"ring flash causal zigzag": ("ring", "flash", True, True),
        "ring flash causal contiguous": ("ring", "flash", True, False),
        "ring flash full": ("ring", "flash", False, False),
        "ring einsum causal zigzag": ("ring", "einsum", True, True),
        "ring einsum causal contiguous": ("ring", "einsum", True, False),
        "ring einsum full": ("ring", "einsum", False, False),
        "ulysses causal": ("ulysses", None, True, True),
        "ulysses full": ("ulysses", None, False, False)},
    4: {"ring flash causal zigzag": ("ring", "flash", True, True),
        "ring flash causal contiguous": ("ring", "flash", True, False),
        "ring einsum causal zigzag": ("ring", "einsum", True, True),
        "ring einsum full": ("ring", "einsum", False, False),
        "ulysses causal": ("ulysses", None, True, True)},
}
CP_SHAPE = {2: (1, 256, 2, 16), 4: (1, 512, 4, 16)}
ENGINE = dict(steps=3, lr=1e-3, batch=2, seq=256,
              overrides=dict(num_layers=2, max_position_embeddings=256))


def _attention_inputs(n):
    rng = np.random.default_rng(100 + n)
    out = {}
    for name, (mode, impl, causal, balanced) in CP_CASES[n].items():
        q, k, v, do = (_randn(rng, *CP_SHAPE[n]) for _ in range(4))
        out[name] = dict(mode=mode, impl=impl, causal=causal,
                         balanced=balanced, q=q, k=k, v=v, do=do)
    return out


def _jax_attention(n, case):
    from paddle_tpu.sharding import MeshConfig

    mesh = MeshConfig(cp=n).build()
    kw = dict(mode=case["mode"], seq_axis="cp", causal=case["causal"])
    if case["mode"] == "ring":
        kw.update(impl=case["impl"], balanced=case["balanced"])

    def f(q, k, v):
        return jdist.context_parallel_attention(q, k, v, mesh, **kw)

    @jax.jit          # one compile: eager shard_map loops are slow
    def out_and_grads(q, k, v, do):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(do))

    q, k, v, do = (jnp.asarray(case[x]) for x in ("q", "k", "v", "do"))
    return [np.asarray(x) for x in out_and_grads(q, k, v, do)]


def _engine_payload():
    from paddle_tpu.models import gpt as jgpt

    paddle.seed(0)
    jm = jgpt("gpt_tiny", **ENGINE["overrides"])
    init = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    ids = np.random.RandomState(0).randint(
        0, 256, (ENGINE["batch"], ENGINE["seq"])).astype(np.int32)
    return dict(init=init, ids=ids, **ENGINE)


def _jax_engine(payload):
    """3 steps of the JAX engine on MeshConfig(cp=2), ring."""
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu.nn import ClipGradByGlobalNorm
    from paddle_tpu.sharding import MeshConfig

    prev = jdist.get_hybrid_communicate_group()
    try:
        jm = jgpt("gpt_tiny", **ENGINE["overrides"])
        jm.set_state_dict({k: paddle.to_tensor(v)
                           for k, v in payload["init"].items()})
        opt = paddle.optimizer.AdamW(learning_rate=ENGINE["lr"],
                                     parameters=jm.parameters(),
                                     grad_clip=ClipGradByGlobalNorm(1.0))
        with jax.default_matmul_precision("highest"):
            eng = jdist.parallelize(jm, opt, mesh=MeshConfig(cp=2).build(),
                                    context_parallel="ring")
            ids = paddle.to_tensor(payload["ids"])
            losses, norms = [], []
            for _ in range(ENGINE["steps"]):
                losses.append(float(eng.train_batch(ids)))
                norms.append(float(eng.last_grad_norm))
    finally:
        jdist.set_hybrid_communicate_group(prev)
    return losses, norms


def _single_device_engine(payload):
    from paddle_tpu_torch.convert import load_jax_state
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    tm = gpt("gpt_tiny", device="cpu", **ENGINE["overrides"])
    load_jax_state(tm, payload["init"])
    opt = AdamW(learning_rate=ENGINE["lr"], parameters=tm.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    eng = parallelize(tm, opt)
    ids = torch.from_numpy(payload["ids"]).long()
    losses, norms = [], []
    for _ in range(ENGINE["steps"]):
        losses.append(float(eng.train_batch(ids)))
        norms.append(float(eng.last_grad_norm))
    return losses, norms


def _start(workdir, n):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, str(workdir), str(r),
                              str(n)], cwd=REPO, env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def _join(procs, workdir, started):
    """Wait for every rank within SPAWN_TIMEOUT of the start; on expiry or
    a failed rank kill them all and fail with their output."""
    logs, failed = [], None
    for r, p in enumerate(procs):
        left = max(1.0, SPAWN_TIMEOUT - (time.monotonic() - started))
        try:
            out, _ = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            failed = f"rank {r} still running after {SPAWN_TIMEOUT} s"
            break
        logs.append(out)
        if p.returncode != 0:
            failed = f"rank {r} exited with {p.returncode}"
            break
    if failed:
        for p in procs:
            p.kill()
        tails = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                out = "(no output)"
            tails.append((out or "")[-3000:])
        pytest.fail(f"{failed}\n" + "\n---\n".join(logs[-1:] + tails))
    res = []
    for r in range(len(procs)):
        with open(os.path.join(workdir, f"out.{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def _run(tmp_path_factory, n, engine):
    workdir = tmp_path_factory.mktemp(f"cp{n}")
    payload = {"attention": _attention_inputs(n),
               "engine": _engine_payload() if engine else None,
               "timeout": SPAWN_TIMEOUT}
    with open(workdir / "in.pkl", "wb") as f:
        pickle.dump(payload, f)
    started = time.monotonic()
    procs = _start(workdir, n)
    try:
        # the references run while the ranks do
        ref = {name: _jax_attention(n, case)
               for name, case in payload["attention"].items()}
        if engine:
            ref["engine"] = {"jax": _jax_engine(payload["engine"]),
                             "single": _single_device_engine(
                                 payload["engine"])}
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return payload, ref, _join(procs, workdir, started)


@pytest.fixture(scope="module")
def cp2(tmp_path_factory):
    return _run(tmp_path_factory, 2, engine=True)


@pytest.fixture(scope="module")
def cp4(tmp_path_factory):
    return _run(tmp_path_factory, 4, engine=False)


def _check_attention(run, name):
    payload, ref, ranks = run
    want = dict(zip(("out", "dq", "dk", "dv"), ref[name]))
    for r, res in enumerate(ranks):
        got = res["attention"][name]
        rows = got["rows"]
        for key, tol in (("out", OUT_TOL), ("dq", GRAD_TOL),
                         ("dk", GRAD_TOL), ("dv", GRAD_TOL)):
            np.testing.assert_allclose(got[key], want[key][:, rows], rtol=0,
                                       atol=tol, err_msg=f"rank {r} {key}")
    # the ranks' rows cover the sequence once
    rows = np.concatenate([res["attention"][name]["rows"] for res in ranks])
    assert sorted(rows.tolist()) == list(range(want["out"].shape[1]))


@pytest.mark.parametrize("name", sorted(CP_CASES[2]))
def test_cp2_attention_matches_jax(cp2, name):
    _check_attention(cp2, name)


@pytest.mark.parametrize("name", sorted(CP_CASES[4]))
def test_cp4_attention_matches_jax(cp4, name):
    _check_attention(cp4, name)


@pytest.mark.parametrize("body", ["einsum", "flash"])
def test_cp2_engine_matches_jax_and_single_device(cp2, body):
    _, ref, ranks = cp2
    jl, jn = ref["engine"]["jax"]
    sl, sn = ref["engine"]["single"]
    runs = [res["engine"][body] for res in ranks]
    np.testing.assert_allclose(runs[0]["losses"], jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runs[0]["losses"], sl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runs[0]["norms"], jn, rtol=1e-4)
    np.testing.assert_allclose(runs[0]["norms"], sn, rtol=1e-4)
    assert runs[0]["losses"][-1] < runs[0]["losses"][0]
    # the ranks report one loss and one norm, and keep one set of weights
    for key in ("losses", "norms", "digest", "eval"):
        assert runs[0][key] == runs[1][key], key
    ex = runs[0]["exchange"]
    assert ex["shift"]["calls"] > 0 and ex["all_reduce"]["calls"] > 0


def test_cp2_engine_weights_and_loss_fn(cp2):
    """Every rank loads the same `params_from_jax` state (convert needs
    nothing for cp), and a custom loss_fn is refused under cp > 1 while
    the model's own loss is accepted."""
    _, _, ranks = cp2
    for res in ranks:
        eng = res["engine"]
        assert eng["loaded_equals_bridge"]
        assert eng["initial_digest"] == ranks[0]["engine"]["initial_digest"]
        assert eng["custom_loss_fn"].startswith("raised: a custom loss_fn")
        assert eng["own_loss_accepted"] == 2


# ---------------------------------------------------------------------------
# what is refused
# ---------------------------------------------------------------------------

def test_mesh_config_refuses_what_is_not_ported():
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.sharding import MeshConfig

    for kw in (dict(dp=2), dict(fsdp=2), dict(tp=2), dict(dcn_dp=2),
               dict(extra={"sep": 2})):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1, item 6: more than one "
                                 "device"):
            MeshConfig(**kw).build(device="cpu")
    with pytest.raises(ValueError):
        MeshConfig(cp=0)
    with pytest.raises(RuntimeError, match="init_process_group"):
        MeshConfig(cp=2).build(device="cpu")
    # cp = 1 is one device: the single-device engine
    tm = gpt("gpt_tiny", device="cpu")
    eng = parallelize(tm, AdamW(learning_rate=1e-3,
                                parameters=tm.parameters()),
                      mesh=MeshConfig(cp=1))
    assert eng.cp == 1 and eng.mesh is None
    with pytest.raises(NotImplementedError, match="sharding_stage"):
        parallelize(tm, mesh=MeshConfig(cp=1), sharding_stage=1)


class _FakeCPMesh:
    """Size only: the routing refusals happen before any exchange."""
    size = 2
    rank = 0


def test_sdpa_under_a_cp_guard_refuses_dropout_and_masks():
    from paddle_tpu_torch.nn import functional as TF

    x = torch.zeros(1, 8, 2, 4)
    with cpm.context_parallel_guard(_FakeCPMesh(), "ring"):
        assert cpm.active_context_parallel()[1] == "ring"
        with pytest.raises(NotImplementedError, match="dropout"):
            TF.scaled_dot_product_attention(x, x, x, dropout_p=0.1,
                                            is_causal=True)
        with pytest.raises(NotImplementedError, match="attn_mask"):
            TF.scaled_dot_product_attention(x, x, x,
                                            attn_mask=torch.zeros(8, 8))
        # cross-attention shapes fall through to the dense paths
        out = TF.scaled_dot_product_attention(x, x[:, :4], x[:, :4])
        assert out.shape == x.shape
    assert cpm.active_context_parallel() is None


def test_ring_shape_rule_equals_jax():
    from paddle_tpu.distributed.context_parallel import (
        _ring_flash_shapes_ok as jok)

    for s_loc in (64, 128, 130, 256, 512, 2048, 4096, 8192):
        for d in (16, 64, 128, 256, 300):
            for balanced in (True, False):
                assert cpm._ring_flash_shapes_ok(s_loc, d, balanced) \
                    == jok(s_loc, d, balanced)
