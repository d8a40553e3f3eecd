"""One rank of the gloo jobs of tests/test_torch_context_parallel.py.

    python tests/test_torch_cp_worker.py WORKDIR RANK WORLD

reads WORKDIR/in.pkl (the cases, numpy arrays made by the test), joins a
gloo job through the file store WORKDIR/store, runs every case as this
rank of a `MeshConfig(cp=WORLD)` mesh on the CPU and writes
WORKDIR/out.RANK.pkl. It imports PyTorch and the port only, and holds no
test itself: pytest collects nothing here.
"""
import datetime
import hashlib
import os
import pickle
import sys

import torch
import torch.distributed as dist


def _attention(mesh, case):
    from paddle_tpu_torch.distributed import context_parallel as cpm

    q, k, v, do = (torch.from_numpy(case[x]) for x in ("q", "k", "v", "do"))
    n = mesh.size
    pos = cpm._local_positions(mesh.rank, n, q.shape[1] // n,
                               case["balanced"]).long()
    ql, kl, vl = (x[:, pos].clone().requires_grad_() for x in (q, k, v))
    out = cpm.context_parallel_attention(
        ql, kl, vl, mesh, mode=case["mode"], causal=case["causal"],
        impl=case["impl"], balanced=case["balanced"])
    out.backward(do[:, pos])
    return {"rows": pos.numpy(), "out": out.detach().numpy(),
            "dq": ql.grad.numpy(), "dk": kl.grad.numpy(),
            "dv": vl.grad.numpy()}


def _params_digest(model):
    h = hashlib.sha256()
    for name, p in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(p.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _engine(mesh, case):
    """3 AdamW steps of gpt_tiny from the JAX weights, on each ring body
    (the plain ring, and the flash ring on the pos kernels' plain
    versions); the weights every rank loads; a custom loss_fn refused."""
    from paddle_tpu_torch.convert import load_jax_state, params_from_jax
    from paddle_tpu_torch.distributed import context_parallel as cpm
    from paddle_tpu_torch.distributed import parallelize
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.sharding import MeshConfig

    def build():
        tm = gpt("gpt_tiny", device="cpu", **case["overrides"])
        load_jax_state(tm, case["init"])
        opt = AdamW(learning_rate=case["lr"], parameters=tm.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        return tm, opt

    res = {}
    tm, _ = build()
    bridge = params_from_jax(case["init"])
    res["loaded_equals_bridge"] = all(
        torch.equal(p, bridge[name]) for name, p in tm.state_dict().items())
    res["initial_digest"] = _params_digest(tm)
    ids = torch.from_numpy(case["ids"]).long()
    plain_cpa = cpm.context_parallel_attention
    for body in ("einsum", "flash"):
        tm, opt = build()
        if body == "flash":
            cpm.context_parallel_attention = (
                lambda *a, **kw: plain_cpa(*a, **{**kw, "impl": "flash"}))
        try:
            # a MeshConfig, as a user passes it: built on the model's device
            eng = parallelize(tm, opt, mesh=MeshConfig(cp=mesh.size),
                              context_parallel="ring")
            losses, norms = [], []
            for _ in range(case["steps"]):
                losses.append(float(eng.train_batch(ids)))
                norms.append(float(eng.last_grad_norm))
        finally:
            cpm.context_parallel_attention = plain_cpa
        res[body] = {"losses": losses, "norms": norms,
                     "digest": _params_digest(tm),
                     "eval": float(eng.eval_batch(ids)),
                     "exchange": eng.mesh.transport.stats}
    tm, opt = build()
    try:
        parallelize(tm, opt, loss_fn=lambda m, x: m.loss(x),
                    mesh=MeshConfig(cp=mesh.size))
        res["custom_loss_fn"] = "accepted"
    except NotImplementedError as e:
        res["custom_loss_fn"] = f"raised: {e}"
    res["own_loss_accepted"] = parallelize(
        tm, opt, loss_fn=tm.loss, mesh=MeshConfig(cp=mesh.size)).cp
    return res


def main(workdir, rank, world):
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "in.pkl"), "rb") as f:
        payload = pickle.load(f)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=payload["timeout"]))
    from paddle_tpu_torch.sharding import MeshConfig

    mesh = MeshConfig(cp=world).build(device="cpu")
    out = {"attention": {name: _attention(mesh, case)
                         for name, case in payload["attention"].items()}}
    if payload.get("engine"):
        out["engine"] = _engine(mesh, payload["engine"])
    with open(os.path.join(workdir, f"out.{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
