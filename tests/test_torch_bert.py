"""Port parity of BERT (`paddle_tpu_torch.models.bert`) against the JAX
package's `paddle_tpu.models.bert` on bert_tiny, with the JAX weights
carried across by `convert`, dropout 0 and f32:

* logits to 1e-4 abs; classification and MLM (`ignore_index`) losses to
  1e-5 relative; every parameter's gradient to 1e-4 normwise;
* the padding-mask case of tests/test_bert.py (f32 -1e9 additive bias);
* three AdamW steps through `distributed.parallelize` against the JAX
  model's eager optimizer loop (`m.loss`, `.backward()`, `opt.step()`, as
  tests/test_bert.py drives it), losses to 1e-4 relative;
* the weight bridge both ways for BERT and, unchanged, for GPT.

With dropout 0.1 on the CPU, attention routes to the short-attention
plain version (kernel counters stay 0) and one generator seed replays a
run exactly. The JAX reference at dropout 0 draws no random numbers, so
its PRNG choice does not matter here.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
from paddle_tpu.models import bert_for_masked_lm as jbert_mlm
from paddle_tpu.models import bert_for_sequence_classification as jbert_cls
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.convert import (_is_linear_weight, load_jax_state,
                                      state_to_jax)
from paddle_tpu_torch.distributed import parallelize
from paddle_tpu_torch.models import (bert, bert_for_masked_lm,
                                     bert_for_sequence_classification, gpt)
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW

tsa = importlib.import_module("paddle_tpu_torch.ops.short_attention")

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S, VOCAB = 3, 16, 1024


def _named(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _batch(seed=0, num_labels=2):
    r = np.random.RandomState(seed)
    ids = r.randint(1, VOCAB, (B, S)).astype(np.int32)
    labels = r.randint(0, num_labels, (B,)).astype(np.int64)
    return ids, labels


def _pair(kind, **cfg):
    """A JAX bert_tiny (seeded) and the port's with its weights."""
    paddle.seed(0)
    jm = (jbert_cls if kind == "cls" else jbert_mlm)("bert_tiny", **cfg)
    build = (bert_for_sequence_classification if kind == "cls"
             else bert_for_masked_lm)
    tm = build("bert_tiny", device="cpu", **cfg)
    load_jax_state(tm, _named(jm))
    return jm, tm


def _normwise(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref),
                                                 1e-30))


def _port_grads(tm):
    """The port's gradients in the JAX layouts."""
    out = {}
    for n, p in tm.named_parameters():
        if p.grad is None:
            continue
        g = p.grad.numpy()
        out[n] = g.T if _is_linear_weight(n, g) else g
    return out


@pytest.mark.parametrize("kind", ["cls", "mlm"])
def test_forward_loss_and_grads_match_jax(kind):
    jm, tm = _pair(kind, **NO_DROPOUT)
    ids, labels = _batch()
    if kind == "mlm":
        labels = np.full((B, S), -100, np.int64)
        labels[:, 3] = 7
        labels[0, 9] = 11
    with jax.default_matmul_precision("highest"):
        jlogits = jm(paddle.to_tensor(ids)).numpy()
        jloss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
        jloss.backward()
    # (the MLM head leaves the pooler without a gradient on both sides)
    jgrads = {n: np.asarray(p.grad.numpy())
              for n, p in jm.named_parameters() if p.grad is not None}
    tids, tlabels = torch.from_numpy(ids).long(), torch.from_numpy(labels)
    tlogits = tm(tids)
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, atol=1e-4)
    tloss = tm.loss(tids, tlabels)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    tloss.backward()
    tgrads = _port_grads(tm)
    assert set(tgrads) == set(jgrads)
    errs = {n: _normwise(tgrads[n], g) for n, g in jgrads.items()
            if np.linalg.norm(g) > 0}
    assert max(errs.values()) <= 1e-4, sorted(errs.items(),
                                               key=lambda x: -x[1])[:3]


def test_padding_mask_matches_jax_and_isolates_padding():
    jm, tm = _pair("cls", **NO_DROPOUT)
    jm.eval()
    tm.eval()
    ids, _ = _batch(1)
    mask = np.ones((B, S), np.float32)
    mask[:, 9:] = 0
    with jax.default_matmul_precision("highest"):
        jout = jm(paddle.to_tensor(ids),
                  attention_mask=paddle.to_tensor(mask)).numpy()
    t = tm(torch.from_numpy(ids).long(),
           attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(t.detach().numpy(), jout, atol=1e-4)
    ids2 = ids.copy()
    ids2[:, 9:] = np.random.RandomState(2).randint(1, VOCAB, (B, S - 9))
    t2 = tm(torch.from_numpy(ids2).long(),
            attention_mask=torch.from_numpy(mask))
    torch.testing.assert_close(t, t2, rtol=0, atol=1e-5)


def test_three_adamw_steps_through_parallelize_match_jax():
    """bench.py's fine-tune step (loss_fn = cross_entropy(m(ids), labels),
    AdamW) three times on one batch; lr 1e-3 so the steps move the loss."""
    lr, steps = 1e-3, 3
    jm, tm = _pair("cls", **NO_DROPOUT)
    ids, labels = _batch(3)
    jopt = paddle.optimizer.AdamW(learning_rate=lr,
                                  parameters=jm.parameters())
    jl = []
    with jax.default_matmul_precision("highest"):
        for _ in range(steps):
            loss = paddle.nn.functional.cross_entropy(
                jm(paddle.to_tensor(ids)), paddle.to_tensor(labels)).mean()
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            jl.append(float(loss))
    eng = parallelize(
        tm, AdamW(learning_rate=lr, parameters=tm.parameters()),
        loss_fn=lambda m, x, y: TF.cross_entropy(m(x), y).mean())
    tl = [float(eng.train_batch(ids, labels)) for _ in range(steps)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("kind", ["cls", "mlm"])
def test_state_to_jax_round_trip(kind):
    jm, tm = _pair(kind)
    ref = _named(jm)
    back = state_to_jax(tm)
    assert set(back) == set(ref)
    for n, a in ref.items():
        assert back[n].shape == a.shape, n
        np.testing.assert_array_equal(back[n], a, err_msg=n)
    # embeddings keep their [V, h] layout on both sides
    emb = tm.bert.embeddings.word_embeddings.weight
    assert tuple(emb.shape) == ref["bert.embeddings.word_embeddings.weight"
                                   ].shape


def test_state_to_jax_round_trip_gpt_unchanged():
    jm = jgpt("gpt_tiny")
    ref = _named(jm)
    tm = gpt("gpt_tiny", device="cpu")
    load_jax_state(tm, ref)
    back = state_to_jax(tm)
    assert set(back) == set(ref)
    for n, a in ref.items():
        np.testing.assert_array_equal(back[n], a, err_msg=n)
    assert tuple(tm.transformer.wte.weight.shape) == ref[
        "transformer.wte.weight"].shape


def test_dropout_routes_to_plain_short_attention_and_replays():
    """dropout 0.1 on the CPU: the short-attention route's plain versions
    (no kernel launch), the same losses and gradients from one generator
    seed, other losses from another."""
    ids, labels = _batch(4)
    tids, tlabels = torch.from_numpy(ids).long(), torch.from_numpy(labels)
    counts = (tsa.short_attention_fwd.launches,
              tsa.short_attention_bwd.launches)
    runs = []
    for gseed in (7, 7, 8):
        g = torch.Generator().manual_seed(gseed)
        m = bert_for_sequence_classification("bert_tiny", device="cpu",
                                             generator=g)
        assert m.training
        loss = m.loss(tids, tlabels)
        loss.backward()
        runs.append((loss.item(),
                     m.bert.layers[0].attention.qkv.weight.grad.clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][0] != runs[2][0]
    assert (tsa.short_attention_fwd.launches,
            tsa.short_attention_bwd.launches) == counts
    # and dropout really acted: eval mode gives another loss
    m.eval()
    assert m.loss(tids, tlabels).item() != runs[2][0]


def test_bert_short_attention_route_draws_one_seed_per_layer(monkeypatch):
    """Each layer's attention draws its own stream seed from the model's
    generator and reaches `short_attention` with the kernels' shape (the
    fused-QKV views, no copy)."""
    from paddle_tpu_torch.nn.functional import attention

    calls = []
    real = attention.short_attention

    def spy(q, k, v, seed, p, causal):
        calls.append((tuple(q.shape), int(seed), p, causal,
                      q.is_contiguous()))
        return real(q, k, v, seed, p, causal)

    monkeypatch.setattr(attention, "short_attention", spy)
    m = bert("bert_tiny", device="cpu")
    ids, _ = _batch(5)
    m(torch.from_numpy(ids).long())
    assert len(calls) == m.cfg.num_hidden_layers
    assert all(c[0] == (B, S, 2, 32) and c[2] == 0.1 and not c[3]
               and not c[4] for c in calls)
    assert len({c[1] for c in calls}) == len(calls)
    # a padding mask takes the composed path instead
    calls.clear()
    m(torch.from_numpy(ids).long(), attention_mask=torch.ones(B, S))
    assert calls == []


def test_dropout_functional_and_layer():
    x = torch.ones(200, 300)
    g = torch.Generator().manual_seed(0)
    y = TF.dropout(x, 0.25, generator=g)
    share = (y != 0).double().mean().item()
    n = x.numel()
    assert abs(share - 0.75) <= 4 * np.sqrt(0.25 * 0.75 / n)
    assert set(torch.unique(y).tolist()) == {0.0, np.float32(1 / 0.75)}
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(TF.dropout(x, 0.25, generator=g2), y)
    assert TF.dropout(x, 0.25, training=False) is x
    assert torch.equal(TF.dropout(x, 1.0), torch.zeros_like(x))
    layer = Dropout(0.5, generator=torch.Generator().manual_seed(1))
    assert (layer(x) == 0).any()
    layer.eval()
    assert layer(x) is x


def test_constructors_resolve_the_device():
    m = bert_for_masked_lm("bert_tiny", device="cpu")
    assert m.device.type == "cpu" and m.bias.device.type == "cpu"
    assert m.bert.layers[0].attention.generator.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-GPU error path is not taken")
    with pytest.raises(RuntimeError, match="CUDA"):
        bert_for_sequence_classification("bert_tiny")
