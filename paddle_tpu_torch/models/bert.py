"""BERT/ERNIE-class encoders (counterpart of paddle_tpu/models/bert.py):
token, position and segment embeddings, post-LN transformer layers, the
pooler, and the sequence-classification and masked-LM heads.

Parameter names follow the JAX package exactly
(``bert.layers.<i>.attention.qkv.weight`` ...), so weights move between the
two with `paddle_tpu_torch.convert`.

Attention takes the fused QKV projection as ``[B, S, 3, H, D]`` and hands
its ``[B, S, H, D]`` views to `nn.functional.scaled_dot_product_attention`
with no transpose: in training mode with attention dropout and no padding
mask that is the short-attention kernels (dropout drawn inside them) on
the GPU; in eval mode the FlashAttention-2 forward where its predicate
admits the shape; a padding mask takes the plain composed path with the
mask as an f32 additive bias of -1e9 on f32 scores. Every dropout of one
model (hidden and attention) draws from the model's one dropout generator,
so a run is replayed from its seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import resolve_device
from ..nn import functional as F
from ..nn.layer.common import Dropout
from ..nn.layer.norm import LayerNorm

__all__ = ["BertConfig", "CONFIGS", "BertEmbeddings", "BertSelfAttention",
           "BertLayer", "BertPooler", "BertModel",
           "BertForSequenceClassification", "BertForMaskedLM", "ErnieModel",
           "ErnieForSequenceClassification", "ErnieForMaskedLM", "bert",
           "bert_for_sequence_classification", "bert_for_masked_lm",
           "n_matmul_params"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    num_labels: int = 2


CONFIGS = {
    "bert_tiny": dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=128,
                      max_position_embeddings=128),
    "bert_base": dict(),
    "bert_large": dict(hidden_size=1024, num_hidden_layers=24,
                       num_attention_heads=16, intermediate_size=4096),
    # ERNIE-3.0-base shares the BERT-base geometry (vocab differs)
    "ernie_base": dict(vocab_size=40000),
}


class _Init:
    """One model's device, seeded initialisation and dropout generator:
    weights N(0, initializer_range) from `seed`, biases 0, LayerNorm 1/0;
    dropout from `generator` (default: a generator on the model's device
    seeded with seed + 1)."""

    def __init__(self, cfg, device, seed, generator):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.g = torch.Generator(device=self.device)
        self.g.manual_seed(int(seed))
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(seed) + 1)
        self.dropout_generator = generator

    def linear(self, fan_in, fan_out):
        lin = nn.Linear(fan_in, fan_out, device=self.device)
        with torch.no_grad():
            lin.weight.normal_(0.0, self.cfg.initializer_range,
                               generator=self.g)
            lin.bias.zero_()
        return lin

    def embedding(self, num, dim):
        emb = nn.Embedding(num, dim, device=self.device)
        with torch.no_grad():
            emb.weight.normal_(0.0, self.cfg.initializer_range,
                               generator=self.g)
        return emb

    def norm(self):
        return LayerNorm(self.cfg.hidden_size, self.cfg.layer_norm_eps,
                         device=self.device)

    def dropout(self, p):
        return Dropout(p, generator=self.dropout_generator)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, init: _Init):
        super().__init__()
        self.word_embeddings = init.embedding(cfg.vocab_size,
                                              cfg.hidden_size)
        self.position_embeddings = init.embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = init.embedding(cfg.type_vocab_size,
                                                    cfg.hidden_size)
        self.layer_norm = init.norm()
        self.dropout = init.dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, init: _Init):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.qkv = init.linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out = init.linear(cfg.hidden_size, cfg.hidden_size)
        self.dropout_p = cfg.attention_probs_dropout_prob
        self.generator = init.dropout_generator

    def forward(self, x, attn_bias=None):
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_bias, dropout_p=self.dropout_p,
            is_causal=False, training=self.training,
            generator=self.generator)
        return self.out(out.reshape(b, s, h))


class BertLayer(nn.Module):
    """Post-LN: x = LN(x + drop(attn(x))), then LN(x + drop(MLP(x)))
    with the exact (erf) GELU."""

    def __init__(self, cfg: BertConfig, init: _Init):
        super().__init__()
        self.attention = BertSelfAttention(cfg, init)
        self.ln1 = init.norm()
        self.fc1 = init.linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = init.linear(cfg.intermediate_size, cfg.hidden_size)
        self.ln2 = init.norm()
        self.dropout = init.dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_bias=None):
        x = self.ln1(x + self.dropout(self.attention(x, attn_bias)))
        y = self.fc2(F.gelu(self.fc1(x)))
        return self.ln2(x + self.dropout(y))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig, init: _Init):
        super().__init__()
        self.dense = init.linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


def _attention_bias(attention_mask):
    """[B, S] 1/0 keep-mask -> f32 additive bias [B, 1, 1, S]: 0 where
    kept, -1e9 where padded."""
    keep = attention_mask[:, None, None, :].bool()
    return torch.where(keep, torch.zeros((), device=keep.device),
                       torch.full((), -1e9, device=keep.device))


class BertModel(nn.Module):
    """Returns (sequence_output [B, S, h], pooled_output [B, h]).
    `device` (default the GPU; raises without one), `seed` of the weights,
    `generator`: the dropout generator (default: one on the model's device
    seeded with seed + 1)."""

    def __init__(self, cfg: BertConfig, *, device=None, seed=0,
                 generator=None, init=None):
        super().__init__()
        init = init or _Init(cfg, device, seed, generator)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, init)
        self.layers = nn.ModuleList(BertLayer(cfg, init)
                                    for _ in range(cfg.num_hidden_layers))
        self.pooler = BertPooler(cfg, init)

    @property
    def device(self):
        return self.pooler.dense.weight.device

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        bias = None if attention_mask is None else _attention_bias(
            attention_mask.to(x.device))
        for layer in self.layers:
            x = layer(x, bias)
        return x, self.pooler(x)


class BertForSequenceClassification(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None, seed=0,
                 generator=None):
        super().__init__()
        init = _Init(cfg, device, seed, generator)
        self.cfg = cfg
        self.bert = BertModel(cfg, init=init)
        self.dropout = init.dropout(cfg.hidden_dropout_prob)
        self.classifier = init.linear(cfg.hidden_size, cfg.num_labels)

    @property
    def device(self):
        return self.bert.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))

    def loss(self, input_ids, labels, token_type_ids=None,
             attention_mask=None):
        logits = self.forward(input_ids, token_type_ids, attention_mask)
        return F.cross_entropy(logits, labels).mean()


class BertForMaskedLM(nn.Module):
    """MLM head tied to the word embedding, with a top-level `bias`."""

    def __init__(self, cfg: BertConfig, *, device=None, seed=0,
                 generator=None):
        super().__init__()
        init = _Init(cfg, device, seed, generator)
        self.cfg = cfg
        self.bert = BertModel(cfg, init=init)
        self.transform = init.linear(cfg.hidden_size, cfg.hidden_size)
        self.layer_norm = init.norm()
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                             device=init.device))

    @property
    def device(self):
        return self.bert.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, _ = self.bert(input_ids, token_type_ids,
                           attention_mask=attention_mask)
        h = self.layer_norm(F.gelu(self.transform(seq)))
        w = self.bert.embeddings.word_embeddings.weight
        return h @ w.t() + self.bias

    def loss(self, input_ids, labels, ignore_index=-100, **kw):
        """labels: masked positions carry target ids, the others
        `ignore_index`."""
        logits = self.forward(input_ids, **kw)
        v = self.cfg.vocab_size
        return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1),
                               ignore_index=ignore_index).mean()


ErnieModel = BertModel
ErnieForSequenceClassification = BertForSequenceClassification
ErnieForMaskedLM = BertForMaskedLM


def _config(name, overrides):
    d = dict(CONFIGS[name])
    d.update(overrides)
    return BertConfig(**d)


def bert(name="bert_base", *, device=None, seed=0, generator=None,
         **overrides):
    """A named config's `BertModel` with seeded random weights on `device`
    (default: the GPU; raises when there is none)."""
    return BertModel(_config(name, overrides), device=device, seed=seed,
                     generator=generator)


def bert_for_sequence_classification(name="bert_base", *, device=None,
                                     seed=0, generator=None, **overrides):
    return BertForSequenceClassification(_config(name, overrides),
                                         device=device, seed=seed,
                                         generator=generator)


def bert_for_masked_lm(name="bert_base", *, device=None, seed=0,
                       generator=None, **overrides):
    return BertForMaskedLM(_config(name, overrides), device=device,
                           seed=seed, generator=generator)


def n_matmul_params(cfg: BertConfig) -> int:
    """Matmul-bearing parameters of a sequence-classification fine-tune
    (the layers' projections and the pooler; the embedding tables are
    gathers): the JAX package's MFU numerator, 6 * this * S a sequence."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    return cfg.num_hidden_layers * (4 * h * h + 2 * h * i) + h * h
