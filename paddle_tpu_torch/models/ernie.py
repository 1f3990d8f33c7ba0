"""ERNIE/BERT-family encoder in PyTorch — the port of
`paddle_tpu/models/ernie.py` (BASELINE config 3: ERNIE-3.0-base
fine-tuning, `bench.py:310 bench_ernie`).

Same configuration (`ErnieConfig` and its three presets) and the same
parameter names as the JAX model's `named_parameters()`
(`ernie.embeddings.word_embeddings.weight`,
`ernie.encoder.{i}.self_attn.q_proj.weight`, `norm1`, `linear1`,
`linear2`, `norm2`, `ernie.pooler.dense.*`, `classifier.*`; the MLM
head's `transform.*` and `layer_norm.*`), Linear weights `[in, out]`:
weights cross by name and value (`load_reference_arrays`).

The forward mirrors the JAX model: word + position + token-type
embeddings -> LayerNorm -> dropout; per layer post-LN blocks
(x = norm1(x + dropout(attention(x))), x = norm2(x + dropout(linear2(
gelu(linear1(x)))))) with exact-erf GELU; a tanh pooler over the first
token.  Attention runs `flash_attention_xla` (kernels K1/K2 on the card,
their plain versions on the CPU) with the (B, S) 1 / 0
`attention_mask` turned into an additive (B, 1, 1, S) bias of
(1 - mask) * -1e9, read by the kernels in place, and attention dropout
in training.  The MLM decoder is tied to the word embeddings.

Randomness is explicit: the model owns one `torch.Generator` on its
device (`generator=`, or one seeded with `seed`), from which the
weights are drawn and every hidden dropout draws its mask; attention
dropout draws its (seed, offset) from the same generator on the host
(`ops.flash_attention.dropout_seed`).  The same seed gives the same
training step, bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import resolve_device
from ..nn import functional as F
from ..nn.layer import Dropout, Embedding, LayerNorm, Linear
from ..ops.flash_attention import flash_attention_xla

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "ErnieForMaskedLM", "ErniePooler"]


@dataclasses.dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0

    @staticmethod
    def presets():
        return {
            "ernie-3.0-base": ErnieConfig(),
            "ernie-3.0-medium": ErnieConfig(num_hidden_layers=6),
            "tiny": ErnieConfig(vocab_size=256, hidden_size=64,
                                num_hidden_layers=2, num_attention_heads=4,
                                intermediate_size=128,
                                max_position_embeddings=128,
                                type_vocab_size=2),
        }

    @classmethod
    def from_preset(cls, name, **overrides):
        return dataclasses.replace(cls.presets()[name], **overrides)


def _init(cfg, device, generator):
    return dict(std=cfg.initializer_range, device=device,
                generator=generator)


class ErnieEmbeddings(nn.Module):
    def __init__(self, cfg: ErnieConfig, device, generator):
        super().__init__()
        kw = _init(cfg, device, generator)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        S = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(S, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class ErnieSelfAttention(nn.Module):
    def __init__(self, cfg: ErnieConfig, device, generator):
        super().__init__()
        kw = _init(cfg, device, generator)
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = h // cfg.num_attention_heads
        self.q_proj = Linear(h, h, **kw)
        self.k_proj = Linear(h, h, **kw)
        self.v_proj = Linear(h, h, **kw)
        self.out_proj = Linear(h, h, **kw)
        self.dropout_p = cfg.attention_probs_dropout_prob
        self.generator = generator

    def forward(self, x, attn_mask=None):
        B, S = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(B, S, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(B, S, self.num_heads, self.head_dim)
        v = self.v_proj(x).reshape(B, S, self.num_heads, self.head_dim)
        out = flash_attention_xla(q, k, v, attn_mask=attn_mask,
                                  dropout_p=self.dropout_p, is_causal=False,
                                  training=self.training,
                                  generator=self.generator)
        return self.out_proj(out.reshape(B, S, -1))


class ErnieLayer(nn.Module):
    """Post-LN encoder block (BERT convention, unlike Llama's pre-LN)."""

    def __init__(self, cfg: ErnieConfig, device, generator):
        super().__init__()
        kw = _init(cfg, device, generator)
        self.self_attn = ErnieSelfAttention(cfg, device, generator)
        self.norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                               device=device)
        self.linear1 = Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.linear2 = Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                               device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob, generator=generator)
        self.act = F.gelu if cfg.hidden_act == "gelu" else torch.relu

    def forward(self, x, attn_mask=None):
        x = self.norm1(x + self.dropout(self.self_attn(x, attn_mask)))
        ff = self.linear2(self.act(self.linear1(x)))
        return self.norm2(x + self.dropout(ff))


class ErniePooler(nn.Module):
    def __init__(self, cfg: ErnieConfig, device, generator):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size,
                            **_init(cfg, device, generator))

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


def _generator(device, generator, seed):
    if generator is not None:
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


class ErnieModel(nn.Module):
    """The encoder: (hidden (B, S, hidden), pooled (B, hidden)).  Built
    on `device` (the CUDA card unless the caller passes `device="cpu"`),
    weights and dropout from `generator` (on `device`), or from a new
    one seeded with `seed`."""

    def __init__(self, config: ErnieConfig, device=None, generator=None,
                 seed=0):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(device, generator, seed)
        self.config = config
        self.generator = generator
        self.embeddings = ErnieEmbeddings(config, device, generator)
        self.encoder = nn.ModuleList(
            [ErnieLayer(config, device, generator)
             for _ in range(config.num_hidden_layers)])
        self.pooler = ErniePooler(config, device, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        bias = None
        if attention_mask is not None:
            # (B, S) 1 / 0 mask -> additive (B, 1, 1, S) bias
            am = torch.as_tensor(attention_mask, device=input_ids.device)
            bias = ((1.0 - am.to(torch.float32)) * -1e9).reshape(
                am.shape[0], 1, 1, am.shape[1])
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            h = layer(h, bias)
        return h, self.pooler(h)


class ErnieForSequenceClassification(nn.Module):
    """ERNIE + dropout + a Linear classifier over the pooled output:
    logits (B, num_classes)."""

    def __init__(self, config: ErnieConfig, num_classes=2, dropout=None,
                 device=None, generator=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(device, generator, seed)
        self.config = config
        self.ernie = ErnieModel(config, device, generator)
        self.dropout = Dropout(dropout if dropout is not None
                               else config.hidden_dropout_prob,
                               generator=generator)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 **_init(config, device, generator))

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask)
        return self.classifier(self.dropout(pooled))


class ErnieForMaskedLM(nn.Module):
    """ERNIE + transform + gelu + LayerNorm, decoded against the word
    embeddings (tied, BERT convention): logits (B, S, vocab)."""

    def __init__(self, config: ErnieConfig, device=None, generator=None,
                 seed=0):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(device, generator, seed)
        self.config = config
        self.ernie = ErnieModel(config, device, generator)
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                **_init(config, device, generator))
        self.layer_norm = LayerNorm(config.hidden_size,
                                    config.layer_norm_eps, device=device)

    @property
    def device(self) -> torch.device:
        return self.transform.weight.device

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        h, _ = self.ernie(input_ids, token_type_ids, position_ids,
                          attention_mask)
        h = self.layer_norm(F.gelu(self.transform(h)))
        return h @ self.ernie.embeddings.word_embeddings.weight.T
