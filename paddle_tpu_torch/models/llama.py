"""Llama model family in PyTorch — the port of `paddle_tpu/models/llama.py`.

Same configuration (`LlamaConfig` and its five presets), same parameter
names as the JAX model's `named_parameters()` (`llama.embed_tokens.weight`,
`llama.layers.{i}.self_attn.q_proj.weight`, ...), and the same Linear
layout: paddle stores a Linear weight as `[in, out]` and computes
`x @ W`, so weights cross between the two packages by name and value
(`load_reference_arrays`) without a transpose.

The training forward mirrors the JAX model layer by layer: embedding;
per decoder layer RMSNorm (fp32 statistics, output in the input dtype)
-> GQA attention with half-split RoPE through `flash_attention_xla`
(kernels K1/K2 on the card) -> residual -> RMSNorm -> SwiGLU, or with
`moe_num_experts > 1` the mixture-of-experts layer (`nn/moe.py`:
capacity routing, or dropless routing on kernels K5f/K5b) -> residual;
final RMSNorm; the LM head (tied or untied).  The causal-LM loss runs
the fused softmax cross-entropy (kernels K3f/K3b); `llama_loss_fn` adds
the layers' summed MoE aux loss.  Serving reads the same parameters
through `models/llama_decode.py` (dense models only).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device
from ..nn.moe import MoELayer
from ..ops.flash_attention import flash_attention_xla
from ..ops.softmax_xent import softmax_xent

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "llama_loss_fn",
           "load_reference_arrays"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    dtype: str = "bfloat16"          # compute/param dtype
    use_flash_attention: bool = True
    recompute: bool = False
    recompute_policy: str = "full"
    sequence_parallel: bool = False
    sp_mode: str = "ulysses"
    moe_num_experts: int = 0         # 0 = dense MLP
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_shared_expert_intermediate: int = 0
    moe_aux_loss_weight: float = 0.01
    moe_gate: str = "gshard"
    moe_dropless: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def presets() -> dict:
        return {
            # Meta's Llama-3-8B shape
            "llama3-8b": LlamaConfig(
                vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                num_hidden_layers=32, num_attention_heads=32,
                num_key_value_heads=8, max_position_embeddings=8192,
                rope_theta=500000.0),
            "llama2-7b": LlamaConfig(),
            # small configs for tests / CPU dry-runs
            "tiny": LlamaConfig(
                vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128,
                dtype="float32"),
            "qwen2-moe-tiny": LlamaConfig(
                vocab_size=256, hidden_size=64, intermediate_size=96,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128,
                dtype="float32", moe_num_experts=8, moe_top_k=2,
                moe_shared_expert_intermediate=96),
            "debug-4l": LlamaConfig(
                vocab_size=1024, hidden_size=256, intermediate_size=512,
                num_hidden_layers=4, num_attention_heads=8,
                num_key_value_heads=4, max_position_embeddings=512,
                dtype="float32"),
        }

    @classmethod
    def from_preset(cls, name: str, **overrides) -> "LlamaConfig":
        cfg = cls.presets()[name]
        return dataclasses.replace(cfg, **overrides)


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------


def _rope_tables_at(positions, head_dim: int, theta: float, dtype):
    """cos/sin (len(positions), head_dim) for ABSOLUTE positions —
    half-split (Llama) convention.  Tables are built in fp32 (the angle
    arithmetic needs it) and cast to `dtype`, where the rotation runs."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim))
    freqs = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)            # (S, D)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _apply_rope(q, k, theta):
    """q, k: (B, S, H, D) at positions 0..S-1.  Tables are built in fp32
    and the rotation runs in the input dtype, as in the JAX model."""
    S, D = q.shape[1], q.shape[-1]
    cos, sin = _rope_tables_at(torch.arange(S, device=q.device), D, theta,
                               q.dtype)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


def rms_norm(x, weight, eps):
    """RMSNorm with fp32 statistics, normalised in fp32, rounded to the
    input dtype, then scaled by `weight` (the JAX package's
    `_rms_norm_cj`; its hand-written JVP only saves memory, so autograd
    on the same formula is its counterpart)."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return y.to(x.dtype) * weight


# --------------------------------------------------------------------------
# Recompute policies
# --------------------------------------------------------------------------

_RECOMPUTE_POLICIES = ("full", "dots")
# the dense products with no batch dimension: every `x @ W` of a Linear
# (q/k/v/o, gate/up/down, the router, the shared expert, the head) folds
# to one of these; batched products (`bmm`, einsum) are not among them
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default,
                         torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    """The counterpart of JAX's `dots_with_no_batch_dims_saveable`:
    save what `_SAVED_DOTS` computes, recompute everything else —
    batched products, norms, RoPE, SwiGLU, and the kernels K1 and K5,
    whose autograd Functions re-run (and re-launch) in the backward."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint_kwargs(policy):
    """`torch.utils.checkpoint.checkpoint` keywords for a policy."""
    if policy == "full":
        return {"use_reentrant": False}
    if policy == "dots":
        return {"use_reentrant": False, "context_fn": functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)}
    raise ValueError(f"recompute_policy must be one of "
                     f"{_RECOMPUTE_POLICIES}, got {policy!r}")


# --------------------------------------------------------------------------
# Model layers, with the JAX model's parameter names
# --------------------------------------------------------------------------


def _normal(shape, cfg, device, generator):
    # drawn directly on `device` in the model dtype: the 8B model's
    # fp32 host copy alone would be 32 GB
    w = torch.empty(shape, dtype=cfg.torch_dtype, device=device)
    return nn.Parameter(w.normal_(0.0, cfg.initializer_range,
                                  generator=generator))


class Linear(nn.Module):
    """Bias-free Linear in paddle's `[in, out]` layout (`y = x @ W`)."""

    def __init__(self, in_features, out_features, cfg, device, generator):
        super().__init__()
        self.weight = _normal((in_features, out_features), cfg, device,
                              generator)

    def forward(self, x):
        return x @ self.weight


class Embedding(nn.Module):
    def __init__(self, num, dim, cfg, device, generator):
        super().__init__()
        self.weight = _normal((num, dim), cfg, device, generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class RMSNorm(nn.Module):
    def __init__(self, dim, cfg, device):
        super().__init__()
        self.eps = cfg.rms_norm_eps
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=cfg.torch_dtype, device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class LlamaAttention(nn.Module):
    """GQA self-attention with half-split RoPE."""

    def __init__(self, cfg, device, generator):
        super().__init__()
        self.config = cfg
        h, nh, nkv, hd = (cfg.hidden_size, cfg.num_attention_heads,
                          cfg.num_key_value_heads, cfg.head_dim)
        self.q_proj = Linear(h, nh * hd, cfg, device, generator)
        self.k_proj = Linear(h, nkv * hd, cfg, device, generator)
        self.v_proj = Linear(h, nkv * hd, cfg, device, generator)
        self.o_proj = Linear(nh * hd, h, cfg, device, generator)

    def forward(self, hidden_states, attn_mask=None):
        cfg = self.config
        B, S = hidden_states.shape[0], hidden_states.shape[1]
        nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        q = self.q_proj(hidden_states).reshape(B, S, nh, hd)
        k = self.k_proj(hidden_states).reshape(B, S, nkv, hd)
        v = self.v_proj(hidden_states).reshape(B, S, nkv, hd)
        q, k = _apply_rope(q, k, cfg.rope_theta)
        if cfg.sequence_parallel and attn_mask is None:
            raise NotImplementedError(
                "sequence-parallel attention is not ported yet (ROADMAP: "
                "queue 1 item 5, multi-GPU)")
        out = flash_attention_xla(q, k, v, attn_mask=attn_mask,
                                  is_causal=True, training=self.training)
        return self.o_proj(out.reshape(B, S, nh * hd))


class LlamaMLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, cfg, device, generator):
        super().__init__()
        h, inter = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Linear(h, inter, cfg, device, generator)
        self.up_proj = Linear(h, inter, cfg, device, generator)
        self.down_proj = Linear(inter, h, cfg, device, generator)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg, device, generator):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, device, generator)
        if cfg.moe_num_experts > 1:
            self.mlp = MoELayer(
                cfg.hidden_size, cfg.intermediate_size, cfg.moe_num_experts,
                gate=cfg.moe_gate,
                # switch routing is top-1 by definition; moe_top_k
                # applies to the top-k gates only
                top_k=1 if cfg.moe_gate == "switch" else cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor,
                aux_loss_weight=cfg.moe_aux_loss_weight,
                shared_expert_hidden=cfg.moe_shared_expert_intermediate,
                dropless=cfg.moe_dropless, device=device,
                dtype=cfg.torch_dtype, generator=generator)
        else:
            self.mlp = LlamaMLP(cfg, device, generator)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg,
                                                device)

    def forward(self, hidden_states, attn_mask=None):
        """(hidden states, the MoE layer's weighted aux loss or None).
        The aux loss is a return value, never state on the layer, so it
        crosses `torch.utils.checkpoint` like the hidden states."""
        h = hidden_states + self.self_attn(
            self.input_layernorm(hidden_states), attn_mask)
        x = self.post_attention_layernorm(h)
        if isinstance(self.mlp, MoELayer):
            y, aux = self.mlp.forward_with_aux(x)
        else:
            y, aux = self.mlp(x), None
        return h + y, aux


class LlamaModel(nn.Module):
    def __init__(self, cfg, device, generator):
        super().__init__()
        self.config = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size, cfg,
                                      device, generator)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(cfg, device, generator)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg, device)

    def forward(self, input_ids, attn_mask=None):
        """Final-normed hidden states; the layers' summed MoE aux loss is
        kept for `aux_loss()`.  In training with `recompute`, each
        decoder layer is rematerialised in the backward
        (`torch.utils.checkpoint`): all of it under policy "full", all
        but its dense products' outputs under "dots"."""
        h = self.embed_tokens(input_ids)
        cfg = self.config
        remat = cfg.recompute and self.training
        if remat:
            ckpt_kw = _checkpoint_kwargs(cfg.recompute_policy)
        aux_total = None
        for layer in self.layers:
            if remat:
                h, aux = checkpoint(layer, h, attn_mask, **ckpt_kw)
            else:
                h, aux = layer(h, attn_mask)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        self._aux_total = aux_total
        return self.norm(h)

    def aux_loss(self):
        """Sum of the per-layer MoE load-balance losses of the last
        forward (None for a dense model or gates without one)."""
        return getattr(self, "_aux_total", None)


class LlamaForCausalLM(nn.Module):
    """Llama causal LM, initialised on `device` (the CUDA card unless
    the caller passes `device="cpu"`) in `config.dtype`, with
    Normal(0, initializer_range) weights drawn from a `torch.Generator`
    on `device` seeded with `seed`.  Tied heads (`tie_word_embeddings`)
    read the embedding; untied ones own `lm_head.weight`
    `[hidden, vocab]`."""

    def __init__(self, config: LlamaConfig, device=None, seed=0):
        super().__init__()
        if config.recompute and \
                config.recompute_policy not in _RECOMPUTE_POLICIES:
            raise ValueError(f"recompute_policy must be 'full' or 'dots', "
                             f"got {config.recompute_policy!r}")
        device = resolve_device(device)
        generator = torch.Generator(device=device)
        generator.manual_seed(int(seed))
        self.config = config
        self.llama = LlamaModel(config, device, generator)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, config.vocab_size,
                               config, device, generator))

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    def forward(self, input_ids, attn_mask=None):
        h = self.llama(input_ids, attn_mask)
        if self.lm_head is None:
            return h @ self.llama.embed_tokens.weight.T
        return self.lm_head(h)


def _causal_lm_loss_raw(logits, labels):
    """Next-token cross entropy, mean over the B * (S - 1) predicted
    positions: logits[:, :-1] against labels[:, 1:], in fp32 (kernel K3
    on the card).  The last position gets label -1, which K3 ignores, so
    the kernel reads the logits in place and its backward writes the
    whole (B, S, V) gradient."""
    B, S = labels.shape
    shifted = torch.cat([labels[:, 1:], labels.new_full((B, 1), -1)], 1)
    return softmax_xent(logits, shifted.to(torch.int32)).sum() / (B * (S - 1))


class LlamaPretrainingCriterion(nn.Module):
    def forward(self, logits, labels):
        return _causal_lm_loss_raw(logits, labels)


def llama_loss_fn(model: LlamaForCausalLM, ids):
    """Training loss incl. the MoE aux loss — the loss_fn shape
    `TrainStep` expects."""
    loss = _causal_lm_loss_raw(model(ids), ids)
    aux = model.llama.aux_loss()
    return loss + aux if aux is not None else loss


def load_reference_arrays(model: nn.Module, arrays: dict) -> None:
    """Copy `{parameter name: numpy array}` into `model` by name —
    e.g. `{n: np.asarray(p._data) for n, p in
    jax_model.named_parameters()}` from the JAX package.  Every name
    must match both ways and every shape exactly; values are cast to
    each parameter's dtype on its device."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(arrays[name])
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                                 f"{tuple(p.shape)}")
            # numpy has no bfloat16: widen to fp32 for the crossing
            t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
            p.copy_(t.to(device=p.device, dtype=p.dtype))
