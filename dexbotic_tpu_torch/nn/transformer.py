"""Decoder stack (port of the single-stream path of dexbotic_tpu/nn/transformer.py).

One configurable LLaMA/Qwen/Gemma-family decoder, run as a full-sequence
prefill without a KV cache (what ``cognition_feature`` needs).  The
flavour flags the presets use are covered: ``attn_bias``, ``qk_norm``,
``norm_offset``, ``embed_scale`` and ``tie_embeddings``.  Not ported yet:
MoE FFNs, adaRMS experts, N-stream mixture-of-transformers and the KV-cache
modes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from dexbotic_tpu_torch.nn import core
from dexbotic_tpu_torch.ops.attention import attention
from dexbotic_tpu_torch.ops.norms import RMSNorm
from dexbotic_tpu_torch.ops.rope import apply_rope, rope_cos_sin


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Geometry + flavour flags for one decoder stack."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    act: str = "silu"
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    norm_offset: float = 0.0  # 1.0 for Gemma-style (1 + w) RMSNorm scales
    qk_norm: bool = False  # Qwen3 per-head q/k RMSNorm
    attn_bias: bool = False  # Qwen2 qkv biases
    embed_scale: bool = False  # Gemma: embeddings * sqrt(hidden)
    tie_embeddings: bool = True
    has_embed: bool = True
    adarms_cond_dim: Optional[int] = None  # pi0.5 action expert: not ported yet
    attn_scale: Optional[float] = None  # default head_dim**-0.5
    attn_impl: str = "auto"
    moe_num_experts: Optional[int] = None  # not ported yet
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


class _Attn(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        h = cfg.hidden_size
        self.q = core.Linear(h, cfg.q_dim, cfg.attn_bias)
        self.k = core.Linear(h, cfg.kv_dim, cfg.attn_bias)
        self.v = core.Linear(h, cfg.kv_dim, cfg.attn_bias)
        self.o = core.Linear(cfg.q_dim, h, False)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, cfg.rms_eps, cfg.norm_offset)
            self.k_norm = RMSNorm(cfg.head_dim, cfg.rms_eps, cfg.norm_offset)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln1 = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.norm_offset)
        self.ln2 = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.norm_offset)
        self.attn = _Attn(cfg)
        self.mlp = core.GatedMLP(cfg.hidden_size, cfg.intermediate_size)


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.moe_num_experts or cfg.adarms_cond_dim is not None:
            raise NotImplementedError("MoE and adaRMS decoders are not ported yet")
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.norm_offset)
        if cfg.has_embed:
            self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            if not cfg.tie_embeddings:
                self.lm_head = core.Linear(cfg.hidden_size, cfg.vocab_size, False)


@torch.no_grad()
def init_transformer_(llm: Transformer, gen: torch.Generator) -> None:
    """The JAX init's distributions (init_transformer), drawn from ``gen``."""
    core.init_linears_(llm, gen)
    core.reset_norms_(llm)
    if hasattr(llm, "embed"):
        core.normal_init_(llm.embed.weight, gen)


def embed_tokens(llm: Transformer, cfg: TransformerConfig, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    x = core.embed(llm.embed, ids)
    if dtype is not None:
        x = x.to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype, device=x.device)
    return x


def lm_logits(llm: Transformer, cfg: TransformerConfig, hidden: torch.Tensor) -> torch.Tensor:
    if hasattr(llm, "lm_head"):
        return llm.lm_head(hidden)
    e = llm.embed  # tied embedding
    if isinstance(e, core.QuantEmbedding):  # int8 rows, per-row scales, in hidden's dtype
        return (hidden @ e.q.to(hidden.dtype).t()) * e.s.to(hidden.dtype).t()
    return hidden @ e.weight.to(hidden.dtype).t()


def transformer_forward(cfg: TransformerConfig, llm: Transformer, embeds: torch.Tensor,
                        positions: torch.Tensor, grp: torch.Tensor, valid: torch.Tensor,
                        q_seg: Optional[torch.Tensor] = None, remat=False) -> torch.Tensor:
    """Full-sequence decoder forward; returns the final-normed hidden states.

    ``remat`` (False | True | "dots") is the JAX flag, applied per layer
    (``core.remat_call``)."""
    B, S, _ = embeds.shape
    scale = cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim ** -0.5
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    grp, valid = grp.to(torch.int32), valid.to(torch.int32)
    q_shape = (B, S, cfg.num_heads, cfg.head_dim)
    kv_shape = (B, S, cfg.num_kv_heads, cfg.head_dim)

    def layer(lp, x):
        h = lp.ln1(x)
        q = lp.attn.q(h).reshape(q_shape)
        k = lp.attn.k(h).reshape(kv_shape)
        v = lp.attn.v(h).reshape(kv_shape)
        if cfg.qk_norm:
            q, k = lp.attn.q_norm(q), lp.attn.k_norm(k)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        a = attention(q, k, v, grp, grp, valid, scale=scale, impl=cfg.attn_impl,
                      q_seg=q_seg, kv_seg=q_seg)
        x = x + lp.attn.o(a.reshape(B, S, -1))
        return x + lp.mlp(lp.ln2(x), cfg.act)

    x = embeds
    for lp in llm.layers:
        x = core.remat_call(layer, remat, lp, x)
    return llm.norm(x)
