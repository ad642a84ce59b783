"""DiT action head (port of dexbotic_tpu/models/dit.py).

Condition token = timestep embedding + projected cognition feature,
prepended to the embedded noisy actions; pre-LN transformer blocks;
zero-initialised final layer.  MemVLA's variant (``mem_cross_attn``) adds to
every block a cross-attention from the tokens to memory tokens, behind an
affine LayerNorm, with a zero-initialised output projection, as plain
attention (the JAX package's ``attention_xla``): kernel K2 does not serve it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dexbotic_tpu_torch.nn import core
from dexbotic_tpu_torch.ops.attention import attention_xla
from dexbotic_tpu_torch.ops.norms import LayerNorm, layer_norm


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    in_channels: int = 7  # action dim
    token_size: int = 4096  # cognition-feature dim
    chunk_size: int = 16
    class_dropout_prob: float = 0.1
    freq_embed_size: int = 256
    mem_cross_attn: bool = False  # MemVLA's memory-conditioned variant
    scan_unroll: int = 1  # JAX scan knob; kept for config parity, unused

    @property
    def seq_len(self) -> int:
        return self.chunk_size + 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


DIT_SIZES = {
    "DiT-S": dict(depth=6, hidden_size=384, num_heads=4),
    "DiT-B": dict(depth=12, hidden_size=768, num_heads=12),
    "DiT-L": dict(depth=24, hidden_size=1024, num_heads=16),
}


def make_dit_config(model_type: str, token_size: int, action_dim: int, chunk_size: int, **kw) -> DiTConfig:
    return DiTConfig(token_size=token_size, in_channels=action_dim, chunk_size=chunk_size,
                     **DIT_SIZES[model_type], **kw)


class DiTAttention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.qkv = core.Linear(h, 3 * h)
        self.o = core.Linear(h, h)


class DiTMemAttention(nn.Module):
    """Cross-attention from the DiT's tokens to the memory tokens (MemVLA)."""

    def __init__(self, h: int):
        super().__init__()
        self.q, self.k, self.v, self.o = (core.Linear(h, h) for _ in range(4))
        self.ln = LayerNorm(h)


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.attn = DiTAttention(cfg.hidden_size)
        self.mlp = core.MLP([cfg.hidden_size, cfg.mlp_dim, cfg.hidden_size])
        if cfg.mem_cross_attn:
            self.xattn = DiTMemAttention(cfg.hidden_size)


class DiT(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.x_embed = core.Linear(cfg.in_channels, h)
        self.t_mlp = core.MLP([cfg.freq_embed_size, h, h])
        self.z_embed = core.Linear(cfg.token_size, h)
        self.pos_embed = nn.Parameter(torch.empty(cfg.seq_len, h))
        self.blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
        self.final = core.Linear(h, cfg.in_channels)
        if cfg.class_dropout_prob > 0:
            self.uncondition = nn.Parameter(torch.empty(cfg.token_size))
        self._k2_cache = {}  # name -> (key, value), kept by ops/dit_fused.py


@torch.no_grad()
def init_dit_(head: DiT, gen: torch.Generator) -> None:
    """The JAX init's distributions (init_dit), drawn from ``gen``."""
    cfg = head.cfg
    for lin in (head.x_embed, head.t_mlp.fc0, head.t_mlp.fc1, head.z_embed):
        core.normal_init_(lin.weight, gen, 0.02)
        lin.bias.zero_()
    core.normal_init_(head.pos_embed, gen, cfg.hidden_size ** -0.5)
    for blk in head.blocks:
        for lin in (blk.attn.qkv, blk.attn.o, blk.mlp.fc0, blk.mlp.fc1):
            core.xavier_init_(lin, gen)
        if cfg.mem_cross_attn:  # the module starts as the identity: zero output projection
            xa = blk.xattn
            for lin in (xa.q, xa.k, xa.v):
                core.xavier_init_(lin, gen)
            xa.o.weight.zero_()
            xa.o.bias.zero_()
            core.reset_norms_(xa)
    head.final.weight.zero_()
    head.final.bias.zero_()
    if hasattr(head, "uncondition"):
        core.normal_init_(head.uncondition, gen, 0.02)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """[cos, sin] sinusoidal embedding of timesteps [B] -> [B, dim] fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def dit_forward(head: DiT, cfg: DiTConfig, x: torch.Tensor, t: torch.Tensor, z: torch.Tensor,
                drop_gen: Optional[torch.Generator] = None, mem: Optional[torch.Tensor] = None,
                mem_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """eps for noisy actions x [B, T, A] at timesteps t [B] under condition z [B, 1, token].

    ``drop_gen`` turns on the train-time CFG condition dropout: a row whose
    uniform draw is below ``class_dropout_prob`` is conditioned on the learned
    uncondition embedding instead.  ``mem`` [B, M, hidden] (and ``mem_valid``
    [B, M], all valid by default) are the memory tokens of ``mem_cross_attn``.
    Computes in the weights' dtype (bf16 when served) with fp32 norms;
    returns fp32 [B, T, A]."""
    B = x.shape[0]
    if drop_gen is not None and cfg.class_dropout_prob > 0:
        drop = torch.rand((B,), generator=drop_gen, device=x.device) < cfg.class_dropout_prob
        z = torch.where(drop[:, None, None], head.uncondition.to(z.dtype)[None, None, :], z)
    cdtype = core.weight_dtype(head.x_embed)
    x, z = x.to(cdtype), z.to(cdtype)
    xe = head.x_embed(x)
    te = timestep_embedding(t, cfg.freq_embed_size).to(cdtype)
    te = head.t_mlp.fc1(F.silu(head.t_mlp.fc0(te)))
    c = te[:, None, :] + head.z_embed(z)
    h = torch.cat([c, xe], dim=1) + head.pos_embed.to(cdtype)[None]
    S = h.shape[1]
    grp = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    valid = torch.ones((B, S), dtype=torch.int32, device=x.device)
    if cfg.mem_cross_attn:
        mem = mem.to(cdtype)
        M = mem.shape[1]
        mem_grp = torch.zeros((B, M), dtype=torch.int32, device=x.device)
        if mem_valid is None:
            mem_valid = torch.ones((B, M), dtype=torch.int32, device=x.device)
    heads, hd = cfg.num_heads, cfg.head_dim
    for blk in head.blocks:
        hn = layer_norm(h, eps=1e-6)
        qkv = blk.attn.qkv(hn).reshape(B, S, 3, heads, hd)
        a = attention_xla(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], grp, grp, valid)
        h = h + blk.attn.o(a.reshape(B, S, -1))
        if cfg.mem_cross_attn:
            xa = blk.xattn
            hn2 = layer_norm(h, xa.ln.weight, xa.ln.bias, eps=1e-6)
            a2 = attention_xla(xa.q(hn2).reshape(B, S, heads, hd),
                               xa.k(mem).reshape(B, M, heads, hd),
                               xa.v(mem).reshape(B, M, heads, hd), grp, mem_grp, mem_valid)
            h = h + xa.o(a2.reshape(B, S, -1))
        m = blk.mlp.fc1(F.gelu(blk.mlp.fc0(layer_norm(h, eps=1e-6)), approximate="tanh"))
        h = h + m
    out = head.final(layer_norm(h, eps=1e-6)).float()
    return out[:, 1:, :]  # drop the condition token


def dit_forward_with_cfg(head: DiT, cfg: DiTConfig, x, t, z, cfg_scale: float,
                         **kw) -> torch.Tensor:
    """Classifier-free-guided eps: the batch is [cond; uncond] halves sharing
    x; ``kw`` (the memory tokens) goes to :func:`dit_forward`."""
    half = x.shape[0] // 2
    combined = torch.cat([x[:half], x[:half]], dim=0)
    eps = dit_forward(head, cfg, combined, t, z, **kw)
    guided = eps[half:] + cfg_scale * (eps[:half] - eps[half:])
    return torch.cat([guided, guided], dim=0)
