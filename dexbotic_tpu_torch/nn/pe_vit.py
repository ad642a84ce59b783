"""Perception Encoder (PE) vision tower: a ViT with 2-D axial RoPE,
LayerScale and optional attention pooling (port of dexbotic_tpu/nn/pe_vit.py).

Half of each head's dims rotate with the patch's row, half with its column;
each residual branch is scaled by a learned per-channel LayerScale; with
``pool_tokens`` a set of learned queries attends over the patch tokens
(``pool``) down to that many outputs.  Attention is the plain version
(``impl="xla"``), as the JAX tower calls ``attention_xla``.  No model of the
repo serves this tower yet; its test holds it against the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from dexbotic_tpu_torch.nn import core
from dexbotic_tpu_torch.nn.vit import patchify
from dexbotic_tpu_torch.ops.attention import attention
from dexbotic_tpu_torch.ops.norms import LayerNorm


@dataclasses.dataclass(frozen=True)
class PEViTConfig:
    image_size: int = 448
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    ln_eps: float = 1e-5
    layer_scale_init: float = 0.1
    pool_tokens: Optional[int] = None  # None -> every patch token

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_output_tokens(self) -> int:
        return self.pool_tokens or self.grid ** 2


class _Attn(nn.Module):
    def __init__(self, h: int, out: bool = True):
        super().__init__()
        self.q, self.k, self.v = (core.Linear(h, h) for _ in range(3))
        if out:
            self.o = core.Linear(h, h)


class _MLP(nn.Module):
    def __init__(self, h: int, inter: int):
        super().__init__()
        self.fc1 = core.Linear(h, inter)
        self.fc2 = core.Linear(inter, h)


class PELayer(nn.Module):
    def __init__(self, cfg: PEViTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.ln1 = LayerNorm(h, cfg.ln_eps)
        self.ln2 = LayerNorm(h, cfg.ln_eps)
        self.attn = _Attn(h)
        self.mlp = _MLP(h, cfg.intermediate_size)
        self.ls1 = nn.Parameter(torch.empty(h))
        self.ls2 = nn.Parameter(torch.empty(h))


class _Pool(nn.Module):
    def __init__(self, cfg: PEViTConfig):
        super().__init__()
        self.queries = nn.Parameter(torch.empty(cfg.pool_tokens, cfg.hidden_size))
        self.attn = _Attn(cfg.hidden_size, out=False)
        self.ln = LayerNorm(cfg.hidden_size, cfg.ln_eps)


class PEViT(nn.Module):
    def __init__(self, cfg: PEViTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.patch_embed = core.Linear(cfg.patch_size ** 2 * 3, h)
        self.layers = nn.ModuleList(PELayer(cfg) for _ in range(cfg.num_layers))
        self.post_ln = LayerNorm(h, cfg.ln_eps)
        if cfg.pool_tokens:
            self.pool = _Pool(cfg)


@torch.no_grad()
def init_pe_vit_(vit: PEViT, cfg: PEViTConfig, gen: torch.Generator) -> None:
    """The JAX init's distributions (init_pe_vit), drawn from ``gen``."""
    core.init_linears_(vit, gen)
    core.reset_norms_(vit)
    core.normal_init_(vit.patch_embed.weight, gen)
    vit.patch_embed.bias.zero_()
    for lp in vit.layers:
        lp.ls1.fill_(cfg.layer_scale_init)
        lp.ls2.fill_(cfg.layer_scale_init)
    if cfg.pool_tokens:
        core.normal_init_(vit.pool.queries, gen, std=cfg.hidden_size ** -0.5)


def rope2d_tables(cfg: PEViTConfig, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Axial 2-D RoPE (cos, sin) [grid^2, head_dim] fp32: the first half of
    the head's dims rotate with the patch's row, the second with its column."""
    d = cfg.head_dim // 2
    g = cfg.grid
    freqs = 1.0 / (10000 ** (np.arange(0, d, 2) / d))
    rows, cols = np.repeat(np.arange(g), g), np.tile(np.arange(g), g)

    def table(pos):
        ang = pos[:, None] * freqs[None, :]
        ang = np.concatenate([ang, ang], axis=-1)
        return np.cos(ang), np.sin(ang)

    (rc, rs), (cc, cs) = table(rows), table(cols)
    cos = torch.tensor(np.concatenate([rc, cc], -1), dtype=torch.float32, device=device)
    sin = torch.tensor(np.concatenate([rs, cs], -1), dtype=torch.float32, device=device)
    return cos, sin


def _rotate_half_axial(x: torch.Tensor, d: int) -> torch.Tensor:
    def rot(y):
        h = y.shape[-1] // 2
        return torch.cat([-y[..., h:], y[..., :h]], -1)

    return torch.cat([rot(x[..., :d]), rot(x[..., d:])], -1)


def apply_rope2d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, N, H, D] rotated in fp32 by the [N, D] tables, in x's dtype."""
    xf = x.float()
    out = xf * cos[None, :, None] + _rotate_half_axial(xf, x.shape[-1] // 2) * sin[None, :, None]
    return out.to(x.dtype)


def pe_vit_forward(vit: PEViT, cfg: PEViTConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> [B, num_output_tokens, hidden]."""
    B = images.shape[0]
    x = vit.patch_embed(patchify(images, cfg.patch_size))
    N = x.shape[1]
    cos, sin = rope2d_tables(cfg, x.device)
    grp = torch.zeros((B, N), dtype=torch.int32, device=x.device)
    valid = torch.ones((B, N), dtype=torch.int32, device=x.device)
    shape = (B, N, cfg.num_heads, cfg.head_dim)
    for lp in vit.layers:
        h = lp.ln1(x)
        q, k, v = (lin(h).reshape(shape) for lin in (lp.attn.q, lp.attn.k, lp.attn.v))
        a = attention(apply_rope2d(q, cos, sin), apply_rope2d(k, cos, sin), v, grp, grp, valid,
                      impl="xla")
        x = x + lp.attn.o(a.reshape(B, N, -1)) * lp.ls1.to(x.dtype)
        m = lp.mlp.fc2(core.ACTIVATIONS["gelu_tanh"](lp.mlp.fc1(lp.ln2(x))))
        x = x + m * lp.ls2.to(m.dtype)
    x = vit.post_ln(x)
    if cfg.pool_tokens:
        p, M = vit.pool, cfg.pool_tokens
        q = p.attn.q(p.queries.to(x.dtype)[None].expand(B, M, -1)).reshape(
            B, M, cfg.num_heads, cfg.head_dim)
        k, v = (lin(x).reshape(shape) for lin in (p.attn.k, p.attn.v))
        q_grp = torch.zeros((B, M), dtype=torch.int32, device=x.device)
        pooled = attention(q, k, v, q_grp, grp, valid, impl="xla").reshape(B, M, -1)
        x = p.ln(pooled)
    return x
