"""RMSNorm, adaptive RMSNorm and LayerNorm, computed in fp32 (port of dexbotic_tpu/ops/norms.py)."""

from __future__ import annotations

import torch
from torch import nn


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             weight_offset: float = 0.0) -> torch.Tensor:
    """RMSNorm.  Gemma-family uses weight_offset=1.0 (scale = 1 + w)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * (weight_offset + weight.float())).to(x.dtype)


def ada_rms_norm(x: torch.Tensor, weight: torch.Tensor, cond_scale: torch.Tensor,
                 eps: float = 1e-6, weight_offset: float = 0.0) -> torch.Tensor:
    """Adaptive RMSNorm: rms_norm(x) * (1 + cond_scale), with a per-sample
    scale [B, D] (or [B, 1, D]) from a conditioning vector."""
    normed = rms_norm(x, weight, eps, weight_offset)
    if cond_scale.ndim == normed.ndim - 1:
        cond_scale = cond_scale[:, None, :]
    return (normed.float() * (1.0 + cond_scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with optional affine params (None = non-affine, DiT style).

    The variance is the population variance, as ``jnp.var`` computes it."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    if weight is not None:
        normed = normed * weight.float()
    if bias is not None:
        normed = normed + bias.float()
    return normed.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, weight_offset: float = 0.0):
        super().__init__()
        self.eps, self.weight_offset = eps, weight_offset
        init = torch.zeros if weight_offset else torch.ones
        self.weight = nn.Parameter(init(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps, self.weight_offset)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
