"""Multimodal projector (port of dexbotic_tpu/nn/projector.py).

Types: 'linear', 'linear{N}x' (a bias-free ``fc`` of ``mm_hidden * N ->
hidden``, applied to features of that width), 'mlp{N}x_gelu' (exact-erf
GELU between layers) and 'mlp_downsample' (NaVILA's: a 2x2 space-to-depth of
the token grid, an odd grid zero-padded, then LayerNorm, fc0, GELU, fc1).
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from dexbotic_tpu_torch.nn import core
from dexbotic_tpu_torch.ops.norms import LayerNorm


def _mlp_depth(projector_type: str) -> int | None:
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    return int(m.group(1)) if m else None


def _linear_mult(projector_type: str) -> int | None:
    m = re.match(r"^linear(\d+)x$", projector_type)
    return int(m.group(1)) if m else None


class Projector(nn.Module):
    def __init__(self, projector_type: str, mm_hidden: int, hidden: int):
        super().__init__()
        self.projector_type = projector_type
        depth = _mlp_depth(projector_type)
        if projector_type == "linear":
            self.fc = core.Linear(mm_hidden, hidden)
        elif _linear_mult(projector_type):
            self.fc = core.Linear(mm_hidden * _linear_mult(projector_type), hidden, bias=False)
        elif projector_type == "mlp_downsample":
            self.ln = LayerNorm(mm_hidden * 4, eps=1e-5)
            self.fc0 = core.Linear(mm_hidden * 4, hidden)
            self.fc1 = core.Linear(hidden, hidden)
        elif depth:
            self.fc0 = core.Linear(mm_hidden, hidden)
            for i in range(1, depth):
                setattr(self, f"fc{i}", core.Linear(hidden, hidden))
        else:
            raise ValueError(f"unknown projector type: {projector_type!r}")


@torch.no_grad()
def init_projector_(proj: Projector, gen: torch.Generator) -> None:
    core.init_linears_(proj, gen)
    core.reset_norms_(proj)


def downsample_2x2(x: torch.Tensor) -> torch.Tensor:
    """[B, g*g, C] -> [B, ceil(g/2)^2, 4C]: space-to-depth 2x2 over the square
    token grid, an odd grid zero-padded at its bottom and right edges.  The
    reference's two view/permute steps give the channel order [row-pair,
    col-pair] (its transpose quirk), kept here."""
    B, N, C = x.shape
    g = int(round(N ** 0.5))
    if g * g != N:
        raise ValueError(f"non-square token grid: {N}")
    x = x.reshape(B, g, g, C)
    if g % 2:
        x = F.pad(x, (0, 0, 0, 1, 0, 1))
        g += 1
    x = x.reshape(B, g, g // 2, C * 2).transpose(1, 2)
    return x.reshape(B, (g // 2) ** 2, C * 4)


def apply_projector(proj: Projector, x: torch.Tensor, projector_type: str) -> torch.Tensor:
    if projector_type == "linear" or _linear_mult(projector_type):
        return proj.fc(x)
    if projector_type == "mlp_downsample":
        x = proj.ln(downsample_2x2(x))
        return proj.fc1(F.gelu(proj.fc0(x)))
    depth = _mlp_depth(projector_type)
    if not depth:
        raise ValueError(f"unknown projector type: {projector_type!r}")
    out = proj.fc0(x)
    for i in range(1, depth):
        out = getattr(proj, f"fc{i}")(F.gelu(out))
    return out
