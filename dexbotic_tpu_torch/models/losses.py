"""Shared losses (port of the hard-target part of dexbotic_tpu/models/losses.py)."""

from __future__ import annotations

import torch

from dexbotic_tpu_torch.constants import IGNORE_INDEX


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token NLL with no shift: (nll fp32 [B, S], mask bool [B, S])."""
    mask = targets != IGNORE_INDEX
    safe = torch.where(mask, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, safe[..., None])[..., 0], mask


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token CE with IGNORE_INDEX masking (HF shift semantics).

    logits [B, S, V] of any float dtype; labels int [B, S].  Mean over the
    unmasked targets."""
    nll, mask = token_nll(logits[:, :-1], labels[:, 1:])
    denom = mask.sum().clamp_min(1)
    return torch.where(mask, nll, 0.0).sum() / denom
