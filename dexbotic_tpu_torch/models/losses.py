"""Shared losses (port of dexbotic_tpu/models/losses.py), and the global
batch's counts under data parallelism.

The JAX package computes a loss over the global batch, so a mean over
tokens divides by the valid count of the whole batch.  Under
:func:`data_parallel` each rank computes on its own rows and the gradients
are averaged over the ranks, so a mean here returns
``local sum / global count x ranks``: the ranks' average is then the
global mean, in value and gradient, whatever number of valid tokens each
rank holds.  Outside it (one process) the means are the plain ones.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from dexbotic_tpu_torch.constants import IGNORE_INDEX
from dexbotic_tpu_torch.parallel.mesh import data_parallel, data_parallel_state  # noqa: F401


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a count, no gradient) summed over the data ranks; ``x`` itself
    outside :func:`data_parallel`."""
    dp = data_parallel_state()
    if dp is None:
        return x
    total = x.detach().clone()
    dist.all_reduce(total, group=dp[0])
    return total


def batch_mean(total: torch.Tensor, count: torch.Tensor, floor: Optional[float] = None,
               eps: Optional[float] = None) -> torch.Tensor:
    """``total / count`` over the global batch: the count (clamped to
    ``floor``, or plus ``eps``, after the sum over ranks) is the global one,
    and the rank's share is scaled by the number of ranks (see the module's
    docstring)."""
    count = global_sum(count)
    if floor is not None:
        count = count.clamp_min(floor)
    if eps is not None:
        count = count + eps
    mean = total / count
    dp = data_parallel_state()
    return mean if dp is None else mean * dp[1]


def token_nll(logits: torch.Tensor, targets: torch.Tensor,
              soft_tokens: Optional[torch.Tensor] = None,
              std: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token NLL with no shift: (nll fp32 [B, S], mask bool [B, S]).

    With ``soft_tokens`` (int [K], an ordered set of vocabulary ids), a
    target in the set is scored against a Gaussian over the set centred at
    its place (std ``std``); any other target keeps the hard NLL."""
    mask = targets != IGNORE_INDEX
    safe = torch.where(mask, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    hard = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if soft_tokens is None:
        return hard, mask
    soft_tokens = soft_tokens.to(device=logits.device, dtype=torch.long)
    eq = safe[..., None] == soft_tokens  # [B, S, K]
    in_set = eq.any(-1)
    pos = eq.int().argmax(-1)  # the target's place in the set, where in_set
    k = torch.arange(soft_tokens.shape[0], dtype=torch.float32, device=logits.device)
    gauss = torch.exp(-0.5 * ((k - pos[..., None].float()) / std) ** 2)
    gauss = gauss / gauss.sum(-1, keepdim=True)
    soft = -(gauss * logp[..., soft_tokens]).sum(-1)
    return torch.where(in_set, soft, hard), mask


def _masked_mean(nll: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return batch_mean(torch.where(mask, nll, 0.0).sum(), mask.sum(), floor=1)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token CE with IGNORE_INDEX masking (HF shift semantics).

    logits [B, S, V] of any float dtype; labels int [B, S].  Mean over the
    unmasked targets."""
    return _masked_mean(*token_nll(logits[:, :-1], labels[:, 1:]))


def soft_cross_entropy_gaussian(logits: torch.Tensor, labels: torch.Tensor,
                                soft_tokens: torch.Tensor, std: float = 1.0) -> torch.Tensor:
    """NaVILA's soft CE: a target among ``soft_tokens`` (the numeric tokens,
    in order) spreads its probability over the set with a Gaussian centred
    at it; other targets take the hard CE.  Shifted and masked as
    :func:`causal_lm_loss`."""
    return _masked_mean(*token_nll(logits[:, :-1], labels[:, 1:], soft_tokens, std))
