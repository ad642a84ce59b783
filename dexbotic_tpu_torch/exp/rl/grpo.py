"""GRPO core: group-normalised outcome advantages and the PPO-clip policy
loss (port of dexbotic_tpu/exp/rl/grpo.py).

The reference groups rollouts in a Python dict; here the group sums are
``index_add_`` over group ids, as the JAX package's ``segment_sum``.
Inputs may be numpy arrays or tensors; outputs are fp32 tensors on the
inputs' device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GRPOConfig:
    gamma: float = 0.99
    lam: float = 0.95
    epsilon: float = 1e-6
    n_samples: int = 8  # rollouts per prompt group
    clip_ratio_low: float = 0.2
    clip_ratio_high: float = 0.28
    entropy_coeff: float = 0.0
    reward_coef: float = 5.0


def _t(x, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


def _segment_sum(x: torch.Tensor, index: torch.Tensor, num_groups: int) -> torch.Tensor:
    return torch.zeros(num_groups, dtype=x.dtype, device=x.device).index_add_(0, index, x)


def grpo_outcome_advantage(token_level_rewards, eos_mask, index, num_groups: int,
                           epsilon: float = 1e-6):
    """Each prompt group's z-scored outcome reward, broadcast over the
    response tokens: (advantages, returns), both [B, T].  The std is
    Bessel-corrected (torch.std); a group of one member uses mean 0 and
    std 1, as the reference does."""
    rewards = _t(token_level_rewards)
    index = torch.as_tensor(index, device=rewards.device).long()
    scores = rewards.sum(-1)  # [B]
    cnt = _segment_sum(torch.ones_like(scores), index, num_groups)
    s1 = _segment_sum(scores, index, num_groups)
    s2 = _segment_sum(scores ** 2, index, num_groups)
    mean = s1 / torch.clamp(cnt, min=1.0)
    var = torch.clamp((s2 - cnt * mean ** 2) / torch.clamp(cnt - 1.0, min=1.0), min=0.0)
    std = torch.sqrt(var)
    single = cnt <= 1.0
    mean = torch.where(single, torch.zeros_like(mean), mean)
    std = torch.where(single, torch.ones_like(std), std)
    z = (scores - mean[index]) / (std[index] + epsilon)
    adv = z[:, None] * _t(eos_mask, device=rewards.device)
    return adv, adv


def ppo_clip_loss(old_log_prob, log_prob, advantages, eos_mask, clip_ratio_low: float = 0.2,
                  clip_ratio_high: float = 0.28):
    """Asymmetric PPO-clip over the masked tokens: (pg_loss, clip_frac, approx_kl)."""
    mask = _t(eos_mask, device=log_prob.device)

    def masked_mean(x):
        return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    neg_kl = log_prob - old_log_prob
    ratio = torch.exp(neg_kl)
    ppo_kl = masked_mean(-neg_kl)
    pg1 = -advantages * ratio
    pg2 = -advantages * torch.clamp(ratio, 1.0 - clip_ratio_low, 1.0 + clip_ratio_high)
    pg_loss = masked_mean(torch.maximum(pg1, pg2))
    clip_frac = masked_mean((pg2 > pg1).float())
    return pg_loss, clip_frac, ppo_kl


def outcome_token_rewards(success, finish_steps, tokens_per_step: int, max_tokens: int,
                          reward_coef: float = 5.0) -> torch.Tensor:
    """Binary success x reward_coef at the last valid response token, [B, max_tokens]."""
    success = _t(success)
    steps = torch.as_tensor(finish_steps, device=success.device).long()
    B = success.shape[0]
    last = torch.clamp(steps * tokens_per_step - 1, 0, max_tokens - 1)
    rewards = torch.zeros((B, max_tokens), dtype=torch.float32, device=success.device)
    rewards[torch.arange(B, device=success.device), last] = reward_coef * success
    return rewards


def response_mask(finish_steps, tokens_per_step: int, max_tokens: int) -> torch.Tensor:
    """The eos mask: 1 for the tokens of executed steps, [B, max_tokens]."""
    steps = torch.as_tensor(finish_steps).long()
    idx = torch.arange(max_tokens, device=steps.device)[None, :]
    return (idx < (steps * tokens_per_step)[:, None]).float()


def accuracy_filter(success, index, num_groups: int, low: float = 0.0,
                    high: float = 1.0) -> torch.Tensor:
    """Keep the groups whose mean success lies strictly inside (low, high):
    all-success and all-fail groups carry no GRPO signal.  bool [B]."""
    success = _t(success)
    index = torch.as_tensor(index, device=success.device).long()
    cnt = _segment_sum(torch.ones_like(success), index, num_groups)
    acc = _segment_sum(success, index, num_groups) / torch.clamp(cnt, min=1.0)
    keep_group = (acc > low) & (acc < high)
    return keep_group[index]
