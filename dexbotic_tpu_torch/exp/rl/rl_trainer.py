"""SimpleVLA-RL (GRPO) trainer: rollout collection, filtering and the policy
update (port of dexbotic_tpu/exp/rl/rl_trainer.py).

Env batches -> chunked sampled rollouts of the OFT-Discrete actor (each
chunk's log-probs kept) -> binary success reward -> accuracy filter ->
redistribution -> PPO-clip update with GRPO advantages and an entropy
bonus.  Envs and filtering stay on the host; rollouts are stored as
fixed-shape [N, max_chunks, ...] arrays with masks.  The sampled bins come
from one ``torch.Generator`` on the actor's device, where the JAX package
splits a key each chunk.  Across processes each one rolls out its own envs,
:func:`allgather_rollouts` gives every process the identical union, and the
update runs over a mesh (``GRPOUpdater(mesh=...)``): the actor sharded by
``parallel/mesh.shard_model``, each micro-batch's rows split over the data
ranks, its masked means over the whole micro-batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from dexbotic_tpu_torch.data.dex_rl_dataset import process_rank_and_count
from dexbotic_tpu_torch.exp.optim import Optimizer, OptimizerConfig, local
from dexbotic_tpu_torch.exp.rl.grpo import (
    GRPOConfig,
    accuracy_filter,
    grpo_outcome_advantage,
    ppo_clip_loss,
)
from dexbotic_tpu_torch.models import losses
from dexbotic_tpu_torch.models.losses import batch_mean
from dexbotic_tpu_torch.models.oft import OFTConfig, oft_action_log_probs
from dexbotic_tpu_torch.parallel import multihost


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    max_env_steps: int = 512  # env step budget of an episode
    chunk_steps: int = 8  # env steps executed per model call
    temperature: float = 1.6
    accuracy_lower_bound: float = 0.0
    accuracy_upper_bound: float = 1.0
    # drop the prompt groups holding an episode that ran out of its step budget
    filter_truncated: bool = False


class RolloutBuffer:
    """Fixed-shape per-episode storage of each chunk's (obs, bins, log-probs)."""

    def __init__(self, num_envs: int, max_chunks: int, obs_shapes: dict, tokens_per_chunk: int):
        self.n = num_envs
        self.max_chunks = max_chunks
        self.obs = {
            k: np.zeros((num_envs, max_chunks) + tuple(shape), np.float32)
            for k, shape in obs_shapes.items()
        }
        self.input_ids = None  # [N, L] prompt ids (constant over an episode)
        self.prompt_valid = None
        self.bins = np.zeros((num_envs, max_chunks, tokens_per_chunk), np.int32)
        self.old_logp = np.zeros((num_envs, max_chunks, tokens_per_chunk), np.float32)
        self.chunk_count = np.zeros(num_envs, np.int32)
        self.success = np.zeros(num_envs, np.float32)
        self.truncated = np.zeros(num_envs, np.float32)  # hit the budget, never done
        self.group_index = np.zeros(num_envs, np.int32)


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def collect_rollouts(
    envs: list,
    actor_fn: Callable,  # (obs_list, instructions, generator) -> (actions, bins, logp, ids, valid, images)
    rollout_cfg: RolloutConfig,
    generator: Optional[torch.Generator],
    group_index: Optional[np.ndarray] = None,
) -> RolloutBuffer:
    """Run every env to its end, or to the step budget, in lock-step chunks.

    The actor sees every env's last observation each chunk (fixed shapes);
    a finished env is not stepped and its rows stay zero.  An env still
    running at the budget is marked ``truncated``."""
    n = len(envs)
    max_chunks = rollout_cfg.max_env_steps // rollout_cfg.chunk_steps
    obs_list = [e.get_obs() for e in envs]
    instructions = [e.get_instruction() for e in envs]

    buf = None
    for chunk in range(max_chunks):
        actions, bins, logp, input_ids, prompt_valid, images = actor_fn(
            obs_list, instructions, generator)
        actions, bins, logp, images = _np(actions), _np(bins), _np(logp), _np(images)
        if buf is None:
            buf = RolloutBuffer(n, max_chunks, obs_shapes={"images": images.shape[1:]},
                                tokens_per_chunk=bins.shape[-1])
            buf.input_ids = _np(input_ids)
            buf.prompt_valid = _np(prompt_valid)
            if group_index is not None:
                buf.group_index = np.asarray(group_index, np.int32)
        any_active = False
        for i, env in enumerate(envs):
            if not env.is_active():
                continue
            any_active = True
            buf.obs["images"][i, chunk] = images[i]
            buf.bins[i, chunk] = bins[i]
            buf.old_logp[i, chunk] = logp[i]
            buf.chunk_count[i] += 1
            obs, done = env.step(actions[i][: rollout_cfg.chunk_steps])
            if done:
                buf.success[i] = float(env.is_complete())
            else:
                obs_list[i] = obs
        if not any_active:
            break
    for i, env in enumerate(envs):
        if env.is_active():  # the budget ran out
            buf.success[i] = float(env.is_complete())
            buf.truncated[i] = 1.0
    return buf


def flatten_rollouts(buf: RolloutBuffer) -> dict:
    """[N, C, ...] chunk storage -> flat training arrays with masks."""
    N, C, T = buf.bins.shape
    chunk_valid = (np.arange(C)[None, :] < buf.chunk_count[:, None]).astype(np.float32)
    return {
        "images": buf.obs["images"].reshape((N * C,) + buf.obs["images"].shape[2:]),
        "input_ids": np.repeat(buf.input_ids, C, axis=0),
        "prompt_valid": np.repeat(buf.prompt_valid, C, axis=0),
        "bins": buf.bins.reshape(N * C, T),
        "old_logp": buf.old_logp.reshape(N * C, T),
        "chunk_valid": chunk_valid.reshape(N * C),
        "episode": np.repeat(np.arange(N), C),
        "success": np.repeat(buf.success, C),
        "group_index": np.repeat(buf.group_index, C),
    }


def allgather_rollouts(buf: RolloutBuffer, pad_prompt_to: Optional[int] = None) -> RolloutBuffer:
    """Every process's rollout buffer, concatenated in process order, on
    every process (``buf`` itself in one process), so that the filter, the
    redistribution and the update are the same everywhere.

    The processes' episode counts and prompt lengths may differ: the prompts
    are right-padded to ``pad_prompt_to``, the counts exchanged, every
    per-episode array right-padded to the largest count, gathered, and the
    padding rows dropped again."""
    if process_rank_and_count()[1] == 1:
        return buf
    if pad_prompt_to is not None and buf.input_ids.shape[1] < pad_prompt_to:
        pad = pad_prompt_to - buf.input_ids.shape[1]
        buf.input_ids = np.pad(buf.input_ids, ((0, 0), (0, pad)))
        buf.prompt_valid = np.pad(buf.prompt_valid, ((0, 0), (0, pad)))
    counts = multihost.allgather(np.asarray([buf.n], np.int32)).reshape(-1)
    n_max = int(counts.max())

    def pad_rows(a):
        return np.pad(a, [(0, n_max - a.shape[0])] + [(0, 0)] * (a.ndim - 1))

    # the gathered rows are [P * n_max, ...]; process p's are p * n_max + [0, counts[p])
    keep = np.concatenate([p * n_max + np.arange(c) for p, c in enumerate(counts)])
    g = RolloutBuffer.__new__(RolloutBuffer)
    g.n = int(counts.sum())
    g.max_chunks = buf.max_chunks
    g.obs = {k: multihost.allgather(pad_rows(v))[keep] for k, v in buf.obs.items()}
    for name in ("input_ids", "prompt_valid", "bins", "old_logp", "chunk_count", "success",
                 "truncated", "group_index"):
        setattr(g, name, multihost.allgather(pad_rows(getattr(buf, name)))[keep])
    return g


def filter_and_redistribute(buf: RolloutBuffer, grpo_cfg: GRPOConfig, rollout_cfg: RolloutConfig,
                            num_groups: int):
    """The accuracy filter (and, with ``filter_truncated``, the truncation
    filter) on the host, then a group-granular circular redistribution back
    to ``num_groups`` groups, with fresh group ids for each redistributed
    block.  Returns (episode_idx, new_group_index): reorder the episode
    arrays by episode_idx and take new_group_index as their groups.  When no
    group survives, every episode is kept as it is."""
    N = len(buf.success)
    keep = accuracy_filter(buf.success, buf.group_index, num_groups,
                           rollout_cfg.accuracy_lower_bound,
                           rollout_cfg.accuracy_upper_bound).numpy()
    if rollout_cfg.filter_truncated:
        # drop the groups holding a truncated episode
        cnt = np.zeros(num_groups)
        np.add.at(cnt, buf.group_index, buf.truncated)
        keep = keep & (cnt[buf.group_index] == 0)
    kept_groups = np.unique(buf.group_index[keep.astype(bool)])
    if len(kept_groups) == 0:
        return np.arange(N), buf.group_index.copy()
    idx_blocks, new_groups = [], []
    total = 0
    for b in range(num_groups):
        g = kept_groups[b % len(kept_groups)]
        eps = np.nonzero(buf.group_index == g)[0]
        idx_blocks.append(eps)
        new_groups.append(np.full(len(eps), b, np.int32))
        total += len(eps)
        if total >= N:
            break
    idx = np.concatenate(idx_blocks)[:N]
    new_group_index = np.concatenate(new_groups)[:N]
    return idx, new_group_index


def rl_policy_loss(model, oft_cfg: OFTConfig, grpo_cfg: GRPOConfig, batch: dict,
                   temperature: float = 1.0, remat=True):
    """PPO-clip minus ``entropy_coeff`` x the masked entropy, on the
    log-probs recomputed under the current weights.  ``remat`` is on by
    default: the reference's RL fine-tune always checkpoints its layers."""
    logp, entropy = oft_action_log_probs(
        model, oft_cfg, batch["input_ids"], batch["prompt_valid"], batch["images"],
        batch.get("states"), batch["bins"], temperature=temperature, remat=remat)
    mask = batch["token_mask"].float()
    pg_loss, clip_frac, approx_kl = ppo_clip_loss(
        batch["old_logp"], logp, batch["advantages"], mask,
        grpo_cfg.clip_ratio_low, grpo_cfg.clip_ratio_high)
    ent = batch_mean((entropy * mask).sum(), mask.sum(), floor=1.0)
    loss = pg_loss - grpo_cfg.entropy_coeff * ent
    return loss, {"pg_loss": pg_loss, "clip_frac": clip_frac, "approx_kl": approx_kl,
                  "entropy": ent, "loss": loss}


def prepare_update_batch(flat: dict, grpo_cfg: GRPOConfig, num_groups: int,
                         episode_success: Optional[np.ndarray] = None,
                         episode_group: Optional[np.ndarray] = None) -> dict:
    """The update's batch (host tensors): each episode's GRPO advantage
    broadcast over its valid chunks.  The group statistics are over episode
    outcome scores, one a rollout, never over the flattened chunk rows:
    padding chunks do not dilute the z-score and an episode is not weighted
    by its chunk count."""
    T = flat["bins"].shape[-1]
    ep = np.asarray(flat["episode"])
    if episode_success is None:
        _, first = np.unique(ep, return_index=True)
        episode_success = np.asarray(flat["success"])[first]
        episode_group = np.asarray(flat["group_index"])[first]
    scores = grpo_cfg.reward_coef * torch.as_tensor(np.asarray(episode_success), dtype=torch.float32)
    adv_ep, _ = grpo_outcome_advantage(scores[:, None], torch.ones_like(scores)[:, None],
                                       np.asarray(episode_group), num_groups, grpo_cfg.epsilon)
    chunk_valid = torch.as_tensor(np.asarray(flat["chunk_valid"]), dtype=torch.float32)
    token_mask = chunk_valid[:, None].expand(chunk_valid.shape[0], T).contiguous()
    adv = adv_ep[torch.as_tensor(ep).long(), 0][:, None] * token_mask
    return {
        "input_ids": torch.as_tensor(np.asarray(flat["input_ids"])),
        "prompt_valid": torch.as_tensor(np.asarray(flat["prompt_valid"])),
        "images": torch.as_tensor(np.asarray(flat["images"])),
        "bins": torch.as_tensor(np.asarray(flat["bins"])),
        "old_logp": torch.as_tensor(np.asarray(flat["old_logp"])),
        "advantages": adv,
        "token_mask": token_mask,
    }


class GRPOUpdater:
    """Micro-batched PPO update over the port's optax-faithful optimizer:
    ``clip_by_global_norm(max_grad_norm)`` then ``adamw(learning_rate)`` at
    optax's defaults (weight decay 1e-4 on every parameter, eps 1e-8, betas
    0.9 / 0.999, a fixed learning rate with no warmup), moments in fp32.
    ``model`` is trained in place; its parameters keep their dtype (the JAX
    init's fp32: bf16 weights would round an update of lr 1e-6 away).

    With a ``mesh`` the update is sharded: the actor is laid out by
    ``parallel/mesh.shard_model`` (call :meth:`gathered` around anything
    else that runs it, such as the rollouts), the moments are sharded like
    their parameters, and each micro-batch's rows are split over the data
    ranks, whose gradients are averaged."""

    def __init__(self, oft_cfg: OFTConfig, grpo_cfg: GRPOConfig, model,
                 learning_rate: float = 1e-6, max_grad_norm: float = 1.0,
                 temperature: float = 1.0, mesh=None, remat=True):
        self.oft_cfg = oft_cfg
        self.grpo_cfg = grpo_cfg
        self.temperature = temperature
        self.remat = remat
        self.mesh = mesh
        model.requires_grad_(True)
        self.sharded = None
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            from dexbotic_tpu_torch.parallel.mesh import shard_model

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a ('data', 'model') DeviceMesh "
                                f"(parallel/mesh.make_mesh), not {type(mesh).__name__}")
            self.sharded = shard_model(model, mesh)
        self.optimizer = Optimizer(
            OptimizerConfig(learning_rate=learning_rate, weight_decay=1e-4,
                            max_grad_norm=max_grad_norm, lr_scheduler_type="fixed"),
            model.named_parameters(), total_steps=1, mesh=mesh)

    def gathered(self):
        """A context in which the sharded actor's parameters are whole on
        every rank (a no-op without a mesh)."""
        if self.sharded is None:
            return contextlib.nullcontext()
        return self.sharded.gathered()

    def grads(self, model, mb: dict) -> tuple[dict, dict]:
        """(metrics as 0-d tensors, {name: gradient or None}) of one
        micro-batch ``mb`` already on the model's device."""
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None

        def loss_fn(model, mb):
            return rl_policy_loss(model, self.oft_cfg, self.grpo_cfg, mb, self.temperature,
                                  remat=self.remat)

        with torch.enable_grad():
            if self.sharded is None:
                loss, metrics = loss_fn(model, mb)
            else:
                with losses.data_parallel(self.sharded.data_group, self.sharded.data_size):
                    loss, metrics = self.sharded(loss_fn, mb)
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.sharded is not None:
            self.sharded.reduce_replicated_grads()
            stacked = torch.stack([v.float().reshape(()) for v in metrics.values()])
            torch.distributed.all_reduce(stacked, group=self.sharded.data_group)
            metrics = dict(zip(metrics, stacked / self.sharded.data_size))
        return metrics, {n: p.grad for n, p in params.items()}

    def apply(self, model, grads: dict) -> torch.Tensor:
        """One optimizer update from ``grads``; returns their global norm."""
        params = dict(model.named_parameters())
        norm = self.optimizer.step_(params, grads)
        for p in params.values():
            p.grad = None
        return norm

    def step(self, model, mb: dict) -> dict:
        metrics, grads = self.grads(model, mb)
        metrics["grad_norm"] = self.apply(model, grads)
        return metrics

    def update(self, model, batch: dict, micro_batch_size: int):
        """Every row of ``batch`` through micro-batches of ``micro_batch_size``
        (moved to the model's device one at a time): a tail short of a whole
        micro-batch is padded with repeats of the first rows whose token
        mask and advantages are zero, so that it counts without weight.
        Returns (model, the metrics' means over the micro-batches).  Over a
        mesh each data rank takes its contiguous share of every micro-batch."""
        device = local(next(model.parameters())).device
        rows = slice(0, micro_batch_size)
        if self.sharded is not None:
            i, d = self.sharded.data_rank, self.sharded.data_size
            if micro_batch_size % d:
                raise ValueError(f"micro_batch_size {micro_batch_size} not divisible by the "
                                 f"data-parallel size {d}")
            rows = slice(i * micro_batch_size // d, (i + 1) * micro_batch_size // d)
        n = batch["bins"].shape[0]
        pad = (-n) % micro_batch_size
        if pad:
            idx = torch.arange(pad) % n
            batch = {k: torch.cat([v, v[idx]], dim=0) for k, v in batch.items()}
            real = (torch.arange(n + pad) < n)[:, None]
            for k in ("token_mask", "advantages"):
                batch[k] = batch[k] * real.to(batch[k].dtype)
            n += pad
        all_metrics = []
        for s in range(0, n, micro_batch_size):
            mb = {k: v[s: s + micro_batch_size][rows].to(device, non_blocking=True)
                  for k, v in batch.items()}
            metrics = self.step(model, mb)
            all_metrics.append({k: float(v) for k, v in metrics.items()})
        agg = ({k: float(np.mean([m[k] for m in all_metrics])) for k in all_metrics[0]}
               if all_metrics else {})
        return model, agg
