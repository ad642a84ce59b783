"""Optimizer: AdamW, warmup schedules, per-module LR groups and freezing.

Port of dexbotic_tpu/exp/optim.py.  The JAX package builds the optax chain
``clip_by_global_norm(max_grad_norm)`` followed by ``multi_transform`` over
group labels, each group an ``adamw`` with its own schedule, and frozen groups
``set_to_zero``.  :class:`Optimizer` writes that update by hand on named
tensors instead of using ``torch.optim.AdamW``, which keeps its moments in
the parameter's dtype and updates in place: here the moments are fp32, the
update is computed in fp32 and applied as ``(p + u).to(p.dtype)``, as
``optax.apply_updates`` applies it to bf16 parameters.  The clip norm counts
every gradient it is given, frozen or not; frozen groups allocate no moments.

Parameters sharded over a mesh (DTensors, ``parallel/mesh.shard_model``)
are updated shard by shard: each rank's moments are those of its own shard,
and the clip norm is the whole tree's, summed from the local shards in one
collective (:func:`global_norm`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from dexbotic_tpu_torch.nn.core import local


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None
    mm_vision_lr: Optional[float] = None
    action_head_lr: Optional[float] = None
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.03
    # 'cosine' | 'constant' | 'linear' (each after a linear warmup), or 'fixed':
    # learning_rate from the first update on (a float given to optax.adamw)
    lr_scheduler_type: str = "cosine"
    # frozen subtrees take no update and allocate no moments
    freeze_llm: bool = False  # decoder stack (lm_head stays trainable)
    freeze_mm_projector: bool = False
    freeze_mm_vision: bool = False


def _keys(name: str) -> list[str]:
    return name.split(".")


def group_of(name: str) -> str:
    """LR group of a parameter name such as ``vlm.projector.fc0.weight``."""
    keys = _keys(name)
    if "projector" in keys or "mm_projector" in keys:
        return "mm_projector"
    if "vit" in keys or "mm_vision" in keys:
        return "mm_vision"
    if "action_head" in keys or "action_expert" in keys:
        return "action_head"
    return "base"


def is_frozen(name: str, cfg: OptimizerConfig) -> bool:
    keys = _keys(name)
    if cfg.freeze_llm and "llm" in keys and "lm_head" not in keys:
        return True  # the decoder stack; lm_head lives outside it
    if cfg.freeze_mm_projector and ("projector" in keys or "mm_projector" in keys):
        return True
    if cfg.freeze_mm_vision and ("vit" in keys or "mm_vision" in keys):
        return True
    return False


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    return lambda count: (init - end) * (1.0 - min(max(count, 0), steps) / steps) + end


def _join(schedules: list, boundaries: list[int]) -> Callable[[int], float]:
    """optax.join_schedules: each schedule sees the count since its boundary."""

    def fn(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return fn


def make_schedule(cfg: OptimizerConfig, base_lr: float, total_steps: int) -> Callable[[int], float]:
    """optax's warmup schedules as a function of the update count before the
    update, so step 0 has lr 0 ('fixed': ``base_lr`` at every count)."""
    if cfg.lr_scheduler_type == "fixed":
        return lambda count: base_lr
    warmup = max(1, int(cfg.warmup_ratio * total_steps))
    if cfg.lr_scheduler_type == "cosine":
        decay_steps = max(total_steps, warmup + 1) - warmup

        def cosine(count: int) -> float:
            count = min(count, decay_steps)
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))

        return _join([_linear(0.0, base_lr, warmup), cosine], [warmup])
    if cfg.lr_scheduler_type == "linear":
        return _join([_linear(0.0, base_lr, warmup),
                      _linear(base_lr, 0.0, max(1, total_steps - warmup))], [warmup])
    return _join([_linear(0.0, base_lr, warmup), lambda count: base_lr], [warmup])


def group_learning_rates(cfg: OptimizerConfig) -> dict[str, float]:
    # `or`, as the JAX package has it: an explicit 0.0 projector or action-head
    # lr falls back to learning_rate
    return {
        "base": cfg.learning_rate,
        "mm_projector": cfg.mm_projector_lr or cfg.learning_rate,
        "mm_vision": cfg.mm_vision_lr if cfg.mm_vision_lr is not None else cfg.learning_rate,
        "action_head": cfg.action_head_lr or cfg.learning_rate,
    }


def stopgrad_subtrees(named_params, names: tuple) -> None:
    """Parameters whose name contains one of ``names`` take no gradient.

    The JAX package stop-gradients a frozen vision tower so that its backward
    graph, not only its update, disappears; here such parameters stop
    requiring grad."""
    for name, p in named_params:
        if any(k in names for k in _keys(name)):
            p.requires_grad_(False)


def _counted_here(t: torch.Tensor, coords: dict) -> bool:
    """Whether this rank's copy of ``t`` enters the mesh-wide sum of
    squares, so that each element counts once: a copy that is replicated
    along a mesh axis (a plain tensor along every axis; a DTensor along the
    axes it is not sharded on) counts on that axis's rank 0.  ``coords`` is
    this rank's {axis: coordinate} on the whole mesh."""
    sub = getattr(t, "device_mesh", None)
    sharded = set() if sub is None else {
        axis for axis, pl in zip(sub.mesh_dim_names, t.placements) if not pl.is_replicate()}
    return all(c == 0 for axis, c in coords.items() if axis not in sharded)


def global_norm(grads, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32 (0-d tensor).

    Over a ``mesh`` the sum runs over every rank's local shards, each
    element once, and one all-reduce adds them: the norm of the whole tree,
    taken once."""
    grads = list(grads)
    if mesh is None:
        sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square() for g in grads]
        return torch.stack(sq).sum().sqrt()
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sq = [torch.linalg.vector_norm(local(g), dtype=torch.float32).square() for g in grads
          if _counted_here(g, coords)]
    device = local(grads[0]).device if grads else torch.device("cpu")
    total = torch.stack(sq).sum() if sq else torch.zeros((), dtype=torch.float32, device=device)
    dist.all_reduce(total)
    return total.sqrt()


@torch.no_grad()
def adamw_update_(p: torch.Tensor, g: Optional[torch.Tensor], mu: torch.Tensor,
                  nu: torch.Tensor, count: int, lr: float, cfg: OptimizerConfig) -> None:
    """One optax ``adamw`` update of ``p`` (moments updated in place).

    ``g`` is the fp32 (clipped) gradient, or None for a parameter the loss
    did not reach (a zero gradient); ``count`` is the update count after
    this update."""
    b1, b2 = cfg.adam_beta1, cfg.adam_beta2
    mu.mul_(b1)
    nu.mul_(b2)
    if g is not None:
        mu.add_((1 - b1) * g)
        nu.add_((1 - b2) * (g * g))
    u = (mu / (1 - b1 ** count)) / (torch.sqrt(nu / (1 - b2 ** count)) + cfg.adam_eps)
    if cfg.weight_decay:
        u = u + cfg.weight_decay * p  # the decay term in the parameter's dtype, as optax
    p.copy_((p.float() - lr * u).to(p.dtype))


class Optimizer:
    """clip_by_global_norm, then per-group AdamW, over named parameters.

    Parameters of a frozen group (a ``freeze_*`` flag or a group lr of 0)
    keep no moments and are never written."""

    def __init__(self, cfg: OptimizerConfig, named_params, total_steps: int, mesh=None):
        self.cfg = cfg
        self.mesh = mesh  # the clip norm's mesh when the parameters are sharded
        named_params = list(named_params)
        lrs = group_learning_rates(cfg)
        self.schedules = {g: make_schedule(cfg, lr, total_steps) for g, lr in lrs.items()
                          if lr != 0.0}
        self.labels = {}
        for name, _ in named_params:
            label = "frozen" if is_frozen(name, cfg) else group_of(name)
            self.labels[name] = label if label in self.schedules else "frozen"
        params = dict(named_params)
        self.count = 0  # updates applied so far
        self.mu = {n: torch.zeros_like(local(params[n]), dtype=torch.float32)
                   for n, label in self.labels.items() if label != "frozen"}
        self.nu = {n: torch.zeros_like(m) for n, m in self.mu.items()}

    def lr(self, group: str) -> float:
        return self.schedules[group](self.count)

    @torch.no_grad()
    def step_(self, params: dict, grads: dict) -> torch.Tensor:
        """Apply one update to ``params`` from fp32-castable ``grads`` (name ->
        gradient, None where the loss did not reach); returns the global norm
        of all the gradients given, taken before clipping."""
        norm = global_norm([g for g in grads.values() if g is not None], self.mesh)
        clip = self.cfg.max_grad_norm and self.cfg.max_grad_norm > 0
        lrs = {g: self.lr(g) for g in self.schedules}
        self.count += 1
        for name, mu in self.mu.items():
            g = grads.get(name)
            if g is not None:
                g = local(g).float()
                if clip:
                    g = torch.where(norm < self.cfg.max_grad_norm, g,
                                    g / norm * self.cfg.max_grad_norm)
            adamw_update_(local(params[name]), g, mu, self.nu[name], self.count,
                          lrs[self.labels[name]], self.cfg)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict, part=None) -> bool:
        """Restore moments saved by :meth:`state_dict`; False (and fresh
        moments kept) when the trainable set has changed since.  ``part(name,
        whole)`` cuts a whole saved moment to this rank's shard."""
        if set(state["mu"]) != set(self.mu):
            return False
        part = part or (lambda name, t: t)
        for name in self.mu:
            self.mu[name].copy_(part(name, state["mu"][name]))
            self.nu[name].copy_(part(name, state["nu"][name]))
        self.count = int(state["count"])
        return True
