"""Mixture-of-Experts FFN with capacity-based dispatch (port of dexbotic_tpu/nn/moe.py).

A GShard/Switch MoE layer: top-k routing in fp32 with the k weights
renormalised, a static capacity of C slots an expert, every token's best
expert placed before any token's second (the k-major order of the JAX
cumsum), an assignment past its expert's capacity dropped (its weight 0;
the token keeps its other experts' outputs), invalid tokens taking no slot
and staying out of the load-balance statistics, and the Switch
load-balance loss (eq. 4), summed over layers by
``mot_forward(want_aux=True)``.

The JAX layer builds one-hot dispatch and combine tensors ([N, E, C]) and
contracts them; here the same slots are indices: each kept assignment's
token row is copied into the [E, C, H] buffer at its slot, the experts run
as three batched products (``torch.bmm``: the JAX package computes them as
einsums outside any Pallas kernel), and each token sums its k slots'
outputs times its weights.  Expert weights are stacked [E, in, out]
(:class:`ExpertStack`), the JAX layout, so ``utils/bridge.py`` carries the
[L, E, in, out] stacks and the router across with its generic rules.

Over data ranks (inside ``parallel/mesh.data_parallel``, as a Trainer step
runs) the capacity, the slot order and the load-balance statistics are the
global batch's, as JAX computes them over the global batch: one all-gather
of each rank's slot counts places its tokens after the earlier ranks'.
Under expert parallelism (``parallel/mesh.place_experts``: each stack a
DTensor sharded on its expert axis over 'expert') a rank holds E / expert
experts and the tokens of its data rank, as every rank of its expert group
does: it runs its experts on their slots of the dispatched buffer, and the
combine gathers every expert's outputs from their owners (an all-gather over
'expert'); in the backward the buffer's gradient is gathered the same way,
so every rank of the group holds the whole gradient of its tokens.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dexbotic_tpu_torch.nn import core
from dexbotic_tpu_torch.parallel.mesh import data_parallel_state


class ExpertStack(nn.Module):
    """One weight of the experts, stacked: ``weight`` [E, in, out]."""

    def __init__(self, num_experts: int, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_experts, d_in, d_out))


class MoE(nn.Module):
    """Router (``router.weight`` [E, H], applied in fp32) and the gated-MLP
    experts ``gate``/``up`` [E, H, I] and ``down`` [E, I, H]."""

    def __init__(self, hidden: int, intermediate: int, num_experts: int):
        super().__init__()
        self.num_experts = num_experts
        self.router = core.Linear(hidden, num_experts, False)
        self.gate = ExpertStack(num_experts, hidden, intermediate)
        self.up = ExpertStack(num_experts, hidden, intermediate)
        self.down = ExpertStack(num_experts, intermediate, hidden)

    def forward(self, x, act: str = "silu", top_k: int = 2, capacity_factor: float = 2.0,
                valid: Optional[torch.Tensor] = None, stats: Optional[dict] = None):
        return moe_mlp(self, x, top_k=top_k, act=act, capacity_factor=capacity_factor,
                       valid=valid, stats=stats)


@torch.no_grad()
def moe_init_(moe: MoE, gen: torch.Generator) -> None:
    """The JAX init's distributions: the router N(0, 0.02), each expert's
    weights U(-1/sqrt(in), 1/sqrt(in))."""
    core.normal_init_(moe.router.weight, gen)
    for stack in (moe.gate, moe.up, moe.down):
        lim = 1.0 / math.sqrt(stack.weight.shape[1])
        stack.weight.uniform_(-lim, lim, generator=gen)


def expert_capacity(num_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Static per-expert slot count."""
    return max(top_k, int(math.ceil(capacity_factor * top_k * num_tokens / num_experts)))


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, the lower index first
    among equal values (``jax.lax.top_k``'s order; ``torch.topk`` does not
    promise one)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


class _OwnExperts(torch.autograd.Function):
    """Forward: this rank's experts' rows [E_l, C, H] of the whole buffer
    [E, C, H] (every rank of the expert group holds the same buffer).
    Backward: the buffer's whole gradient, every owner's part gathered."""

    @staticmethod
    def forward(ctx, buf, group, rank: int, per: int):
        ctx.group = group
        return buf[rank * per: (rank + 1) * per].contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g) for _ in range(dist.get_world_size(ctx.group))]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts), None, None, None


class _GatherExperts(torch.autograd.Function):
    """Forward: every expert's outputs [E, C, H] gathered from their owners.
    Backward: this rank's experts' rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, ys, group, rank: int):
        ctx.rank, ctx.per = rank, ys.shape[0]
        parts = [torch.empty_like(ys) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, ys.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.per: (ctx.rank + 1) * ctx.per].contiguous(), None, None


def _experts(p: MoE, xs: torch.Tensor, act: str) -> torch.Tensor:
    """The gated-MLP experts on their slots: xs [E, C, H] -> [E, C, H]; under
    expert parallelism each rank runs its own experts (see the module's
    docstring)."""
    wg, wu, wd = (core.local(s.weight) for s in (p.gate, p.up, p.down))
    mesh = getattr(p.gate.weight, "device_mesh", None)
    if mesh is not None and wg.shape[0] != p.num_experts:
        group, rank = mesh.get_group(), mesh.get_local_rank()
        xs = _OwnExperts.apply(xs, group, rank, wg.shape[0])
    dt = xs.dtype
    h = core.ACTIVATIONS[act](torch.bmm(xs, wg.to(dt))) * torch.bmm(xs, wu.to(dt))
    ys = torch.bmm(h, wd.to(dt))
    if mesh is not None and wg.shape[0] != p.num_experts:
        ys = _GatherExperts.apply(ys, group, rank)
    return ys


def _slot_counts(counts: torch.Tensor, n_tokens: int, dp) -> tuple:
    """(assignments of earlier data ranks [k, E], of all ranks [k, E], the
    global token count): this rank's alone outside data parallelism."""
    if dp is None or dp[1] == 1:
        return torch.zeros_like(counts), counts, n_tokens
    group, size = dp
    mine = torch.cat([counts.reshape(-1), counts.new_tensor([n_tokens])])
    every = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(every, mine, group=group)
    every = torch.stack(every)
    rank = dist.get_rank(group)
    per_rank = every[:, :-1].reshape((size,) + tuple(counts.shape))
    return per_rank[:rank].sum(0), per_rank.sum(0), int(every[:, -1].sum())


def moe_mlp(p: MoE, x: torch.Tensor, *, top_k: int = 2, act: str = "silu",
            capacity_factor: float = 2.0, valid: Optional[torch.Tensor] = None,
            stats: Optional[dict] = None):
    """(y [B, T, H] in x's dtype, aux load-balance loss, an fp32 scalar).

    ``valid`` (bool/int [B, T]) masks padding: an invalid token takes no
    slot, enters no statistic and comes out 0.  ``stats``, when given, gets
    the capacity and the share of this rank's valid assignments dropped
    (read on the host)."""
    B, T, H = x.shape
    E = p.num_experts
    N = B * T
    xf = x.reshape(N, H)
    vf = None if valid is None else valid.reshape(N).to(torch.float32)
    dp = data_parallel_state()

    logits = F.linear(xf.float(), p.router.weight.float())  # [N, E]
    probs = torch.softmax(logits, dim=-1)
    w_topk, idx = _top_k(probs, top_k)  # [N, k]
    w_topk = w_topk / w_topk.sum(-1, keepdim=True)
    if vf is not None:
        w_topk = w_topk * vf[:, None]

    # each assignment's slot in its expert's buffer, k-major: every token's
    # best expert before any token's second, earlier data ranks first
    ohk = F.one_hot(idx.t(), E).to(torch.int32)  # [k, N, E]
    if vf is not None:
        ohk = ohk * vf.to(torch.int32)[None, :, None]
    counts = ohk.sum(1)  # [k, E]
    before, total, n_global = _slot_counts(counts, N, dp)
    C = expert_capacity(n_global, E, top_k, capacity_factor)
    base = torch.cumsum(total, 0) - total + before  # [k, E]: slots taken ahead of this rank's
    pos = ((torch.cumsum(ohk, 1) - ohk + base[:, None, :]) * ohk).sum(-1)  # [k, N]
    keep = (pos < C) & (ohk.sum(-1) > 0)
    slot = torch.where(keep, idx.t() * C + pos, E * C).reshape(-1)  # row E * C: dropped

    buf = xf.new_zeros(E * C + 1, H).index_copy(0, slot, xf.repeat(top_k, 1))
    ys = _experts(p, buf[: E * C].view(E, C, H), act)
    ys = torch.cat([ys.reshape(E * C, H), ys.new_zeros(1, H)])
    wt = (w_topk.t() * keep).to(ys.dtype)  # [k, N]
    y = (ys[slot].view(top_k, N, H) * wt[..., None]).sum(0)

    # Switch load balance: E * sum_e f_e * P_e over the valid tokens of the
    # global batch; each data rank's gradient is its tokens' share (times the
    # ranks: the Trainer averages gradients over them), its value the whole
    v = torch.ones(N, device=x.device) if vf is None else vf
    top1 = F.one_hot(idx[:, 0], E).to(torch.float32) * v[:, None]
    f_sum, p_sum, count = top1.sum(0), (probs * v[:, None]).sum(0), v.sum()
    scale = 1.0
    if dp is not None and dp[1] > 1:
        group, scale = dp
        every = torch.cat([f_sum, p_sum.detach(), count[None]])
        dist.all_reduce(every, group=group)
        f_sum, p_all, count = every[:E], every[E: 2 * E], every[-1]
    denom = count.clamp_min(1.0) if vf is not None else count
    f = f_sum / denom
    aux = E * (f * p_sum).sum() / denom * scale
    if scale != 1.0:
        aux = aux + (E * (f * p_all).sum() / denom - aux).detach()
    if stats is not None:
        stats["capacity"] = C
        stats["dropped_share"] = 1.0 - float(keep.sum()) / max(float(ohk.sum()), 1.0)
    return y.view(B, T, H).to(x.dtype), aux
