"""Ring attention: exact attention over a sequence sharded on a 'seq' axis
(port of dexbotic_tpu/parallel/ring.py).

Context parallelism splits a row's tokens over the ranks of the 'seq' axis
of a mesh: every per-token operation runs on the rank's own columns, and
attention, the one operation that mixes positions, becomes a ring.  Each
rank keeps its query block and passes its key/value block, with the block's
mask ints ``(kv_grp, kv_valid, kv_seg)``, to rank ``(r + 1) % n``; after n
hops every query has seen every key.  The group ints are global values, so
causal, prefix and packed-segment masks need no index bookkeeping, and the
kernels' tile classes skip a hop's dead tiles by themselves.

* Forward: each hop is kernel K1 (``ops/attention.flash_attention_fwd``) on
  the resident queries against the visiting block, returning the hop's
  partial output and log-sum-exp; the partials merge by their lse in fp32
  (:func:`merge`).  A row that sees no key of a hop has an lse of about
  MASKED_BIAS there (K1 writes ``m + log(max(l, 1e-30))`` with m still at
  MASKED_BIAS, as its plain version), so the merge gives that hop zero
  weight, and a row that sees no key at all comes out 0.
* Backward: the ring runs again with kernel K3 (``flash_attention_bwd``) on
  each hop, fed the global output, lse and dO; dq accumulates on the rank,
  and each block's dk and dv accumulate (fp32) on the block as it travels,
  ending at its owner after the n-th pass.
* A group of one runs one hop and sends nothing; CPU tensors take K1's and
  K3's plain versions, which those wrappers pick for them.

The per-rank schedule is a generator that yields each transfer it needs
(:func:`forward_hops`, :func:`backward_hops`); :class:`P2PRing` carries the
transfers between processes (``dist.batch_isend_irecv``: each send posted
with its receive, so gloo and NCCL pass them in order without a deadlock),
and :func:`run_lockstep` runs n ranks' schedules in one process, hop by hop
(the kernels' check on one card, where NCCL refuses two ranks).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from dexbotic_tpu_torch.constants import MASKED_BIAS
from dexbotic_tpu_torch.ops.attention import _i32, flash_attention_bwd, flash_attention_fwd

__all__ = ["ring_attention", "RingAttention", "P2PRing", "forward_hops", "backward_hops",
           "merge", "run_lockstep", "simulate"]


def merge(acc_out: Optional[torch.Tensor], acc_lse: Optional[torch.Tensor], out: torch.Tensor,
          lse: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one hop's (out [B, Sq, Hq, D], lse [B, Hq, Sq]) into the running
    fp32 pair: the lse is the log-sum-exp of the two, and the output the
    lse-weighted sum.  An lse at MASKED_BIAS weighs 0 against a live one;
    two such give a finite mean of zeros, never NaN."""
    lse = lse.float().clamp_min(MASKED_BIAS)
    if acc_out is None:
        return out.float(), lse
    new = torch.logaddexp(acc_lse, lse)
    w_acc = torch.exp(acc_lse - new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse - new).transpose(1, 2)[..., None]
    return acc_out * w_acc + out.float() * w_new, new


def forward_hops(q, block, q_grp, q_seg, scale, n: int):
    """One rank's forward ring (a generator): n hops of K1 over the visiting
    ``block`` = (k, v, kv_grp, kv_valid, kv_seg), merged.  Before each hop
    but the last it yields the block it holds and takes a handle whose
    ``wait()`` gives the next one; returns (out fp32, lse)."""
    acc_out = acc_lse = None
    for hop in range(n):
        pending = (yield block) if hop < n - 1 else None
        k, v, g, val, seg = block
        out, lse = flash_attention_fwd(q, k, v, q_grp, g, val, scale, q_seg, seg)
        acc_out, acc_lse = merge(acc_out, acc_lse, out, lse)
        ring_attention.hops += 1
        if pending is not None:
            block = pending.wait()
    return acc_out, acc_lse


def backward_hops(q, block, q_grp, q_seg, out, lse, dout, scale, n: int):
    """One rank's backward ring (a generator): n hops of K3 from the global
    (out, lse, dO).  At each hop but the last it yields the block it holds
    (the next one's transfer overlaps K3); after each hop, with n > 1, it
    yields the visiting block's fp32 (dk, dv) accumulators, which move on
    with their block and end at its owner.  Returns (dq, dk, dv) in fp32."""
    k, v = block[:2]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for hop in range(n):
        pending = (yield block) if hop < n - 1 else None
        k, v, g, val, seg = block
        dq_h, dk_h, dv_h = flash_attention_bwd(q, k, v, q_grp, g, val, out, lse, dout, scale,
                                               q_seg, seg)
        dq += dq_h.float()
        dk += dk_h.float()
        dv += dv_h.float()
        if n > 1:
            dk, dv = (yield (dk, dv)).wait()
        if pending is not None:
            block = pending.wait()
    return dq, dk, dv


class _Handle:
    def __init__(self, reqs, bufs, keep):
        self.reqs, self.bufs, self.keep = reqs, bufs, keep

    def wait(self):
        for r in self.reqs:
            r.wait()
        self.keep = None
        return tuple(self.bufs)


class P2PRing:
    """The transfers of a ring over ``group``: each tensor to rank
    ``(r + 1) % n`` of the group, each buffer from ``(r - 1) % n``, posted
    together (``batch_isend_irecv``).  Every rank posts its sends and
    receives in the same order, which is how gloo (in order between a pair)
    and NCCL (one group call) match them.  None entries (absent segments)
    stay None."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        r = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (r + 1) % self.n)
        self.prev = dist.get_global_rank(group, (r - 1) % self.n)

    def exchange(self, tensors) -> _Handle:
        sent = [None if t is None else t.contiguous() for t in tensors]
        bufs = [None if t is None else torch.empty_like(t) for t in sent]
        ops = [dist.P2POp(dist.isend, t, self.next, self.group) for t in sent if t is not None]
        ops += [dist.P2POp(dist.irecv, b, self.prev, self.group) for b in bufs if b is not None]
        return _Handle(dist.batch_isend_irecv(ops), bufs, sent)


def _drive(gen, ring: Optional[P2PRing]):
    """Run one rank's schedule, ``ring`` carrying what it yields."""
    try:
        msg = next(gen)
        while True:
            msg = gen.send(ring.exchange(msg))
    except StopIteration as stop:
        return stop.value


class _LocalHandle:
    def __init__(self, sent: list, rank: int):
        self.sent, self.rank = sent, rank

    def wait(self):
        return self.sent[(self.rank - 1) % len(self.sent)]


def run_lockstep(gens: list) -> list:
    """Run n ranks' schedules in one process, transfer by transfer: every
    rank yields, then each takes what rank ``(r - 1) % n`` yielded.
    Returns each schedule's result, in rank order."""
    results, done = [None] * len(gens), [False] * len(gens)

    def step(r, arg):
        try:
            return gens[r].send(arg)
        except StopIteration as stop:
            results[r], done[r] = stop.value, True
            return None

    sent = [step(r, None) for r in range(len(gens))]
    while not all(done):
        sent = [step(r, _LocalHandle(sent, r)) for r in range(len(gens))]
    return results


def simulate(q, k, v, q_grp, kv_grp, kv_valid, q_seg=None, kv_seg=None, n: int = 2,
             dout=None, scale=None) -> dict:
    """The ring of ``n`` ranks over whole-sequence inputs, in one process:
    the sequence cut into n contiguous blocks, each rank's schedule run by
    :func:`run_lockstep`.  Returns {"out", "lse"} (and {"dq", "dk", "dv"},
    fp32, with ``dout``), concatenated over the ranks."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    ints = [_i32(t) for t in (q_grp, kv_grp, kv_valid, q_seg, kv_seg)]

    def cols(t, r):
        return None if t is None else t[:, r * t.shape[1] // n: (r + 1) * t.shape[1] // n]

    blocks = [(cols(k, r), cols(v, r), cols(ints[1], r), cols(ints[2], r), cols(ints[4], r))
              for r in range(n)]
    fwd = run_lockstep([forward_hops(cols(q, r), blocks[r], cols(ints[0], r), cols(ints[3], r),
                                     scale, n) for r in range(n)])
    out = torch.cat([o for o, _ in fwd], 1).to(q.dtype)
    lse = torch.cat([lse for _, lse in fwd], 2)
    res = {"out": out, "lse": lse}
    if dout is not None:
        bwd = run_lockstep([backward_hops(cols(q, r), blocks[r], cols(ints[0], r),
                                          cols(ints[3], r), cols(out, r), lse[..., r * lse.shape[-1]
                                          // n: (r + 1) * lse.shape[-1] // n], cols(dout, r),
                                          scale, n) for r in range(n)])
        for i, key in enumerate(("dq", "dk", "dv")):
            res[key] = torch.cat([g[i] for g in bwd], 1)
    return res


class RingAttention(torch.autograd.Function):
    """Differentiable ring attention over the process group ``group`` (None:
    a group of one).  The mask ints take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_grp, kv_grp, kv_valid, q_seg, kv_seg, scale, group):
        ring = P2PRing(group) if group is not None and dist.get_world_size(group) > 1 else None
        n = 1 if ring is None else ring.n
        block = (k, v, kv_grp, kv_valid, kv_seg)
        out, lse = _drive(forward_hops(q, block, q_grp, q_seg, scale, n), ring)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, q_grp, kv_grp, kv_valid, q_seg, kv_seg, out, lse)
        ctx.scale, ctx.ring, ctx.n = scale, ring, n
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_grp, kv_grp, kv_valid, q_seg, kv_seg, out, lse = ctx.saved_tensors
        block = (k, v, kv_grp, kv_valid, kv_seg)
        dq, dk, dv = _drive(backward_hops(q, block, q_grp, q_seg, out, lse, dout, ctx.scale,
                                          ctx.n), ctx.ring)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 7


def ring_attention(q, k, v, q_grp, kv_grp, kv_valid, group=None, scale=None, q_seg=None,
                   kv_seg=None):
    """Exact attention over a sequence sharded on ``group`` (the 'seq' axis's
    process group; None or a group of one: one hop, no transfer).

    q [B, Sl, Hq, D], k/v [B, Sl, Hkv, D] and the int [B, Sl] mask vectors
    are this rank's contiguous columns; group ints are global values.
    Returns the local output in q's dtype.  On CUDA tensors every hop
    launches K1 (forward) and K3 (backward), in bf16: an fp32 call is rounded
    to bf16 at the kernels' inputs, as ``attention(impl="flash")`` does."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both q_seg and kv_seg or neither")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    ints = [_i32(t) for t in (q_grp, kv_grp, kv_valid, q_seg, kv_seg)]
    if q.device.type == "cuda" and q.dtype == torch.float32:
        return RingAttention.apply(q.bfloat16(), k.bfloat16(), v.bfloat16(), *ints, scale,
                                   group).float()
    return RingAttention.apply(q, k, v, *ints, scale, group)


ring_attention.hops = 0  # K1 hops run by the ring's forward in this process
