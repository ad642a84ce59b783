"""Attention with group-int masking (port of dexbotic_tpu/ops/attention.py).

Callers pass per-token attention-group integers instead of dense masks:
query i may attend key j iff ``kv_grp[j] <= q_grp[i]``, key j is valid, and
(when given) ``q_seg[i] == kv_seg[j]``.  Layout: q [B, Sq, Hq, D],
k/v [B, Skv, Hkv, D] with Hq % Hkv == 0 (GQA); int32 [B, S] mask vectors.

* :func:`attention_xla` is the plain version of the JAX ``attention_xla``
  (a fully masked row averages V uniformly, as there).
* :func:`flash_attention` is :class:`FlashAttention`, the counterpart of the
  JAX ``custom_vjp``: its forward is kernel K1 (``csrc/flash_fwd.cu``, wrapper
  :func:`flash_attention_fwd`), which saves the log-sum-exp, and its backward
  is kernel K3 (``csrc/flash_bwd.cu``, wrapper :func:`flash_attention_bwd`).
  On CPU tensors each runs its plain version (:func:`flash_attention_ref`,
  where a fully masked row gives 0, and :func:`flash_attention_bwd_ref`); on
  CUDA tensors each launches its kernel or raises.
* :func:`flash_tile_classes` is the per-call pre-pass both kernels share:
  every (64-row q tile, 64-row kv tile) pair classed dead, partial or wholly
  visible (plain version :func:`flash_tile_classes_ref`).
* :func:`attention` dispatches: ``impl="auto"`` sends CUDA tensors whose
  head_dim K1 serves (:data:`FLASH_HEAD_DIMS`, :func:`flash_serves`) to the
  kernels, and every other call to ``attention_xla``, as the JAX ``auto``
  sends unaligned head dims to XLA; such a plain call on CUDA tensors counts
  on ``attention.plain_cuda_calls`` (an explicit ``impl="xla"`` does not);
  ``impl="ring:<axis>"`` is context parallelism, the ring of K1 and K3 hops
  over that axis of the current mesh (``parallel/ring.py``).
"""

from __future__ import annotations

import functools

import torch

from dexbotic_tpu_torch.constants import MASKED_BIAS


def _allowed(q_grp, kv_grp, kv_valid, q_seg, kv_seg) -> torch.Tensor:
    """[B, 1, Sq, Skv] bool visibility from the int vectors."""
    allowed = (kv_grp[:, None, :] <= q_grp[:, :, None]) & (kv_valid[:, None, :] != 0)
    if q_seg is not None:
        allowed = allowed & (kv_seg[:, None, :] == q_seg[:, :, None])
    return allowed[:, None]


def _gqa_expand(k: torch.Tensor, group: int) -> torch.Tensor:
    return k if group == 1 else k.repeat_interleave(group, dim=2)


def attention_xla(q, k, v, q_grp, kv_grp, kv_valid, scale=None, q_seg=None, kv_seg=None):
    """Plain grouped-query attention; fp32 softmax; returns q.dtype."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    scale = D ** -0.5 if scale is None else scale
    qf = q.float() * scale
    kf = _gqa_expand(k.float(), Hq // Hkv)
    vf = _gqa_expand(v.float(), Hq // Hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    scores = scores.masked_fill(~_allowed(q_grp, kv_grp, kv_valid, q_seg, kv_seg), MASKED_BIAS)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def flash_attention_ref(q, k, v, q_grp, kv_grp, kv_valid, scale=None, q_seg=None, kv_seg=None):
    """Plain version of kernel K1: (out [B, Sq, Hq, D] in q.dtype, lse [B, Hq, Sq] fp32).

    q is pre-scaled in its own dtype, as ``_flash_impl`` does; rows with no
    visible key give 0 (``_flash_kernel_single``'s rule)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    scale = D ** -0.5 if scale is None else scale
    qf = (q.float() * scale).to(q.dtype).float()
    kf = _gqa_expand(k.float(), Hq // Hkv)
    vf = _gqa_expand(v.float(), Hq // Hkv)
    allowed = _allowed(q_grp, kv_grp, kv_valid, q_seg, kv_seg)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf).masked_fill(~allowed, MASKED_BIAS)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(allowed, torch.exp(scores - m), 0.0)
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / denom.permute(0, 2, 1, 3)
    lse = (m + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


TILE = 64  # rows of a class-map tile
FLASH_HEAD_DIMS = (64, 128, 256)  # K1's instances (csrc/flash_fwd.cu)
FLASH_BWD_HEAD_DIMS = (64, 128, 256)  # K3's (csrc/flash_bwd.cu)
DEAD, PARTIAL, VISIBLE = 0, 1, 2


def flash_tile_classes_ref(q_grp, kv_grp, kv_valid, q_seg=None, kv_seg=None) -> torch.Tensor:
    """Plain version of the class pre-pass: uint8 [B, ceil(Sq/64), ceil(Skv/64)].

    A (q tile, kv tile) pair is DEAD when no query row sees a key of the
    tile, VISIBLE when every query row sees every key (rows past Sq do not
    count; keys past Skv are masked), PARTIAL otherwise."""
    B, Sq = q_grp.shape
    Skv = kv_grp.shape[1]
    nq, nk = -(-Sq // TILE), -(-Skv // TILE)
    allowed = _allowed(q_grp, kv_grp, kv_valid, q_seg, kv_seg)[:, 0]
    grid = torch.zeros(B, nq * TILE, nk * TILE, dtype=torch.bool, device=allowed.device)
    grid[:, :Sq, :Skv] = allowed
    counts = torch.ones_like(grid)  # query rows past Sq see everything: they do not count
    counts[:, :Sq, Skv:] = False
    counts[:, :Sq, :Skv] = allowed
    tiles = grid.reshape(B, nq, TILE, nk, TILE)
    any_ = tiles.any(4).any(2)
    all_ = counts.reshape(B, nq, TILE, nk, TILE).all(4).all(2)
    return torch.where(any_, torch.where(all_, VISIBLE, PARTIAL), DEAD).to(torch.uint8)


def _i32(x: torch.Tensor | None) -> torch.Tensor | None:
    if x is None or (x.dtype == torch.int32 and x.is_contiguous()):
        return x
    return x.to(torch.int32).contiguous()


def _mask_args(q, B, Sq, Skv, q_grp, kv_grp, kv_valid, q_seg, kv_seg) -> tuple[list, list]:
    """(the int32 mask vectors' pointers, None for absent segments; the
    vectors), checked.  A vector that was not int32 and contiguous (a column
    slice: the ring's blocks) is a new tensor: the caller holds the vectors
    until its launch is queued, or their memory could be reused before it."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both q_seg and kv_seg or neither")
    ints = [_i32(t) for t in (q_grp, kv_grp, kv_valid, q_seg, kv_seg)]
    for t, n in zip(ints, (Sq, Skv, Skv, Sq, Skv)):
        if t is not None and (t.shape != (B, n) or t.device != q.device):
            raise ValueError(f"mask vector of shape {tuple(t.shape)} on {t.device}, want ({B}, {n})")
    return [None if t is None else t.data_ptr() for t in ints], ints


def _classes_buffer(B, Sq, Skv, device) -> torch.Tensor:
    return torch.empty(B * -(-Sq // TILE) * -(-Skv // TILE), dtype=torch.uint8, device=device)


def flash_tile_classes(q_grp, kv_grp, kv_valid, q_seg=None, kv_seg=None) -> torch.Tensor:
    """The class pre-pass of K1 and K3 alone; CPU tensors take the plain version."""
    if q_grp.device.type == "cpu":
        return flash_tile_classes_ref(q_grp, kv_grp, kv_valid, q_seg, kv_seg)
    from dexbotic_tpu_torch.kernels import build

    (B, Sq), Skv = q_grp.shape, kv_grp.shape[1]
    ptr, ints = _mask_args(q_grp, B, Sq, Skv, q_grp, kv_grp, kv_valid, q_seg, kv_seg)
    cls = _classes_buffer(B, Sq, Skv, q_grp.device)
    code = build.load().dbx_flash_tile_classes(
        *ptr, cls.data_ptr(), B, Sq, Skv, torch.cuda.current_stream(q_grp.device).cuda_stream)
    build.check(code, "dbx_flash_tile_classes")
    return cls.view(B, -(-Sq // TILE), -(-Skv // TILE))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fwd_rows(B: int, Sq: int, Hq: int, sms: int, D: int = 128) -> int:
    """Query rows a K1 block takes on a card of ``sms`` SMs.

    At head_dim <= 128: 128 (two warpgroups, one block an SM) when that
    makes at least eight waves of blocks, else 64 (one warpgroup, two blocks
    an SM, twice the blocks); on the H100, 64-row blocks were faster at
    224-896 blocks of 128 rows, even at 1024 and slower from 1792.  At 256
    both shapes run one block an SM: 128 rows once 64-row blocks would need
    more than one wave (on the H100, 64 rows were faster at 104 blocks of 64
    and slower at 208; PERF.md)."""
    if D == 256:
        return 128 if -(-Sq // 64) * Hq * B > sms else 64
    return 128 if -(-Sq // 128) * Hq * B >= 8 * sms else 64


def _flash_cuda(q, k, v, q_grp, kv_grp, kv_valid, scale, q_seg, kv_seg, rows=None):
    """K1's launch; ``rows`` overrides :func:`fwd_rows` (tests, measurements)."""
    from dexbotic_tpu_torch.kernels import build

    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"flash kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash kernel serves head_dim {FLASH_HEAD_DIMS}, got {D}")
    if not (0 < Skv <= 16384 and Sq > 0):  # the kernel lists at most 256 kv tiles of 64
        raise ValueError(f"flash kernel serves 0 < Skv <= 16384 and Sq > 0, got Sq={Sq} Skv={Skv}")
    if Hq % Hkv or k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"bad GQA shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash kernel needs 16-byte aligned q/k/v")
    ptr, ints = _mask_args(q, B, Sq, Skv, q_grp, kv_grp, kv_valid, q_seg, kv_seg)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    cls = _classes_buffer(B, Sq, Skv, q.device)
    rows = rows or fwd_rows(B, Sq, Hq, _sm_count(q.device.index), D)
    code = build.load().dbx_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptr, out.data_ptr(), lse.data_ptr(),
        cls.data_ptr(), B, Sq, Skv, Hq, Hkv, D, float(scale), rows,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "dbx_flash_fwd")
    flash_attention.launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, q_grp, kv_grp, kv_valid, scale=None, q_seg=None, kv_seg=None):
    """K1 forward: (out, lse).  CPU tensors take the plain version."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, q_grp, kv_grp, kv_valid, scale, q_seg, kv_seg)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_grp, kv_grp, kv_valid, scale, q_seg, kv_seg)
    raise RuntimeError(f"flash attention has no kernel for device {q.device}")


def flash_bwd_preprocess_ref(q, out, g, scale):
    """Plain version of K3's preprocess launch: (q~, delta).

    q~ = q pre-scaled and rounded to its dtype, the q K1 multiplied;
    delta = rowsum(dO * O) in fp32, [B, Hq, Sq], with dO rounded to q's
    dtype first, as ``_flash_bwd_impl`` computes them."""
    qs = (q.float() * scale).to(q.dtype)
    delta = (g.to(q.dtype).float() * out.float()).sum(-1).transpose(1, 2)
    return qs, delta


def flash_attention_bwd_ref(q, k, v, q_grp, kv_grp, kv_valid, out, lse, g, scale=None,
                            q_seg=None, kv_seg=None):
    """Plain version of kernel K3: (dq, dk, dv) in the inputs' dtypes.

    The FA2 backward from the saved LSE, as ``_flash_bwd_impl`` computes it:
    q pre-scaled and rounded to its dtype, delta = rowsum(dO * O) with O in
    fp32, P = exp(S - lse) where allowed (so rows that see no key get no
    gradient), dq rescaled by ``scale``, dK/dV per query head then summed per
    GQA group."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    group = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    qs, delta = flash_bwd_preprocess_ref(q, out, g, scale)
    qs, delta = qs.float(), delta[..., None]  # delta [B, Hq, Sq, 1]
    kf = _gqa_expand(k.float(), group)
    vf = _gqa_expand(v.float(), group)
    do = g.to(q.dtype).float()
    allowed = _allowed(q_grp, kv_grp, kv_valid, q_seg, kv_seg)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    p = torch.where(allowed, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vf) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dk = dk.reshape(B, Skv, Hkv, group, D).sum(3)
    dv = dv.reshape(B, Skv, Hkv, group, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


BWD_MAX_SPLITS = 16  # csrc/flash_bwd.cu's bound on splits
BWD_BLOCK_ITEMS = 2  # a dK/dV block's fixed cost, in items: K/V in, the ring filled, partials out


def bwd_splits(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, sms: int) -> int:
    """Blocks that share one 64-row kv tile's work list in K3's head_dim-256
    dK/dV launch (``dkv256_kernel``) on a card of ``sms`` SMs.

    A work list holds ceil(Sq/64) x Hq/Hkv items (a 64-row q tile of one
    query head of the group); the launch has ceil(Skv/64) x Hkv x B lists
    and runs one block an SM.  With G blocks a list, a block walks
    ceil(items / G) items and the launch takes ceil(G x lists / sms) waves;
    the rule takes the G <= 16 with the fewest waves x (ceil(items / G) +
    BWD_BLOCK_ITEMS), the smallest on a tie.  G = 1 writes bf16 dK/dV from
    the blocks; a larger G writes fp32 partials that a second pass adds up."""
    items, lists = -(-Sq // TILE) * (Hq // Hkv), -(-Skv // TILE) * Hkv * B

    def cost(G):
        return -(-G * lists // sms) * (-(-items // G) + BWD_BLOCK_ITEMS)

    return min(range(1, min(BWD_MAX_SPLITS, items) + 1), key=cost)


def _flash_bwd_cuda(q, k, v, q_grp, kv_grp, kv_valid, out, lse, g, scale, q_seg, kv_seg,
                    splits=None):
    """K3's launch; ``splits`` overrides :func:`bwd_splits` at head_dim 256
    (tests, measurements)."""
    from dexbotic_tpu_torch.kernels import build

    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"flash backward takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in FLASH_BWD_HEAD_DIMS:
        raise ValueError(f"flash backward serves head_dim {FLASH_BWD_HEAD_DIMS}, got {D}")
    if not (0 < Skv <= 16384 and 0 < Sq <= 16384):
        raise ValueError(f"flash backward serves 0 < Sq, Skv <= 16384, got Sq={Sq} Skv={Skv}")
    if Hq % Hkv or k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"bad GQA shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    if out.shape != q.shape or g.shape != q.shape or lse.shape != (B, Hq, Sq):
        raise ValueError(f"bad saved shapes out={tuple(out.shape)} dO={tuple(g.shape)} "
                         f"lse={tuple(lse.shape)}")
    # dO is read through its strides when they are a row-major [B, S, H, D]
    # layout with 16-byte multiples (padded rows, a slice), else copied
    do = g if g.dtype == torch.bfloat16 else g.to(torch.bfloat16)
    sb, ss, sh, sd = do.stride()
    if (sd != 1 or any(st % 8 for st in (sb, ss, sh)) or do.data_ptr() % 16
            or sh < D or ss < Hq * sh or sb < Sq * ss):
        do = do.contiguous()
    q, k, v, out = q.contiguous(), k.contiguous(), v.contiguous(), out.contiguous()
    lse = lse.float().contiguous()
    for t in (q, k, v, out):
        if t.data_ptr() % 16:
            raise ValueError("flash backward needs 16-byte aligned q/k/v/out")
    ptr, ints = _mask_args(q, B, Sq, Skv, q_grp, kv_grp, kv_valid, q_seg, kv_seg)
    dq, dk, dv, qs = (torch.empty_like(t) for t in (q, k, v, q))
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    cls = _classes_buffer(B, Sq, Skv, q.device)
    if D != 256:
        splits = 1
    elif splits is None:
        splits = bwd_splits(B, Sq, Skv, Hq, Hkv, _sm_count(q.device.index))
    # the shares' fp32 partial dK and dV, [splits, 2, B, Skv, Hkv, D]
    part = (torch.empty(splits * 2 * k.numel(), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    code = build.load().dbx_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
        *ptr, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), qs.data_ptr(), delta.data_ptr(),
        cls.data_ptr(), None if part is None else part.data_ptr(), B, Sq, Skv, Hq, Hkv, D, splits,
        float(scale), *do.stride()[:3], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "dbx_flash_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, q_grp, kv_grp, kv_valid, out, lse, g, scale=None,
                        q_seg=None, kv_seg=None):
    """K3 backward: (dq, dk, dv) from the forward's (out, lse) and dO = ``g``.

    CPU tensors take the plain version; CUDA tensors launch the kernel or raise."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cuda":
        return _flash_bwd_cuda(q, k, v, q_grp, kv_grp, kv_valid, out, lse, g, scale, q_seg, kv_seg)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, q_grp, kv_grp, kv_valid, out, lse, g, scale,
                                       q_seg, kv_seg)
    raise RuntimeError(f"flash attention backward has no kernel for device {q.device}")


flash_attention_bwd.launches = 0  # K3 launches in this process


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: K1 forward saving (out, lse), K3 backward.

    The port of the JAX ``_flash_vjp`` custom VJP; the mask vectors take no
    gradient.  Under non-reentrant checkpointing the forward runs again in
    the backward pass, so K1 is counted twice per layer there."""

    @staticmethod
    def forward(ctx, q, k, v, q_grp, kv_grp, kv_valid, scale, q_seg, kv_seg):
        ints = [_i32(t) for t in (q_grp, kv_grp, kv_valid, q_seg, kv_seg)]
        out, lse = flash_attention_fwd(q, k, v, *ints[:3], scale, *ints[3:])
        ctx.save_for_backward(q, k, v, out, lse, *ints)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, q_grp, kv_grp, kv_valid, q_seg, kv_seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, q_grp, kv_grp, kv_valid, out, lse, g,
                                         ctx.scale, q_seg, kv_seg)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, q_grp, kv_grp, kv_valid, scale=None, q_seg=None, kv_seg=None):
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return FlashAttention.apply(q, k, v, q_grp, kv_grp, kv_valid, scale, q_seg, kv_seg)


flash_attention.launches = 0  # K1 launches in this process


def flash_serves(head_dim: int) -> bool:
    """Whether ``attention(impl="auto")`` sends a CUDA call of this head_dim
    to K1: a rule of the shape, decided before any launch."""
    return head_dim in FLASH_HEAD_DIMS


def attention(q, k, v, q_grp, kv_grp, kv_valid, scale=None, impl: str = "auto",
              q_seg=None, kv_seg=None, group=None):
    """impl: 'auto' | 'flash' | 'xla' | 'ring:<axis>'.  'auto' takes the
    kernel for CUDA tensors of a head_dim it serves, else the plain
    ``attention_xla``.  'ring:<axis>' runs the call as this rank's part of
    ring attention over ``group``, the sequence sharded on it; with no
    ``group``, over axis ``<axis>`` of the current mesh
    (``parallel/mesh.axis_group``).  Set
    ``TransformerConfig(attn_impl="ring:seq")`` to train a decoder with its
    columns split over a 'seq' axis, and pass the mesh's group down
    (``transformer_forward(attn_group=...)``, as
    ``models/navila.navila_packed_loss_cp`` does).

    K1 computes in bf16: a CUDA call in fp32 (π0's decoder and expert, whose
    residual stream is fp32) is rounded to bf16 at the kernel's input and
    its output returned in fp32."""
    if impl.startswith("ring:"):
        from dexbotic_tpu_torch.parallel.mesh import axis_group
        from dexbotic_tpu_torch.parallel.ring import ring_attention

        if group is None:
            group = axis_group(impl[len("ring:"):])
        return ring_attention(q, k, v, q_grp, kv_grp, kv_valid, group, scale, q_seg=q_seg,
                              kv_seg=kv_seg)
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" and flash_serves(q.shape[-1]) else "xla"
        if impl == "xla" and q.device.type == "cuda":
            attention.plain_cuda_calls += 1
    if impl == "xla":
        return attention_xla(q, k, v, q_grp, kv_grp, kv_valid, scale, q_seg=q_seg, kv_seg=kv_seg)
    if impl == "flash":
        if q.device.type == "cuda" and q.dtype == torch.float32:
            return flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), q_grp, kv_grp,
                                   kv_valid, scale, q_seg=q_seg, kv_seg=kv_seg).float()
        return flash_attention(q, k, v, q_grp, kv_grp, kv_valid, scale, q_seg=q_seg, kv_seg=kv_seg)
    raise ValueError(f"unknown attention impl: {impl}")


attention.plain_cuda_calls = 0  # 'auto' calls on CUDA tensors sent to attention_xla

