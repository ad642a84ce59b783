"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips without a CUDA device.  On a machine with
an NVIDIA Hopper GPU and no JAX, run them with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
Tolerances are the bf16 rule of chip_smoke.py: the kernel's max error
against the plain version run in fp32 on the same inputs may be at most
twice the plain bf16 version's error plus 1e-3 (for K3 on each of dq, dk and
dv); the fp32 instance of K2 at 1e-4.  K4 with fp32 activations and K2 with
int8 weights follow the same rule against fp64 and fp32 references.  K1's
lse is held at 1e-4 against the plain version's on the same bf16 q~ (they
differ by exp and summation order only); K1 and K3 must repeat their outputs
bit for bit, and the class pre-pass must equal its plain version.
"""

import contextlib
import copy
import dataclasses

import pytest
import torch

from dexbotic_tpu_torch.nn.core import cast_like_jax_
from dexbotic_tpu_torch.models.dit import DiT, DiTConfig, init_dit_
from dexbotic_tpu_torch.ops.attention import (
    _flash_bwd_cuda,
    _flash_cuda,
    attention,
    attention_xla,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_ref,
    flash_tile_classes,
    flash_tile_classes_ref,
)
from dexbotic_tpu_torch.ops import dit_fused
from dexbotic_tpu_torch.ops import quant_matmul as qm
from dexbotic_tpu_torch.ops.diffusion import DiffusionSchedule
from dexbotic_tpu_torch.ops.dit_fused import dit_sample_ref, fused_dit_sample
from dexbotic_tpu_torch.ops.quant import quantize_model_, quantize_weight

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(2, 100, 4, 2, 64), (1, 300, 8, 8, 128)])
def test_flash_kernel_matches_plain(cuda, B, S, Hq, Hkv, D):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=cuda).bfloat16() for H in (Hq, Hkv, Hkv))
    valid = torch.ones(B, S, dtype=torch.int32, device=cuda)
    valid[-1, -17:] = 0
    grp = torch.cumsum(valid, 1, dtype=torch.int32)
    q_grp = grp.clone()
    q_grp[0, 2] = 0  # a row that sees no key gives 0
    seg = (torch.arange(S, device=cuda) >= S // 2).int()[None].expand(B, S).contiguous()
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, q_grp, grp, valid, q_seg=seg, kv_seg=seg)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    ref, _ = flash_attention_ref(q.float(), k.float(), v.float(), q_grp, grp, valid, None, seg, seg)
    plain, _ = flash_attention_ref(q, k, v, q_grp, grp, valid, None, seg, seg)
    bound = 2 * (plain.float() - ref).abs().max().item() + 1e-3
    assert (out.float() - ref).abs().max().item() <= bound
    assert torch.all(out[0, 2] == 0)


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(2, 100, 4, 2, 64), (1, 300, 8, 8, 128),
                                          (2, 70, 4, 1, 128)])
def test_flash_backward_kernel_matches_plain(cuda, B, S, Hq, Hkv, D):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=cuda).bfloat16().requires_grad_(True)
               for H in (Hq, Hkv, Hkv))
    dout = torch.randn(B, S, Hq, D, generator=g, device=cuda).bfloat16()
    valid = torch.ones(B, S, dtype=torch.int32, device=cuda)
    valid[-1, -17:] = 0
    grp = torch.cumsum(valid, 1, dtype=torch.int32)
    q_grp = grp.clone()
    q_grp[0, 2] = 0  # a row that sees no key takes no gradient
    seg = (torch.arange(S, device=cuda) >= S // 2).int()[None].expand(B, S).contiguous()
    ints = (q_grp, grp, valid)
    n0 = flash_attention_bwd.launches
    out = flash_attention(q, k, v, *ints, q_seg=seg, kv_seg=seg)
    out.backward(dout)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == n0 + 1
    with torch.no_grad():
        # the plain version on K3's inputs: the out and lse K1 saved (K1 is deterministic)
        out_k, lse_k = flash_attention_fwd(q, k, v, *ints, None, seg, seg)
        assert torch.equal(out_k, out)
        ref = flash_attention_bwd_ref(q.float(), k.float(), v.float(), *ints, out_k.float(), lse_k,
                                      dout.float(), None, seg, seg)
        plain = flash_attention_bwd_ref(q, k, v, *ints, out_k, lse_k, dout, None, seg, seg)
    for got, p, r in zip((q.grad, k.grad, v.grad), plain, ref):
        bound = 2 * (p.float() - r).abs().max().item() + 1e-3
        assert (got.float() - r).abs().max().item() <= bound
    assert torch.all(q.grad[0, 2] == 0)


def _attn_case(cuda, B, Sq, Skv, Hq, Hkv, D, seed, segments):
    """bf16 q [B, Sq], k/v [B, Skv], dO; the queries are the last Sq of the
    Skv positions, the last row's final 17 keys padding; with ``segments``,
    two segments and a query row that sees no key (row 2, when Sq > 3)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g, device=cuda).bfloat16()
                     for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv), (Sq, Hq)))
    valid = torch.ones(B, Skv, dtype=torch.int32, device=cuda)
    if Skv > 17:
        valid[-1, -17:] = 0
    kv_grp = torch.cumsum(valid, 1, dtype=torch.int32)
    q_grp = kv_grp[:, Skv - Sq:].clone()
    q_seg = kv_seg = None
    if segments:
        kv_seg = (torch.arange(Skv, device=cuda) >= Skv // 2).int()[None].expand(B, Skv).contiguous()
        q_seg = kv_seg[:, Skv - Sq:].contiguous()
        if Sq > 3:
            q_grp[0, 2] = 0
    return q, k, v, dout, (q_grp, kv_grp, valid), q_seg, kv_seg


def _bound(plain, ref):
    return 2 * (plain.float() - ref).abs().max().item() + 1e-3


def _check_k1(cuda, case, rows):
    q, k, v, _, ints, q_seg, kv_seg = case
    out, lse = _flash_cuda(q, k, v, *ints, q.shape[-1] ** -0.5, q_seg, kv_seg, rows=rows)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_ref(q.float(), k.float(), v.float(), *ints, None, q_seg, kv_seg)
    plain, plain_lse = flash_attention_ref(q, k, v, *ints, None, q_seg, kv_seg)
    assert (out.float() - ref).abs().max().item() <= _bound(plain, ref)
    live = ref_lse > -1e30  # the lse of the same bf16 q~, up to exp and summation order
    assert (lse - plain_lse)[live].abs().max().item() <= 1e-4
    if q_seg is not None and q.shape[1] > 3:
        assert torch.all(out[0, 2] == 0)
    return out, lse


def _check_k3(cuda, case):
    q, k, v, dout, ints, q_seg, kv_seg = case
    out, lse = flash_attention_fwd(q, k, v, *ints, None, q_seg, kv_seg)
    got = flash_attention_bwd(q, k, v, *ints, out, lse, dout, None, q_seg, kv_seg)
    torch.cuda.synchronize()
    ref = flash_attention_bwd_ref(q.float(), k.float(), v.float(), *ints, out.float(), lse,
                                  dout.float(), None, q_seg, kv_seg)
    plain = flash_attention_bwd_ref(q, k, v, *ints, out, lse, dout, None, q_seg, kv_seg)
    for a, p, r in zip(got, plain, ref):
        assert torch.isfinite(a).all()
        assert (a.float() - r).abs().max().item() <= _bound(p, r)
    if q_seg is not None and q.shape[1] > 3:
        assert torch.all(got[0][0, 2] == 0)
    return got


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 1304])
def test_flash_kernels_at_tile_edges(cuda, S):
    """K1 at both block shapes and K3 at lengths around the 64- and 128-row
    tiles, GQA 4:1, D=128, segments and a row that sees no key."""
    case = _attn_case(cuda, 1, S, S, 8, 2, 128, seed=S, segments=S > 3)
    for rows in (64, 128):
        _check_k1(cuda, case, rows)
    _check_k3(cuda, case)


def _oft_case(cuda, B, n_valid, padded, seg, cached, seed):
    """OFT's decoder call at head_dim 128: the padded prompt (its pads
    mid-row, with the group of the last prompt token), then the appended
    segment; ``cached``: the segment's queries alone against the prompt."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    S = padded + seg
    Sq = seg if cached else S
    q, k, v, dout = (torch.randn(B, n, 32, 128, generator=g, device=cuda).bfloat16()
                     for n in (Sq, S, S, Sq))
    valid = torch.ones(B, S, dtype=torch.int32, device=cuda)
    valid[:, n_valid:padded] = 0
    grp = torch.cumsum(valid, 1, dtype=torch.int32)
    q_grp = grp[:, padded:].contiguous() if cached else grp.clone()
    return q, k, v, dout, (q_grp, grp, valid), None, None


@pytest.mark.parametrize("cached", [False, True])
def test_flash_kernels_at_oft_shapes(cuda, cached):
    """K1 (both block shapes) and K3 at OFT's joint 1 x 944 rows (21 pads
    mid-row) and its cached 113 x 945 segment; the kv tiles holding the pads
    must be classed partial, never wholly visible."""
    case = _oft_case(cuda, 1, 811, 832, 113 if cached else 112, cached, seed=11)
    q, k = case[0], case[1]
    assert (q.shape[1], k.shape[1]) == ((113, 945) if cached else (944, 944))
    for rows in (64, 128):
        _check_k1(cuda, case, rows)
    _check_k3(cuda, case)
    cls = flash_tile_classes(*case[4])
    assert torch.equal(cls, flash_tile_classes_ref(*case[4]))
    assert not (cls[:, :, 811 // 64: (832 - 1) // 64 + 1] == 2).any()  # the pads' kv tiles


@pytest.mark.parametrize("B,seg,cached", [(1, 57, False), (1, 0, False), (2, 112, False),
                                          (4, 112, False), (2, 57, False), (2, 113, True),
                                          (4, 113, True)])
def test_flash_forward_at_oft_served_shapes(cuda, B, seg, cached):
    """K1 (both block shapes) at the other calls OFT's server gives it: the
    LIBERO segment (1 x 889), Diffusion's prompt prefill (1 x 832, its pads
    trailing: also MemVLA's served prefill), and the batch_size=2 and
    4-frame micro-batch rows."""
    case = _oft_case(cuda, B, 811, 832, seg, cached, seed=12 + B + seg)
    for rows in (64, 128):
        _check_k1(cuda, case, rows)
    if seg:
        cls = flash_tile_classes(*case[4])
        assert not (cls[:, :, 811 // 64: (832 - 1) // 64 + 1] == 2).any()


def _rl_case(cuda, B, pads, seed):
    """The OFT-Discrete actor's decoder call in GRPO (head_dim 128): each row
    a 592-token prompt (576 image tokens + 16 of text) with ``pads[b]``
    right-padded slots left mid-row, then the 56-slot Discrete segment."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    S = 592 + 56
    q, k, v, dout = (torch.randn(B, S, 32, 128, generator=g, device=cuda).bfloat16()
                     for _ in range(4))
    valid = torch.ones(B, S, dtype=torch.int32, device=cuda)
    for b, pad in enumerate(pads):
        valid[b, 592 - pad: 592] = 0
    grp = torch.cumsum(valid, 1, dtype=torch.int32)
    return q, k, v, dout, (grp.clone(), grp, valid), None, None


@pytest.mark.parametrize("pads", [(0,) * 8, (0, 3, 0, 7, 1, 0, 12, 5)])
def test_flash_kernels_at_rl_shapes(cuda, pads):
    """K1 (both block shapes) and K3 at the GRPO rollouts' and update's 8 x
    648 rows: prompts that fill their 592 slots (the mock env's
    instructions) and prompts padded mid-row."""
    case = _rl_case(cuda, 8, pads, seed=31 + sum(pads))
    for rows in (64, 128):
        _check_k1(cuda, case, rows)
    _check_k3(cuda, case)
    assert torch.equal(flash_tile_classes(*case[4]), flash_tile_classes_ref(*case[4]))


def _navila_packed_case(cuda, B, segments, seed):
    """NaVILA's packed training rows (LLaMA-2: 32 heads of 128): B rows of
    4096, each the ``segments`` samples back to back (positions restarting,
    groups = positions + 1) and the tail padding (segment -1)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    S = 4096
    q, k, v, dout = (torch.randn(B, S, 32, 128, generator=g, device=cuda).bfloat16()
                     for _ in range(4))
    pos = torch.zeros(B, S, dtype=torch.int32, device=cuda)
    seg = torch.full((B, S), -1, dtype=torch.int32, device=cuda)
    valid = torch.zeros(B, S, dtype=torch.int32, device=cuda)
    for r in range(B):
        start = 0
        for j, n in enumerate(segments):
            pos[r, start: start + n] = torch.arange(n, dtype=torch.int32, device=cuda)
            seg[r, start: start + n] = 2 * r + j
            valid[r, start: start + n] = 1
            start += n
    grp = pos + 1
    return q, k, v, dout, (grp, grp.clone(), valid), seg, seg.clone()


def _navila_cached_case(cuda, Sq, filled, columns, seed):
    """NaVILA's served calls: the prompt's prefill (``Sq`` = ``filled``) or one
    decode row (``Sq`` = 1, the last filled column's) against a bf16 cache of
    ``columns``, ``filled`` of them written; the cache's all-zero segments."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, dout = (torch.randn(1, Sq, 32, 128, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(1, columns, 32, 128, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    valid = torch.zeros(1, columns, dtype=torch.int32, device=cuda)
    valid[:, :filled] = 1
    grp = torch.zeros(1, columns, dtype=torch.int32, device=cuda)
    grp[:, :filled] = torch.arange(1, filled + 1, dtype=torch.int32, device=cuda)
    q_grp = grp[:, filled - Sq: filled].clone()
    zeros = [torch.zeros(1, n, dtype=torch.int32, device=cuda) for n in (Sq, columns)]
    return q, k, v, dout, (q_grp, grp, valid), *zeros


def _k1_within_bound(case, rows):
    q, k, v, _, ints, q_seg, kv_seg = case
    out, _ = _flash_cuda(q, k, v, *ints, q.shape[-1] ** -0.5, q_seg, kv_seg, rows=rows)
    torch.cuda.synchronize()
    ref, _ = flash_attention_ref(q.float(), k.float(), v.float(), *ints, None, q_seg, kv_seg)
    plain, _ = flash_attention_ref(q, k, v, *ints, None, q_seg, kv_seg)
    assert (out.float() - ref).abs().max().item() <= _bound(plain, ref)
    return out


@pytest.mark.parametrize("B,segments", [(1, (1931, 1850)), (2, (1792, 2100)), (1, (4096,))])
def test_flash_kernels_at_navila_packed_rows(cuda, B, segments):
    """K1 (both block shapes) and K3 with segments at NaVILA's packed 4096-token
    rows; every tile pairing two segments is classed dead, in the class map
    both kernels share."""
    case = _navila_packed_case(cuda, B, segments, seed=41 + B)
    for rows in (64, 128):
        _k1_within_bound(case, rows)
    q, k, v, dout, ints, q_seg, kv_seg = case
    out, lse = flash_attention_fwd(q, k, v, *ints, None, q_seg, kv_seg)
    got = flash_attention_bwd(q, k, v, *ints, out, lse, dout, None, q_seg, kv_seg)
    torch.cuda.synchronize()
    ref = flash_attention_bwd_ref(q.float(), k.float(), v.float(), *ints, out.float(), lse,
                                  dout.float(), None, q_seg, kv_seg)
    plain = flash_attention_bwd_ref(q, k, v, *ints, out, lse, dout, None, q_seg, kv_seg)
    for a, p, r in zip(got, plain, ref):
        assert torch.isfinite(a).all() and (a.float() - r).abs().max().item() <= _bound(p, r)
    pad = sum(segments)
    if pad < 4096:  # the padding takes no gradient
        assert not got[1][:, pad:].any() and not got[2][:, pad:].any()
    cls = flash_tile_classes(*ints, q_seg, kv_seg)
    assert torch.equal(cls, flash_tile_classes_ref(*ints, q_seg, kv_seg))
    if len(segments) > 1:  # the second segment's q tiles against the first's kv tiles
        first_kv = segments[0] // 64  # tiles wholly inside segment 0
        second_q = -(-segments[0] // 64)  # tiles wholly inside segment 1
        assert (cls[:, second_q:(segments[0] + segments[1]) // 64, :first_kv] == 0).all()


@pytest.mark.parametrize("Sq,filled,columns", [(1, 1700, 1732), (1, 2211, 2227),
                                               (2195, 2195, 2227)])
def test_flash_kernel_at_navila_decode_and_prefill(cuda, Sq, filled, columns):
    """K1 (both block shapes) at one query row against a 1.7k and a 2.2k bf16
    cache (NaVILA's decode steps: the block's other 63 or 127 rows are past
    Sq), and at the 2195-token prompt's prefill against the cache's 2227
    columns; the rows past Sq are never written."""
    case = _navila_cached_case(cuda, Sq, filled, columns, seed=Sq + filled)
    for rows in (64, 128):
        out = _k1_within_bound(case, rows)
        assert out.shape == (1, Sq, 32, 128) and torch.isfinite(out).all()


def _engine_case(cuda, kind, B, seed, **kw):
    """chip_smoke's engine case (engine_attn_inputs) in _attn_case's layout,
    with a dO, and the rows that see no key."""
    import chip_smoke
    from dexbotic_tpu_torch.ops.attention import _allowed

    g = torch.Generator(device=cuda).manual_seed(seed)
    _, q, k, v, ints, (q_seg, kv_seg) = chip_smoke.engine_attn_inputs(kind, B, g, **kw)
    dout = torch.randn(q.shape, generator=g, device=cuda).bfloat16()
    blind = ~_allowed(*ints, q_seg, kv_seg)[:, 0].any(-1)
    return (q, k, v, dout, ints, q_seg, kv_seg), blind


@pytest.mark.parametrize("B,N", [(8, 32), (4, 48)])
def test_flash_kernel_at_engine_decode_rows(cuda, B, N):
    """K1 (both block shapes) at one query row a slot against the decode
    engine's cache (the Discrete server's 8 slots of 896 + 32 columns, and 4
    slots of 896 + 48): each slot at its own depth, the slots of
    range(2, B, 3) empty, whose rows see no key and must be exactly 0."""
    case, blind = _engine_case(cuda, "decode", B, seed=B + N, prompt=855, P=896, N=N)
    assert int(blind.sum()) == len(range(2, B, 3))
    for rows in (64, 128):
        out = _k1_within_bound(case, rows)
        assert torch.all(out[blind] == 0) and torch.isfinite(out).all()


@pytest.mark.parametrize("off,chunk", [(0, 512), (512, 384)])
def test_flash_kernel_at_engine_chunk_with_parked_rows(cuda, off, chunk):
    """K1 at a chunked admission's 8 x 512 and 8 x 384 chunks against the
    engine's 928 columns: the admitted slots' prompt columns causal, the
    parked live slots' queries over their own prompt and decode columns, the
    empty slots' rows seeing no key (exactly 0)."""
    case, blind = _engine_case(cuda, "chunk", 8, seed=off + chunk, prompt=855, P=896, N=32,
                               off=off, chunk=chunk)
    assert blind.any()
    for rows in (64, 128):
        out = _k1_within_bound(case, rows)
        assert torch.all(out[blind] == 0)


def test_flash_kernels_at_discrete_vla_training_rows(cuda):
    """K1 and K3 at Discrete VLA training's micro-batch of 8 rows of 2048
    (samples of up to 884 tokens, the collator's pads trailing)."""
    import chip_smoke

    g = torch.Generator(device=cuda).manual_seed(15)
    _, q, k, v, ints, _ = chip_smoke.attn_inputs(chip_smoke.DISCRETE_TRAIN_CASE, g)
    dout = torch.randn(q.shape, generator=g, device=cuda).bfloat16()
    case = (q, k, v, dout, ints, None, None)
    _check_k1(cuda, case, None)
    _check_k3(cuda, case)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", [(2, 129, 129, 8, 2, 64), (2, 65, 300, 4, 1, 128),
                                              (1, 200, 520, 4, 4, 64)])
def test_flash_kernels_d64_and_cross_lengths(cuda, B, Sq, Skv, Hq, Hkv, D):
    """D=64, and queries shorter than the keys (Sq != Skv)."""
    case = _attn_case(cuda, B, Sq, Skv, Hq, Hkv, D, seed=Sq + Skv, segments=True)
    for rows in (64, 128):
        _check_k1(cuda, case, rows)
    _check_k3(cuda, case)


@pytest.mark.parametrize("Sq,Skv", [(64, 64), (192, 192), (576, 576), (100, 192)])
def test_flash_kernels_with_every_key_visible(cuda, Sq, Skv):
    """Bidirectional attention (all-zero groups, as the vision tower passes
    them) with every key valid: every tile is wholly visible, and at
    Skv % 128 == 64 K1's 128-row kv tile reaches past Skv, where its keys
    must stay masked."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Skv)
    q, k, v, dout = (torch.randn(2, S, H, 128, generator=g, device=cuda).bfloat16()
                     for S, H in ((Sq, 8), (Skv, 2), (Skv, 2), (Sq, 8)))
    zeros = torch.zeros(2, Skv, dtype=torch.int32, device=cuda)
    ints = (zeros[:, :Sq].contiguous(), zeros, torch.ones_like(zeros))
    case = (q, k, v, dout, ints, None, None)
    for rows in (64, 128):
        _check_k1(cuda, case, rows)
    _check_k3(cuda, case)


def test_flash_kernels_are_deterministic(cuda):
    """Two calls on the same inputs give bitwise-equal outputs (K1) and
    gradients (K3): no atomics, fixed summation order."""
    q, k, v, dout, ints, q_seg, kv_seg = _attn_case(cuda, 2, 700, 700, 8, 2, 128, 11, True)
    first = flash_attention_fwd(q, k, v, *ints, None, q_seg, kv_seg)
    again = flash_attention_fwd(q, k, v, *ints, None, q_seg, kv_seg)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    out, lse = first
    g1 = flash_attention_bwd(q, k, v, *ints, out, lse, dout, None, q_seg, kv_seg)
    g2 = flash_attention_bwd(q, k, v, *ints, out, lse, dout, None, q_seg, kv_seg)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_flash_backward_reads_strided_dout(cuda):
    """dO handed over as a strided view gives the gradients of its contiguous copy."""
    q, k, v, dout, ints, q_seg, kv_seg = _attn_case(cuda, 2, 130, 130, 4, 2, 128, 12, True)
    out, lse = flash_attention_fwd(q, k, v, *ints, None, q_seg, kv_seg)
    wide = torch.zeros(2, 130, 4, 2 * 128, dtype=torch.bfloat16, device=cuda)
    wide[..., :128] = dout
    strided = wide[..., :128]
    assert not strided.is_contiguous()
    a = flash_attention_bwd(q, k, v, *ints, out, lse, strided, None, q_seg, kv_seg)
    b = flash_attention_bwd(q, k, v, *ints, out, lse, dout, None, q_seg, kv_seg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flash_tile_classes_match_plain(cuda, seed):
    """The class pre-pass on random group, valid and segment vectors (and a
    row that sees no key) against its plain version."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    B, Sq, Skv = 2, 300, 450
    q_grp = torch.randint(0, 40, (B, Sq), generator=g, device=cuda, dtype=torch.int32)
    kv_grp = torch.randint(0, 40, (B, Skv), generator=g, device=cuda, dtype=torch.int32)
    valid = (torch.rand(B, Skv, generator=g, device=cuda) > 0.1).int()
    q_seg = torch.randint(0, 2, (B, Sq), generator=g, device=cuda, dtype=torch.int32)
    kv_seg = torch.randint(0, 2, (B, Skv), generator=g, device=cuda, dtype=torch.int32)
    q_grp[0, 5] = -1
    for segs in ((None, None), (q_seg, kv_seg)):
        got = flash_tile_classes(q_grp, kv_grp, valid, *segs)
        assert torch.equal(got.cpu(), flash_tile_classes_ref(q_grp, kv_grp, valid, *segs).cpu())


def test_flash_backward_kernel_refuses_what_it_does_not_serve(cuda):
    q = torch.randn(1, 8, 2, 32, device=cuda).bfloat16()  # head_dim 32
    ints = [torch.ones(1, 8, dtype=torch.int32, device=cuda)] * 3
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, *ints, q, lse, q)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 816])
def test_flash_kernel_d256_at_tile_edges(cuda, S):
    """K1 at head_dim 256 (pi0's Gemma), MQA 8:1, both block shapes, at
    lengths around the tiles; segments and a row that sees no key."""
    case = _attn_case(cuda, 1, S, S, 8, 1, 256, seed=S, segments=S > 3)
    for rows in (64, 128):
        _check_k1(cuda, case, rows)


@pytest.mark.parametrize("B,Sq,Skv", [(1, 51, 867), (2, 51, 883), (1, 816, 816)])
def test_flash_kernel_d256_prefix_and_suffix(cuda, B, Sq, Skv):
    """pi0's calls: the bidirectional prefix with its text tail masked, and the
    suffix (state token group 1, actions group 2) against the cached prefix."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Skv)
    q = torch.randn(B, Sq, 8, 256, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, Skv, 1, 256, generator=g, device=cuda).bfloat16() for _ in range(2))
    valid = torch.ones(B, Skv, dtype=torch.int32, device=cuda)
    P = Skv - Sq if Sq < Skv else Skv
    valid[:, P - 20: P] = 0  # the text's padded tail
    kv_grp = torch.zeros(B, Skv, dtype=torch.int32, device=cuda)
    if Sq < Skv:
        kv_grp[:, P:] = 2
        kv_grp[:, P] = 1
    case = (q, k, v, None, (kv_grp[:, Skv - Sq:].contiguous(), kv_grp, valid), None, None)
    for rows in (64, 128):
        _check_k1(cuda, case, rows)


@pytest.mark.parametrize("Sq,Skv", [(64, 64), (192, 192), (100, 192)])
def test_flash_kernel_d256_with_every_key_visible(cuda, Sq, Skv):
    """All-zero groups and every key valid at Skv % 128 == 64: the 128-row
    block's last kv tile reaches past Skv, where its keys stay masked."""
    g = torch.Generator(device=cuda).manual_seed(Sq * Skv)
    q = torch.randn(2, Sq, 8, 256, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, Skv, 1, 256, generator=g, device=cuda).bfloat16() for _ in range(2))
    zeros = torch.zeros(2, Skv, dtype=torch.int32, device=cuda)
    case = (q, k, v, None, (zeros[:, :Sq].contiguous(), zeros, torch.ones_like(zeros)), None, None)
    for rows in (64, 128):
        _check_k1(cuda, case, rows)


def test_flash_kernel_d256_is_deterministic(cuda):
    q, k, v, _, ints, q_seg, kv_seg = _attn_case(cuda, 2, 700, 700, 8, 1, 256, 13, True)
    for rows in (64, 128):
        first = _flash_cuda(q, k, v, *ints, 256 ** -0.5, q_seg, kv_seg, rows=rows)
        again = _flash_cuda(q, k, v, *ints, 256 ** -0.5, q_seg, kv_seg, rows=rows)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_wrappers_refuse_what_they_do_not_serve(cuda):
    ints = [torch.ones(1, 8, dtype=torch.int32, device=cuda)] * 3
    with pytest.raises(ValueError, match="head_dim"):  # SigLIP's 72
        flash_attention_fwd(*(torch.randn(1, 8, 2, 72, device=cuda).bfloat16(),) * 3, *ints)
    with pytest.raises(TypeError):  # fp32 q/k/v
        flash_attention_fwd(*(torch.randn(1, 8, 2, 256, device=cuda),) * 3, *ints)
    x = torch.randn(1, 8, 2, 72, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="head_dim"):  # K3 serves 64, 128 and 256
        flash_attention_bwd(x, x, x, *ints, x, torch.zeros(1, 2, 8, device=cuda), x)
    q = torch.randn(1, 8, 2, 256, device=cuda).bfloat16().requires_grad_(True)
    flash_attention(q, q, q, *ints).sum().backward()  # K1 and K3 both serve 256
    assert torch.isfinite(q.grad).all()


# pi0's training rows (the LIBERO recipe): 3 views x 256 image tokens and the
# text padded to 48 tokens, of which PI0_TEXT are real, bidirectional; then
# the state token (group 1) and 50 action tokens (group 2): 867 tokens.
PI0_IMAGE, PI0_TEXT, PI0_PREFIX, PI0_SEQ = 768, 22, 816, 867


def _pi0_train_case(cuda, B, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, dout = (torch.randn(B, PI0_SEQ, H, 256, generator=g, device=cuda).bfloat16()
                     for H in (8, 1, 1, 8))
    valid = torch.ones(B, PI0_SEQ, dtype=torch.int32, device=cuda)
    valid[:, PI0_IMAGE + PI0_TEXT: PI0_PREFIX] = 0
    valid[-1, PI0_IMAGE - 256: PI0_IMAGE] = 0  # the last row lacks its third view
    grp = torch.zeros(B, PI0_SEQ, dtype=torch.int32, device=cuda)
    grp[:, PI0_PREFIX] = 1
    grp[:, PI0_PREFIX + 1:] = 2
    return q, k, v, dout, (grp.clone(), grp, valid), None, None


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 867])
def test_flash_backward_d256_at_tile_edges(cuda, S):
    """K3 at head_dim 256, MQA 8:1, at lengths around the 64-row tiles;
    segments and a row that sees no key (no gradient)."""
    _check_k3(cuda, _attn_case(cuda, 1, S, S, 8, 1, 256, seed=S, segments=S > 3))


def test_flash_backward_d256_at_pi0_training_shape(cuda):
    """K3 at the shape pi0's LIBERO recipe gives it: (4, 867, 8/1, 256)."""
    _check_k3(cuda, _pi0_train_case(cuda, 4, 21))


@pytest.mark.parametrize("B,Sq,Skv", [(2, 64, 64), (2, 192, 192), (1, 100, 192), (1, 51, 867)])
def test_flash_backward_d256_with_every_key_visible(cuda, B, Sq, Skv):
    """All-zero groups and every key valid: every tile wholly visible, the
    last kv tile reaching past Skv where Skv % 64 != 0."""
    g = torch.Generator(device=cuda).manual_seed(Sq * Skv)
    q, dout = (torch.randn(B, Sq, 8, 256, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, Skv, 1, 256, generator=g, device=cuda).bfloat16() for _ in range(2))
    zeros = torch.zeros(B, Skv, dtype=torch.int32, device=cuda)
    _check_k3(cuda, (q, k, v, dout, (zeros[:, :Sq].contiguous(), zeros, torch.ones_like(zeros)),
                     None, None))


def test_flash_backward_d256_is_deterministic(cuda):
    q, k, v, dout, ints, _, _ = _pi0_train_case(cuda, 2, 22)
    out, lse = flash_attention_fwd(q, k, v, *ints)
    g1 = flash_attention_bwd(q, k, v, *ints, out, lse, dout)
    g2 = flash_attention_bwd(q, k, v, *ints, out, lse, dout)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def _check_k3_splits(cuda, case, splits):
    """K3 with a head_dim-256 kv tile's work list split over ``splits``
    blocks (None: ``bwd_splits``'s count) against the plain version, a row
    that sees no key given no gradient, and two calls bitwise equal."""
    q, k, v, dout, ints, q_seg, kv_seg = case
    out, lse = flash_attention_fwd(q, k, v, *ints, None, q_seg, kv_seg)
    args = (q, k, v, *ints, out, lse, dout, q.shape[-1] ** -0.5, q_seg, kv_seg)
    got = _flash_bwd_cuda(*args, splits=splits)
    again = _flash_bwd_cuda(*args, splits=splits)
    torch.cuda.synchronize()
    ref = flash_attention_bwd_ref(q.float(), k.float(), v.float(), *ints, out.float(), lse,
                                  dout.float(), None, q_seg, kv_seg)
    plain = flash_attention_bwd_ref(q, k, v, *ints, out, lse, dout, None, q_seg, kv_seg)
    for a, p, r in zip(got, plain, ref):
        assert torch.isfinite(a).all()
        assert (a.float() - r).abs().max().item() <= _bound(p, r)
    if q_seg is not None and q.shape[1] > 3:
        assert torch.all(got[0][0, 2] == 0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("Hq,Hkv,Sq,Skv,splits", [
    (8, 1, 129, 129, 1), (8, 1, 129, 129, 5),  # pi0's group of 8: 24 items a list, 5 shares
    (8, 2, 65, 200, 3), (8, 2, 65, 200, None),  # a group of 4, Sq != Skv
    (4, 2, 128, 192, 7), (4, 2, 63, 127, None),  # a group of 2 at tile edges: 4 items, 7 shares
    (2, 2, 64, 64, 1), (2, 2, 64, 64, 16),  # a group of 1: one item, 15 empty shares
])
def test_flash_backward_d256_splits(cuda, Hq, Hkv, Sq, Skv, splits):
    """K3 at head_dim 256 for every GQA group of pi0's 8 heads, each kv
    tile's work list split over blocks that do and do not divide it;
    segments and a row that sees no key."""
    _check_k3_splits(cuda, _attn_case(cuda, 2, Sq, Skv, Hq, Hkv, 256, seed=Sq * Skv + Hkv,
                                      segments=True), splits)


@pytest.mark.parametrize("splits", [1, 5])
def test_flash_backward_d256_at_pi0_training_shape_split(cuda, splits):
    """pi0's training call with its kv tiles' work lists whole (dK and dV
    written in bf16 by their blocks) and in 5 shares (fp32 partials added
    by the second pass)."""
    _check_k3_splits(cuda, _pi0_train_case(cuda, 4, 23), splits)


def test_auto_dispatch_counts_plain_cuda_calls(cuda):
    """``attention(impl="auto")`` on CUDA: head_dim 72 takes the plain path and
    counts it; 256 launches K1 and does not count."""
    g = torch.Generator(device=cuda).manual_seed(21)
    ints = [torch.zeros(1, 40, dtype=torch.int32, device=cuda),
            torch.zeros(1, 40, dtype=torch.int32, device=cuda),
            torch.ones(1, 40, dtype=torch.int32, device=cuda)]
    for D, plain in ((72, True), (256, False)):
        q, k, v = (torch.randn(1, 40, 4, D, generator=g, device=cuda).bfloat16() for _ in range(3))
        n_plain, n_k1 = attention.plain_cuda_calls, flash_attention.launches
        out = attention(q, k, v, *ints)
        assert attention.plain_cuda_calls - n_plain == int(plain)
        assert flash_attention.launches - n_k1 == int(not plain)
        if plain:
            assert torch.equal(out, attention_xla(q, k, v, *ints))


def test_auto_dispatch_rounds_fp32_to_bf16_at_k1(cuda):
    """An fp32 call (π0's decoder and expert) takes K1 on its bf16-rounded
    q/k/v and returns fp32: exactly K1 on the rounded inputs, and within the
    error rule of the fp32 plain version."""
    g = torch.Generator(device=cuda).manual_seed(22)
    valid = torch.ones(1, 867, dtype=torch.int32, device=cuda)
    valid[:, 790:816] = 0
    kv_grp = torch.zeros(1, 867, dtype=torch.int32, device=cuda)
    kv_grp[:, 816] = 1
    kv_grp[:, 817:] = 2
    ints = (kv_grp[:, 816:].contiguous(), kv_grp, valid)
    q = torch.randn(1, 51, 8, 256, generator=g, device=cuda)
    k, v = (torch.randn(1, 867, 1, 256, generator=g, device=cuda) for _ in range(2))
    n_plain, n_k1 = attention.plain_cuda_calls, flash_attention.launches
    out = attention(q, k, v, *ints)
    assert out.dtype == torch.float32
    assert (attention.plain_cuda_calls - n_plain, flash_attention.launches - n_k1) == (0, 1)
    rounded = flash_attention_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), *ints)[0]
    assert torch.equal(out, rounded.float())
    ref = attention_xla(q, k, v, *ints)
    plain_bf16 = attention_xla(q.bfloat16(), k.bfloat16(), v.bfloat16(), *ints).float()
    assert (out - ref).abs().max() <= 2 * (plain_bf16 - ref).abs().max() + 1e-3


def _dit_head(cuda, hidden, heads, depth, seed):
    cfg = DiTConfig(hidden_size=hidden, depth=depth, num_heads=heads, token_size=128)
    g = torch.Generator(device=cuda).manual_seed(seed)
    with torch.device(cuda):
        head = DiT(cfg)
    init_dit_(head, g)
    with torch.no_grad():
        head.final.weight.normal_(0, 0.02, generator=g)
        head.final.bias.normal_(0, 0.02, generator=g)
    return cfg, head, g


@pytest.mark.parametrize("dtype,hidden,heads,depth,B", [
    (torch.float32, 256, 4, 2, 2), (torch.bfloat16, 256, 4, 2, 2),
    (torch.bfloat16, 1536, 24, 1, 2),  # more product items than two per block
    (torch.bfloat16, 256, 4, 2, 8), (torch.float32, 256, 4, 2, 8),  # 16 rows: two N tiles
    (torch.bfloat16, 256, 4, 12, 1), (torch.bfloat16, 256, 4, 12, 8),  # the ring over 48 products a step
])
def test_dit_kernel_matches_plain(cuda, dtype, hidden, heads, depth, B):
    cfg, head, g = _dit_head(cuda, hidden, heads, depth, 1)
    ref_head = head
    if dtype == torch.bfloat16:
        ref_head = copy.deepcopy(head)
        cast_like_jax_(head, dtype)
    z = torch.randn(B, 1, cfg.token_size, generator=g, device=cuda)
    noise = torch.randn(B, cfg.chunk_size, cfg.in_channels, generator=g, device=cuda)
    sched = DiffusionSchedule.create(100)
    for sampler, steps in (("ddim", 10), ("dpm", 5)):
        kw = dict(steps=steps, cfg_scale=1.5, sampler=sampler)
        n0 = fused_dit_sample.launches
        out = fused_dit_sample(head, cfg, z, noise, sched, **kw)
        torch.cuda.synchronize()
        assert fused_dit_sample.launches == n0 + 1
        ref = dit_sample_ref(ref_head, cfg, z, noise, sched, **kw)
        err = (out - ref).abs().max().item()
        if dtype == torch.float32:
            assert err <= 1e-4
        else:
            plain = dit_sample_ref(head, cfg, z, noise, sched, **kw)
            assert err <= 2 * (plain - ref).abs().max().item() + 1e-3


# (rows of the sampler: B with cfg_scale 1, 2 B with CFG) -> every N tile the
# planner picks: 17 tokens -> 24, 34 -> 40, 68 -> 72, 136 -> 2 x 72, 272 -> 4 x 72
_TILE_CASES = [(1, 1.0), (1, 1.5), (2, 1.5), (4, 1.5), (8, 1.5)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,cfg_scale", _TILE_CASES)
@pytest.mark.parametrize("chunks", ["planned", "fewest", "most"])
def test_dit_kernel_every_plan(cuda, int8, B, cfg_scale, chunks):
    """Every N tile the planner can pick, with its own k chunks and with the
    extremes: one chunk a product (a block walks up to 16 k steps of fc1,
    past the ring's 6 stages) and one k step a chunk."""
    cfg, head, g = _dit_head(cuda, 256, 4, 2, 3)
    cast_like_jax_(head, torch.bfloat16)
    if int8:
        quantize_model_(head)
    ref_head = copy.deepcopy(head)
    for p in ref_head.parameters():
        if p.is_floating_point():
            p.data = p.data.float()
    z = torch.randn(B, 1, cfg.token_size, generator=g, device=cuda)
    noise = torch.randn(B, cfg.chunk_size, cfg.in_channels, generator=g, device=cuda)
    sched = DiffusionSchedule.create(100)
    rows = B * (2 if cfg_scale > 1.0 else 1)
    planned = dit_fused.plan(rows, cfg.chunk_size, cfg.hidden_size, cfg.mlp_dim,
                             torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (planned.bn, planned.nt) == [(24, 1), (40, 1), (72, 1), (72, 2), (72, 4)][
        _TILE_CASES.index((B, cfg_scale))]
    steps = [K // 64 for _, _, K in dit_fused.products(cfg.hidden_size, cfg.mlp_dim)]
    pl = {"planned": planned, "fewest": dataclasses.replace(planned, chunks=(1, 1, 1, 1)),
          "most": dataclasses.replace(planned, chunks=tuple(steps))}[chunks]
    kw = dict(steps=10, cfg_scale=cfg_scale, sampler="ddim")
    out = dit_fused._launch(head, cfg, z, noise, sched, **kw, k2_plan=pl)
    torch.cuda.synchronize()
    with _plain_int8():
        ref = dit_sample_ref(ref_head, cfg, z, noise, sched, **kw)
        plain = dit_sample_ref(head, cfg, z, noise, sched, **kw)
    assert (out - ref).abs().max().item() <= 2 * (plain - ref).abs().max().item() + 1e-3


@pytest.mark.parametrize("int8", [False, True])
def test_dit_kernel_is_deterministic(cuda, int8):
    """Two calls give the same chunk bit for bit: the partials are summed in
    chunk order, whichever block finishes first."""
    cfg, head, g = _dit_head(cuda, 256, 4, 2, 5)
    cast_like_jax_(head, torch.bfloat16)
    if int8:
        quantize_model_(head)
    z = torch.randn(8, 1, cfg.token_size, generator=g, device=cuda)
    noise = torch.randn(8, cfg.chunk_size, cfg.in_channels, generator=g, device=cuda)
    kw = dict(steps=10, cfg_scale=1.5, sampler="dpm")
    sched = DiffusionSchedule.create(100)
    a = fused_dit_sample(head, cfg, z, noise, sched, **kw)
    b = fused_dit_sample(head, cfg, z, noise, sched, **kw)
    assert torch.equal(a, b)


def test_dit_kernel_refuses_what_it_does_not_serve(cuda):
    cfg, head, g = _dit_head(cuda, 256, 4, 1, 6)
    cast_like_jax_(head, torch.bfloat16)
    z = torch.randn(9, 1, cfg.token_size, generator=g, device=cuda)
    noise = torch.randn(9, cfg.chunk_size, cfg.in_channels, generator=g, device=cuda)
    with pytest.raises(ValueError):  # 18 rows of 17 tokens: past k2_serves
        fused_dit_sample(head, cfg, z, noise, DiffusionSchedule.create(100), steps=10,
                         cfg_scale=1.5)


@contextlib.contextmanager
def _plain_int8():
    """Quantized layers take the dequantize formulation (no K4) while inside."""
    qm.KERNEL_DISPATCH = False
    try:
        yield
    finally:
        qm.KERNEL_DISPATCH = True


def _quant_case(cuda, dtype, M, K, N, seed=4):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, s = quantize_weight(torch.randn(N, K, generator=g, device=cuda) * 0.05)
    s = s[:, 0].to(dtype)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    return x, q, s


def _check_quant(out, x, q, s):
    """The bf16 rule, against fp64 for fp32 activations."""
    ref_dtype = torch.float64 if x.dtype == torch.float32 else torch.float32
    ref = qm.quant_matmul_ref(x.to(ref_dtype), q, s.to(ref_dtype))
    plain = qm.quant_matmul_ref(x, q, s)
    bound = 2 * (plain.to(ref_dtype) - ref).abs().max().item() + 1e-3
    assert out.dtype == x.dtype and out.shape == ref.shape
    assert (out.to(ref_dtype) - ref).abs().max().item() <= bound


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [(2, 4096, 768), (35, 256, 200), (64, 1024, 4096), (1, 64, 8),
                                   (16, 768, 768), (65, 256, 200)])
def test_quant_matmul_kernel_matches_plain(cuda, dtype, M, K, N):
    x, q, s = _quant_case(cuda, dtype, M, K, N)
    n0 = qm.quant_matmul.launches
    out = qm.quant_matmul(x, q, s)
    torch.cuda.synchronize()
    assert qm.quant_matmul.launches == n0 + 1
    _check_quant(out, x, q, s)


@pytest.mark.parametrize("M,K,N", [(16, 7 * 4096, 4096), (16, 4096, 4096)])
def test_quant_matmul_kernel_at_oft_mlp_resnet(cuda, M, K, N):
    """K4 with fp32 activations at OFT's MLPResNet: fc1 over the chunk's 16
    rows of 7 x 4096 concatenated hidden states, then a block."""
    x, q, s = _quant_case(cuda, torch.float32, M, K, N)
    assert qm.quant_matmul_eligible(M, K, N)
    n0 = qm.quant_matmul.launches
    out = qm.quant_matmul(x, q, s)
    torch.cuda.synchronize()
    assert qm.quant_matmul.launches == n0 + 1
    _check_quant(out, x, q, s)


@pytest.mark.parametrize("dtype,M,K,N", [
    (torch.float32, 577, 1024, 1024),  # CLIP-L/336's rows
    (torch.float32, 577, 1024, 1000),  # ragged N
    (torch.float32, 576, 4096, 4096),  # the projector's
    (torch.bfloat16, 832, 4096, 4096),  # the LLaMA prefill's
    (torch.bfloat16, 1664, 4096, 1000)])  # batch_size=2's, ragged N
def test_quant_matmul_kernel_matches_plain_at_prefill_rows(cuda, dtype, M, K, N):
    x, q, s = _quant_case(cuda, dtype, M, K, N)
    out = qm.quant_matmul(x, q, s)
    torch.cuda.synchronize()
    _check_quant(out, x, q, s)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", qm._FEW_ROWS + qm._MANY_ROWS)
@pytest.mark.parametrize("splits", [1, 3])
def test_quant_matmul_every_instance(cuda, dtype, rows, splits):
    """Each tile of the kernel, on several row tiles with a ragged last one,
    several channel tiles with a ragged N, unsplit and split over K."""
    M, K, N = 2 * rows - 3 if rows > 8 else 5, 512, 200
    x, q, s = _quant_case(cuda, dtype, M, K, N, seed=rows + splits)
    ch = 64 if rows in qm._FEW_ROWS else 128
    grid = (-(-M // rows), -(-N // ch), splits)
    out = qm._launch(x, q, s, qm.Plan(rows, ch, splits, grid))
    torch.cuda.synchronize()
    _check_quant(out, x, q, s)


@pytest.mark.parametrize("dtype,M,K,N", [(torch.bfloat16, 2, 4096, 768),
                                         (torch.float32, 577, 1024, 1024),
                                         (torch.bfloat16, 832, 4096, 4096)])
def test_quant_matmul_kernel_is_deterministic(cuda, dtype, M, K, N):
    """Split (ordered second pass) and unsplit plans repeat their output bit for bit."""
    x, q, s = _quant_case(cuda, dtype, M, K, N)
    a, b = qm.quant_matmul(x, q, s), qm.quant_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_quant_matmul_kernel_refuses_what_it_does_not_serve(cuda):
    q = torch.zeros(8, 64, dtype=torch.int8, device=cuda)
    s = torch.ones(8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # more rows than the dispatch rule gives K4
        qm.quant_matmul(torch.zeros(qm._MAX_M + 1, 64, dtype=torch.bfloat16, device=cuda), q, s)
    with pytest.raises(TypeError):  # scales in another dtype than x
        qm.quant_matmul(torch.zeros(4, 64, device=cuda), q, s)


def test_w8a8_int_mm_matches_the_int32_product(cuda):
    """torch._int_mm with K and N padded to its multiples of 8 (the ViT patch
    embedding's K = 588) gives the exact int32 product; W8A8 then differs from
    the CPU's only by fp32 rounding of the rescale."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(40, 588, generator=g, device=cuda)
    q, s = quantize_weight(torch.randn(100, 588, generator=g, device=cuda) * 0.05)
    xq = torch.randint(-127, 128, (40, 588), generator=g, device=cuda).to(torch.int8)
    acc = qm._int_mm(xq, q)
    assert acc.dtype == torch.int32
    torch.testing.assert_close(acc.cpu(), xq.cpu().int() @ q.cpu().int().t(), rtol=0, atol=0)
    got = qm.w8a8_matmul(x, q, s[:, 0])
    ref = qm.w8a8_matmul(x.cpu(), q.cpu(), s[:, 0].cpu())
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):  # _int_mm refuses 16 rows or fewer
        qm.w8a8_matmul(x[:16], q, s[:, 0])


@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)])
def test_quant_matmul_kernel_at_engine_decode_rows(cuda, M, K, N):
    """K4 at the decode engine's rows (M = its slots, 1 to 8) at LLaMA-2-7B's
    widths and its lm_head, through quant_linear (one launch) with bf16
    activations, against its plain version by the bf16 rule."""
    x, q, s = _quant_case(cuda, torch.bfloat16, M, K, N, seed=M)
    n0 = qm.quant_matmul.launches
    out = qm.quant_linear(x, q, s)
    torch.cuda.synchronize()
    assert qm.quant_matmul.launches == n0 + 1
    _check_quant(out, x, q, s)


def test_quantized_engine_tick_matches_plain(cuda):
    """One tick of the decode engine (4 slots, 2 steps) over a small
    quantized decoder (hidden 256, FFN 512, 4 heads of 64, untied lm_head;
    every linear int8): K4 launches once a product (7 a layer and the
    lm_head a step), and the tick's logits through K4 against the same tick
    with the dequantize formulation from the same engine state, cosine
    >= 0.999 a row (bf16 activations; the two differ by summation order)."""
    from dexbotic_tpu_torch.exp import decode_engine as de
    from dexbotic_tpu_torch.models.discrete_vla import DiscreteVLAConfig, build_discrete_vla
    from dexbotic_tpu_torch.models.presets import VIT_TEST
    from dexbotic_tpu_torch.models.vlm import VLMConfig
    from dexbotic_tpu_torch.nn.transformer import TransformerConfig

    llm = TransformerConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                            num_kv_heads=4, head_dim=64, intermediate_size=512,
                            tie_embeddings=False)
    cfg = DiscreteVLAConfig(vlm=VLMConfig(llm=llm, vit=VIT_TEST))
    model = build_discrete_vla(cfg, cuda, seed=0,
                               prepare=lambda m: cast_like_jax_(m, torch.bfloat16))
    quantize_model_(model, min_size=0)
    eng = de.ContinuousBatchingEngine(model.vlm, cfg.vlm, slots=4, max_prompt=64, max_new=8,
                                      eos_token_id=-1, steps_per_tick=2)
    eng.close()  # the loop thread: the test admits and ticks by hand
    g = torch.Generator(device=cuda).manual_seed(0)
    try:
        lens = torch.tensor([40, 33, 17], device=cuda)  # three live slots, one empty
        ids = torch.randint(3, 500, (3, 64), generator=g, device=cuda, dtype=torch.int32)
        valid = (torch.arange(64, device=cuda)[None] < lens[:, None]).to(torch.int32)
        with torch.no_grad():
            eng._install(*eng._prefill(ids, valid, None, None), torch.arange(3, device=cuda))
        live = torch.tensor([True, True, True, False], device=cuda)
        args = (torch.tensor([40, 33, 17, 0], dtype=torch.int32, device=cuda),
                torch.zeros(4, dtype=torch.int32, device=cuda), ~live,
                torch.full((4,), 8, dtype=torch.int32, device=cuda), 2)
        state = (copy.deepcopy(eng.cache), eng.last_hidden.clone())
        logits = {}
        real = de.lm_logits
        for path in ("kernel", "plain"):
            eng.cache, eng.last_hidden = copy.deepcopy(state[0]), state[1].clone()
            seen = []
            de.lm_logits = lambda *a, seen=seen: seen.append(real(*a).float()) or seen[-1]
            n0 = qm.quant_matmul.launches
            try:
                with _plain_int8() if path == "plain" else contextlib.nullcontext():
                    eng._step(*args)
                torch.cuda.synchronize()
            finally:
                de.lm_logits = real
            launches = qm.quant_matmul.launches - n0
            assert launches == (0 if path == "plain" else 2 * (7 * llm.num_layers + 1))
            logits[path] = torch.stack(seen)  # [steps, slots, V]
    finally:
        eng.close()
    k, p = logits["kernel"][:, :3], logits["plain"][:, :3]
    assert torch.isfinite(k).all()
    cos = torch.nn.functional.cosine_similarity(k.double(), p.double(), dim=-1)
    assert cos.min().item() >= 0.999


@pytest.mark.parametrize("min_size,B,depth", [(1 << 16, 2, 2), (0, 2, 2), (1 << 16, 8, 2),
                                              (1 << 16, 1, 12), (1 << 16, 8, 12)])
def test_dit_kernel_int8_matches_plain(cuda, min_size, B, depth):
    """K2 on int8 block weights (min_size 0: x_embed and final too) against the
    plain sampler on the same int8 head, bf16, and on its fp32 copy."""
    cfg, head, g = _dit_head(cuda, 256, 4, depth, 7)
    cast_like_jax_(head, torch.bfloat16)
    quantize_model_(head, min_size=min_size)
    assert head.blocks[0].attn.qkv.q.dtype == torch.int8
    ref_head = copy.deepcopy(head)
    for p in ref_head.parameters():
        if p.is_floating_point():
            p.data = p.data.float()
    z = torch.randn(B, 1, cfg.token_size, generator=g, device=cuda)
    noise = torch.randn(B, cfg.chunk_size, cfg.in_channels, generator=g, device=cuda)
    sched = DiffusionSchedule.create(100)
    for sampler, steps in (("ddim", 10), ("dpm", 5)):
        kw = dict(steps=steps, cfg_scale=1.5, sampler=sampler)
        n0 = fused_dit_sample.launches
        out = fused_dit_sample(head, cfg, z, noise, sched, **kw)
        torch.cuda.synchronize()
        assert fused_dit_sample.launches == n0 + 1
        with _plain_int8():
            ref = dit_sample_ref(ref_head, cfg, z, noise, sched, **kw)
            plain = dit_sample_ref(head, cfg, z, noise, sched, **kw)
        assert (out - ref).abs().max().item() <= 2 * (plain - ref).abs().max().item() + 1e-3


@pytest.mark.parametrize("in_hw,pad,resample", [((480, 640), True, "bicubic"),
                                                ((48, 64), True, "bilinear"),
                                                ((336, 336), False, "bicubic")])
def test_device_preprocess_on_cuda_matches_the_cpu(cuda, in_hw, pad, resample):
    """ops/image_ops.py on the card against the same function on the CPU:
    the same clip8 pixels up to the fp32 summation order at a .5 rounding
    tie (at most one quantum, on few pixels), at 336 px (CLIP-L/336)."""
    import numpy as np

    from dexbotic_tpu_torch.ops.image_ops import make_device_preprocess

    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, *in_hw, 3),
                                                                dtype=np.uint8))
    kw = dict(resample=resample, pad_to_square=pad, fill=(122, 116, 104), rescale=1.0)
    got = make_device_preprocess(in_hw, 336, device=cuda, **kw)(frames.to(cuda)).cpu()
    want = make_device_preprocess(in_hw, 336, device="cpu", **kw)(frames)
    diff = (got - want).abs()
    assert got.shape == (2, 336, 336, 3) and diff.max().item() <= 1.0
    assert (diff > 0).float().mean().item() < 1e-3


def test_safetensors_parser_reads_to_cuda(cuda, tmp_path):
    """utils/convert.read_safetensors onto the card: each tensor in its
    stored dtype and bits, misaligned offsets included."""
    import chip_smoke
    from dexbotic_tpu_torch.utils.convert import load_torch_state_dict, read_safetensors

    want = {"a_int8": torch.arange(7, dtype=torch.int8), "b_f32": torch.randn(5),
            "c_bf16": torch.randn(3, 4).bfloat16(), "d_f16": torch.randn(9).half(),
            "e_i64": torch.arange(3)}
    chip_smoke.write_safetensors(str(tmp_path / "m.safetensors"), want)
    for got in (read_safetensors(str(tmp_path / "m.safetensors"), cuda),
                load_torch_state_dict(str(tmp_path), cuda)):
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].device.type == "cuda" and got[k].dtype == v.dtype, k
            assert torch.equal(got[k].cpu(), v), k


@pytest.mark.parametrize("n", [2, 4])
def test_ring_hops_match_whole_sequence(cuda, n):
    """The ring's hop arithmetic on the card (parallel/ring.simulate: n
    ranks' K1 hops merged, then their K3 hops, in one process) at a packed
    NaVILA-like row (two segments, padding): out, lse, dq, dk and dv on the
    rows that see a key within 2x the whole-sequence K1/K3 call's error
    against the fp32 plain reference, + 1e-3."""
    from dexbotic_tpu_torch.parallel.ring import simulate

    g = torch.Generator(device=cuda).manual_seed(3)
    B, S, H, D = 2, 512, 4, 64
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g, device=cuda).bfloat16() for _ in range(4))
    pos = torch.zeros(B, S, dtype=torch.int32, device=cuda)
    seg = torch.full((B, S), -1, dtype=torch.int32, device=cuda)
    valid = torch.zeros(B, S, dtype=torch.int32, device=cuda)
    for lo, hi, s_id in ((0, 230, 0), (230, 470, 1)):
        pos[:, lo:hi] = torch.arange(hi - lo, dtype=torch.int32, device=cuda)
        seg[:, lo:hi], valid[:, lo:hi] = s_id, 1
    grp = pos + 1
    ints = (grp, grp, valid, seg, seg)
    ring = simulate(q, k, v, *ints, n=n, dout=dout)
    out, lse = flash_attention_fwd(q, k, v, grp, grp, valid, None, seg, seg)
    whole = dict(zip(("dq", "dk", "dv"), flash_attention_bwd(q, k, v, grp, grp, valid, out, lse,
                                                              dout, None, seg, seg)))
    whole.update(out=out, lse=lse)
    qf, kf, vf = q.float(), k.float(), v.float()
    ref_out, ref_lse = flash_attention_ref(qf, kf, vf, grp, grp, valid, None, seg, seg)
    ref = dict(zip(("dq", "dk", "dv"), flash_attention_bwd_ref(
        qf, kf, vf, grp, grp, valid, ref_out, ref_lse, dout.float(), None, seg, seg)))
    ref.update(out=ref_out, lse=ref_lse)
    rows = valid.bool()
    for key in ("out", "lse", "dq", "dk", "dv"):
        pick = (lambda t: t.transpose(1, 2)[rows]) if key == "lse" else (lambda t: t[rows])
        err = (pick(ring[key]).float() - pick(ref[key])).abs().max().item()
        whole_err = (pick(whole[key]).float() - pick(ref[key])).abs().max().item()
        assert err <= 2 * whole_err + 1e-3, (key, err, whole_err)


def test_flash_kernels_take_column_slices_of_the_masks(cuda):
    """Mask vectors that are column slices (the ring's blocks; not
    contiguous) give K1 and K3 exactly what contiguous copies give: the
    wrappers' int32 copies live through the launch."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, S, H, D = 2, 384, 4, 64
    q, k, v, dout = (torch.randn(B, S // 2, H, D, generator=g, device=cuda).bfloat16()
                     for _ in range(4))
    grp = torch.arange(1, S + 1, dtype=torch.int32, device=cuda).repeat(B, 1)
    valid = torch.ones(B, S, dtype=torch.int32, device=cuda)
    valid[1, 250:] = 0
    seg = (torch.arange(S, device=cuda) >= 300).int().repeat(B, 1)
    cols = slice(S // 2, S)
    sliced = (grp[:, cols], grp[:, cols], valid[:, cols], seg[:, cols], seg[:, cols])
    assert not sliced[0].is_contiguous()
    whole = tuple(t.contiguous() for t in sliced)
    for _ in range(3):  # other allocations in between reuse freed memory
        a = flash_attention_fwd(q, k, v, *sliced[:3], None, *sliced[3:])
        scratch = [torch.full((B, S // 2), -7, dtype=torch.int32, device=cuda) for _ in range(8)]
        b = flash_attention_fwd(q, k, v, *whole[:3], None, *whole[3:])
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        ga = flash_attention_bwd(q, k, v, *sliced[:3], *a, dout, None, *sliced[3:])
        gb = flash_attention_bwd(q, k, v, *whole[:3], *b, dout, None, *whole[3:])
        assert all(torch.equal(x, y) for x, y in zip(ga, gb))
        del scratch
