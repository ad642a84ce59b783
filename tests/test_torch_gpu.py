"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips without a CUDA device.  On a machine with
an NVIDIA Hopper GPU and no JAX, run them with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
Tolerances are the bf16 rule of chip_smoke.py: the kernel's max error
against the plain version run in fp32 on the same inputs may be at most
twice the plain bf16 version's error plus 1e-3 (for K3 on each of dq, dk and
dv); the fp32 instance of K2 at 1e-4.  K4 with fp32 activations and K2 with
int8 weights follow the same rule against fp64 and fp32 references.
"""

import contextlib
import copy

import pytest
import torch

from dexbotic_tpu_torch.nn.core import cast_matrices_
from dexbotic_tpu_torch.models.dit import DiT, DiTConfig, init_dit_
from dexbotic_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_ref,
)
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


def test_flash_backward_kernel_refuses_what_it_does_not_serve(cuda):
    q = torch.randn(1, 8, 2, 32, device=cuda).bfloat16()  # head_dim 32
    ints = [torch.ones(1, 8, dtype=torch.int32, device=cuda)] * 3
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, *ints, q, lse, q)


@pytest.mark.parametrize("dtype,hidden,heads,depth", [
    (torch.float32, 256, 4, 2), (torch.bfloat16, 256, 4, 2),
    (torch.bfloat16, 1536, 24, 1),  # more product items than two per block
])
def test_dit_kernel_matches_plain(cuda, dtype, hidden, heads, depth):
    cfg = DiTConfig(hidden_size=hidden, depth=depth, num_heads=heads, token_size=128)
    g = torch.Generator(device=cuda).manual_seed(1)
    with torch.device(cuda):
        head = DiT(cfg)
    init_dit_(head, g)
    with torch.no_grad():
        head.final.weight.normal_(0, 0.02, generator=g)
        head.final.bias.normal_(0, 0.02, generator=g)
    ref_head = head
    if dtype == torch.bfloat16:
        ref_head = copy.deepcopy(head)
        cast_matrices_(head, dtype)
    z = torch.randn(2, 1, cfg.token_size, generator=g, device=cuda)
    noise = torch.randn(2, cfg.chunk_size, cfg.in_channels, generator=g, device=cuda)
    sched = DiffusionSchedule.create(100)
    for sampler, steps in (("ddim", 10), ("dpm", 5)):
        kw = dict(steps=steps, cfg_scale=1.5, sampler=sampler)
        out = fused_dit_sample(head, cfg, z, noise, sched, **kw)
        torch.cuda.synchronize()
        ref = dit_sample_ref(ref_head, cfg, z, noise, sched, **kw)
        err = (out - ref).abs().max().item()
        if dtype == torch.float32:
            assert err <= 1e-4
        else:
            plain = dit_sample_ref(head, cfg, z, noise, sched, **kw)
            assert err <= 2 * (plain - ref).abs().max().item() + 1e-3


@contextlib.contextmanager
def _plain_int8():
    """Quantized layers take the dequantize formulation (no K4) while inside."""
    qm.KERNEL_DISPATCH = False
    try:
        yield
    finally:
        qm.KERNEL_DISPATCH = True


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [(2, 4096, 768), (35, 256, 200), (64, 1024, 4096), (1, 64, 8),
                                   (16, 768, 768)])
def test_quant_matmul_kernel_matches_plain(cuda, dtype, M, K, N):
    g = torch.Generator(device=cuda).manual_seed(4)
    q, s = quantize_weight(torch.randn(N, K, generator=g, device=cuda) * 0.05)
    s = s[:, 0].to(dtype)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    n0 = qm.quant_matmul.launches
    out = qm.quant_matmul(x, q, s)
    torch.cuda.synchronize()
    assert qm.quant_matmul.launches == n0 + 1 and out.dtype == dtype and out.shape == (M, N)
    ref_dtype = torch.float64 if dtype == torch.float32 else torch.float32
    ref = qm.quant_matmul_ref(x.to(ref_dtype), q, s.to(ref_dtype))
    plain = qm.quant_matmul_ref(x, q, s)
    bound = 2 * (plain.to(ref_dtype) - ref).abs().max().item() + 1e-3
    assert (out.to(ref_dtype) - ref).abs().max().item() <= bound


def test_quant_matmul_kernel_refuses_what_it_does_not_serve(cuda):
    q = torch.zeros(8, 64, dtype=torch.int8, device=cuda)
    s = torch.ones(8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # more than 64 rows
        qm.quant_matmul(torch.zeros(65, 64, dtype=torch.bfloat16, device=cuda), q, s)
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


@pytest.mark.parametrize("min_size", [1 << 16, 0])
def test_dit_kernel_int8_matches_plain(cuda, min_size):
    """K2 on int8 block weights (min_size 0: x_embed and final too) against the
    plain sampler on the same int8 head, bf16, and on its fp32 copy."""
    cfg = DiTConfig(hidden_size=256, depth=2, num_heads=4, token_size=128)
    g = torch.Generator(device=cuda).manual_seed(7)
    with torch.device(cuda):
        head = DiT(cfg)
    init_dit_(head, g)
    with torch.no_grad():
        head.final.weight.normal_(0, 0.02, generator=g)
        head.final.bias.normal_(0, 0.02, generator=g)
    cast_matrices_(head, torch.bfloat16)
    quantize_model_(head, min_size=min_size)
    assert head.blocks[0].attn.qkv.q.dtype == torch.int8
    ref_head = copy.deepcopy(head)
    for p in ref_head.parameters():
        if p.is_floating_point():
            p.data = p.data.float()
    z = torch.randn(2, 1, cfg.token_size, generator=g, device=cuda)
    noise = torch.randn(2, cfg.chunk_size, cfg.in_channels, generator=g, device=cuda)
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
