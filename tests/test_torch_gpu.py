"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips without a CUDA device.  On a machine with
an NVIDIA Hopper GPU and no JAX, run them with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
Tolerances are the bf16 rule of chip_smoke.py: the kernel's max error
against the plain version run in fp32 on the same inputs may be at most
twice the plain bf16 version's error plus 1e-3 (for K3 on each of dq, dk and
dv); the fp32 instance of K2 at 1e-4.
"""

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
from dexbotic_tpu_torch.ops.diffusion import DiffusionSchedule
from dexbotic_tpu_torch.ops.dit_fused import dit_sample_ref, fused_dit_sample

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
