"""The port's flash backward (plain version of kernel K3) against the JAX package.

Gradients of sum(out * dO) through ``FlashAttention`` on the CPU, where the
backward is ``flash_attention_bwd_ref``, are held against ``jax.grad`` through
``dexbotic_tpu.ops.attention.flash_attention`` run in interpret mode: with
``single_block_max=0`` (the multi-block kernels, K3b) and ``1024`` (the
whole-sequence kernel, K3a).  They are also held against autograd through
the port's ``attention_xla`` on rows that see a key (that version averages
V uniformly on a row that sees none, the flash versions give 0).  Same numpy
inputs, fp32, rtol = atol = 2e-4 as tests/test_ops.py pins the JAX backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexbotic_tpu.ops.attention import flash_attention as jax_flash_attention
from dexbotic_tpu_torch.ops import attention as ta

torch.set_num_threads(2)
TOL = 2e-4

CASES = {  # B, S, Hq, Hkv, D, right padding, segments, a row that sees no key
    "causal_gqa": (2, 40, 4, 2, 128, False, False, False),
    "padding_segments": (2, 24, 4, 1, 128, True, True, False),
    "masked_row_d64": (1, 33, 4, 4, 64, True, False, True),
}


def _inputs(name):
    B, S, Hq, Hkv, D, pad, seg, masked = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for H in (Hq, Hkv, Hkv))
    valid = np.ones((B, S), np.int32)
    if pad:
        valid[:, -6:] = 0
    grp = np.cumsum(valid, axis=1).astype(np.int32)
    q_grp = grp.copy()
    if masked:
        q_grp[0, 4] = 0
    segs = (np.arange(S) >= 9).astype(np.int32)[None].repeat(B, 0) if seg else None
    dout = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    sees_key = (valid > 0) & (q_grp > 0)  # rows counted in the loss
    dout *= sees_key[:, :, None, None]
    return q, k, v, q_grp, grp, valid, segs, dout


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _port_grads(fn, q, k, v, dout):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (fn(qt, kt, vt) * torch.from_numpy(dout)).sum().backward()
    return [x.grad.numpy() for x in (qt, kt, vt)]


@pytest.mark.parametrize("single_block_max", [0, 1024])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_backward_matches_jax_and_xla(name, single_block_max):
    q, k, v, qg, kg, valid, seg, dout = _inputs(name)
    n0 = ta.flash_attention_bwd.launches
    got = _port_grads(lambda a, b, c: ta.flash_attention(
        a, b, c, _t(qg), _t(kg), _t(valid), q_seg=_t(seg), kv_seg=_t(seg)), q, k, v, dout)
    assert ta.flash_attention_bwd.launches == n0  # CPU tensors take the plain backward

    jseg = None if seg is None else jnp.asarray(seg)

    def jax_loss(a, b, c):
        out = jax_flash_attention(a, b, c, jnp.asarray(qg), jnp.asarray(kg), jnp.asarray(valid),
                                  interpret=True, block_q=16, block_kv=16, q_seg=jseg,
                                  kv_seg=jseg, single_block_max=single_block_max)
        return jnp.sum(out * dout)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)

    plain = _port_grads(lambda a, b, c: ta.attention_xla(
        a, b, c, _t(qg), _t(kg), _t(valid), q_seg=_t(seg), kv_seg=_t(seg)), q, k, v, dout)
    for g, w in zip(got, plain):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_masked_rows_take_no_gradient_and_dout_may_be_strided():
    q, k, v, qg, kg, valid, seg, dout = _inputs("masked_row_d64")
    dout = np.random.default_rng(9).standard_normal(dout.shape).astype(np.float32)
    qt = torch.from_numpy(q).requires_grad_(True)
    out = ta.flash_attention(qt, _t(k), _t(v), _t(qg), _t(kg), _t(valid))
    # dO reaches the Function transposed, as from the o-projection's backward
    g = torch.from_numpy(dout).transpose(1, 2).contiguous().transpose(1, 2)
    assert not g.is_contiguous()
    out.backward(g)
    assert torch.all(out[0, 4] == 0) and torch.all(qt.grad[0, 4] == 0)
    assert torch.isfinite(qt.grad).all()


def _pi0_inputs(B=2, image=32, text=8, real=5, chunk=6):
    """pi0's joint rows at a small S: ``image`` image tokens and ``text``
    text tokens (the last ``text - real`` padding, the second row's second
    half of the images missing), bidirectional; then the state token (group
    1) and ``chunk`` action tokens (group 2).  8 query heads on 1 kv head of 256."""
    S = image + text + 1 + chunk
    rng = np.random.default_rng(21)
    q, k, v, dout = (rng.standard_normal((B, S, H, 256)).astype(np.float32) for H in (8, 1, 1, 8))
    valid = np.ones((B, S), np.int32)
    valid[:, image + real: image + text] = 0
    valid[1, image // 2: image] = 0
    grp = np.zeros((B, S), np.int32)
    grp[:, image + text] = 1
    grp[:, image + text + 1:] = 2
    return q, k, v, grp, valid, dout


@pytest.mark.parametrize("single_block_max", [0, 1024])
def test_flash_backward_d256_pi0_rows_match_jax(single_block_max):
    """head_dim 256, MQA 8:1, the masked text tail and pi0's suffix groups:
    K3's plain version against the JAX backward in interpret mode."""
    q, k, v, grp, valid, dout = _pi0_inputs()
    got = _port_grads(lambda a, b, c: ta.flash_attention(a, b, c, _t(grp), _t(grp), _t(valid)),
                      q, k, v, dout)

    def jax_loss(a, b, c):
        out = jax_flash_attention(a, b, c, jnp.asarray(grp), jnp.asarray(grp), jnp.asarray(valid),
                                  interpret=True, block_q=16, block_kv=16,
                                  single_block_max=single_block_max)
        return jnp.sum(out * dout)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    for g, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 1e-2
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
