"""Port attention (dexbotic_tpu_torch/ops/attention.py) vs the JAX package.

The plain version of kernel K1 is held against the JAX Pallas flash kernel
run in interpret mode, and the port's attention_xla against JAX's, on the
same numpy inputs, in fp32 at atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexbotic_tpu.ops.attention import attention_xla as jax_attention_xla
from dexbotic_tpu.ops.attention import flash_attention as jax_flash_attention
from dexbotic_tpu_torch.ops import attention as ta

torch.set_num_threads(2)
ATOL = 1e-4


def _case(name):
    """(q, k, v, q_grp, kv_grp, kv_valid, q_seg, kv_seg, jax flash kwargs)."""
    rng = np.random.default_rng(CASES.index(name))
    B, S, Hq, Hkv, D = {
        "causal_right_pad": (2, 24, 4, 4, 16),
        "gqa": (1, 24, 4, 2, 32),
        "segments": (2, 32, 4, 2, 16),
        "masked_row": (1, 16, 2, 2, 16),
        "multi_block": (1, 40, 4, 2, 16),
    }[name]
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for H in (Hq, Hkv, Hkv))
    valid = np.ones((B, S), np.int32)
    if name == "causal_right_pad":
        valid[1, -7:] = 0
    grp = np.cumsum(valid, axis=1).astype(np.int32)
    q_grp = grp.copy()
    q_seg = kv_seg = None
    if name == "segments":
        q_seg = kv_seg = (np.arange(S) >= 13).astype(np.int32)[None].repeat(B, 0)
    if name == "masked_row":
        q_grp[0, 3] = 0  # sees no key
    kw = dict(interpret=True, block_q=16, block_kv=16)
    if name == "multi_block":
        kw["single_block_max"] = 0  # the JAX multi-block online-softmax kernel
    return q, k, v, q_grp, grp, valid, q_seg, kv_seg, kw


CASES = ["causal_right_pad", "gqa", "segments", "masked_row", "multi_block"]


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("name", CASES)
def test_flash_plain_matches_jax_flash(name):
    q, k, v, qg, kg, valid, qs, ks, kw = _case(name)
    ref = jax_flash_attention(_j(q), _j(k), _j(v), _j(qg), _j(kg), _j(valid),
                              q_seg=_j(qs), kv_seg=_j(ks), **kw)
    got = ta.flash_attention(_t(q), _t(k), _t(v), _t(qg), _t(kg), _t(valid),
                             q_seg=_t(qs), kv_seg=_t(ks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if name == "masked_row":
        assert np.all(got.numpy()[0, 3] == 0.0) and np.all(np.asarray(ref)[0, 3] == 0.0)


@pytest.mark.parametrize("name", CASES)
def test_attention_xla_matches_jax(name):
    q, k, v, qg, kg, valid, qs, ks, _ = _case(name)
    ref = jax_attention_xla(_j(q), _j(k), _j(v), _j(qg), _j(kg), _j(valid),
                            q_seg=_j(qs), kv_seg=_j(ks))
    got = ta.attention_xla(_t(q), _t(k), _t(v), _t(qg), _t(kg), _t(valid),
                           q_seg=_t(qs), kv_seg=_t(ks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_flash_lse_is_masked_logsumexp():
    q, k, v, qg, kg, valid, _, _, _ = _case("gqa")
    _, lse = ta.flash_attention_fwd(_t(q), _t(k), _t(v), _t(qg), _t(kg), _t(valid))
    kr = np.repeat(k, 2, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, kr)
    s = np.where(np.tril(np.ones((24, 24), bool))[None, None], s, -np.inf)
    expect = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), expect, atol=ATOL, rtol=0)


def test_dispatch():
    q, k, v, qg, kg, valid, _, _, _ = _case("causal_right_pad")
    args = [_t(x) for x in (q, k, v, qg, kg, valid)]
    auto = ta.attention(*args)  # CPU tensors: the plain attention_xla
    np.testing.assert_array_equal(auto.numpy(), ta.attention_xla(*args).numpy())
    np.testing.assert_array_equal(ta.attention(*args, impl="flash").numpy(),
                                  ta.flash_attention(*args).numpy())
    with pytest.raises(ValueError):
        ta.attention(*args, impl="nope")
    meta = [a.to("meta") for a in args]
    with pytest.raises(RuntimeError):  # no silent path for a device without a kernel
        ta.flash_attention(*meta)


@pytest.mark.parametrize("Sq,Skv", [(16, 16), (5, 40)])
def test_flash_plain_matches_jax_flash_head_dim_256(Sq, Skv):
    """pi0's shapes at a small size: D=256, MQA (8 query heads on 1 kv head);
    Sq = Skv is the bidirectional prefix with a padded text tail, Sq < Skv the
    suffix against the cached prefix (state token group 1, actions group 2)."""
    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((1, Sq, 8, 256)).astype(np.float32)
    k, v = (rng.standard_normal((1, Skv, 1, 256)).astype(np.float32) for _ in range(2))
    valid = np.ones((1, Skv), np.int32)
    kv_grp = np.zeros((1, Skv), np.int32)
    if Sq == Skv:
        valid[0, -3:] = 0
    else:
        valid[0, Skv - Sq - 4: Skv - Sq] = 0
        kv_grp[0, Skv - Sq:] = [1] + [2] * (Sq - 1)
    q_grp = kv_grp[:, Skv - Sq:].copy()
    ref = jax_flash_attention(_j(q), _j(k), _j(v), _j(q_grp), _j(kv_grp), _j(valid),
                              interpret=True, block_q=16, block_kv=16)
    got = ta.flash_attention(_t(q), _t(k), _t(v), _t(q_grp), _t(kv_grp), _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_dispatch_rule_is_a_function_of_head_dim():
    """``auto`` sends a CUDA call to K1 exactly where K1 serves the head_dim
    (no length thresholds); a CPU call never counts as a plain CUDA call."""
    assert [d for d in (16, 32, 64, 72, 96, 128, 192, 256, 320, 512) if ta.flash_serves(d)] == \
        [64, 128, 256]
    assert ta.FLASH_HEAD_DIMS == (64, 128, 256) and ta.FLASH_BWD_HEAD_DIMS == (64, 128, 256)
    q, k, v, qg, kg, valid, _, _, _ = _case("gqa")
    n0 = ta.attention.plain_cuda_calls
    ta.attention(*[_t(x) for x in (q, k, v, qg, kg, valid)])
    assert ta.attention.plain_cuda_calls == n0
