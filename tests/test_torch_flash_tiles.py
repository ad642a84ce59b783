"""The plain versions of what K1 and K3 now do in CUDA besides attention itself.

* ``flash_bwd_preprocess_ref`` (K3's preprocess launch: q~ and delta) against
  the preprocessing of the JAX ``_flash_bwd_impl``
  (dexbotic_tpu/ops/attention.py:622 and :644), written out in jnp on the same
  numpy inputs: q~ bit for bit; delta to rel 1e-6 of sum |dO * O| (the fp32
  sums run in another order).  That function computes them inline, so the
  test also asserts that its source still holds those expressions.
* ``flash_tile_classes_ref`` (the class pre-pass both kernels share) against
  classes built tile by tile from the visibility the JAX ``attention_xla``
  gives on indicator inputs: DEAD when no pair of the 64 x 64 tile is
  visible, VISIBLE when all are (query rows past Sq do not count, keys past
  Skv are masked), PARTIAL otherwise.  Exact, over random group, valid and
  segment vectors with a row that sees no key.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexbotic_tpu_torch.ops import attention as ta

jattn = importlib.import_module("dexbotic_tpu.ops.attention")  # the package exports a function of that name

torch.set_num_threads(2)


def _bf16(x):
    return torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,S,H,D", [(2, 70, 4, 64), (1, 33, 2, 128)])
def test_preprocess_matches_jax(dtype, B, S, H, D):
    src = inspect.getsource(jattn._flash_bwd_impl)  # the expressions copied below
    for expr in ("qs_arr = (q.astype(jnp.float32) * scale).astype(q.dtype)",
                 "gp = _pad_to(g.astype(q.dtype), 1, block_q)",
                 "op = _pad_to(out.astype(jnp.float32), 1, block_q)",
                 "dot.astype(jnp.float32) * jnp.transpose(op, (0, 2, 1, 3)), axis=-1"):
        assert expr in src, expr
    rng = np.random.default_rng(S + D)
    q, out, g = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    scale = D ** -0.5
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    qt, ot, gt = (torch.from_numpy(x).to(tdt) for x in (q, out, g))
    qs, delta = ta.flash_bwd_preprocess_ref(qt, ot, gt, scale)

    qj, oj, gj = (jnp.asarray(x).astype(jdt) for x in (q, out, g))
    qs_j = (qj.astype(jnp.float32) * scale).astype(qj.dtype)  # attention.py:622
    dot = jnp.transpose(gj.astype(qj.dtype), (0, 2, 1, 3))
    delta_j = jnp.sum(dot.astype(jnp.float32)  # attention.py:643-645
                      * jnp.transpose(oj.astype(jnp.float32), (0, 2, 1, 3)), axis=-1)

    assert qs.dtype == tdt and delta.dtype == torch.float32 and delta.shape == (B, H, S)
    np.testing.assert_array_equal(qs.float().numpy(), np.asarray(qs_j.astype(jnp.float32)))
    mag = np.asarray(jnp.sum(jnp.abs(dot.astype(jnp.float32)
                                     * jnp.transpose(oj.astype(jnp.float32), (0, 2, 1, 3))), -1))
    np.testing.assert_array_less(np.abs(delta.numpy() - np.asarray(delta_j)), 1e-6 * mag + 1e-30)


def _jax_visible(q_grp, kv_grp, kv_valid, q_seg, kv_seg):
    """[B, Sq, Skv]: which keys each query sees, read from the JAX
    ``attention_xla``.  Equal scores and one-hot values put 1/n on each
    visible key; one more key, which no query sees, takes weight only in a
    row that sees none."""
    B, Sq = q_grp.shape
    Skv = kv_grp.shape[1]
    n = Skv + 1

    def extra_key(x):
        return None if x is None else jnp.asarray(np.concatenate([x, np.zeros((B, 1), x.dtype)], 1))

    q = jnp.zeros((B, Sq, 1, n), jnp.float32)
    k = jnp.zeros((B, n, 1, n), jnp.float32)
    v = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float32)[None, :, None, :], (B, n, 1, n))
    out = jattn.attention_xla(q, k, v, jnp.asarray(q_grp), extra_key(kv_grp), extra_key(kv_valid),
                              1.0, None if q_seg is None else jnp.asarray(q_seg), extra_key(kv_seg))
    out = np.asarray(out)[:, :, 0]
    return (out[..., :Skv] > 0) & (out[..., Skv:] == 0)


def _jax_classes(q_grp, kv_grp, kv_valid, q_seg, kv_seg):
    """Tile classes from the JAX visibility, 64 x 64 tiles."""
    allowed = _jax_visible(q_grp, kv_grp, kv_valid, q_seg, kv_seg)
    B, Sq, Skv = allowed.shape
    nq, nk = -(-Sq // 64), -(-Skv // 64)
    cls = np.zeros((B, nq, nk), np.uint8)
    for b in range(B):
        for i in range(nq):
            for j in range(nk):
                block = allowed[b, i * 64:(i + 1) * 64, j * 64:(j + 1) * 64]
                full = block.all() and (j + 1) * 64 <= Skv  # keys past Skv are masked
                cls[b, i, j] = ta.DEAD if not block.any() else (ta.VISIBLE if full else ta.PARTIAL)
    return cls


def _vectors(rng, B, Sq, Skv, kind):
    if kind == "random":
        q_grp = rng.integers(0, 12, (B, Sq)).astype(np.int32)
        kv_grp = rng.integers(0, 12, (B, Skv)).astype(np.int32)
        valid = (rng.random((B, Skv)) > 0.05).astype(np.int32)
        segs = rng.integers(0, 2, (B, Sq)).astype(np.int32), rng.integers(0, 2, (B, Skv)).astype(np.int32)
    else:  # causal groups with right padding, contiguous segments: what the models send
        valid = np.ones((B, Skv), np.int32)
        valid[-1, Skv - 37:] = 0
        kv_grp = np.cumsum(valid, axis=1).astype(np.int32)
        q_grp = kv_grp[:, Skv - Sq:].copy()
        kv_seg = (np.arange(Skv) >= Skv // 3).astype(np.int32)[None].repeat(B, 0)
        segs = kv_seg[:, Skv - Sq:].copy(), kv_seg
    q_grp[0, 3] = -1  # sees no key
    return q_grp, kv_grp, valid, segs


@pytest.mark.parametrize("kind", ["random", "causal"])
@pytest.mark.parametrize("Sq,Skv", [(200, 200), (130, 300), (64, 64)])
def test_tile_classes_match_jax_rule(kind, Sq, Skv):
    rng = np.random.default_rng(Sq * 7 + Skv)
    q_grp, kv_grp, valid, (q_seg, kv_seg) = _vectors(rng, 2, Sq, Skv, kind)
    for segs in ((None, None), (q_seg, kv_seg)):
        got = ta.flash_tile_classes_ref(*(torch.from_numpy(x) for x in (q_grp, kv_grp, valid)),
                                        *(None if x is None else torch.from_numpy(x) for x in segs))
        np.testing.assert_array_equal(got.numpy(), _jax_classes(q_grp, kv_grp, valid, *segs))
        assert (got.numpy() == ta.PARTIAL).any()
    if kind == "causal" and Sq == Skv == 200:  # a causal mask has all three classes
        classes = set(np.unique(got.numpy()))
        assert classes == {ta.DEAD, ta.PARTIAL, ta.VISIBLE}


def test_tile_classes_on_cpu_take_the_plain_version():
    q_grp = torch.arange(1, 101, dtype=torch.int32)[None]
    valid = torch.ones_like(q_grp)
    torch.testing.assert_close(ta.flash_tile_classes(q_grp, q_grp, valid),
                               ta.flash_tile_classes_ref(q_grp, q_grp, valid), rtol=0, atol=0)


@pytest.mark.parametrize("B,S,Hq,rows", [(1, 832, 32, 64), (2, 832, 32, 64), (4, 832, 32, 64),
                                         (8, 832, 32, 128), (2, 2048, 32, 64), (4, 2048, 32, 128),
                                         (8, 2048, 32, 128), (2, 832, 14, 64)])
def test_fwd_rows_rule(B, S, Hq, rows):
    """K1 takes 128-row blocks when they make eight waves on the H100's 132 SMs, else 64."""
    assert ta.fwd_rows(B, S, Hq, 132) == rows


@pytest.mark.parametrize("B,Sq,rows", [(1, 816, 64), (1, 832, 64), (1, 51, 64), (2, 51, 64),
                                       (2, 832, 128), (8, 51, 64)])
def test_fwd_rows_rule_head_dim_256(B, Sq, rows):
    """At head_dim 256 (pi0: 8 query heads) K1 takes 128-row blocks once its
    64-row blocks would need more than one wave of the H100's 132 SMs."""
    assert ta.fwd_rows(B, Sq, 8, 132, 256) == rows


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,splits", [
    (4, 867, 867, 8, 1, 7),  # pi0's training call: 56 kv-tile lists of 112 items
    (4, 978, 978, 8, 1, 2),  # pi0.5's: 64 lists of 128 items
    (2, 867, 867, 8, 1, 4),
    (1, 51, 867, 8, 1, 8),  # a suffix against a long prefix: one q tile a head
    (8, 2048, 2048, 8, 1, 1),  # 256 lists: the card is full without splitting
    (1, 64, 64, 1, 1, 1),  # one item
])
def test_bwd_splits_rule(B, Sq, Skv, Hq, Hkv, splits):
    """K3's head_dim-256 dK/dV launch splits each kv tile's work list over
    the blocks that make the fewest waves x (items a block + its fixed cost)
    on the H100's 132 SMs."""
    assert ta.bwd_splits(B, Sq, Skv, Hq, Hkv, 132) == splits


def test_bwd_splits_rule_minimises_its_cost():
    """Over a grid of shapes the rule's pick costs no more than any other
    split count, is the smallest such count, and never exceeds the work
    list's items or the kernel's bound."""
    for B in (1, 2, 4, 8):
        for S in (1, 63, 64, 65, 300, 867, 2048):
            for Hq, Hkv in ((8, 1), (8, 2), (8, 8), (16, 8)):
                items = -(-S // 64) * (Hq // Hkv)
                lists = -(-S // 64) * Hkv * B

                def cost(G):
                    return -(-G * lists // 132) * (-(-items // G) + ta.BWD_BLOCK_ITEMS)

                G = ta.bwd_splits(B, S, S, Hq, Hkv, 132)
                assert 1 <= G <= min(items, ta.BWD_MAX_SPLITS)
                others = range(1, min(items, ta.BWD_MAX_SPLITS) + 1)
                assert cost(G) == min(cost(g) for g in others)
                assert all(cost(g) > cost(G) for g in others if g < G)
