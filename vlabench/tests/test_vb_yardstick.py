"""The frozen arithmetic against counts made by hand."""

import pytest
import torch

from vlabench import readers, yardstick


def test_gemm():
    assert yardstick.gemm(2, 3, 4) == (48.0, float((8 + 12) * 2 + 6 * 2))


def causal(n, valid=None):
    g = torch.arange(1, n + 1, dtype=torch.int32)[None]
    v = torch.ones(1, n, dtype=torch.int32) if valid is None else torch.tensor([valid], dtype=torch.int32)
    return g, g.clone(), v


def test_visible_pairs_with_a_mask():
    assert readers.visible_pairs(causal(4), {}) == 10
    # the last key padded away: query i sees keys j <= i with j < 3 -> 1 + 2 + 3 + 3
    assert readers.visible_pairs(causal(4, [1, 1, 1, 0]), {}) == 9
    # one group of four (bidirectional) sees all 16 pairs
    g = torch.ones(1, 4, dtype=torch.int32)
    assert readers.visible_pairs((g, g, g), {}) == 16


def test_k1_forward_by_hand():
    # B=1, Sq=Skv=4 causal, Hq=2, Hkv=1, D=8, bf16: 10 pairs a head
    ops, nbytes = yardstick.attention_fwd(1, 4, 4, 2, 1, 8, 10 * 2, 2)
    assert ops == 4 * 8 * 20
    # q (4*2*8) + k and v (2*4*1*8) read, out (4*2*8) written, in 2 bytes; lse 2*4 fp32; 3 mask vectors of 4 int32
    assert nbytes == (64 + 64) * 2 + 64 * 2 + 8 * 4 + 3 * 4 * 4


def test_k1_span_work_counts_only_visible_pairs():
    span = {"shapes": ((1, 4, 2, 8), (1, 4, 1, 8)), "masks": causal(4, [1, 1, 1, 0]), "elem": 2}
    ops, _ = readers.attention_work(span, {})
    assert ops == 4 * 8 * 9 * 2


def test_k3_backward_by_hand():
    ops, nbytes = yardstick.attention_bwd(1, 4, 4, 2, 1, 8, 20, 2)
    assert ops == 10 * 8 * 20
    q, kv = 4 * 2 * 8, 4 * 1 * 8
    # q, out, dO (3 q) and k, v read; dq, dk, dv written; lse read; 3 mask vectors
    assert nbytes == (3 * q + 2 * kv) * 2 + 2 * 4 * 4 + (q + 2 * kv) * 2 + 3 * 4 * 4


def test_k2_by_hand():
    # B=1 with guidance: 2 rows of T+1=3 tokens, A=2, D=4, M=8, depth 1, 2 steps, cond 5
    ops, nbytes = yardstick.dit_sample(1, 2, 2, 4, 8, 1, 2, 5, True)
    per_token = 2 * (3 * 16 + 16 + 2 * 32) + 4 * 3 * 4
    per_step = 2 * 3 * per_token + 2 * 2 * 2 * 2 * 2 * 4
    assert ops == 2 * per_step + 2 * 2 * 5 * 4
    weights = (3 * 16 + 16 + 2 * 32) * 2 + (12 + 4 + 8 + 4) * 4 + (2 * 2 * 4 + 3 * 4) * 2 + 5 * 4 * 2
    assert nbytes == weights + 2 * 5 * 2 + 2 * 1 * 2 * 2 * 4


def test_roofline_bound():
    t, which = yardstick.bound_s(989e12, 1.0)
    assert which == "operations" and t == pytest.approx(1.0)
    t, which = yardstick.bound_s(1.0, 3.35e12)
    assert which == "bytes" and t == pytest.approx(1.0)
