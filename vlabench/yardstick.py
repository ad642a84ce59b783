"""The frozen arithmetic: the chip's peaks, and the operations and bytes of
each measured operation, computed from its shapes and masks.

A roofline share is the least time the chip could take for the work (the
larger of operations / peak FLOP/s and bytes / peak bytes/s) over the time
the kernels took.  Each input byte is counted read once and each output
byte written once; masked attention counts only the visible query-key
pairs; model FLOPs count only valid tokens.  Peaks are the NVIDIA H100 SXM
data sheet's dense rates at 700 W.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """(least seconds, 'operations' or 'bytes': which of the two sets it)."""
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gemm(M: int, N: int, K: int, in_bytes: int = 2, out_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of an [M, K] x [K, N] product written as [M, N]."""
    return 2.0 * M * N * K, float((M * K + K * N) * in_bytes + M * N * out_bytes)


def attention_fwd(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, D: int, pairs: int,
                  elem: int, mask_vectors: int = 3) -> tuple[float, float]:
    """(operations, bytes) of one attention call's forward: ``pairs`` visible
    (query, key) pairs of one batch row summed over rows, times Hq heads
    counted by the caller; q, k, v read, out written in ``elem`` bytes, the
    fp32 log-sum-exp written, int32 mask vectors read."""
    ops = 4.0 * D * pairs
    nbytes = (B * Sq * Hq * D + 2 * B * Skv * Hkv * D) * elem + B * Sq * Hq * D * elem \
        + B * Hq * Sq * 4 + mask_vectors * B * max(Sq, Skv) * 4
    return ops, float(nbytes)


def attention_bwd(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, D: int, pairs: int,
                  elem: int, mask_vectors: int = 3) -> tuple[float, float]:
    """(operations, bytes) of one attention backward: scores recomputed and
    four more products (dP, dV, dQ, dK), 2 D each per pair; q, k, v, out, dO
    and the log-sum-exp read, dq, dk, dv written."""
    ops = 10.0 * D * pairs
    q = B * Sq * Hq * D
    kv = B * Skv * Hkv * D
    nbytes = (3 * q + 2 * kv) * elem + B * Hq * Sq * 4 + (q + 2 * kv) * elem \
        + mask_vectors * B * max(Sq, Skv) * 4
    return ops, float(nbytes)


def dit_token_flops(D: int, M: int, S: int, A: int) -> float:
    """FLOPs of one token through a DiT forward of ``depth``-free parts per
    block: the four products and attention over S tokens; see dit_sample."""
    return 2.0 * (3 * D * D + D * D + 2 * D * M) + 4.0 * S * D


def dit_sample(B: int, T: int, A: int, D: int, M: int, depth: int, steps: int, cond_dim: int,
               cfg_pair: bool, w_elem: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one sampling call: ``steps`` DiT forwards over
    R rows (2 B with guidance) of T + 1 tokens, the action embedding and the
    final layer per token, and the condition projection once a call; the
    weights, the conditions and the noise read once, the chunk written."""
    R = B * (2 if cfg_pair else 1)
    S = T + 1
    per_step = R * S * depth * dit_token_flops(D, M, S, A) + R * T * 2.0 * 2 * A * D
    ops = steps * per_step + 2.0 * R * cond_dim * D
    weights = depth * (3 * D * D + D * D + 2 * D * M) * w_elem + depth * (3 * D + D + M + D) * 4 \
        + (2 * A * D + S * D) * w_elem + cond_dim * D * w_elem
    nbytes = weights + R * cond_dim * w_elem + 2 * B * T * A * 4
    return ops, float(nbytes)


def decoder_flops(n: int, hidden: int, heads: int, kv_heads: int, head_dim: int, inter: int,
                  layers: int, causal_pairs: float) -> float:
    """Forward FLOPs of a gated-MLP decoder over n valid tokens whose
    attention sees ``causal_pairs`` (query, key) pairs a head."""
    qd, kvd = heads * head_dim, kv_heads * head_dim
    per_token = 2.0 * (hidden * qd + 2 * hidden * kvd + qd * hidden + 3 * hidden * inter)
    return layers * (n * per_token + 4.0 * head_dim * heads * causal_pairs)


def vit_flops(images: int, tokens: int, hidden: int, inter: int, layers: int, patch_in: int,
              patches: int) -> float:
    """Forward FLOPs of a ViT tower over ``images`` images of ``tokens`` tokens."""
    per_layer = tokens * 2.0 * (4 * hidden * hidden + 2 * hidden * inter) + 4.0 * tokens * tokens * hidden
    return images * (layers * per_layer + 2.0 * patches * patch_in * hidden)
