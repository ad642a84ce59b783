"""int8-weight matmul (port of dexbotic_tpu/ops/quant_matmul.py).

:func:`quant_matmul` is the wrapper of kernel K4 (``csrc/quant_matmul.cu``):
``out[M, N] = (x[M, K] @ q[N, K]^T) * s[N]`` with the int8 weights streamed
from device memory and expanded in registers, fp32 accumulation and the
scale applied once on the way out.  On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs :func:`quant_matmul_ref`, the plain version.
:func:`plan` gives the kernel's tile, K split and grid for a shape.

:func:`quant_linear` is what a quantized layer (``nn/core.QuantLinear``)
calls, with the JAX dispatch order: int8 activations (:func:`w8a8_matmul`)
at ``M >= W8A8_MIN_ROWS`` when that is set; else K4 where the shape is
eligible on a CUDA tensor; else the dequantize formulation (the plain version,
``(x @ q^T) * s`` in x's dtype, what XLA runs in JAX).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

# Rows K4 takes.  JAX's _MAX_M (64) is a TPU guard (v5e VMEM and a v5e
# measurement); the JAX kernel itself computes any M.  On the H100 the limit
# is the largest M of chip_smoke phase 4c's table at which K4 beats the
# dequantize formulation it replaces (PERF.md, the K4 row).
_MAX_M = 1664
# K4's k step: one stage of the ring holds 64 int8 of every weight row
_K_STEP = 64
_SMS = 132  # streaming multiprocessors of an H100 SXM
# x rows a block takes: one consumer warpgroup of 64 output channels for few
# rows (the weight stream), two of 128 channels for prefill rows (the tensor
# cores); the kernel's instances (csrc/quant_matmul.cu:launch_rows)
_FEW_ROWS = (8, 16, 32, 64)
_MANY_ROWS = (128, 192, 256)
# few rows: blocks K4 aims to put on the card (two an SM), splitting K to
# reach them; the partial sums are reduced by a second pass
_FEW_ROW_BLOCKS = 2 * _SMS
_MIN_K_STEPS = 4  # k steps of one split at least
# prefill rows: a split's partials cost a second pass that a short K does not
# win back (577 x 1024->1024: one pass or four, the same device time)
_MIN_PREFILL_K_STEPS = 16
# prefill plans: a block's fixed work in rows of x (its weight tile's loads
# and int8 expansion, the same whatever its rows), fitted to the device times
# of script/bench_quant_matmul_torch.py plans on the H100
_TILE_COST = 64

# JAX ships its kernel off (KERNEL_DISPATCH = False, a TPU v5e measurement);
# the port dispatches K4 for every eligible shape on a CUDA tensor.  A plain
# reference run (chip_smoke's kernel-vs-plain comparison) turns it off.
KERNEL_DISPATCH = True

# W8A8: when set, quant_linear runs int8 activations x int8 weights for
# matmuls of at least this many rows (the batched prefill);
# exp inference_quantize="w8a8" sets 2048.  None = weight-only.
W8A8_MIN_ROWS: int | None = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """How K4 computes one (M, K, N): blocks of ``channels`` output channels
    by ``rows`` rows of x, over ``splits`` ranges of K; ``grid`` is (row
    tiles, channel tiles, splits), the row tiles of one weight panel
    running together."""

    rows: int
    channels: int
    splits: int
    grid: tuple[int, int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int) -> Plan:
    """K4's tile, split and grid for an eligible shape.

    Few rows (M <= 64) are bound by the weight stream: one tile of the
    smallest instance covers every row, and K is split into the largest
    power of two of ranges that puts at most ~2 blocks an SM on the card.
    Prefill rows are bound by the tensor cores: of the 128/192/256-row tiles
    (on 128 channels) and the splits that fill at most one wave and leave
    each split at least _MIN_PREFILL_K_STEPS k steps, the plan with the
    least waves x (rows + _TILE_COST) x k steps a block (ties: fewer splits,
    then more rows a tile)."""
    steps = K // _K_STEP
    if M <= _FEW_ROWS[-1]:
        rows = next(r for r in _FEW_ROWS if r >= M)
        tiles = _cdiv(N, 64)
        want = _cdiv(_FEW_ROW_BLOCKS, tiles)
        splits = min(max(1, steps // _MIN_K_STEPS), 1 << (want.bit_length() - 1))  # a power of 2
        return Plan(rows, 64, splits, (1, tiles, splits))
    best, max_splits = None, max(1, steps // _MIN_PREFILL_K_STEPS)
    for rows in _MANY_ROWS:
        blocks = _cdiv(M, rows) * _cdiv(N, 128)
        for splits in range(1, min(max_splits, max(1, _SMS // blocks)) + 1):
            cost = _cdiv(blocks * splits, _SMS) * (rows + _TILE_COST) * _cdiv(steps, splits)
            key = (cost, splits, -rows)
            if best is None or key < best[0]:
                best = (key, Plan(rows, 128, splits, (_cdiv(M, rows), _cdiv(N, 128), splits)))
    return best[1]


def quant_matmul_eligible(M: int, K: int, N: int) -> bool:
    """Does K4 take this shape?  1 to _MAX_M rows (a rule of the shape, from
    the card's measurement) and K a multiple of its 64-deep k step; any N
    (the kernel masks the ragged column edge)."""
    return 1 <= M <= _MAX_M and K % _K_STEP == 0 and K > 0 and N > 0


def quant_matmul_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: ``(x @ q^T) * s`` in x's dtype (JAX's XLA formulation)."""
    return (x @ q.t().to(x.dtype)) * s.to(x.dtype)


def split_bf16x3_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K4's split of fp32 activations: [3, ...] bf16 parts
    hi, mid, lo, each the bf16 rounding of what the parts before it left of
    x; their sum carries x to within 2^-24 |x|."""
    parts, r = [], x.float()
    for _ in range(3):
        p = r.to(torch.bfloat16)
        parts.append(p)
        r = r - p.float()
    return torch.stack(parts)


def _launch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, p: Plan | None = None) -> torch.Tensor:
    """K4 on the card; ``p`` overrides :func:`plan` (the tests run every
    instance).  The wrapper is on the host path of every int8 layer, so it
    allocates once (the output) plus one scratch buffer for the fp32
    partials of a split and the bf16 parts of fp32 x."""
    from dexbotic_tpu_torch.kernels import build

    dt = x.dtype
    if dt is not torch.bfloat16 and dt is not torch.float32:
        raise TypeError(f"K4 takes bf16 or fp32 activations, got {dt}")
    if q.dtype is not torch.int8 or s.dtype is not dt:
        raise TypeError(f"K4 takes int8 weights and scales in x's dtype, got {q.dtype}, {s.dtype}")
    if x.ndim != 2 or q.ndim != 2 or s.shape != (q.shape[0],) or x.shape[1] != q.shape[1]:
        raise ValueError(f"K4 shapes: x {tuple(x.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)}")
    M, K = x.shape
    N = q.shape[0]
    if not quant_matmul_eligible(M, K, N):
        raise ValueError(f"K4 does not take M={M} K={K} N={N}")
    dev = x.device
    ptrs = (x.data_ptr(), q.data_ptr(), s.data_ptr())
    if (q.device != dev or s.device != dev
            or not (x.is_contiguous() and q.is_contiguous() and s.is_contiguous())
            or (ptrs[0] | ptrs[1] | ptrs[2]) % 16):
        raise ValueError(f"K4 operands must be contiguous and 16-byte aligned on {dev}")
    p = plan(M, K, N) if p is None else p
    out = torch.empty((M, N), dtype=dt, device=dev)
    part_bytes = -(-4 * p.splits * M * N // 256) * 256 if p.splits > 1 else 0  # xs 256-aligned
    xs_bytes = 6 * M * K if dt is torch.float32 else 0
    part = xs = None
    if part_bytes or xs_bytes:
        scratch = torch.empty(part_bytes + xs_bytes, dtype=torch.uint8, device=dev)
        base = scratch.data_ptr()
        part, xs = (base if part_bytes else None), (base + part_bytes if xs_bytes else None)
    code = build.load().dbx_quant_matmul(
        int(dt is torch.bfloat16), ptrs[0], ptrs[1], ptrs[2], out.data_ptr(), part, xs, M, N,
        K, p.rows, p.splits, torch._C._cuda_getCurrentRawStream(dev.index))
    build.check(code, "dbx_quant_matmul")
    quant_matmul.launches += 1
    return out


def quant_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``(x[M, K] @ q[N, K]^T) * s[N]`` -> [M, N] in x's dtype (bf16 or fp32);
    ``s`` in x's dtype."""
    if x.device.type == "cuda":
        return _launch(x, q, s)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, q, s)
    raise RuntimeError(f"int8 matmul has no kernel for device {x.device}")


quant_matmul.launches = 0  # K4 launches in this process


def _int_mm(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int32 ``xq @ q^T`` on the card by ``torch._int_mm``, which needs more
    than 16 rows and K and N multiples of 8: K and N are padded with zeros
    (exact: a zero adds nothing to an int32 sum), fewer rows raise."""
    M, K = xq.shape
    N = q.shape[0]
    if M <= 16:
        raise ValueError(f"torch._int_mm needs more than 16 rows, got {M}")
    kp, np_ = -(-K // 8) * 8, -(-N // 8) * 8
    if kp != K or np_ != N:
        xq = torch.nn.functional.pad(xq, (0, kp - K))
        q = torch.nn.functional.pad(q, (0, kp - K, 0, np_ - N))
    return torch._int_mm(xq, q.t())[:, :N]


def w8a8_matmul(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[M, K] activations x int8 [N, K] weights with int8 activations -> fp32 [M, N].

    Activations are quantized per row (dynamic absmax -> int8), the product
    accumulates in int32 and is rescaled by (row scale x column scale), as in
    JAX.  An XLA dot there; ``torch._int_mm`` on the card, an int32 matmul on
    the CPU."""
    xf = x2.float()
    xs = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    xq = torch.round(xf / xs).clamp_(-127, 127).to(torch.int8)
    if x2.device.type == "cuda":
        acc = _int_mm(xq, q)
    else:
        acc = xq.to(torch.int32) @ q.t().to(torch.int32)
    return acc.float() * xs * s.float()[None]


def quant_linear(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """A quantized linear layer on x [..., K] -> [..., N] in x's dtype.

    Dispatch (shape and device only): W8A8 when enabled and the rows reach
    W8A8_MIN_ROWS; else K4 on a CUDA tensor where the shape is eligible; else
    the dequantize formulation."""
    N, K = q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if W8A8_MIN_ROWS is not None and M >= W8A8_MIN_ROWS:
        out = w8a8_matmul(x2, q, s).to(x.dtype)
    elif KERNEL_DISPATCH and x.device.type == "cuda" and quant_matmul_eligible(M, K, N):
        out = quant_matmul(x2.contiguous(), q, s.to(x.dtype))
    else:
        out = quant_matmul_ref(x2, q, s)
    out = out.reshape(*lead, N)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
