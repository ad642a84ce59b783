"""int8-weight matmul (port of dexbotic_tpu/ops/quant_matmul.py).

:func:`quant_matmul` is the wrapper of kernel K4 (``csrc/quant_matmul.cu``):
``out[M, N] = (x[M, K] @ q[N, K]^T) * s[N]`` with the int8 weights streamed
from device memory and converted in registers, fp32 accumulation and the
scale applied once on the way out.  On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs :func:`quant_matmul_ref`, the plain version.

:func:`quant_linear` is what a quantized layer (``nn/core.QuantLinear``)
calls, with the JAX dispatch order: int8 activations (:func:`w8a8_matmul`)
at ``M >= W8A8_MIN_ROWS`` when that is set; else K4 where the shape is
eligible on a CUDA tensor; else the dequantize formulation (the plain version,
``(x @ q^T) * s`` in x's dtype, what XLA runs in JAX).
"""

from __future__ import annotations

import torch

# Rows K4 takes: the weight-streaming regime (JAX's _MAX_M).  Larger M goes to
# the dequantize formulation, as in JAX.
_MAX_M = 64
# K4's k step: 16 weight bytes a thread, 4 threads a row
_K_STEP = 64
# Warps K4 aims to put on the card (132 SMs x 16): a product with few output
# columns is split over K to reach it, the partial sums reduced by a second pass.
_TARGET_WARPS = 132 * 16
_MIN_K_STEPS = 4  # k steps of one split at least

# JAX ships its kernel off (KERNEL_DISPATCH = False, a TPU v5e measurement);
# the port dispatches K4 for every eligible shape on a CUDA tensor.  A plain
# reference run (chip_smoke's kernel-vs-plain comparison) turns it off.
KERNEL_DISPATCH = True

# W8A8: when set, quant_linear runs int8 activations x int8 weights for
# matmuls of at least this many rows (the batched prefill);
# exp inference_quantize="w8a8" sets 2048.  None = weight-only.
W8A8_MIN_ROWS: int | None = None


def quant_matmul_eligible(M: int, K: int, N: int) -> bool:
    """Does K4 take this shape?  At most _MAX_M rows and K a multiple of its
    64-deep k step; any N (the kernel masks the ragged column edge)."""
    return 1 <= M <= _MAX_M and K % _K_STEP == 0 and K > 0 and N > 0


def quant_matmul_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: ``(x @ q^T) * s`` in x's dtype (JAX's XLA formulation)."""
    return (x @ q.t().to(x.dtype)) * s.to(x.dtype)


def k_splits(N: int, K: int) -> int:
    """How many K ranges K4 splits a product into (1 = no second pass)."""
    tiles = -(-N // 8)  # one warp per 8 output columns and K range
    want = -(-_TARGET_WARPS // tiles)
    return max(1, min(want, K // _K_STEP // _MIN_K_STEPS))


def _launch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    from dexbotic_tpu_torch.kernels import build

    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K4 takes bf16 or fp32 activations, got {x.dtype}")
    if q.dtype != torch.int8 or s.dtype != x.dtype:
        raise TypeError(f"K4 takes int8 weights and scales in x's dtype, got {q.dtype}, {s.dtype}")
    if x.ndim != 2 or q.ndim != 2 or s.shape != (q.shape[0],) or x.shape[1] != q.shape[1]:
        raise ValueError(f"K4 shapes: x {tuple(x.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)}")
    M, K = x.shape
    N = q.shape[0]
    if not quant_matmul_eligible(M, K, N):
        raise ValueError(f"K4 does not take M={M} K={K} N={N}")
    for name, t in (("x", x), ("q", q), ("s", s)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"K4 operand {name} must be contiguous and 16-byte aligned on {x.device}")
    splits = k_splits(N, K)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    part = torch.empty((splits, M, N) if splits > 1 else (0,), dtype=torch.float32,
                       device=x.device)
    code = build.load().dbx_quant_matmul(
        int(x.dtype == torch.bfloat16), x.data_ptr(), q.data_ptr(), s.data_ptr(),
        out.data_ptr(), part.data_ptr() if splits > 1 else None, M, N, K, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
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
