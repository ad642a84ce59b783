"""On-device image preprocessing: PIL-parity antialiased resize as two products.

Port of dexbotic_tpu/ops/image_ops.py.  PIL's resampler is a separable
convolution whose support grows with the downscale factor (antialiasing)
and whose border windows are clipped and renormalised (PIL's
precompute_coeffs, mirrored by csrc/host/fast_image.cpp).  Each axis is
therefore a fixed [out, in] weight matrix, and the resample is two fp32
products a frame, horizontal first:

    out[b, oy, ox, c] = Ty[oy, y] * img[b, y, x, c] * Tx[ox, x]

with the intermediate rounded and clipped to [0, 255] after each pass, as
PIL's clip8 does.  The matrices are built in float64 on the host once per
camera geometry and kept on the device.  The products must run at full fp32
precision (PyTorch's default, ``torch.backends.cuda.matmul.allow_tf32 =
False``): a TF32 product can move a value across a clip8 rounding.
"""

from __future__ import annotations

import numpy as np
import torch


def _bicubic_w(x: np.ndarray) -> np.ndarray:
    # PIL's bicubic filter, a = -0.5
    a = -0.5
    x = np.abs(x)
    return np.where(
        x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


def _bilinear_w(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def resize_matrix(out_n: int, in_n: int, resample: str = "bicubic") -> np.ndarray:
    """Dense [out_n, in_n] PIL-parity resampling matrix for one axis, float64."""
    support0 = 2.0 if resample == "bicubic" else 1.0
    kernel = _bicubic_w if resample == "bicubic" else _bilinear_w
    scale = in_n / out_n
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    w = np.zeros((out_n, in_n), np.float64)
    for x in range(out_n):
        center = (x + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_n)
        vals = kernel((np.arange(xmin, xmax) + 0.5 - center) / filterscale)
        total = vals.sum()
        if total != 0.0:
            vals = vals / total
        w[x, xmin:xmax] = vals
    return w


def make_device_preprocess(
    in_hw: tuple[int, int],
    size: int,
    resample: str = "bicubic",
    mean=(0.0, 0.0, 0.0),
    std=(1.0, 1.0, 1.0),
    rescale: float = 1.0 / 255.0,
    pad_to_square: bool = False,
    fill=(0, 0, 0),
    device="cuda",
):
    """A function uint8 [B, H, W, 3] -> float32 [B, size, size, 3] on ``device``.

    ``pad_to_square`` reproduces expand2square: the frame is centred on a
    max(H, W)^2 canvas filled with ``fill`` before the resize (CLIP-style
    processors' serving path)."""
    H, W = in_hw
    if pad_to_square and H != W:
        side = max(H, W)
        src_h = src_w = side
        top, left = (side - H) // 2, (side - W) // 2
    else:
        src_h, src_w = H, W
        top = left = 0
    device = torch.device(device)

    def const(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32, device=device)

    ty = const(resize_matrix(size, src_h, resample))
    tx = const(resize_matrix(size, src_w, resample))
    mean_t, inv_std = const(mean), const(1.0 / np.asarray(std, np.float64))
    fill_t = const(fill)

    def fn(frames: torch.Tensor) -> torch.Tensor:
        x = frames.to(device=device, dtype=torch.float32)
        if top or left:
            canvas = fill_t.expand(x.shape[0], src_h, src_w, 3).clone()
            canvas[:, top:top + H, left:left + W] = x
            x = canvas
        # horizontal, then vertical, each rounded and clipped (PIL's clip8)
        x = torch.einsum("jx,byxc->byjc", tx, x).round_().clamp_(0.0, 255.0)
        x = torch.einsum("iy,byxc->bixc", ty, x).round_().clamp_(0.0, 255.0)
        return (x * rescale - mean_t) * inv_std

    return fn
