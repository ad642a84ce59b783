"""ctypes bindings for the native C++ image-preprocessing kernel.

Builds csrc/host/fast_image.cpp on first use (g++, cached in _build/);
falls back cleanly when no compiler is available — callers should use
`preprocess_batch_fast` / `pad_preprocess_batch_fast`, which mirror
`preprocess_image` / expand2square->processor semantics for batches of
identically-sized uint8 frames (PIL/HF-processor-parity antialiased
bilinear or bicubic; tests pin <=2 uint8 quanta vs PIL — do NOT
reintroduce cv2-matching behavior, cv2 resize is not what HF processors
do).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_LOCK = threading.Lock()
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc", "host")
_BUILD = os.path.join(_PKG, "_build")

INTERP = {"bilinear": 0, "bicubic": 1}


def _build_and_load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        src = os.path.join(_CSRC, "fast_image.cpp")
        so = os.path.join(_BUILD, "libfastimage.so")
        if not os.path.exists(src):
            raise FileNotFoundError(src)
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            os.makedirs(_BUILD, exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", so, src, "-lpthread"],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(so)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.preprocess_batch.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.pad_preprocess_batch.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.expand2square_u8.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int, u8p,
        ]
        _LIB = lib
        return lib


def available() -> bool:
    try:
        _build_and_load()
        return True
    except Exception:  # noqa: BLE001
        return False


def preprocess_batch_fast(
    images: np.ndarray,  # uint8 [B, H, W, 3]
    size: int,
    mean=(0.5, 0.5, 0.5),
    std=(0.5, 0.5, 0.5),
    num_threads: int = 8,
    interp: str = "bilinear",
    channel_order: str = "rgb",
) -> np.ndarray:
    """Fused resize + rescale + normalize -> float32 [B, size, size, 3].

    channel_order='bgr' folds the cv2.imdecode BGR->RGB reorder into the
    kernel's float conversion (fill/mean/std remain RGB)."""
    lib = _build_and_load()
    images = np.ascontiguousarray(images, dtype=np.uint8)
    b, h, w, c = images.shape
    assert c == 3
    out = np.empty((b, size, size, 3), np.float32)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    lib.preprocess_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size, size,
        mean_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads, INTERP[interp], int(channel_order == "bgr"),
    )
    return out


def pad_preprocess_batch_fast(
    images: np.ndarray,  # uint8 [B, H, W, 3]
    size: int,
    mean=(0.5, 0.5, 0.5),
    std=(0.5, 0.5, 0.5),
    fill=(0, 0, 0),
    num_threads: int = 8,
    interp: str = "bilinear",
    channel_order: str = "rgb",
) -> np.ndarray:
    """Fused centered pad-to-square + resize + rescale + normalize.

    One pass over the output — no intermediate padded uint8 frame.  Matches
    expand2square(fill) -> preprocess_image (the CogACT serving image path,
    reference dexbotic_arch.py:516-529)."""
    lib = _build_and_load()
    images = np.ascontiguousarray(images, dtype=np.uint8)
    b, h, w, c = images.shape
    assert c == 3
    out = np.empty((b, size, size, 3), np.float32)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    fill_a = np.asarray(fill, np.uint8)
    lib.pad_preprocess_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size, size,
        mean_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fill_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_threads, INTERP[interp], int(channel_order == "bgr"),
    )
    return out


def expand2square_fast(image: np.ndarray, fill=(0, 0, 0)) -> np.ndarray:
    lib = _build_and_load()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, _ = image.shape
    side = max(h, w)
    out = np.empty((side, side, 3), np.uint8)
    fill_a = np.asarray(fill, np.uint8)
    lib.expand2square_u8(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), side,
        fill_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out
