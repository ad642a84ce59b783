"""Host-side image preprocessing (numpy/cv2; no torchvision/albumentations).

Equivalent surface to the reference's PreprocessRGB + HF image processors
(/root/reference/dexbotic/data/dataset/rgb_preprocess.py) and its PixelAug
augmentation policies (augmentations.py): pad-to-square, resize, rescale,
normalize, and pixel-level augmentation, producing NHWC float32 arrays for
the NHWC-native ViT.
"""

from __future__ import annotations

import dataclasses

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# Standard normalization constants.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ImageProcessorConfig:
    size: int = 224
    mean: tuple = SIGLIP_MEAN
    std: tuple = SIGLIP_STD
    resample: str = "bicubic"
    rescale: float = 1.0 / 255.0

    @classmethod
    def clip_336(cls):
        return cls(size=336, mean=CLIP_MEAN, std=CLIP_STD)

    @classmethod
    def siglip(cls, size=384):
        return cls(size=size, mean=SIGLIP_MEAN, std=SIGLIP_STD)


_CV2_INTERP = {"bicubic": 2, "bilinear": 1, "nearest": 0}  # cv2.INTER_CUBIC/LINEAR/NEAREST


def to_numpy_image(image) -> np.ndarray:
    """PIL.Image | ndarray -> uint8 HWC RGB ndarray."""
    if isinstance(image, np.ndarray):
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        return image
    return np.asarray(image.convert("RGB"))


def expand2square(image: np.ndarray, fill: tuple[int, int, int]) -> np.ndarray:
    """Pad to square, centered (dexbotic_arch.py:516-529 semantics)."""
    h, w = image.shape[:2]
    if h == w:
        return image
    side = max(h, w)
    out = np.empty((side, side, 3), dtype=image.dtype)
    out[:, :] = np.asarray(fill, dtype=image.dtype)
    top = (side - h) // 2
    left = (side - w) // 2
    out[top : top + h, left : left + w] = image
    return out


def resize(image: np.ndarray, size: int, resample: str = "bicubic") -> np.ndarray:
    if image.shape[0] == size and image.shape[1] == size:
        return image
    if cv2 is not None:
        return cv2.resize(image, (size, size), interpolation=_CV2_INTERP[resample])
    # numpy fallback: nearest
    ys = (np.arange(size) * image.shape[0] / size).astype(int)
    xs = (np.arange(size) * image.shape[1] / size).astype(int)
    return image[ys][:, xs]


_PIL_INTERP = {"bicubic": 3, "bilinear": 2, "nearest": 0}  # PIL.Image.Resampling


def resize_pil(image: np.ndarray, size: int, resample: str) -> np.ndarray:
    """PIL filter-based resample — the reference's HF image-processor
    semantics (proper antialiased downscale; NOT cv2's fixed-tap interp)."""
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        return resize(image, size, resample)
    if image.shape[0] == size and image.shape[1] == size:
        return image
    return np.asarray(
        Image.fromarray(image).resize((size, size), _PIL_INTERP[resample])
    )


def preprocess_image(image, cfg: ImageProcessorConfig) -> np.ndarray:
    """uint8 HWC -> normalized float32 HWC at cfg.size (HF processor parity:
    PIL resample, then rescale + normalize)."""
    arr = to_numpy_image(image)
    if arr.dtype == np.uint8 and cfg.resample in _PIL_INTERP:
        arr = resize_pil(arr, cfg.size, cfg.resample)
    else:
        arr = resize(arr, cfg.size, cfg.resample)
    arr = arr.astype(np.float32) * cfg.rescale
    return (arr - np.asarray(cfg.mean, np.float32)) / np.asarray(cfg.std, np.float32)


def preprocess_images_batch(
    images, cfg: ImageProcessorConfig, use_native: bool = True,
    pad_fill: tuple | None = None, channel_order: str = "rgb",
) -> np.ndarray:
    """Batch of identically-sized uint8 frames -> [B, size, size, 3] float32.

    Uses the fused C++ kernel (csrc/fast_image.cpp, PIL/HF-processor-parity
    antialiased resampling — tests pin <=2 uint8 quanta vs PIL) when
    available and the frames share a shape; falls back to the per-image
    path.  With pad_fill set, fuses a centered pad-to-square (expand2square
    semantics) into the same pass — the serving image path."""
    arrs = [to_numpy_image(im) for im in images]
    native_ok = (
        use_native
        and len({a.shape for a in arrs}) == 1
        and arrs[0].dtype == np.uint8
        and cfg.resample in ("bilinear", "bicubic")
        and abs(cfg.rescale - 1.0 / 255.0) < 1e-12
    )
    if native_ok:
        try:
            from dexbotic_tpu_torch.data import fast_image

            if pad_fill is not None:
                return fast_image.pad_preprocess_batch_fast(
                    np.stack(arrs), cfg.size, mean=cfg.mean, std=cfg.std,
                    fill=pad_fill, interp=cfg.resample,
                    channel_order=channel_order,
                )
            return fast_image.preprocess_batch_fast(
                np.stack(arrs), cfg.size, mean=cfg.mean, std=cfg.std,
                interp=cfg.resample, channel_order=channel_order,
            )
        except Exception:  # noqa: BLE001 (no toolchain)
            pass
    if channel_order == "bgr":
        arrs = [a[:, :, ::-1] for a in arrs]
    if pad_fill is not None:
        arrs = [expand2square(a, pad_fill) for a in arrs]
    return np.stack([preprocess_image(a, cfg) for a in arrs])


# ---------------------------------------------------------------------------
# Augmentation policies (host-side numpy; reference augmentations.py surface)
# ---------------------------------------------------------------------------


# Individual transforms, parameter-faithful to the reference's
# albumentations stacks (augmentations.py:135-233).  Each takes/returns
# uint8 RGB HWC and draws from the policy rng.


def _color_jitter(img, rng, brightness, contrast, saturation, hue):
    """torchvision-semantics ColorJitter (what A.ColorJitter implements):
    factors ~ U[max(0,1-x), 1+x], hue ~ U[-h, h], applied in random order."""
    fb = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    fc = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    fs = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    fh = rng.uniform(-hue, hue)

    def bri(x):
        return np.clip(x.astype(np.float32) * fb, 0, 255)

    def con(x):
        xf = x.astype(np.float32)
        gray_mean = (0.299 * xf[..., 0] + 0.587 * xf[..., 1] + 0.114 * xf[..., 2]).mean()
        return np.clip(xf * fc + gray_mean * (1 - fc), 0, 255)

    def sat(x):
        xf = x.astype(np.float32)
        gray = (0.299 * xf[..., 0] + 0.587 * xf[..., 1] + 0.114 * xf[..., 2])[..., None]
        return np.clip(xf * fs + gray * (1 - fs), 0, 255)

    def hue_fn(x):
        if cv2 is None:
            return x.astype(np.float32)
        hsv = cv2.cvtColor(x.astype(np.uint8), cv2.COLOR_RGB2HSV).astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] + fh * 180.0) % 180.0
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB).astype(np.float32)

    ops = [bri, con, sat, hue_fn]
    for i in rng.permutation(4):
        img = ops[i](img)
    return img.astype(np.uint8)


def _pad_to_square(img, fill=0):
    """Centered constant pad to square (the reference's PadToSquare
    DualTransform semantics, augmentations.py:24-133)."""
    h, w = img.shape[:2]
    size = max(h, w)
    if h == w:
        return img
    top = (size - h) // 2
    left = (size - w) // 2
    out = np.full((size, size) + img.shape[2:], fill, img.dtype)
    out[top : top + h, left : left + w] = img
    return out


def _random_resized_crop(img, rng, size, scale, ratio=(1.0, 1.0)):
    """Area-based RandomResizedCrop at fixed ratio (torchvision sampling)."""
    h, w = img.shape[:2]
    area = h * w
    s = rng.uniform(*scale)
    r = rng.uniform(*ratio)
    cw = int(round(np.sqrt(area * s * r)))
    ch = int(round(np.sqrt(area * s / r)))
    cw, ch = min(cw, w), min(ch, h)
    top = int(rng.integers(0, h - ch + 1))
    left = int(rng.integers(0, w - cw + 1))
    crop = img[top : top + ch, left : left + cw]
    return resize(crop, size, "bilinear")


def _rotate(img, rng, limit=(-5, 5)):
    if cv2 is None:
        return img
    angle = rng.uniform(*limit)
    h, w = img.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    return cv2.warpAffine(img, m, (w, h), borderMode=cv2.BORDER_REFLECT_101)


def _coarse_dropout(img, rng, num_holes=(3, 6), hole_frac=(0.05, 0.2)):
    """Random-uniform-filled holes (A.CoarseDropout fill='random_uniform')."""
    img = img.copy()
    h, w = img.shape[:2]
    for _ in range(int(rng.integers(num_holes[0], num_holes[1] + 1))):
        hh = max(1, int(h * rng.uniform(*hole_frac)))
        ww = max(1, int(w * rng.uniform(*hole_frac)))
        top = int(rng.integers(0, max(1, h - hh)))
        left = int(rng.integers(0, max(1, w - ww)))
        img[top : top + hh, left : left + ww] = rng.integers(
            0, 256, (hh, ww) + img.shape[2:], dtype=np.uint8
        )
    return img


def _gauss_noise(img, rng, std_range=(0.1, 0.22)):
    std = rng.uniform(*std_range) * 255.0
    noisy = img.astype(np.float32) + rng.normal(0, std, img.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def _additive_noise(img, rng, limit=0.1):
    noisy = img.astype(np.float32) + rng.uniform(-limit * 255, limit * 255, img.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def _rgb_shift(img, rng, limit=20):
    shift = rng.uniform(-limit, limit, (1, 1, 3))
    return np.clip(img.astype(np.float32) + shift, 0, 255).astype(np.uint8)


def _salt_and_pepper(img, rng, amount=(0.01, 0.06), salt_vs_pepper=(0.4, 0.6)):
    img = img.copy()
    a = rng.uniform(*amount)
    svp = rng.uniform(*salt_vs_pepper)
    mask = rng.random(img.shape[:2]) < a
    salt = rng.random(img.shape[:2]) < svp
    img[mask & salt] = 255
    img[mask & ~salt] = 0
    return img


def _motion_blur(img, rng, ksizes=(3, 5, 7)):
    if cv2 is None:
        return img
    k = int(rng.choice(ksizes))
    kernel = np.zeros((k, k), np.float32)
    if rng.random() < 0.5:
        kernel[k // 2, :] = 1.0
    else:
        kernel[:, k // 2] = 1.0
    kernel /= kernel.sum()
    return cv2.filter2D(img, -1, kernel)


def _median_blur(img, rng, ksizes=(3, 5, 7)):
    if cv2 is None:
        return img
    return cv2.medianBlur(img, int(rng.choice(ksizes)))


def _gaussian_blur(img, rng, ksizes=(3, 5, 7)):
    if cv2 is None:
        return img
    k = int(rng.choice(ksizes))
    return cv2.GaussianBlur(img, (k, k), 0)


def _sharpen(img, rng, alpha=(0.2, 0.5), lightness=(0.5, 1.0)):
    if cv2 is None:
        return img
    a = rng.uniform(*alpha)
    l = rng.uniform(*lightness)
    kernel = np.array([[-1, -1, -1], [-1, 8 + l, -1], [-1, -1, -1]], np.float32)
    sharp = cv2.filter2D(img, -1, kernel / kernel.sum())
    out = (1 - a) * img.astype(np.float32) + a * sharp.astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


def _random_gamma(img, rng, gamma=(0.8, 1.2)):
    g = rng.uniform(*gamma)
    out = ((img.astype(np.float32) / 255.0) ** g) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def _iso_noise(img, rng, color_shift=(0.01, 0.05), intensity=(0.1, 0.5)):
    inten = rng.uniform(*intensity)
    cshift = rng.uniform(*color_shift)
    lum_noise = rng.normal(0, inten * 30.0, img.shape[:2])[..., None]
    col_noise = rng.normal(0, cshift * 255.0, img.shape)
    out = img.astype(np.float32) + lum_noise + col_noise
    return np.clip(out, 0, 255).astype(np.uint8)


def _illumination(img, rng, limit=0.2):
    """Linear brightness gradient across a random direction."""
    h, w = img.shape[:2]
    strength = rng.uniform(-limit, limit)
    if rng.random() < 0.5:
        field = np.linspace(-1, 1, w)[None, :, None]
    else:
        field = np.linspace(-1, 1, h)[:, None, None]
    out = img.astype(np.float32) * (1.0 + strength * field)
    return np.clip(out, 0, 255).astype(np.uint8)


def _shot_noise(img, rng, scale_range=(0.02, 0.1)):
    s = rng.uniform(*scale_range)
    lam = img.astype(np.float32) / 255.0 / max(s, 1e-6)
    noisy = rng.poisson(np.maximum(lam, 0)) * s * 255.0
    return np.clip(noisy, 0, 255).astype(np.uint8)


class PixelAug:
    """Named augmentation policies, parameter-faithful to the reference's
    albumentations stacks (augmentations.py:135-233):

      v1        CoarseDropout(3-6 random-uniform holes, 5-20%, p)
      v2        SomeOf(n=2) over [OneOf(noise, p=.2), OneOf(blur, p=.8),
                SomeOf([gamma, iso, illumination, shot], n=2), CoarseDropout]
      v3        RandomResizedCrop(384, scale .95-1, p) + ColorJitter(.3/.4/.5/.08, p)
      pi0       PadToSquare + RRC(224, scale .95) + Rotate(±5°) + CJ(.3/.4/.5/.1, p)
      dm0       PadToSquare + RRC(728, scale .95) + Rotate(±5°) + CJ(.3/.4/.5/.1, p)
      color     PadToSquare + CJ(.3/.4/.5/.1, p)
      color_dm0 PadToSquare + Resize(728) + CJ(.3/.4/.5/.1, p)
      identity  no-op
    """

    POLICIES = ("v1", "v2", "v3", "pi0", "dm0", "color", "color_dm0", "identity")

    def __init__(self, policy: str = "identity", seed: int | None = None, p: float = 0.5):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown aug policy {policy}")
        self.policy = policy
        self.p = p
        self.rng = np.random.default_rng(seed)

    # -- v2 building blocks -------------------------------------------------

    def _one_of(self, img, rng, members, gate_p):
        """A.OneOf: with prob gate_p pick one member (weighted by member p)
        and apply it unconditionally."""
        if rng.random() >= gate_p:
            return img
        ps = np.asarray([m[1] for m in members], np.float64)
        i = int(rng.choice(len(members), p=ps / ps.sum()))
        return members[i][0](img, rng)

    def _some_of(self, img, rng, members, n):
        """A.SomeOf: sample n distinct members (weighted by p), apply each."""
        ps = np.asarray([m[1] for m in members], np.float64)
        idx = rng.choice(len(members), size=min(n, len(members)), replace=False,
                         p=ps / ps.sum())
        for i in idx:
            img = members[int(i)][0](img, rng)
        return img

    def __call__(self, image) -> np.ndarray:
        img = to_numpy_image(image)
        if self.policy == "identity":
            return img
        rng, p = self.rng, self.p

        if self.policy == "v1":
            if rng.random() < p:
                img = _coarse_dropout(img, rng)
            return img

        if self.policy == "v2":
            noise = [(_additive_noise, p), (_rgb_shift, p), (_gauss_noise, p),
                     (_salt_and_pepper, p)]
            blur = [(_motion_blur, p), (_median_blur, p), (_gaussian_blur, p),
                    (_sharpen, p)]
            photo = [(_random_gamma, p), (_iso_noise, 0.1), (_illumination, p),
                     (_shot_noise, p)]
            stages = [
                (lambda x, r: self._one_of(x, r, noise, 0.2), 1.0),
                (lambda x, r: self._one_of(x, r, blur, 0.8), 1.0),
                (lambda x, r: self._some_of(x, r, photo, 2), 1.0),
                (lambda x, r: _coarse_dropout(x, r) if r.random() < p else x, 1.0),
            ]
            return self._some_of(img, rng, stages, 2)

        if self.policy == "v3":
            if rng.random() < p:
                img = _random_resized_crop(img, rng, 384, (0.95, 1.0))
            if rng.random() < p:
                img = _color_jitter(img, rng, 0.3, 0.4, 0.5, 0.08)
            return img

        if self.policy in ("pi0", "dm0", "color", "color_dm0"):
            img = _pad_to_square(img, fill=0)
            if self.policy == "pi0":
                img = _random_resized_crop(img, rng, 224, (0.95, 0.95))
                img = _rotate(img, rng)
            elif self.policy == "dm0":
                img = _random_resized_crop(img, rng, 728, (0.95, 0.95))
                img = _rotate(img, rng)
            elif self.policy == "color_dm0":
                img = resize(img, 728, "bilinear")
            if rng.random() < p:
                img = _color_jitter(img, rng, 0.3, 0.4, 0.5, 0.1)
            return img

        raise AssertionError(self.policy)


class PreprocessRGB:
    """None-tolerant per-view preprocessing: pad-to-square -> aug -> processor."""

    def __init__(
        self,
        processor: ImageProcessorConfig,
        image_aspect_ratio: str | None = "pad",
        augmentations: PixelAug | None = None,
        image_pad_mode: str = "mean",
    ):
        self.processor = processor
        self.image_aspect_ratio = image_aspect_ratio
        self.augmentations = augmentations
        self.image_pad_mode = image_pad_mode

    def __call__(self, image) -> np.ndarray:
        if image is None:
            return np.zeros((self.processor.size, self.processor.size, 3), np.float32)
        img = to_numpy_image(image)
        fill = None
        if self.image_aspect_ratio == "pad":
            if self.image_pad_mode == "zero":
                fill = (0, 0, 0)
            else:
                fill = tuple(int(x * 255) for x in self.processor.mean)
        if self.augmentations is None:
            # eval/serving fast path: fused native pad+resize+normalize
            return preprocess_images_batch([img], self.processor, pad_fill=fill)[0]
        if fill is not None:
            img = expand2square(img, fill)
        img = self.augmentations(img)
        return preprocess_image(img, self.processor)


class DummyRGBProcessor:
    def __call__(self, image) -> np.ndarray:
        return np.zeros((1,), np.float32)


class PreprocessDepth:
    """Aspect-keeping resize + pad for uint16 depth maps
    (reference: data/dataset/depth_preprocess.py).  Returns float32 [H, W, 1]
    in meters (mm / 1000)."""

    def __init__(self, target_size: int = 224, pad_value: float = 0.0, scale: float = 1e-3):
        self.target_size = target_size
        self.pad_value = pad_value
        self.scale = scale

    def __call__(self, depth) -> np.ndarray:
        s = self.target_size
        if depth is None:
            return np.zeros((s, s, 1), np.float32)
        d = np.asarray(depth, np.float32) * self.scale
        if d.ndim == 3:
            d = d[..., 0]
        h, w = d.shape
        r = s / max(h, w)
        nh, nw = max(1, int(round(h * r))), max(1, int(round(w * r)))
        if cv2 is not None:
            d = cv2.resize(d, (nw, nh), interpolation=1)
        else:
            ys = (np.arange(nh) * h / nh).astype(int)
            xs = (np.arange(nw) * w / nw).astype(int)
            d = d[ys][:, xs]
        out = np.full((s, s), self.pad_value, np.float32)
        top, left = (s - nh) // 2, (s - nw) // 2
        out[top : top + nh, left : left + nw] = d
        return out[..., None]
