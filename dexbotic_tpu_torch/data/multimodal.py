"""Multimodal frame loading: images, video frames, gray16 depth video.

Reimplements the reference's LoadMultiModal
(/root/reference/dexbotic/data/dataset/transform/multimodal.py) with
cv2-backed video decode (decord/PyAV are not available in this image) and a
per-URL frame-batch cache, plus `image_masks` for missing views.
"""

from __future__ import annotations

import io
import os
from collections import defaultdict

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from PIL import Image

from dexbotic_tpu_torch.data.io import smart_local_path, smart_open


def load_image(url: str) -> Image.Image:
    # smart_open: local paths or any registered remote scheme (data/io.py,
    # the megfile seam of the reference's multimodal loader)
    with smart_open(url, "rb") as f:
        return Image.open(io.BytesIO(f.read())).convert("RGB")


def load_video_frames(url: str, frame_indices: list[int]) -> dict[int, Image.Image]:
    """Decode the requested frames of a video in one pass."""
    if cv2 is None:
        raise RuntimeError("cv2 unavailable; cannot decode video")
    wanted = sorted(set(frame_indices))
    out = {}
    cap = cv2.VideoCapture(smart_local_path(url))
    try:
        # sequential decode up to max index (robust; seeks can be inexact)
        last = wanted[-1]
        i = 0
        wanted_set = set(wanted)
        while i <= last:
            ok, frame = cap.read()
            if not ok:
                break
            if i in wanted_set:
                out[i] = Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            i += 1
    finally:
        cap.release()
    missing = wanted_set - set(out)
    if missing:
        raise ValueError(f"missing frames {sorted(missing)} in {url}")
    return out


def load_depth_video_frames(url: str, frame_indices: list[int]) -> dict[int, np.ndarray]:
    """gray16le depth video frames (reference uses PyAV; cv2 fallback)."""
    if cv2 is None:
        raise RuntimeError("cv2 unavailable; cannot decode depth video")
    cap = cv2.VideoCapture(smart_local_path(url))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    out = {}
    wanted = set(frame_indices)
    try:
        i = 0
        last = max(wanted)
        while i <= last:
            ok, frame = cap.read()
            if not ok:
                break
            if i in wanted:
                out[i] = np.asarray(frame).astype(np.uint16)
            i += 1
    finally:
        cap.release()
    return out


class LoadMultiModal:
    """Resolve images_* / depths_* refs into 'rgb_data' / 'depth_data'.

    Each frame ref is {'type': 'image'|'video', 'url': ..., 'frame_idx': ...}.
    Views are ordered alphabetically by key and truncated to num_images;
    `image_masks` marks which of images_1..images_N exist when
    return_masks=True (multi-view pi0/DM0 style).
    """

    def __init__(self, return_masks: bool = False):
        self.return_masks = return_masks

    def __call__(self, episode: dict, **kw) -> dict:
        meta = episode["meta_data"]
        frame_indices = meta["frame_indices"]
        num_images = meta.get("num_images")
        images_keys = meta.get("images_keys")
        depths_keys = meta.get("depths_keys")
        load_depth = meta.get("load_depth", False)
        prefix = meta.get("data_path_prefix", "")

        if isinstance(frame_indices, np.ndarray):
            frame_indices = frame_indices.tolist()
        if isinstance(frame_indices, int):
            frame_indices = [frame_indices]

        if images_keys is None:
            keys = sorted(k for k in episode if k.startswith("images"))
        else:
            keys = sorted(k for k in images_keys if k in episode)
        if self.return_masks:
            masks = [f"images_{i}" in episode for i in range(1, (num_images or 0) + 1)]
            episode["image_masks"] = np.array([masks] * len(episode["prompt"]))
        if num_images is not None:
            keys = keys[:num_images]

        for key in keys:
            self._load_rgb(episode, key, frame_indices, prefix)

        episode["rgb_data"] = []
        for views in zip(*[episode[k] for k in keys]):
            episode["rgb_data"].append([v.get("data") for v in views])
        if not episode["rgb_data"]:
            episode.pop("rgb_data")
        for k in keys:
            episode.pop(k)

        if load_depth:
            dkeys = (
                sorted(k for k in episode if k.startswith("depths"))
                if depths_keys is None
                else sorted(depths_keys)
            )
            if num_images is not None:
                dkeys = dkeys[:num_images]
            for key in dkeys:
                self._load_depth(episode, key, frame_indices, prefix)
            episode["depth_data"] = []
            for views in zip(*[episode[k] for k in dkeys]):
                episode["depth_data"].append([v.get("data") for v in views])
            if not episode["depth_data"]:
                episode.pop("depth_data")
            for k in dkeys:
                episode.pop(k)
        return episode

    @staticmethod
    def _gather(refs, frame_indices):
        image_frames, video_frames = [], []
        for idx, ref in enumerate(refs):
            if frame_indices is not None and idx not in frame_indices:
                continue
            (image_frames if ref["type"] == "image" else video_frames).append((idx, ref))
        return image_frames, video_frames

    def _load_rgb(self, episode, key, frame_indices, prefix):
        image_frames, video_frames = self._gather(episode[key], frame_indices)
        per_url = defaultdict(list)
        for _, ref in video_frames:
            per_url[os.path.join(prefix, ref["url"])].append(int(ref["frame_idx"]))
        cache = {url: load_video_frames(url, idxs) for url, idxs in per_url.items()}
        for _, ref in video_frames:
            ref["data"] = cache[os.path.join(prefix, ref["url"])][int(ref["frame_idx"])]
        for _, ref in image_frames:
            ref["data"] = load_image(os.path.join(prefix, ref["url"]))

    def _load_depth(self, episode, key, frame_indices, prefix):
        _, video_frames = self._gather(episode[key], frame_indices)
        per_url = defaultdict(list)
        for _, ref in video_frames:
            per_url[os.path.join(prefix, ref["url"])].append(int(ref["frame_idx"]))
        cache = {url: load_depth_video_frames(url, idxs) for url, idxs in per_url.items()}
        for _, ref in video_frames:
            ref["data"] = cache[os.path.join(prefix, ref["url"])][int(ref["frame_idx"])]
