"""NaVILA: the multi-frame navigation VLA (port of dexbotic_tpu/models/navila.py).

A SigLIP-so400m tower and the ``mlp_downsample`` projector (196 tokens a
frame) on a LLaMA decoder; the answer is text (``parse_nav_action`` turns it
into robot actions).  Training packs the samples of a step into static rows
on the host (:func:`pack_batch`): each row holds several samples, each a
segment whose positions restart at 0, and attention is causal within a
segment and blind across segments (the segment ids of kernels K1 and K3 on
a CUDA device).  The image features of all samples come from one batched
tower call and are gathered into the packed rows.  The loss is the causal
LM loss, or NaVILA's soft CE over the numeric tokens.  Serving decodes text
over an 8-frame history (:class:`FrameHistoryBuffer`, ``models/generate.py``).
Not ported: the context-parallel packed loss (ring attention), ROADMAP
Queue 1 item 11b.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from dexbotic_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from dexbotic_tpu_torch.models.losses import causal_lm_loss, soft_cross_entropy_gaussian
from dexbotic_tpu_torch.models.vlm import VLM, VLMConfig, encode_images, init_vlm_, vlm_forward
from dexbotic_tpu_torch.nn.transformer import embed_tokens, lm_logits, transformer_forward


@dataclasses.dataclass(frozen=True)
class NaVILAConfig:
    vlm: VLMConfig
    num_video_frames: int = 8
    soft_ce_std: float = 1.0
    use_soft_ce: bool = True


class NaVILA(nn.Module):
    def __init__(self, cfg: NaVILAConfig):
        super().__init__()
        self.vlm = VLM(cfg.vlm)


def build_navila(cfg: NaVILAConfig, device, seed: int = 0,
                 prepare: Optional[Callable[[nn.Module], nn.Module]] = None) -> NaVILA:
    """Seeded random NaVILA built in place on ``device`` (laid out on the
    meta device, recast by ``prepare``, then materialised and initialised)."""
    device = torch.device(device)
    with torch.device("meta"):
        model = NaVILA(cfg)
    if prepare is not None:
        model = prepare(model)
    model = model.to_empty(device=device)
    with torch.no_grad():
        init_vlm_(model.vlm, torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Host-side sequence packing
# ---------------------------------------------------------------------------


def pack_batch(input_ids: np.ndarray, labels: np.ndarray, valid: np.ndarray, num_rows: int,
               max_len: int, pad_token_id: int = 0) -> dict:
    """Pack de-padded samples, longest first, each into the first of
    ``num_rows`` rows of ``max_len`` with room for it; a sample that fits no
    row is dropped with a warning.

    Returns input_ids / labels / attention_mask / positions / segments and
    ``img_index``, all [num_rows, max_len]: positions restart at 0 in each
    segment, segments number the samples (-1 on padding), the label at a
    segment's start is IGNORE_INDEX (the shifted loss never predicts across
    segments), and ``img_index`` is each image slot's row in the
    [B * tokens_per_sample] image features of the unpacked batch."""
    B = input_ids.shape[0]
    lens = valid.sum(1).astype(int)
    order = np.argsort(-lens)
    n_img = (input_ids == IMAGE_TOKEN_INDEX).sum(1).astype(int)
    tokens_per_sample = int(n_img.max()) if B else 0

    out_ids = np.full((num_rows, max_len), pad_token_id, input_ids.dtype)
    out_labels = np.full((num_rows, max_len), IGNORE_INDEX, labels.dtype)
    out_valid = np.zeros((num_rows, max_len), np.int32)
    out_pos = np.zeros((num_rows, max_len), np.int32)
    out_seg = np.full((num_rows, max_len), -1, np.int32)
    out_img = np.zeros((num_rows, max_len), np.int32)
    row_fill = np.zeros(num_rows, int)
    seg_counter = 0
    for i in order:
        L = lens[i]
        r = next((r for r in range(num_rows) if row_fill[r] + L <= max_len), None)
        if r is None:
            warnings.warn(f"pack_batch: dropped sequence of length {L}")
            continue
        s = row_fill[r]
        sel = valid[i].astype(bool)
        seq = input_ids[i][sel]
        out_ids[r, s: s + L] = seq
        out_labels[r, s: s + L] = labels[i][sel]
        out_labels[r, s] = IGNORE_INDEX
        out_valid[r, s: s + L] = 1
        out_pos[r, s: s + L] = np.arange(L)
        out_seg[r, s: s + L] = seg_counter
        is_img = seq == IMAGE_TOKEN_INDEX
        out_img[r, s: s + L] = np.where(is_img, i * tokens_per_sample + np.cumsum(is_img) - 1, 0)
        row_fill[r] += L
        seg_counter += 1
    return {"input_ids": out_ids, "labels": out_labels, "attention_mask": out_valid,
            "positions": out_pos, "segments": out_seg, "img_index": out_img}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def packed_embeds(model: NaVILA, cfg: NaVILAConfig, batch: dict, remat=False) -> torch.Tensor:
    """The packed rows' input embeddings [R, L, H]: one tower call over the K
    unpacked samples' frames ``images`` [K, n_frames, H, W, 3], whose features
    are gathered into the image slots by ``img_index``.  ``remat``
    checkpoints the tower's layers (the JAX loss runs the tower without
    remat; the values are the same)."""
    feats = encode_images(model.vlm, cfg.vlm, batch["images"], remat=remat)  # [K, NT, H]
    K, NT, H = feats.shape
    ids = batch["input_ids"]
    is_img = ids == IMAGE_TOKEN_INDEX
    text = embed_tokens(model.vlm.llm, cfg.vlm.llm, torch.where(is_img, 0, ids))
    idx = batch["img_index"].long().clamp(0, K * NT - 1)
    gathered = feats.reshape(K * NT, H).to(text.dtype)[idx]
    return torch.where(is_img[..., None], gathered, text)


def navila_forward_packed(model: NaVILA, cfg: NaVILAConfig, packed: dict,
                          images_embeds: torch.Tensor, remat=False) -> torch.Tensor:
    """The decoder over packed rows: causal within each segment (groups =
    positions + 1, positions restarting a segment), blind across segments."""
    positions = packed["positions"].to(torch.int32)
    return transformer_forward(cfg.vlm.llm, model.vlm.llm, images_embeds, positions,
                               positions + 1, packed["attention_mask"].to(torch.int32),
                               q_seg=packed["segments"].to(torch.int32), remat=remat)


def _text_loss(model, cfg, hidden, labels, soft_tokens):
    logits = lm_logits(model.vlm.llm, cfg.vlm.llm, hidden)
    if cfg.use_soft_ce and soft_tokens is not None:
        loss = soft_cross_entropy_gaussian(logits, labels, soft_tokens, std=cfg.soft_ce_std)
    else:
        loss = causal_lm_loss(logits, labels)
    return loss, {"text_loss": loss, "loss": loss}


def navila_packed_loss(model: NaVILA, cfg: NaVILAConfig, batch: dict,
                       soft_tokens: Optional[torch.Tensor] = None, remat=False):
    """(loss, metrics) over packed rows: ``batch`` holds pack_batch's arrays
    [R, L] and ``images`` [K, n_frames, H, W, 3] of the K unpacked samples."""
    embeds = packed_embeds(model, cfg, batch, remat=remat)
    hidden = navila_forward_packed(model, cfg, batch, embeds, remat=remat)
    return _text_loss(model, cfg, hidden, batch["labels"], soft_tokens)


def navila_packed_loss_cp(*args, **kwargs):
    raise NotImplementedError("the context-parallel packed loss (ring attention over a 'seq' "
                              "mesh axis) is not ported yet: ROADMAP Queue 1 item 11b")


def navila_loss(model: NaVILA, cfg: NaVILAConfig, batch: dict,
                soft_tokens: Optional[torch.Tensor] = None, remat=False):
    """(loss, metrics) of unpacked rows: the VLM's causal LM loss, or the soft
    CE over the numeric tokens; ``images`` [B, n_frames, H, W, 3]."""
    hidden = vlm_forward(model.vlm, cfg.vlm, batch["input_ids"], batch["attention_mask"],
                         images=batch["images"], remat=remat)
    return _text_loss(model, cfg, hidden, batch["labels"], soft_tokens)


# ---------------------------------------------------------------------------
# Serving helpers
# ---------------------------------------------------------------------------


class FrameHistoryBuffer:
    """The served frame history: a short history is padded at the front
    with black frames (zeros like the first frame, unless ``pad_frame``),
    ``num_frames - 1`` history frames are taken at
    ``linspace(0, n - 1, endpoint=False)``, and the latest frame comes last."""

    def __init__(self, num_frames: int = 8, pad_frame=None):
        self.num_frames = num_frames
        self.pad_frame = pad_frame
        self.frames: list = []

    def reset(self) -> None:
        self.frames = []

    def add(self, frame) -> list:
        self.frames.append(frame)
        return self.sample()

    def sample(self) -> list:
        frames = list(self.frames)
        if len(frames) < self.num_frames:
            pad = self.pad_frame if self.pad_frame is not None else np.zeros_like(
                np.asarray(frames[0]))
            frames = [pad] * (self.num_frames - len(frames)) + frames
        idx = np.linspace(0, len(frames) - 1, num=self.num_frames - 1, endpoint=False, dtype=int)
        return [frames[i] for i in idx] + [frames[-1]]


_NAV_PATTERNS = {0: re.compile(r"\bstop\b", re.IGNORECASE),
                 1: re.compile(r"\bis move forward\b", re.IGNORECASE),
                 2: re.compile(r"\bis turn left\b", re.IGNORECASE),
                 3: re.compile(r"\bis turn right\b", re.IGNORECASE)}


def parse_nav_action(text: str) -> list:
    """Generated text -> the env's action ints: 0 stop, 1 forward, 2 left,
    3 right.  'move forward N cm' repeats 1 N // 25 times (N snapped to 25,
    50 or 75), a turn of N degrees repeats N // 15 times (snapped to 15, 30
    or 45); a missing magnitude is 25 cm or 15 degrees; any other text is
    [0]."""
    action = next((a for a, pat in _NAV_PATTERNS.items() if pat.search(text)), None)

    def magnitude(pattern, default, steps):
        m = re.search(pattern, text)
        try:
            v = int(m.group(1))
        except (AttributeError, ValueError):
            v = default
        if v % steps[0] != 0:
            v = min(steps, key=lambda x: abs(x - v))
        return v

    if action == 1:
        return [1] * (magnitude(r"move forward (\d+) cm", 25, [25, 50, 75]) // 25)
    if action == 2:
        return [2] * (magnitude(r"turn left (\d+) degree", 15, [15, 30, 45]) // 15)
    if action == 3:
        return [3] * (magnitude(r"turn right (\d+) degree", 15, [15, 30, 45]) // 15)
    return [0]
