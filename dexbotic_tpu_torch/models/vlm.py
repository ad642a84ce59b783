"""VLM core: vision tower + projector + LLM (port of dexbotic_tpu/models/vlm.py).

The tokenizer expands each ``<image>`` tag to exactly ``num_image_tokens``
IMAGE_TOKEN_INDEX placeholders, so the splice is a cumsum gather.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from dexbotic_tpu_torch.constants import IMAGE_TOKEN_INDEX
from dexbotic_tpu_torch.nn.projector import Projector, apply_projector, init_projector_
from dexbotic_tpu_torch.nn.transformer import (
    Stream,
    Transformer,
    TransformerConfig,
    embed_tokens,
    init_transformer_,
    mot_forward,
    transformer_forward,
)
from dexbotic_tpu_torch.nn.vit import ViT, ViTConfig, init_vit_, vit_forward


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    llm: TransformerConfig
    vit: ViTConfig
    projector_type: str = "mlp2x_gelu"

    @property
    def num_image_tokens(self) -> int:
        n = self.vit.num_output_tokens
        if self.projector_type == "mlp_downsample":
            g = int(round(n ** 0.5))
            n = ((g + 1) // 2) ** 2
        return n


class VLM(nn.Module):
    def __init__(self, cfg: VLMConfig):
        super().__init__()
        self.llm = Transformer(cfg.llm)
        self.vit = ViT(cfg.vit)
        self.projector = Projector(cfg.projector_type, cfg.vit.hidden_size, cfg.llm.hidden_size)


@torch.no_grad()
def init_vlm_(vlm: VLM, gen: torch.Generator) -> None:
    init_transformer_(vlm.llm, gen)
    init_vit_(vlm.vit, gen)
    init_projector_(vlm.projector, gen)


def encode_images(vlm: VLM, cfg: VLMConfig, images: torch.Tensor, remat=False) -> torch.Tensor:
    """[B, n, H, W, 3] or [B, H, W, 3] -> [B, n*T, llm_hidden]."""
    if images.ndim == 4:
        images = images[:, None]
    B, n = images.shape[:2]
    feats = vit_forward(vlm.vit, cfg.vit, images.reshape((B * n,) + images.shape[2:]), remat=remat)
    feats = apply_projector(vlm.projector, feats, cfg.projector_type)
    return feats.reshape(B, -1, feats.shape[-1])


def splice_image_embeds(vlm: VLM, cfg: VLMConfig, input_ids: torch.Tensor,
                        image_features: torch.Tensor) -> torch.Tensor:
    """Replace placeholder ids with image features, in order, per row."""
    is_img = input_ids == IMAGE_TOKEN_INDEX
    text = embed_tokens(vlm.llm, cfg.llm, torch.where(is_img, 0, input_ids))
    idx = (torch.cumsum(is_img.to(torch.int64), dim=1) - 1).clamp(0, image_features.shape[1] - 1)
    gathered = torch.gather(image_features.to(text.dtype), 1,
                            idx[..., None].expand(-1, -1, text.shape[-1]))
    return torch.where(is_img[..., None], gathered, text)


def vlm_forward(vlm: VLM, cfg: VLMConfig, input_ids: torch.Tensor, valid: torch.Tensor,
                images: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                grp: Optional[torch.Tensor] = None, remat=False,
                cache: Optional[dict] = None, update_cache: bool = False,
                write_cols=None):
    """Causal VLM forward: the final-normed last hidden states [B, S, H], or
    (hidden, cache) when a cache is given or written (``update_cache``).

    With a cache, groups and positions continue per row after its valid
    tokens; see ``nn/transformer.mot_forward`` for the cache modes and
    ``write_cols`` (per-row cache columns, the decode engine's).
    ``remat`` (False | True | "dots") checkpoints every ViT and decoder
    layer."""
    if write_cols is not None and (cache is None or not update_cache):
        raise ValueError("write_cols writes into a given cache (update_cache=True)")
    if inputs_embeds is None:
        if images is not None:
            feats = encode_images(vlm, cfg, images, remat=remat)
            inputs_embeds = splice_image_embeds(vlm, cfg, input_ids, feats)
        else:
            inputs_embeds = embed_tokens(vlm.llm, cfg.llm, input_ids)
    valid = valid.to(torch.int32)
    before = 0
    if cache is not None and (grp is None or positions is None):
        before = cache["valid"].sum(1, keepdim=True, dtype=torch.int32)
    if grp is None:
        grp = torch.cumsum(valid, dim=1, dtype=torch.int32) + before
    if positions is None:
        positions = torch.cumsum(valid, dim=1, dtype=torch.int32) - 1 + before
    if cache is None and not update_cache:
        return transformer_forward(cfg.llm, vlm.llm, inputs_embeds, positions, grp, valid,
                                   remat=remat)
    outs, cache = mot_forward([Stream(cfg.llm, vlm.llm, inputs_embeds)], positions, grp, valid,
                              cache=cache, update_cache=update_cache, remat=remat,
                              write_cols=write_cols)
    return outs[0], cache


def last_valid_index(valid: torch.Tensor) -> torch.Tensor:
    """Index of the last non-padding token per row (right- or left-padded)."""
    cs = torch.cumsum(valid.to(torch.int32), dim=1)
    return (cs == cs[:, -1:]).to(torch.int32).argmax(dim=1)


def gather_last_hidden(hidden: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, S, H], [B, S] -> [B, H] hidden state at the last valid token."""
    idx = last_valid_index(valid)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
