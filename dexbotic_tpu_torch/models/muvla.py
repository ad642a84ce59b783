"""MUVLA: the map-understanding VLA with two towers and a reward head
(port of dexbotic_tpu/models/muvla.py).

* two vision towers: the MAP view through ``vit`` (the VLM's tower), the
  observation views through ``obs_vit``;
* the history views compressed by a QFormer (``num_history_queries``
  learned queries, one attention over the history's tokens, LayerNorm);
* ``fuser`` (CrossFuseReduce): the observation tokens (history queries,
  then the current view's) attend into the map's tokens, then residual +
  LayerNorm; the fused tokens go through the projector into the LLM, where
  they fill the prompt's image slots;
* the loss: per-sample CE weighted by (1 + sigmoid(reward)), plus 0.5 x an
  expectile-0.9 regression of the last position's reward prediction;
* generation: ``models/generate.generate`` over the spliced prompt embeds.

The fuser's and the QFormer's attention is the plain version
(``impl="xla"``), as the JAX model calls ``attention_xla``; the decoder's is
K1 (and K3 in training) on a CUDA device.  The module has the VLM's
``llm``, ``vit`` and ``projector``, so ``models/vlm`` functions take it as
the VLM.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from dexbotic_tpu_torch.constants import IGNORE_INDEX
from dexbotic_tpu_torch.models.generate import generate
from dexbotic_tpu_torch.models.vlm import VLMConfig, splice_image_embeds, vlm_forward
from dexbotic_tpu_torch.nn import core
from dexbotic_tpu_torch.nn.projector import Projector, apply_projector, init_projector_
from dexbotic_tpu_torch.nn.transformer import Transformer, init_transformer_, lm_logits
from dexbotic_tpu_torch.nn.vit import ViT, ViTConfig, init_vit_, vit_forward
from dexbotic_tpu_torch.ops.attention import attention
from dexbotic_tpu_torch.ops.norms import LayerNorm


@dataclasses.dataclass(frozen=True)
class MUVLAConfig:
    vlm: VLMConfig  # the LLM, the MAP tower and the projector
    obs_vit: ViTConfig
    inter_dim: int = 1024
    num_history_queries: int = 192
    fuse_heads: Optional[int] = None  # default inter_dim // 64
    expectile: float = 0.9

    @property
    def heads(self) -> int:
        return self.fuse_heads or self.inter_dim // 64

    def num_fused_tokens(self, n_views: int) -> int:
        """The fused tokens a prompt holds slots for: the history queries
        (when there are history views) and the current view's tokens."""
        n = self.obs_vit.num_output_tokens
        if n_views > 1:
            n += self.num_history_queries
        return n


class MHA(nn.Module):
    """Multi-head attention with q/k/v/o projections (biases)."""

    def __init__(self, dim: int):
        super().__init__()
        self.q, self.k, self.v, self.o = (core.Linear(dim, dim) for _ in range(4))


def mha(p: MHA, query: torch.Tensor, kv: torch.Tensor, heads: int) -> torch.Tensor:
    """Every query sees every key: the plain attention, as JAX's ``_mha``."""
    B, N, D = query.shape
    M = kv.shape[1]
    hd = D // heads
    q = p.q(query).reshape(B, N, heads, hd)
    k, v = (lin(kv).reshape(B, M, heads, hd) for lin in (p.k, p.v))
    zeros = torch.zeros((B, N), dtype=torch.int32, device=query.device)
    kv_grp = torch.zeros((B, M), dtype=torch.int32, device=query.device)
    a = attention(q, k, v, zeros, kv_grp, torch.ones_like(kv_grp), impl="xla")
    return p.o(a.reshape(B, N, D))


class Fuser(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.attn = MHA(dim)
        self.ln = LayerNorm(dim, eps=1e-5)


class QFormer(nn.Module):
    def __init__(self, cfg: MUVLAConfig):
        super().__init__()
        d = cfg.inter_dim
        self.queries = nn.Parameter(torch.empty(cfg.num_history_queries, d))
        self.input_proj = core.Linear(cfg.obs_vit.hidden_size, d)
        self.attn = MHA(d)
        self.ln = LayerNorm(d, eps=1e-5)


class MUVLA(nn.Module):
    def __init__(self, cfg: MUVLAConfig):
        super().__init__()
        self.llm = Transformer(cfg.vlm.llm)
        self.vit = ViT(cfg.vlm.vit)  # the map tower
        self.obs_vit = ViT(cfg.obs_vit)
        self.projector = Projector(cfg.vlm.projector_type, cfg.vlm.vit.hidden_size,
                                   cfg.vlm.llm.hidden_size)
        self.fuser = Fuser(cfg.inter_dim)
        self.qformer = QFormer(cfg)
        self.reward_head = core.Linear(cfg.vlm.llm.hidden_size, 1, False)


@torch.no_grad()
def init_muvla_(model: MUVLA, gen: torch.Generator) -> None:
    """The JAX init's distributions (init_muvla), drawn from ``gen``."""
    init_transformer_(model.llm, gen)
    init_vit_(model.vit, gen)
    init_vit_(model.obs_vit, gen)
    init_projector_(model.projector, gen)
    for m in (model.fuser, model.qformer, model.reward_head):
        core.init_linears_(m, gen)
        core.reset_norms_(m)
    core.normal_init_(model.qformer.queries, gen, std=1.0)


def build_muvla(cfg: MUVLAConfig, device, seed: int = 0,
                prepare: Optional[Callable[[nn.Module], nn.Module]] = None) -> MUVLA:
    """Seeded random MUVLA built in place on ``device`` (laid out on the meta
    device, recast by ``prepare``, then materialised and initialised)."""
    device = torch.device(device)
    with torch.device("meta"):
        model = MUVLA(cfg)
    if prepare is not None:
        model = prepare(model)
    model = model.to_empty(device=device)
    init_muvla_(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


def fuse_obs_with_history(model: MUVLA, cfg: MUVLAConfig, map_img: torch.Tensor,
                          obs_imgs: torch.Tensor) -> torch.Tensor:
    """map_img [B, H, W, 3], obs_imgs [B, N_views, H, W, 3] (view 0 the
    current one, the rest the history) -> the projected fused tokens
    [B, num_fused_tokens(N_views), llm hidden]."""
    B, N = obs_imgs.shape[:2]
    cur = vit_forward(model.obs_vit, cfg.obs_vit, obs_imgs[:, 0])
    if N > 1:
        hist = vit_forward(model.obs_vit, cfg.obs_vit,
                           obs_imgs[:, 1:].reshape((B * (N - 1),) + obs_imgs.shape[2:]))
        q = model.qformer
        memory = q.input_proj(hist.reshape(B, -1, hist.shape[-1]))
        queries = q.queries.to(memory.dtype)[None].expand(B, -1, -1)
        obs_tok = torch.cat([q.ln(mha(q.attn, queries, memory, 8)), cur], 1)
    else:
        obs_tok = cur
    map_feat = vit_forward(model.vit, cfg.vlm.vit, map_img)
    fused = model.fuser.ln(mha(model.fuser.attn, obs_tok, map_feat, cfg.heads) + obs_tok)
    return apply_projector(model.projector, fused, cfg.vlm.projector_type)


def muvla_loss(model: MUVLA, cfg: MUVLAConfig, batch: dict, generator=None, remat=False):
    """Reward-weighted CE + the expectile reward regression.

    batch: input_ids (with the fused-token slots), attention_mask, labels,
    map_images [B, H, W, 3], obs_images [B, N, H, W, 3], optional reward [B]."""
    tokens = fuse_obs_with_history(model, cfg, batch["map_images"], batch["obs_images"])
    embeds = splice_image_embeds(model, cfg.vlm, batch["input_ids"], tokens)
    hidden = vlm_forward(model, cfg.vlm, batch["input_ids"], batch["attention_mask"],
                         inputs_embeds=embeds, remat=remat)
    logits = lm_logits(model.llm, cfg.vlm.llm, hidden).float()
    labels = batch["labels"][:, 1:]
    mask = (labels != IGNORE_INDEX).float()
    safe = torch.where(labels == IGNORE_INDEX, 0, labels).long()
    nll = -torch.log_softmax(logits[:, :-1], -1).gather(-1, safe[..., None])[..., 0]
    per_sample = (nll * mask).sum(1) / mask.sum(1).clamp_min(1.0)
    reward = batch.get("reward")
    if reward is None:
        text_loss = per_sample.mean()
        return text_loss, {"text_loss": text_loss, "loss": text_loss}
    reward = reward.float()
    text_loss = (per_sample * (1.0 + torch.sigmoid(reward))).mean()
    last = model.reward_head(hidden.float())[:, -1, 0]
    diff = last - reward
    w = torch.where(diff < 0, cfg.expectile, 1.0 - cfg.expectile)
    reward_loss = (w * diff ** 2).mean()
    loss = text_loss + 0.5 * reward_loss
    return loss, {"text_loss": text_loss, "reward_loss": reward_loss, "loss": loss}


@torch.no_grad()
def muvla_generate(model: MUVLA, cfg: MUVLAConfig, input_ids: torch.Tensor, valid: torch.Tensor,
                   map_images: torch.Tensor, obs_images: torch.Tensor, max_new_tokens: int,
                   eos_token_id: int, pad_token_id: int = 0, temperature: float = 0.0,
                   generator: Optional[torch.Generator] = None):
    """Decoding over the fused map+obs tokens: fuse -> splice -> generate;
    (tokens, logprobs).  ``input_ids`` holds num_fused_tokens(N_views) slots."""
    tokens = fuse_obs_with_history(model, cfg, map_images, obs_images)
    embeds = splice_image_embeds(model, cfg.vlm, input_ids, tokens)
    return generate(model, cfg.vlm, input_ids, valid, None, max_new_tokens, eos_token_id,
                    pad_token_id=pad_token_id, temperature=temperature, generator=generator,
                    inputs_embeds=embeds)
