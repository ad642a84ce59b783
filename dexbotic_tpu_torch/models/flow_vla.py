"""Flow-matching VLA family: pi0, pi0.5, DM0 on one MoT engine (port of
dexbotic_tpu/models/flow_vla.py).

One policy module, parameterised by config flags:

* pi0: PaliGemma VLM + Gemma action expert; bidirectional prefix; the suffix
  is a state token plus ``chunk_size`` action tokens fused with a sincos time
  embedding by an MLP;
* pi0.5: the same skeleton without the state token; time conditions the
  expert through adaptive RMSNorm (``silu(time_mlp_out(silu(time_mlp_in(sincos))))``);
* DM0 (and DM0-Prog, with a progress token): Qwen3 VLM + Qwen3 expert with
  qk-norm, a causal prefix, time fused as in pi0.

Training (:func:`flow_vla_loss`) runs the prefix and the noised action
suffix jointly through both streams without a cache and regresses the
expert's velocity on ``noise - actions``.  Inference prefills the prefix into
a KV cache once, then integrates the flow by Euler steps
(``ops/diffusion.flow_euler_sample``) that run the expert's suffix alone
against the frozen cache.  On a CUDA device the decoder's and the expert's
attention (head_dim 256 for Gemma, 128 for Qwen3) runs in kernel K1
(``ops/attention.py``), and its gradient in kernel K3.

The prefix is embedded in the images' dtype (fp32, as the server gives them)
and every layer casts its weights to its input's dtype, as in the JAX
package: with bf16 serving weights the decoder, the expert, their norms and
the KV cache compute in fp32.  Only K1 rounds: a CUDA fp32 attention call is
cast to bf16 at the kernel (``ops/attention.attention``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dexbotic_tpu_torch.models.vlm import VLM, VLMConfig, encode_images, init_vlm_
from dexbotic_tpu_torch.nn import core
from dexbotic_tpu_torch.nn.transformer import (
    Stream,
    Transformer,
    TransformerConfig,
    embed_tokens,
    init_transformer_,
    mot_forward,
)
from dexbotic_tpu_torch.nn.vit import ViTConfig
from dexbotic_tpu_torch.ops.diffusion import flow_euler_sample


@dataclasses.dataclass(frozen=True)
class FlowVLAConfig:
    llm: TransformerConfig
    expert: TransformerConfig
    vit: ViTConfig
    projector_type: str = "linear"
    action_dim: int = 32
    chunk_size: int = 50
    num_flow_steps: int = 10
    use_state_token: bool = True  # pi0 yes; pi0.5 / DM0 no
    adarms: bool = False  # pi0.5
    time_in_suffix: bool = True  # pi0/DM0 fuse time into action tokens
    causal_prefix: bool = False  # DM0
    progress_token: bool = False  # DM0-Prog

    @property
    def vlm(self) -> VLMConfig:
        return VLMConfig(llm=self.llm, vit=self.vit, projector_type=self.projector_type)

    @property
    def suffix_len(self) -> int:
        return self.chunk_size + (1 if self.use_state_token else 0)


def pi0_config(llm, expert, vit, **kw) -> FlowVLAConfig:
    return FlowVLAConfig(llm=llm, expert=expert, vit=vit, use_state_token=True, **kw)


def pi05_config(llm, expert, vit, **kw) -> FlowVLAConfig:
    if expert.adarms_cond_dim is None:
        raise ValueError("pi0.5 needs an adaRMS expert (adarms_cond_dim)")
    return FlowVLAConfig(llm=llm, expert=expert, vit=vit, use_state_token=False, adarms=True,
                         time_in_suffix=False, **kw)


def dm0_config(llm, expert, vit, **kw) -> FlowVLAConfig:
    return FlowVLAConfig(llm=llm, expert=expert, vit=vit, use_state_token=False,
                         causal_prefix=True, **kw)


def dm0_prog_config(llm, expert, vit, **kw) -> FlowVLAConfig:
    return FlowVLAConfig(llm=llm, expert=expert, vit=vit, use_state_token=False,
                         causal_prefix=True, progress_token=True, **kw)


class FlowVLA(nn.Module):
    """Parameters named as the JAX ``init_flow_vla`` tree (utils/bridge.py)."""

    def __init__(self, cfg: FlowVLAConfig):
        super().__init__()
        eh = cfg.expert.hidden_size
        self.vlm = VLM(cfg.vlm)
        self.expert = Transformer(cfg.expert)
        self.action_in_proj = core.Linear(cfg.action_dim, eh)
        self.action_out_proj = core.Linear(eh, cfg.action_dim)
        if cfg.use_state_token:
            self.state_proj = core.Linear(cfg.action_dim, eh)
        # pi0/DM0: [action token, sincos] -> eh; pi0.5: sincos(eh) -> eh
        self.time_mlp_in = core.Linear(2 * eh if cfg.time_in_suffix else eh, eh)
        self.time_mlp_out = core.Linear(eh, eh)
        if cfg.progress_token:
            self.progress_in_proj = core.Linear(1, eh)
            self.progress_out_proj = core.Linear(eh, 1)


@torch.no_grad()
def init_flow_vla_(model: FlowVLA, gen: torch.Generator) -> None:
    """The JAX init's distributions (init_flow_vla), drawn from ``gen``."""
    init_vlm_(model.vlm, gen)
    init_transformer_(model.expert, gen)
    for m in model.children():
        if isinstance(m, core.Linear):
            core.torch_linear_init_(m, gen)


def build_flow_vla(cfg: FlowVLAConfig, device, seed: int = 0,
                   prepare: Optional[Callable[[nn.Module], nn.Module]] = None) -> FlowVLA:
    """Seeded random flow VLA built in place on ``device``: laid out on the
    meta device, recast by ``prepare`` (a dtype policy), then materialised
    and initialised there, as ``models/cogact.build_cogact``."""
    device = torch.device(device)
    with torch.device("meta"):
        model = FlowVLA(cfg)
    if prepare is not None:
        model = prepare(model)
    model = model.to_empty(device=device)
    init_flow_vla_(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


def posemb_sincos(time: torch.Tensor, dim: int, min_period: float = 4e-3,
                  max_period: float = 4.0) -> torch.Tensor:
    """[sin, cos] embedding of scalar times [B] -> [B, dim] fp32 (the period
    table in float64 on the host, as the JAX package builds it)."""
    fraction = np.linspace(0.0, 1.0, dim // 2)
    period = min_period * (max_period / min_period) ** fraction
    scale = torch.tensor(1.0 / period * 2 * np.pi, dtype=torch.float32, device=time.device)
    arg = scale[None, :] * time.float()[:, None]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)


# ---------------------------------------------------------------------------
# Prefix / suffix embedding
# ---------------------------------------------------------------------------


def embed_prefix(model: FlowVLA, cfg: FlowVLAConfig, images: torch.Tensor,
                 image_masks: torch.Tensor, input_ids: torch.Tensor, text_mask: torch.Tensor):
    """images [B, n_views, H, W, 3], image_masks [B, n_views], input_ids and
    text_mask [B, T_text] -> (tokens [B, P, llm_hidden], input_mask [B, P],
    ar [B, P]), int32 masks; tokens in the images' dtype."""
    n = images.shape[1]
    feats = encode_images(model.vlm, cfg.vlm, images)  # [B, n * T_img, H]
    text = embed_tokens(model.vlm.llm, cfg.llm, input_ids, dtype=feats.dtype)
    img_mask = image_masks.to(torch.int32).repeat_interleave(feats.shape[1] // n, dim=1)
    tokens = torch.cat([feats, text], dim=1)
    input_mask = torch.cat([img_mask, text_mask.to(torch.int32)], dim=1)
    ar = torch.full_like(input_mask, 1 if cfg.causal_prefix else 0)
    return tokens, input_mask, ar


def embed_suffix(model: FlowVLA, cfg: FlowVLAConfig, states: Optional[torch.Tensor],
                 x_t: torch.Tensor, time: torch.Tensor, dtype=None,
                 progress: Optional[torch.Tensor] = None):
    """states [B, action_dim], x_t [B, chunk, action_dim], time [B] ->
    (tokens [B, S, expert_hidden], mask, ar, adaRMS condition or None)."""
    B = x_t.shape[0]
    dtype = dtype or x_t.dtype
    parts, ar = [], []
    if cfg.use_state_token:
        parts.append(model.state_proj(states.to(dtype))[:, None, :])
        ar.append(1)
    time_emb = posemb_sincos(time, cfg.expert.hidden_size).to(dtype)
    action_tok = model.action_in_proj(x_t.to(dtype))
    n_extra = 0
    if cfg.progress_token and progress is not None:
        # the progress token goes before the action tokens, ahead of the time fusion
        action_tok = torch.cat([model.progress_in_proj(progress.to(dtype)), action_tok], dim=1)
        n_extra = 1
    cond = None
    if cfg.time_in_suffix:
        fused = torch.cat([action_tok, time_emb[:, None, :].expand(action_tok.shape)], dim=-1)
        action_tok = model.time_mlp_out(F.silu(model.time_mlp_in(fused)))
    else:  # pi0.5: the time conditions the expert's adaRMS norms
        cond = F.silu(model.time_mlp_out(F.silu(model.time_mlp_in(time_emb))))
    parts.append(action_tok)
    ar += [1] + [0] * (cfg.chunk_size - 1 + n_extra)
    tokens = torch.cat(parts, dim=1)
    mask = torch.ones((B, tokens.shape[1]), dtype=torch.int32, device=tokens.device)
    ar = torch.tensor(ar, dtype=torch.int32, device=tokens.device)[None].expand(B, -1)
    return tokens, mask, ar, cond


def _positions_and_grp(prefix_mask, prefix_ar, suffix_mask=None, suffix_ar=None):
    """(mask, attention groups = cumsum(ar), rope positions = cumsum(mask) - 1)."""
    if suffix_mask is not None:
        mask = torch.cat([prefix_mask, suffix_mask], dim=1)
        ar = torch.cat([prefix_ar, suffix_ar], dim=1)
    else:
        mask, ar = prefix_mask, prefix_ar
    grp = torch.cumsum(ar, dim=1, dtype=torch.int32)
    positions = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    return mask, grp, positions


def _streams(model: FlowVLA, cfg: FlowVLAConfig, prefix_tokens, suffix_tokens, cond):
    return [Stream(cfg.llm, model.vlm.llm, prefix_tokens),
            Stream(cfg.expert, model.expert, suffix_tokens, cond if cfg.adarms else None)]


# ---------------------------------------------------------------------------
# Train / inference
# ---------------------------------------------------------------------------


def sample_flow_time(batch: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """[B] flow times t ~ Beta(1.5, 1), mapped to [0.001, 1) as the JAX loss
    does.  Beta(1.5, 1)'s CDF is t^1.5, so t = U^(1/1.5) for U uniform, drawn
    from ``generator`` (``torch.distributions.Beta`` takes none)."""
    u = torch.rand(batch, generator=generator, dtype=torch.float32, device=device)
    return u.pow(1.0 / 1.5) * 0.999 + 0.001


def flow_vla_loss(model: FlowVLA, cfg: FlowVLAConfig, batch: dict,
                  generator: Optional[torch.Generator] = None, remat=False,
                  noise: Optional[torch.Tensor] = None, time: Optional[torch.Tensor] = None):
    """Flow-matching MSE: (loss, {"action_loss", "loss"}).

    x_t = t * noise + (1 - t) * actions is embedded as the suffix, the
    prefix and the suffix run jointly through both streams (no cache,
    ``remat`` per layer), and the expert's velocity over the last
    ``chunk_size`` positions is regressed on u_t = noise - actions in fp32
    over every action dim, padded ones included.  ``noise`` [B, chunk,
    action_dim] and ``time`` [B] are injectable; otherwise both are drawn
    from ``generator``."""
    actions = batch["actions"].float()
    B, device = actions.shape[0], actions.device
    if noise is None:
        noise = torch.randn(actions.shape, generator=generator, dtype=torch.float32, device=device)
    if time is None:
        time = sample_flow_time(B, generator, device)
    noise, time = noise.float(), time.float()
    t_exp = time[:, None, None]
    x_t = t_exp * noise + (1 - t_exp) * actions
    u_t = noise - actions

    images = batch["images"]
    image_masks = batch.get("image_masks")
    if image_masks is None:
        image_masks = torch.ones(images.shape[:2], dtype=torch.int32, device=images.device)
    prefix_tokens, prefix_mask, prefix_ar = embed_prefix(
        model, cfg, images, image_masks, batch["input_ids"], batch["attention_mask"])
    states = batch.get("states") if cfg.use_state_token else None
    suffix_tokens, suffix_mask, suffix_ar, cond = embed_suffix(
        model, cfg, states, x_t, time, dtype=prefix_tokens.dtype)
    mask, grp, positions = _positions_and_grp(prefix_mask, prefix_ar, suffix_mask, suffix_ar)
    outs, _ = mot_forward(_streams(model, cfg, prefix_tokens, suffix_tokens, cond),
                          positions=positions, q_grp=grp, q_valid=mask, remat=remat)
    v_t = model.action_out_proj(outs[1][:, -cfg.chunk_size:])
    loss = (v_t.float() - u_t).square().mean()
    return loss, {"action_loss": loss, "loss": loss}



@torch.no_grad()
def flow_vla_inference_action(
    model: FlowVLA,
    cfg: FlowVLAConfig,
    input_ids: torch.Tensor,
    text_mask: torch.Tensor,
    images: torch.Tensor,
    image_masks: Optional[torch.Tensor],
    states: Optional[torch.Tensor],
    generator: Optional[torch.Generator] = None,
    num_steps: Optional[int] = None,
    progress: Optional[torch.Tensor] = None,  # [B, 1, 1] DM0-Prog input
    noise: Optional[torch.Tensor] = None,  # injectable initial noise (parity/replay)
):
    """Prefill the prefix into a KV cache, then integrate the flow from the
    noise by Euler steps over the frozen cache; returns the chunk [B, chunk,
    action_dim] fp32, and with a ``progress`` input (DM0-Prog) also the least
    end-progress over the steps [B, 1, 1].  The noise is drawn from
    ``generator`` unless injected."""
    num_steps = num_steps or cfg.num_flow_steps
    B = input_ids.shape[0]
    if image_masks is None:
        image_masks = torch.ones(images.shape[:2], dtype=torch.int32, device=images.device)
    prefix_tokens, prefix_mask, prefix_ar = embed_prefix(model, cfg, images, image_masks,
                                                         input_ids, text_mask)
    _, prefix_grp, prefix_pos = _positions_and_grp(prefix_mask, prefix_ar)
    _, cache = mot_forward(_streams(model, cfg, prefix_tokens, None, None),
                           positions=prefix_pos, q_grp=prefix_grp, q_valid=prefix_mask,
                           update_cache=True)
    prefix_len = prefix_mask.sum(1, keepdim=True, dtype=torch.int32)
    prefix_grp_max = prefix_grp[:, -1:]
    if noise is None:
        noise = torch.randn((B, cfg.chunk_size, cfg.action_dim), generator=generator,
                            dtype=torch.float32, device=prefix_tokens.device)
    progs = []

    def velocity(x_t, time):
        suffix_tokens, suffix_mask, suffix_ar, cond = embed_suffix(
            model, cfg, states, x_t, time.expand(B), dtype=prefix_tokens.dtype, progress=progress)
        suffix_grp = torch.cumsum(suffix_ar, dim=1, dtype=torch.int32) + prefix_grp_max
        suffix_pos = prefix_len + torch.cumsum(suffix_mask, dim=1, dtype=torch.int32) - 1
        outs, _ = mot_forward(_streams(model, cfg, None, suffix_tokens, cond),
                              positions=suffix_pos, q_grp=suffix_grp, q_valid=suffix_mask,
                              cache=cache, update_cache=False)
        if progress is not None:
            progs.append(model.progress_out_proj(
                outs[1][:, -cfg.chunk_size - 1: -cfg.chunk_size]).float())
        return model.action_out_proj(outs[1][:, -cfg.chunk_size:]).float()

    x = flow_euler_sample(velocity, noise.float(), num_steps)
    if progress is not None:
        return x, torch.stack(progs).amin(0)
    return x
