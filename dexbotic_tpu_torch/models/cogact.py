"""CogACT policy: VLM -> cognition feature -> DiT diffusion head.

Port of dexbotic_tpu/models/cogact.py.  The cognition feature is the last
valid token's hidden state.  Training (:func:`cogact_loss`) is a 4x-repeated
diffusion MSE in fp32, plus the causal-LM loss under ``with_text_loss``;
inference samples the action chunk by DDIM (or DPM-Solver++(2M)) with
classifier-free guidance through the learned uncondition embedding.  At
serving batch on a CUDA device the whole sampling loop runs as kernel K2
(``ops/dit_fused.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from dexbotic_tpu_torch.models import dit as dit_mod
from dexbotic_tpu_torch.models.losses import causal_lm_loss
from dexbotic_tpu_torch.models.vlm import VLM, VLMConfig, gather_last_hidden, init_vlm_, vlm_forward
from dexbotic_tpu_torch.nn.transformer import lm_logits
from dexbotic_tpu_torch.ops.diffusion import DiffusionSchedule
from dexbotic_tpu_torch.ops.dit_fused import dit_sample_ref, fused_dit_sample, k2_serves


@dataclasses.dataclass(frozen=True)
class CogActConfig:
    vlm: VLMConfig
    action_model_type: str = "DiT-B"
    action_dim: int = 7
    chunk_size: int = 16
    diffusion_steps: int = 100
    repeated_diffusion_steps: int = 4
    cfg_scale: float = 1.5
    ddim_steps: int = 10
    sampler: str = "ddim"  # 'ddim' | 'dpm' (DPM-Solver++(2M))
    sampler_unroll: int = 1  # JAX scan knob; kept for config parity, unused
    dit_scan_unroll: int = 1  # JAX scan knob; kept for config parity, unused
    # Run the whole sampling loop as kernel K2 when the rows fit (<= 4) on CUDA.
    fused_sampler: bool = True

    @property
    def dit(self) -> dit_mod.DiTConfig:
        return dit_mod.make_dit_config(
            self.action_model_type, token_size=self.vlm.llm.hidden_size,
            action_dim=self.action_dim, chunk_size=self.chunk_size,
            scan_unroll=self.dit_scan_unroll,
        )


class CogAct(nn.Module):
    def __init__(self, cfg: CogActConfig):
        super().__init__()
        self.vlm = VLM(cfg.vlm)
        self.action_head = dit_mod.DiT(cfg.dit)


@torch.no_grad()
def init_cogact_(model: CogAct, gen: torch.Generator) -> None:
    init_vlm_(model.vlm, gen)
    dit_mod.init_dit_(model.action_head, gen)


def build_cogact(cfg: CogActConfig, device, seed: int = 0,
                 prepare: Optional[Callable[[nn.Module], nn.Module]] = None) -> CogAct:
    """Seeded random CogACT built in place on ``device``.

    The module is laid out on the meta device, where ``prepare`` (a dtype
    policy such as ``BaseExp.prepare_inference_params``) may recast it, then
    materialised and initialised on ``device``: a bf16 7B model never exists
    in fp32 anywhere."""
    device = torch.device(device)
    with torch.device("meta"):
        model = CogAct(cfg)
    if prepare is not None:
        model = prepare(model)
    model = model.to_empty(device=device)
    init_cogact_(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


def schedule(cfg: CogActConfig) -> DiffusionSchedule:
    return DiffusionSchedule.create(cfg.diffusion_steps)


def cognition_feature(model: CogAct, cfg: CogActConfig, input_ids, valid, images, remat=False):
    hidden = vlm_forward(model.vlm, cfg.vlm, input_ids, valid, images=images, remat=remat)
    return gather_last_hidden(hidden, valid), hidden


def cogact_loss(
    model: CogAct,
    cfg: CogActConfig,
    batch: dict,
    generator: Optional[torch.Generator] = None,
    remat=False,
    with_text_loss: bool = False,
    diffusion_t: Optional[torch.Tensor] = None,  # [B*rep] injectable (parity)
    diffusion_noise: Optional[torch.Tensor] = None,  # [B*rep, chunk, dim]
) -> tuple[torch.Tensor, dict]:
    """Training loss.  batch: input_ids, attention_mask, images, actions
    [B, >=chunk, action_dim] (+ labels / has_text / has_action for hybrid
    co-training).  Timesteps, noise and the condition dropout are drawn from
    ``generator`` unless injected; injected noise turns the dropout off."""
    cog, hidden = cognition_feature(model, cfg, batch["input_ids"], batch["attention_mask"],
                                    batch["images"], remat=remat)
    actions = batch["actions"].reshape(cog.shape[0], -1, cfg.action_dim)
    actions = actions[:, : cfg.chunk_size].float()

    rep = cfg.repeated_diffusion_steps
    actions_rep = actions.repeat(rep, 1, 1)
    cog_rep = cog[:, None, :].repeat(rep, 1, 1).float()
    sched = schedule(cfg)
    drop_gen = None if diffusion_noise is not None else generator

    def eps_fn(x_t, t):
        return dit_mod.dit_forward(model.action_head, cfg.dit, x_t, t, cog_rep, drop_gen=drop_gen)

    has_action = batch.get("has_action") if with_text_loss else None
    if has_action is not None:
        # hybrid gating: per-sample MSE, mean over has_action rows (+1e-6)
        per_sample = sched.training_loss(eps_fn, actions_rep, generator, t=diffusion_t,
                                         noise=diffusion_noise, reduction="none")
        ha = has_action.reshape(-1).float().repeat(rep)
        action_loss = (per_sample * ha).sum() / (ha.sum() + 1e-6)
    else:
        action_loss = sched.training_loss(eps_fn, actions_rep, generator, t=diffusion_t,
                                          noise=diffusion_noise)
    metrics = {"action_loss": action_loss}
    loss = action_loss

    if with_text_loss:
        logits = lm_logits(model.vlm.llm, cfg.vlm.llm, hidden)
        text_loss = causal_lm_loss(logits, batch["labels"])
        has_text = batch.get("has_text")
        if has_text is not None:
            # as the reference: when any row has text, every row's labels count
            # and the term is scaled by has_text.any()
            text_loss = text_loss * has_text.reshape(-1).bool().any().float()
        metrics["text_loss"] = text_loss
        loss = loss + text_loss
    metrics["loss"] = loss
    return loss, metrics


@torch.no_grad()
def k2_uses(cfg: CogActConfig, B: int, cfg_scale: float) -> bool:
    """Whether K2's shape rule takes the action head's sampling of B frames
    (2 B rows with CFG); past it the sampler runs the plain loop."""
    d = cfg.dit
    return k2_serves(B * (2 if cfg_scale > 1.0 else 1), cfg.chunk_size, cfg.action_dim,
                     d.hidden_size, d.mlp_dim, d.num_heads)


def cogact_inference_action(
    model: CogAct,
    cfg: CogActConfig,
    input_ids: torch.Tensor,
    valid: torch.Tensor,
    images: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    cfg_scale: Optional[float] = None,
    ddim_steps: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,  # injectable initial noise (parity/replay)
) -> torch.Tensor:
    """Frame -> normalised action chunk [B, chunk, action_dim] fp32."""
    cfg_scale = cfg.cfg_scale if cfg_scale is None else cfg_scale
    ddim_steps = cfg.ddim_steps if ddim_steps is None else ddim_steps
    cog, _ = cognition_feature(model, cfg, input_ids, valid, images)
    B = cog.shape[0]
    if noise is None:
        noise = torch.randn((B, cfg.chunk_size, cfg.action_dim), generator=generator,
                            dtype=torch.float32, device=cog.device)
    head, z = model.action_head, cog[:, None, :].float()
    kw = dict(steps=ddim_steps, cfg_scale=cfg_scale, sampler=cfg.sampler)
    if k2_uses(cfg, B, cfg_scale) and cfg.fused_sampler and cog.device.type == "cuda":
        return fused_dit_sample(head, cfg.dit, z, noise, schedule(cfg), **kw)
    return dit_sample_ref(head, cfg.dit, z, noise, schedule(cfg), **kw)


def denorm_actions(actions: np.ndarray, low, high) -> np.ndarray:
    """[-1, 1]-normalised -> robot units."""
    actions = np.clip(actions, -1.0, 1.0)
    low, high = np.asarray(low)[None, :], np.asarray(high)[None, :]
    return low + (actions + 1.0) * 0.5 * (high - low)
