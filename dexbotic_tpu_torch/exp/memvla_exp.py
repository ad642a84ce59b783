"""MemVLA experiment, serving half (port of dexbotic_tpu/exp/memvla_exp.py).

Defaults as the JAX package's: LLaMA-2-7B + CLIP-L/336 + ``mlp2x_gelu``,
a DiT-B head with memory cross-attention, action_dim 7, chunk 16, and the
memory surface (per tokens of 256 channels, a bank of 16 entries, two
retrieval layers, timestep embeddings, gate fusion, ToMe consolidation).
``load_for_inference`` lays the model out in the serving dtype (bf16, or
int8 / w8a8 through ``inference_quantize``) on ``device`` and fills it from
``model_name_or_path`` if set: a port ``checkpoint-{step}`` directory, or a
released checkpoint converted by ``utils/convert.convert_memvla``.  Serving
is ``exp/serve.MemVLAServer``: one episode's bank across requests, reset by
the request field ``episode_first_frame``.  Training (``memvla_loss``, the
episode-ordered schedule, the Trainer's carry of the bank) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.models import presets
from dexbotic_tpu_torch.models.memvla import (
    MemVLAConfig,
    build_memvla,
    init_mem_state,
    memvla_inference_action,
    reset_mem_rows,
)
from dexbotic_tpu_torch.models.vlm import VLMConfig
from dexbotic_tpu_torch.utils.convert import convert_memvla

TRAINING_NOT_PORTED = ("MemVLA training (memvla_loss, the sequential bank, the episode-ordered "
                       "schedule and the Trainer's carry of the bank) is not ported yet "
                       "(ROADMAP Queue 1 item 7, training)")


@dataclass
class MemVLAModelConfig(base_exp.Config):
    # a checkpoint-{step} dir, or a released checkpoint (HF layout) to convert
    model_name_or_path: Optional[str] = None
    llm_preset: str = "llama2_7b"
    vit_preset: str = "clip_vit_l_336"
    mm_projector_type: str = "mlp2x_gelu"
    action_model_type: str = "DiT-B"
    action_dim: int = 7
    chunk_size: int = 16
    per_token_size: int = 256
    mem_length: int = 16
    retrieval_layers: int = 2
    use_timestep_pe: bool = True
    fusion_type: str = "gate"
    consolidate_type: str = "tome"
    update_fused: bool = True
    seed: int = 0

    def build_config(self) -> MemVLAConfig:
        return MemVLAConfig(
            vlm=VLMConfig(llm=presets.LLM_PRESETS[self.llm_preset],
                          vit=presets.VIT_PRESETS[self.vit_preset],
                          projector_type=self.mm_projector_type),
            action_model_type=self.action_model_type, action_dim=self.action_dim,
            chunk_size=self.chunk_size, per_token_size=self.per_token_size,
            mem_length=self.mem_length, retrieval_layers=self.retrieval_layers,
            use_timestep_pe=self.use_timestep_pe, fusion_type=self.fusion_type,
            consolidate_type=self.consolidate_type, update_fused=self.update_fused)

    @torch.no_grad()
    def build_params(self, cfg: MemVLAConfig, device, prepare=None):
        model = build_memvla(cfg, device, seed=self.seed, prepare=prepare)
        return base_exp.fill_weights_(model, self.model_name_or_path, convert_memvla, cfg)


class MemVLAInferenceSession:
    """Serving-side state of one episode stream: the bank and the frame
    counter (the timestep fed to the bank's embeddings)."""

    def __init__(self, exp: "MemVLAExp", cfg: MemVLAConfig, model, batch_size: int = 1):
        self.cfg, self.model = cfg, model
        self.device = torch.device(exp.device)
        self.state = init_mem_state(cfg, batch_size, device=self.device)
        self.timestep = 0

    def reset(self) -> None:
        B = self.state["cog"]["count"].shape[0]
        self.state = reset_mem_rows(self.state, torch.ones((B,), dtype=torch.bool,
                                                           device=self.device))
        self.timestep = 0

    def step(self, input_ids, valid, images, generator=None, noise=None) -> torch.Tensor:
        t = torch.full((input_ids.shape[0],), float(self.timestep), device=self.device)
        actions, self.state = memvla_inference_action(
            self.model, self.cfg, input_ids, valid, images, self.state, t, generator, noise=noise)
        self.timestep += 1
        return actions


@dataclass
class MemVLAExp(base_exp.BaseExp):
    exp_name: str = "memvla"
    model: MemVLAModelConfig = field(default_factory=MemVLAModelConfig)

    def num_image_tokens(self) -> int:
        return self.model.build_config().vlm.num_image_tokens

    def inference(self):
        """The stateful action server (``episode_first_frame`` resets the bank)."""
        from dexbotic_tpu_torch.exp.serve import MemVLAServer

        cfg, model, norms = self.load_for_inference()
        MemVLAServer(self, cfg, model, self.tokenizer.build_tokenizer(), norms).run()

    def build_model(self, tokenizer):
        raise NotImplementedError(TRAINING_NOT_PORTED)

    def train(self):
        raise NotImplementedError(TRAINING_NOT_PORTED)


if __name__ == "__main__":
    MemVLAExp.main()
