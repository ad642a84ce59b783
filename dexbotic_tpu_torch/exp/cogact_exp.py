"""CogACT experiment (port of dexbotic_tpu/exp/cogact_exp.py).

Defaults mirror the JAX package: DiT-B head, action_dim 7, chunk 16,
CLIP-L-336 tower + mlp2x_gelu projector on LLaMA-2-7B.  The model is laid
out and initialised from ``seed`` directly on ``device`` (in the serving dtype
for inference, fp32 for training, where the Trainer casts it), then filled
from ``model_name_or_path`` if set: a port ``checkpoint-{step}`` directory,
or a released checkpoint converted by ``utils/convert.py`` (the model then
holds its load and convert seconds in ``checkpoint_times``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.models import presets
from dexbotic_tpu_torch.models.cogact import (
    CogActConfig,
    build_cogact,
    cogact_inference_action,
    cogact_loss,
    denorm_actions,
)
from dexbotic_tpu_torch.models.vlm import VLMConfig
from dexbotic_tpu_torch.utils.convert import convert_cogact


@dataclass
class CogActModelConfig(base_exp.Config):
    # a checkpoint-{step} dir, or a released checkpoint (HF layout) to convert
    model_name_or_path: Optional[str] = None
    llm_preset: str = "llama2_7b"
    vit_preset: str = "clip_vit_l_336"
    mm_projector_type: str = "mlp2x_gelu"
    action_model_type: str = "DiT-B"
    action_dim: int = 7
    chunk_size: int = 16
    # as in the JAX package, freeze_llm is not passed on to the optimizer
    # (set OptimizerConfig.freeze_llm); freeze_mm_projector sets a 0.0
    # projector lr, which the optimizer's `or` turns back into learning_rate
    freeze_llm: bool = False
    freeze_mm_projector: bool = False
    freeze_mm_vision: bool = True
    seed: int = 0
    sampler: str = "ddim"  # 'dpm' = DPM-Solver++(2M); pair with ddim_steps=5
    ddim_steps: int = 10
    fused_sampler: bool = True  # kernel K2 at serving batch on CUDA

    def build_config(self) -> CogActConfig:
        return CogActConfig(
            vlm=VLMConfig(
                llm=presets.LLM_PRESETS[self.llm_preset],
                vit=presets.VIT_PRESETS[self.vit_preset],
                projector_type=self.mm_projector_type,
            ),
            action_model_type=self.action_model_type,
            action_dim=self.action_dim,
            chunk_size=self.chunk_size,
            sampler=self.sampler,
            ddim_steps=self.ddim_steps,
            fused_sampler=self.fused_sampler,
        )

    @torch.no_grad()
    def build_params(self, cfg: CogActConfig, device, prepare=None):
        model = build_cogact(cfg, device, seed=self.seed, prepare=prepare)
        return base_exp.fill_weights_(model, self.model_name_or_path, convert_cogact, cfg)


@dataclass
class CogActExp(base_exp.BaseExp):
    exp_name: str = "cogact"
    model: CogActModelConfig = field(default_factory=CogActModelConfig)
    action: base_exp.ActionConfig = field(
        default_factory=lambda: base_exp.ActionConfig(trajectory_length=16))

    def num_image_tokens(self) -> int:
        return self.model.build_config().vlm.num_image_tokens

    def build_model(self, tokenizer):
        """(config, fp32 model on ``device``, loss_fn(model, batch, generator))."""
        cfg = self.model.build_config()
        model = self.model.build_params(cfg, self.device)
        # freeze flags -> zero-lr groups, as the JAX exp maps them
        if self.model.freeze_mm_vision and self.optimizer.mm_vision_lr is None:
            self.optimizer = dataclasses.replace(self.optimizer, mm_vision_lr=0.0)
        if self.model.freeze_mm_projector:
            self.optimizer = dataclasses.replace(self.optimizer, mm_projector_lr=0.0)
        remat = self.trainer.gradient_checkpointing

        def loss_fn(model, batch, generator):
            return cogact_loss(model, cfg, batch, generator, remat=remat)

        return cfg, model, loss_fn

    def make_infer_fn(self, cfg, model):
        """(ids, valid, images, generator) -> normalised chunk [B, chunk, dim]."""

        def infer(ids, valid, images, generator):
            return cogact_inference_action(model, cfg, ids, valid, images, generator=generator)

        return infer

    def inference(self):
        from dexbotic_tpu_torch.exp.serve import CogActServer

        cfg, model, norms = self.load_for_inference()
        server = CogActServer(self, cfg, model, self.tokenizer.build_tokenizer(), norms,
                              micro_batch=self.serve_micro_batch)
        server.run()

    def inference_single(self, image=None, prompt: str = "pick up the object"):
        from dexbotic_tpu_torch.exp.serve import prepare_cogact_inputs

        cfg, model, norms = self.load_for_inference()
        tokenizer = self.tokenizer.build_tokenizer()
        if image is None:
            image = np.zeros((224, 224, 3), np.uint8)
        ids, valid, imgs = prepare_cogact_inputs(self, cfg, tokenizer, [image], prompt, self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.model.seed)
        actions = self.make_infer_fn(cfg, model)(ids, valid, imgs, gen)[0].float().cpu().numpy()
        if norms is not None:
            actions = denorm_actions(actions, norms["min"], norms["max"])
        print(actions.tolist())
        return actions


if __name__ == "__main__":
    CogActExp.main()
