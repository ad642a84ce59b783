"""Discrete VLA experiment (port of dexbotic_tpu/exp/discrete_vla_exp.py).

Defaults as the JAX package's: LLaMA-2-7B + CLIP-L/336 + ``mlp2x_gelu``,
7 actions in 255 bins, answers of one step (``trajectory_length=1``) as
``ActionNormAnd2String``'s strings.  The model is laid out and initialised
from ``seed`` on ``device``, then filled from ``model_name_or_path`` (a port
``checkpoint-{step}`` directory: the JAX package reads its own checkpoints
only, and so does this one).  ``inference()`` serves
``exp/serve.DiscreteVLAServer``; ``serve_micro_batch`` > 0 is the decode
engine's slot count.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.models import presets
from dexbotic_tpu_torch.models.discrete_vla import (
    DiscreteVLAConfig,
    build_discrete_vla,
    discrete_vla_loss,
)
from dexbotic_tpu_torch.models.vlm import VLMConfig


def _no_release_converter(sd, cfg):
    raise ValueError("Discrete VLA reads checkpoint-{step} directories of this package only, "
                     "as the JAX package reads its own")


@dataclass
class DiscreteVLAModelConfig(base_exp.Config):
    model_name_or_path: Optional[str] = None
    llm_preset: str = "llama2_7b"
    vit_preset: str = "clip_vit_l_336"
    mm_projector_type: str = "mlp2x_gelu"
    action_dim: int = 7
    vocab_bins: int = 255
    seed: int = 0

    def build_config(self) -> DiscreteVLAConfig:
        return DiscreteVLAConfig(
            vlm=VLMConfig(llm=presets.LLM_PRESETS[self.llm_preset],
                          vit=presets.VIT_PRESETS[self.vit_preset],
                          projector_type=self.mm_projector_type),
            action_dim=self.action_dim, vocab_bins=self.vocab_bins)

    @torch.no_grad()
    def build_params(self, cfg: DiscreteVLAConfig, device, prepare=None):
        model = build_discrete_vla(cfg, device, seed=self.seed, prepare=prepare)
        return base_exp.fill_weights_(model, self.model_name_or_path, _no_release_converter, cfg)


@dataclass
class DiscreteVLAExp(base_exp.BaseExp):
    exp_name: str = "discrete_vla"
    model: DiscreteVLAModelConfig = field(default_factory=DiscreteVLAModelConfig)
    # action strings come from ActionNormAnd2String (vocab_size=255 bins)
    action: base_exp.ActionConfig = field(
        default_factory=lambda: base_exp.ActionConfig(trajectory_length=1))

    def num_image_tokens(self) -> int:
        return self.model.build_config().vlm.num_image_tokens

    def build_model(self, tokenizer):
        """(config, fp32 model on ``device``, loss_fn(model, batch, generator))."""
        cfg = self.model.build_config()
        model = self.model.build_params(cfg, self.device)
        remat = self.trainer.gradient_checkpointing

        def loss_fn(model, batch, generator):
            return discrete_vla_loss(model, cfg, batch, generator, remat=remat)

        return cfg, model, loss_fn

    def inference(self):
        """HTTP text-action server; ``serve_micro_batch`` > 0 serves through
        the continuous-batching decode engine with that many slots."""
        from dexbotic_tpu_torch.exp.serve import DiscreteVLAServer

        cfg, model, norms = self.load_for_inference()
        DiscreteVLAServer(self, cfg, model, self.tokenizer.build_tokenizer(), norms,
                          continuous_batching=self.serve_micro_batch).run()


if __name__ == "__main__":
    DiscreteVLAExp.main()
