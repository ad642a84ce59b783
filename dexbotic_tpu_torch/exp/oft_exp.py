"""OFT / OFT-Discrete experiments (port of dexbotic_tpu/exp/oft_exp.py).

Defaults as the JAX package's: LLaMA-2-7B + CLIP-L/336 + ``mlp2x_gelu``
projector, the L1 head, action_dim 7, chunk 16, 256 bins for the Discrete
head.  The model is laid out and initialised from ``seed`` directly on
``device`` (in the serving dtype for inference, fp32 for training, where the
Trainer casts it), then filled from ``model_name_or_path`` if set: a port
``checkpoint-{step}`` directory, or a released checkpoint converted by
``utils/convert.convert_oft``.  Serving is ``exp/serve.OFTServer`` (the
CogACT request contract plus an optional ``states`` field); as in the JAX
package, OFT has no ``inference_single``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.models import presets
from dexbotic_tpu_torch.models.oft import (
    OFTConfig,
    build_oft,
    continuous_to_bins,
    oft_inference_action,
    oft_loss,
)
from dexbotic_tpu_torch.models.vlm import VLMConfig
from dexbotic_tpu_torch.utils.convert import convert_oft


@dataclass
class OFTModelConfig(base_exp.Config):
    # a checkpoint-{step} dir, or a released checkpoint (HF layout) to convert
    model_name_or_path: Optional[str] = None
    llm_preset: str = "llama2_7b"
    vit_preset: str = "clip_vit_l_336"
    mm_projector_type: str = "mlp2x_gelu"
    action_model_type: str = "L1"  # 'L1' | 'Diffusion' | 'Discrete'
    action_dim: int = 7
    chunk_size: int = 16
    use_proprio: bool = False
    proprio_dim: Optional[int] = None
    num_bins: int = 256
    # the reference's discrete-decode slice, off by one (checkpoint replay);
    # False for the corrected decode
    reference_parity: bool = True
    seed: int = 0

    def build_config(self) -> OFTConfig:
        return OFTConfig(
            vlm=VLMConfig(llm=presets.LLM_PRESETS[self.llm_preset],
                          vit=presets.VIT_PRESETS[self.vit_preset],
                          projector_type=self.mm_projector_type),
            action_model_type=self.action_model_type, action_dim=self.action_dim,
            chunk_size=self.chunk_size, use_proprio=self.use_proprio,
            proprio_dim=self.proprio_dim, num_bins=self.num_bins,
            reference_parity=self.reference_parity)

    @torch.no_grad()
    def build_params(self, cfg: OFTConfig, device, prepare=None):
        model = build_oft(cfg, device, seed=self.seed, prepare=prepare)
        return base_exp.fill_weights_(model, self.model_name_or_path, convert_oft, cfg)


def discrete_labels(actions: torch.Tensor, cfg: OFTConfig) -> torch.Tensor:
    """Normalised actions -> the Discrete head's labels: bins moved to the
    last ``num_bins`` vocab slots, [B, chunk * action_dim]."""
    a = actions.reshape(actions.shape[0], -1, cfg.action_dim)[:, : cfg.chunk_size]
    bins = continuous_to_bins(a, cfg)
    return bins.reshape(bins.shape[0], -1) + (cfg.vlm.llm.vocab_size - cfg.num_bins)


@dataclass
class OFTExp(base_exp.BaseExp):
    exp_name: str = "oft"
    model: OFTModelConfig = field(default_factory=OFTModelConfig)
    data: base_exp.DataConfig = field(default_factory=lambda: base_exp.DataConfig(
        data_keys=["input_ids", "labels", "action", "image", "state"]))

    def num_image_tokens(self) -> int:
        return self.model.build_config().vlm.num_image_tokens

    def build_model(self, tokenizer):
        """(config, fp32 model on ``device``, loss_fn(model, batch, generator))."""
        cfg = self.model.build_config()
        model = self.model.build_params(cfg, self.device)
        remat = self.trainer.gradient_checkpointing

        def loss_fn(model, batch, generator):
            if "Discrete" in cfg.action_model_type and "action_bins" not in batch:
                batch = dict(batch, action_bins=discrete_labels(batch["actions"], cfg))
            return oft_loss(model, cfg, batch, generator, remat=remat)

        return cfg, model, loss_fn

    def make_infer_fn(self, cfg, model):
        """(ids, valid, images, states, generator) -> normalised chunk
        [B, chunk, dim]; ``states`` is None without proprio."""

        def infer(ids, valid, images, states, generator):
            return oft_inference_action(model, cfg, ids, valid, images, states=states,
                                        generator=generator)

        return infer

    def inference(self):
        from dexbotic_tpu_torch.exp.serve import OFTServer

        cfg, model, norms = self.load_for_inference()
        OFTServer(self, cfg, model, self.tokenizer.build_tokenizer(), norms,
                  micro_batch=self.serve_micro_batch).run()


@dataclass
class OFTDiscreteExp(OFTExp):
    exp_name: str = "oft_discrete"
    model: OFTModelConfig = field(
        default_factory=lambda: OFTModelConfig(action_model_type="Discrete"))


if __name__ == "__main__":
    OFTExp.main()
