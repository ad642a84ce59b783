"""MUVLA experiment (port of dexbotic_tpu/exp/muvla_exp.py).

Defaults as the JAX package's: LLaMA-2-7B, two CLIP-L/336 towers (the map
view's and the observation views'), the ``mlp2x_gelu`` projector, a fuser
of width 1024 and 192 history queries.  The model is laid out and
initialised from ``seed`` on ``device``, then filled from
``model_name_or_path`` (a port ``checkpoint-{step}`` directory, or a
released DB-MUVLA checkpoint converted by ``utils/convert.convert_muvla``).
``inference()`` serves ``exp/serve.MUVLAServer``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.models import presets
from dexbotic_tpu_torch.models.muvla import MUVLAConfig, build_muvla, muvla_generate, muvla_loss
from dexbotic_tpu_torch.models.vlm import VLMConfig
from dexbotic_tpu_torch.utils.convert import convert_muvla


@dataclass
class MUVLAModelConfig(base_exp.Config):
    model_name_or_path: Optional[str] = None
    llm_preset: str = "llama2_7b"
    vit_preset: str = "clip_vit_l_336"  # the map tower
    obs_vit_preset: str = "clip_vit_l_336"
    mm_projector_type: str = "mlp2x_gelu"
    inter_dim: int = 1024
    num_history_queries: int = 192
    fuse_heads: Optional[int] = None
    seed: int = 0

    def build_config(self) -> MUVLAConfig:
        return MUVLAConfig(
            vlm=VLMConfig(llm=presets.LLM_PRESETS[self.llm_preset],
                          vit=presets.VIT_PRESETS[self.vit_preset],
                          projector_type=self.mm_projector_type),
            obs_vit=presets.VIT_PRESETS[self.obs_vit_preset], inter_dim=self.inter_dim,
            num_history_queries=self.num_history_queries, fuse_heads=self.fuse_heads)

    @torch.no_grad()
    def build_params(self, cfg: MUVLAConfig, device, prepare=None):
        model = build_muvla(cfg, device, seed=self.seed, prepare=prepare)
        return base_exp.fill_weights_(model, self.model_name_or_path, convert_muvla, cfg)


@dataclass
class MUVLAExp(base_exp.BaseExp):
    exp_name: str = "muvla"
    model: MUVLAModelConfig = field(default_factory=MUVLAModelConfig)
    data: base_exp.DataConfig = field(default_factory=lambda: base_exp.DataConfig(
        data_keys=["input_ids", "labels", "image", "reward"]))

    def num_image_tokens(self) -> int:
        cfg = self.model.build_config()
        return cfg.num_history_queries + cfg.obs_vit.num_output_tokens

    def build_model(self, tokenizer):
        """(config, fp32 model on ``device``, loss_fn(model, batch, generator))."""
        cfg = self.model.build_config()
        model = self.model.build_params(cfg, self.device)
        remat = self.trainer.gradient_checkpointing

        def loss_fn(model, batch, generator):
            return muvla_loss(model, cfg, batch, generator, remat=remat)

        return cfg, model, loss_fn

    def make_generate_fn(self, cfg: MUVLAConfig, model, max_new_tokens: int = 32,
                         eos_token_id: int = 0, temperature: float = 0.0):
        """(ids, valid, map_img, obs_imgs, generator) -> tokens [B, max_new_tokens]."""

        def gen(ids, valid, map_img, obs_imgs, generator=None):
            return muvla_generate(model, cfg, ids, valid, map_img, obs_imgs,
                                  max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                                  temperature=temperature, generator=generator)[0]

        return gen

    def inference(self):
        """Serve MUVLA text actions over /process_frame (the map view first)."""
        from dexbotic_tpu_torch.exp.serve import MUVLAServer

        cfg, model, _ = self.load_for_inference()
        MUVLAServer(self, cfg, model, self.tokenizer.build_tokenizer()).run()


if __name__ == "__main__":
    MUVLAExp.main()
