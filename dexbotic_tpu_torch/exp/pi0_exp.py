"""pi0 / pi0.5 / DM0 experiments (port of dexbotic_tpu/exp/pi0_exp.py).

Defaults as the JAX package's: PaliGemma (SigLIP so400m/224 + ``linear``
projector + Gemma-2B) with the Gemma-300M action expert, 48-token fixed text
prompts, 3 camera views with zero padding and image masks, a state input,
action_dim 32, chunk 50, 10 Euler steps; serving normalises the state and
denormalises the chunk with the served statistics, then turns it absolute
against the request's state.  The model is laid out and initialised from
``seed`` directly on ``device`` (in the serving dtype for inference, fp32
for training, where the Trainer casts it), then filled from
``model_name_or_path`` if set: a port ``checkpoint-{step}`` directory, or a
released checkpoint converted by ``utils/convert.py`` (the model then holds
its load and convert seconds in ``checkpoint_times``).
Training is ``BaseExp.train`` over :func:`flow_vla_loss` (a full fine-tune:
the JAX exp freezes nothing either).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from dexbotic_tpu_torch.data import transforms as T
from dexbotic_tpu_torch.data.multimodal import LoadMultiModal
from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.models import presets
from dexbotic_tpu_torch.models.flow_vla import (
    FlowVLAConfig,
    build_flow_vla,
    dm0_config,
    flow_vla_inference_action,
    flow_vla_loss,
    pi0_config,
    pi05_config,
)
from dexbotic_tpu_torch.utils.convert import convert_flow_vla


@dataclass
class FlowModelConfig(base_exp.Config):
    # a checkpoint-{step} dir, or a released checkpoint (HF layout) to convert
    model_name_or_path: Optional[str] = None
    variant: str = "pi0"  # 'pi0' | 'pi05' | 'dm0'
    llm_preset: str = "gemma_2b"
    expert_preset: str = "gemma_300m"
    vit_preset: str = "siglip_so400m_224"
    projector_type: str = "linear"
    action_dim: int = 32
    chunk_size: int = 50
    num_flow_steps: int = 10
    seed: int = 0

    def build_config(self) -> FlowVLAConfig:
        llm = presets.LLM_PRESETS[self.llm_preset]
        expert = presets.EXPERT_PRESETS[self.expert_preset]
        vit = presets.VIT_PRESETS[self.vit_preset]
        kw = dict(projector_type=self.projector_type, action_dim=self.action_dim,
                  chunk_size=self.chunk_size, num_flow_steps=self.num_flow_steps)
        if self.variant == "pi0":
            return pi0_config(llm, expert, vit, **kw)
        if self.variant == "pi05":
            return pi05_config(llm, expert, vit, **kw)
        if self.variant == "dm0":
            return dm0_config(llm, expert, vit, **kw)
        raise ValueError(self.variant)

    @torch.no_grad()
    def build_params(self, cfg: FlowVLAConfig, device, prepare=None):
        model = build_flow_vla(cfg, device, seed=self.seed, prepare=prepare)
        return base_exp.fill_weights_(model, self.model_name_or_path, convert_flow_vla, cfg)


@dataclass
class Pi0ActionConfig(base_exp.ActionConfig):
    """pi0's action pipeline: pad state/action to 32-D, a 50-step unflattened
    'last'-padded trajectory, then delta against the window's start state,
    then normalise action and state (mean/std for pi0, quantiles for
    pi0.5/DM0)."""

    trajectory_length: int = 50
    action_ndim: int = 32
    use_quantiles: bool = False

    def _stats_mapping(self, stats: dict) -> dict:
        # pi0-format norm files carry {'action', 'state'}; a CogACT-format
        # {'default'} file is aliased to 'action'
        if "action" not in stats and "default" in stats:
            return {"action": stats["default"], "default": stats["default"]}
        return stats

    def build_action_process_func(self) -> T.Pipeline:
        stats = self._read_norm_stats(self.statistic_mapping)
        return T.Pipeline([
            T.ToDict(),
            T.ToNumpy(),
            T.AddAction(predict_length=1),
            T.PadState(ndim=self.action_ndim),
            T.PadAction(ndim=self.action_ndim),
            T.AddTrajectory(trajectory_length=self.trajectory_length, flatten=False,
                            padding_mode="last", padding_action=self.padding_action),
            T.DeltaAction(enable=self.delta),
            T.ActionNorm(statistic_mapping=self._stats_mapping(stats), strict=False,
                         use_quantiles=self.use_quantiles),
            LoadMultiModal(return_masks=self.load_multimodal_masks),
            T.AddPromptTemplate(prompt_template=self.prompt_template),
            T.ReplaceAnswer(default_answer=self.replace_with_default_answer),
            T.ToList(),
        ])


@dataclass
class Pi0InferenceConfig(base_exp.Config):
    """Serving output transforms: delta -> absolute (always, as the reference
    pi0 server) with the gripper dim [6] left as predicted, optionally
    relative -> delta first; then the env's first ``action_dim_out`` dims."""

    absolute_action: bool = True
    relative_to_delta: bool = False
    action_dim_out: int = 7  # env action dims (the rest of the 32 are padding)
    non_delta_mask: Optional[list] = field(default_factory=lambda: [6])

    def build_output_transforms(self, meta_data: dict):
        meta = {"non_delta_mask": self.non_delta_mask, "periodic_mask": None,
                "periodic_range": None, **meta_data}
        out = []
        if self.relative_to_delta:
            out.append(T.Relative2Delta())
        if self.absolute_action:
            out.append(T.AbsoluteAction())
        return T.Pipeline(out), meta


@dataclass
class Pi0Exp(base_exp.BaseExp):
    exp_name: str = "pi0"
    model: FlowModelConfig = field(default_factory=FlowModelConfig)
    inference_cfg: Pi0InferenceConfig = field(default_factory=Pi0InferenceConfig)
    action: Pi0ActionConfig = field(default_factory=lambda: Pi0ActionConfig(
        load_multimodal_masks=True, prompt_template="{prompt}"))
    data: base_exp.DataConfig = field(default_factory=lambda: base_exp.DataConfig(
        num_images=3, image_pad_mode="zero", image_aspect_ratio=None,
        data_keys=["input_ids", "labels", "action", "image", "state", "image_masks"]))
    tokenizer: base_exp.TokenizerConfig = field(
        default_factory=lambda: base_exp.TokenizerConfig(model_max_length=48))

    def build_tokenization(self, tokenizer):
        from dexbotic_tpu_torch.tokenization.tokenize import Pi0Tokenization

        return Pi0Tokenization(tokenizer, max_len=self.tokenizer.model_max_length)

    def build_model(self, tokenizer):
        """(config, fp32 model on ``device``, loss_fn(model, batch, generator))."""
        cfg = self.model.build_config()
        model = self.model.build_params(cfg, self.device)
        remat = self.trainer.gradient_checkpointing

        def loss_fn(model, batch, generator):
            batch = dict(batch)
            batch["states"] = batch.pop("states", None)
            return flow_vla_loss(model, cfg, batch, generator, remat=remat)

        return cfg, model, loss_fn

    def served_norm_stats(self):
        """The checkpoint's full ``norm_stats.json`` mapping or None."""
        path = os.path.join(self.model.model_name_or_path or "", "norm_stats.json")
        if not (self.model.model_name_or_path and os.path.exists(path)):
            return None
        with open(path) as f:
            return json.load(f)["norm_stats"]

    def make_infer_fn(self, cfg, model):
        """(ids, text_mask, images, image_masks, states, generator) ->
        normalised chunk [B, chunk, action_dim] fp32."""

        def infer(ids, text_mask, images, image_masks, states, generator):
            return flow_vla_inference_action(model, cfg, ids, text_mask, images, image_masks,
                                             states, generator=generator)

        return infer

    def inference(self):
        from dexbotic_tpu_torch.exp.serve import FlowVLAServer

        cfg, model, norms = self.load_for_inference()
        FlowVLAServer(self, cfg, model, self.tokenizer.build_tokenizer(), norms,
                      micro_batch=self.serve_micro_batch).run()

    def inference_single(self, images=None, prompt: str = "pick up the object", states=None):
        from dexbotic_tpu_torch.data.image_processing import preprocess_image
        from dexbotic_tpu_torch.exp.serve import ServingStats

        cfg, model, norms = self.load_for_inference()
        tok = self.build_tokenization(self.tokenizer.build_tokenizer())
        out = tok(conversations=[{"from": "human", "value": prompt}])
        dev = torch.device(self.device)
        ids = torch.tensor(np.asarray(out["input_ids"], np.int32)[None], device=dev)
        proc = self.data.build_image_processor()
        n = self.data.num_images
        if images is None:
            images = [np.zeros((proc.size, proc.size, 3), np.uint8)]
        imgs = np.zeros((1, n, proc.size, proc.size, 3), np.float32)
        masks = np.zeros((1, n), np.int32)
        for i, im in enumerate(images[:n]):
            imgs[0, i] = preprocess_image(np.asarray(im), proc)
            masks[0, i] = 1
        s = np.zeros((1, cfg.action_dim), np.float32)
        if states is not None:
            vals = np.asarray(states, np.float32).ravel()
            s[0, : len(vals)] = vals
        mapping = norms
        if norms is not None and not isinstance(norms.get("action"), dict):
            mapping = {"action": norms.get("default", norms)}
        stats = ServingStats(mapping, self.action.use_quantiles)
        gen = torch.Generator(device=dev).manual_seed(self.model.seed)
        actions = self.make_infer_fn(cfg, model)(
            ids, (ids != 0).to(torch.int32), torch.from_numpy(imgs).to(dev),
            torch.from_numpy(masks).to(dev),
            torch.from_numpy(stats.normalize("state", s)).to(dev), gen)[0]
        actions = stats.denormalize("action", actions.float().cpu().numpy().astype(np.float64))
        print(actions.tolist())
        return actions


@dataclass
class Pi05Exp(Pi0Exp):
    exp_name: str = "pi05"
    model: FlowModelConfig = field(default_factory=lambda: FlowModelConfig(
        variant="pi05", expert_preset="gemma_300m_adarms"))
    # pi0.5 normalises by q01/q99 quantiles, not mean/std
    action: Pi0ActionConfig = field(default_factory=lambda: Pi0ActionConfig(
        load_multimodal_masks=True, prompt_template="{prompt}", use_quantiles=True))


@dataclass
class DM0Exp(Pi0Exp):
    exp_name: str = "dm0"
    model: FlowModelConfig = field(default_factory=lambda: FlowModelConfig(
        variant="dm0", llm_preset="qwen3_1.7b", expert_preset="qwen3_0.6b",
        vit_preset="siglip_so400m_224"))
    tokenizer: base_exp.TokenizerConfig = field(default_factory=lambda: base_exp.TokenizerConfig(
        model_max_length=100, chat_template="step"))
    # DM0 is quantile-normalised like pi0.5
    action: Pi0ActionConfig = field(default_factory=lambda: Pi0ActionConfig(
        load_multimodal_masks=True, prompt_template="{prompt}", use_quantiles=True))

    def build_tokenization(self, tokenizer):
        from dexbotic_tpu_torch.tokenization.tokenize import DM0Tokenization

        return DM0Tokenization(tokenizer, max_len=self.tokenizer.model_max_length)


if __name__ == "__main__":
    Pi0Exp.main()
