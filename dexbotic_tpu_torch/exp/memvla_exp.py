"""MemVLA experiment (port of dexbotic_tpu/exp/memvla_exp.py).

Defaults as the JAX package's: LLaMA-2-7B + CLIP-L/336 + ``mlp2x_gelu``,
a DiT-B head with memory cross-attention, action_dim 7, chunk 16, and the
memory surface (per tokens of 256 channels, a bank of 16 entries, two
retrieval layers, timestep embeddings, gate fusion, ToMe consolidation).
``load_for_inference`` lays the model out in the serving dtype (bf16, or
int8 / w8a8 through ``inference_quantize``) on ``device`` and fills it from
``model_name_or_path`` if set: a port ``checkpoint-{step}`` directory, or a
released checkpoint converted by ``utils/convert.convert_memvla``.  Serving
is ``exp/serve.MemVLAServer``: one episode's bank across requests, reset by
the request field ``episode_first_frame``.

Training follows ``dataloader_type`` (``exp/mem_trainer.episode_batches``):
'parallel_stream' keeps a bank a row, 'group' / 'stream' one bank shared by
the batch's consecutive frames.  The bank is the Trainer's aux state, carried
from step to step and not checkpointed; each batch carries 'timesteps' (each
row's frame in its episode) and 'episode_reset'.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.mem_trainer import episode_batches
from dexbotic_tpu_torch.models import presets
from dexbotic_tpu_torch.models.memvla import (
    MemVLAConfig,
    build_memvla,
    init_mem_state,
    memvla_inference_action,
    memvla_loss,
    reset_mem_rows,
)
from dexbotic_tpu_torch.models.vlm import VLMConfig
from dexbotic_tpu_torch.utils.convert import convert_memvla


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
    dataloader_type: str = "parallel_stream"  # | 'group' | 'stream'
    group_size: int = 8
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

    @property
    def sequential_bank(self) -> bool:
        return self.model.dataloader_type in ("group", "stream")

    def build_model(self, tokenizer):
        """(config, fp32 model on ``device``, the stateful loss_fn(model,
        batch, generator, state) -> (loss, metrics, new state)); 'group' and
        'stream' take the sequential single-bank semantics."""
        cfg = self.model.build_config()
        model = self.model.build_params(cfg, self.device)
        sequential, remat = self.sequential_bank, self.trainer.gradient_checkpointing

        def loss_fn(model, batch, generator, state):
            return memvla_loss(model, cfg, batch, state, generator, sequential_bank=sequential,
                               remat=remat)

        return cfg, model, loss_fn

    def build_aux_state(self, batch_size: int) -> dict:
        """The training bank: one a row, or one shared bank in 'group' / 'stream' mode."""
        return init_mem_state(self.model.build_config(), 1 if self.sequential_bank else batch_size,
                              device=self.device)

    def make_data_schedule(self, dataset, batch_size: int, shard: int = 0, num_shards: int = 1):
        return episode_batches(dataset, batch_size, mode=self.model.dataloader_type,
                               group_size=self.model.group_size, seed=self.trainer.seed,
                               shard=shard, num_shards=num_shards)

    def schedule_batches(self, dataset, collator, batch_size: int, shard: int = 0,
                         num_shards: int = 1):
        """The episode-ordered batches, the schedule looped for more epochs:
        collated rows plus 'timesteps' and 'episode_reset' (in 'group' mode
        the first row always resets: the reference empties every bank at the
        head of a 'group' forward).  A schedule batch short of
        ``batch_size`` is skipped."""
        mode = self.model.dataloader_type
        while True:
            any_batch = False
            for sched in self.make_data_schedule(dataset, batch_size, shard, num_shards):
                if len(sched) < batch_size:
                    continue
                any_batch = True
                batch = collator([dataset[i] for i, _ in sched])
                batch["timesteps"] = np.asarray(
                    [float(dataset.global_index[i][2]) for i, _ in sched], np.float32)
                resets = [start for _, start in sched]
                if mode == "group":
                    resets[0] = True
                batch["episode_reset"] = np.asarray(resets, bool)
                yield batch
            if not any_batch:
                return

    def train(self) -> dict:
        """Episode-ordered training with the bank carried by the Trainer."""
        from dexbotic_tpu_torch.data.collator import Collator
        from dexbotic_tpu_torch.exp.trainer import Trainer
        from dexbotic_tpu_torch.parallel import multihost

        multihost.maybe_initialize(device=self.device)
        self._auto_compute_norm_stats()
        tokenizer = self.tokenizer.build_tokenizer()
        _, model, loss_fn = self.build_model(tokenizer)
        dataset = self.data.build_data(self.build_tokenization(tokenizer),
                                       self.action.build_action_process_func())
        collator = Collator(pad_token_id=tokenizer.pad_token_id,
                            max_length=self.tokenizer.model_max_length)
        with open(self.action.statistic_mapping) as f:
            norm_stats_json = f.read()
        B = self.trainer.per_device_batch_size
        if self.model.dataloader_type == "group" and B != self.model.group_size:
            raise ValueError(f"'group' mode trains one group a step: set per_device_batch_size "
                             f"({B}) == group_size ({self.model.group_size})")
        if self.sequential_bank and self.trainer.mesh_data not in (None, 1):
            raise ValueError(f"'{self.model.dataloader_type}' mode is sequential within the "
                             f"batch; use mesh_data=1 (got {self.trainer.mesh_data})")
        trainer = Trainer(loss_fn, model, self.trainer, self.optimizer,
                          norm_stats_json=norm_stats_json, aux_state=self.build_aux_state(B))
        if self.sequential_bank and trainer.data_size > 1:
            raise ValueError(f"'{self.model.dataloader_type}' mode is sequential within the "
                             f"batch: it cannot split over {trainer.data_size} data ranks")
        try:
            return trainer.train(self.schedule_batches(dataset, collator, B, trainer.data_rank,
                                                       trainer.data_size))
        finally:
            trainer.close()


if __name__ == "__main__":
    MemVLAExp.main()
