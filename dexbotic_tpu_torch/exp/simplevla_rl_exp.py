"""SimpleVLA-RL experiment: GRPO post-training of the OFT-Discrete actor
(port of dexbotic_tpu/exp/simplevla_rl_exp.py).

Env batches from a task sampler -> chunked sampled rollouts with each
chunk's log-probs kept -> binary success reward -> accuracy filter ->
circular redistribution -> PPO-clip update with GRPO advantages.  The actor
trains in the JAX init's fp32 on ``device``; a rollout's images and prompt
are made on the host, its bins drawn on the device.  Across processes
(torchrun, or the DEXBOTIC_* variables of ``parallel/multihost``) each
process rolls out its own envs from its own seeds (``seed + rank``), the
buffers are gathered so that every process holds the same union, and the
update runs over a ('data', 'model') mesh whose data size is
``mesh_data`` or the largest that divides both the processes and the
micro-batch.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dexbotic_tpu_torch.data.dex_rl_dataset import (
    BufferedRLDataLoader,
    DexRLDataset,
    process_rank_and_count,
)
from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.oft_exp import OFTModelConfig
from dexbotic_tpu_torch.exp.rl.grpo import GRPOConfig
from dexbotic_tpu_torch.exp.rl.rl_trainer import (
    GRPOUpdater,
    RolloutConfig,
    allgather_rollouts,
    collect_rollouts,
    filter_and_redistribute,
    flatten_rollouts,
    prepare_update_batch,
)
from dexbotic_tpu_torch.models.oft import oft_generate_action
from dexbotic_tpu_torch.parallel import multihost
from dexbotic_tpu_torch.parallel.mesh import make_mesh, mesh_requested
from dexbotic_tpu_torch.sim_envs.base import extract_rgb
from dexbotic_tpu_torch.sim_envs.factory import create_env_batch
from dexbotic_tpu_torch.tokenization.tokenize import tokenizer_image_token


def update_mesh_data(processes: int, model: int, micro_batch_size: int) -> int:
    """The GRPO update mesh's data size: the largest the micro-batch can be
    split over, ``gcd(processes // model, micro_batch_size)``, as the JAX
    recipe picks it.  JAX lays that mesh over the first data x model devices
    and leaves the others out of the update; here the mesh covers every
    process (one a card), so a size short of ``processes // model`` is
    refused (ROADMAP Queue 3)."""
    data = math.gcd(processes // model, micro_batch_size) or 1
    if data * model != processes:
        raise ValueError(
            f"the GRPO update's mesh must cover all {processes} processes, but "
            f"micro_batch_size {micro_batch_size} splits over {data} data ranks x mesh_model "
            f"{model}: make micro_batch_size a multiple of processes // mesh_model, or set "
            f"mesh_data (the JAX recipe would update on the first {data * model} devices alone)")
    return data


@dataclass
class RLEnvConfig(base_exp.Config):
    env_type: str = "mock"  # 'mock' | 'libero'
    task_suite_name: str = "libero_spatial"
    task_names: tuple = ("task_0",)
    num_envs: int = 8
    max_episode_steps: int = 512
    obs_dim: tuple = (224, 224, 3)
    camera_height: int = 256
    camera_width: int = 256
    mock_success_prob: float = 0.5


@dataclass
class RLDataLoaderConfig(base_exp.Config):
    """How each step's envs are drawn: schedule='random' draws a task for each
    group every step; schedule='epoch' enumerates every (task, trial) of the
    suite each epoch through data/dex_rl_dataset.py's BufferedRLDataLoader
    (a seeded shuffle each epoch, disjoint per-process slices, env_dup
    repeats)."""

    n_samples: int = 8  # rollouts per prompt group (GRPO)
    schedule: str = "random"  # 'random' | 'epoch'
    num_trials_per_task: int = 50
    env_dup: int = 1
    drop_last: bool = False

    def sample_env_batch(self, env_cfg: RLEnvConfig, rng: np.random.Generator):
        n_groups = max(1, env_cfg.num_envs // self.n_samples)
        tasks, trials, seeds, groups = [], [], [], []
        for g in range(n_groups):
            task = env_cfg.task_names[int(rng.integers(len(env_cfg.task_names)))]
            for s in range(self.n_samples):
                tasks.append(task)
                trials.append(g * self.n_samples + s)
                seeds.append(int(rng.integers(1 << 30)))
                groups.append(g)
        return tasks, trials, seeds, np.asarray(groups), n_groups

    def build_loader(self, env_cfg: RLEnvConfig, seed: int):
        ds = DexRLDataset(list(env_cfg.task_names), num_trials_per_task=self.num_trials_per_task,
                          env_type=env_cfg.env_type, task_suite_name=env_cfg.task_suite_name)
        n_groups = max(1, env_cfg.num_envs // self.n_samples)
        return BufferedRLDataLoader(ds, batch_size=n_groups, env_dup=self.env_dup,
                                    drop_last=self.drop_last, seed=seed)

    def expand_groups(self, base_specs, rng: np.random.Generator):
        """A loader batch (base EnvSpecs) -> (tasks, trials, seeds, groups,
        n_groups): each spec is one GRPO prompt group, rolled out n_samples
        times with distinct episode seeds."""
        tasks, trials, seeds, groups = [], [], [], []
        for g, spec in enumerate(base_specs):
            for _ in range(self.n_samples):
                tasks.append(spec.task_name)
                trials.append(spec.trial_id)
                seeds.append(int(rng.integers(1 << 30)))
                groups.append(g)
        return tasks, trials, seeds, np.asarray(groups), len(base_specs)


@dataclass
class SimpleVLARLExp(base_exp.BaseExp):
    exp_name: str = "simplevla_rl"
    model: OFTModelConfig = field(
        default_factory=lambda: OFTModelConfig(action_model_type="Discrete"))
    env: RLEnvConfig = field(default_factory=RLEnvConfig)
    rl_data: RLDataLoaderConfig = field(default_factory=RLDataLoaderConfig)
    grpo: GRPOConfig = field(default_factory=lambda: GRPOConfig(entropy_coeff=0.001))
    rollout: RolloutConfig = field(default_factory=RolloutConfig)
    rl_epochs: int = 1
    rl_steps_per_epoch: int = 4
    micro_batch_size: int = 8
    rl_learning_rate: float = 1e-6
    prompt_text_len: int = 16

    def _make_actor(self, cfg, model, tokenizer):
        """actor_fn(obs_list, instructions, generator) for collect_rollouts:
        each env's frame preprocessed on the host, the prompt
        ``<image>\\n{instruction}`` cut and right-padded to num_image_tokens +
        prompt_text_len tokens, the bins sampled at the rollout temperature."""
        from dexbotic_tpu_torch.data.image_processing import preprocess_image

        nt = cfg.vlm.num_image_tokens
        proc = self.data.build_image_processor()
        device = next(model.parameters()).device

        def actor_fn(obs_list, instructions, generator):
            B = len(obs_list)
            imgs = np.stack([preprocess_image(extract_rgb(o), proc) for o in obs_list])[:, None]
            L = nt + self.prompt_text_len
            ids = np.zeros((B, L), np.int64)
            valid = np.zeros((B, L), bool)
            for i, inst in enumerate(instructions):
                text = tokenizer_image_token(f"<image>\n{inst}", tokenizer, num_image_tokens=nt)
                text = text[:L]
                ids[i, : len(text)] = text
                valid[i, : len(text)] = True
            actions, bins, logp = oft_generate_action(
                model, cfg, torch.from_numpy(ids).to(device), torch.from_numpy(valid).to(device),
                torch.from_numpy(imgs).to(device), None, generator,
                temperature=self.rollout.temperature)
            return actions, bins, logp, ids, valid, imgs[:, 0]

        return actor_fn

    def train_rl(self):
        """Rollouts, filter and update, ``rl_epochs`` x ``rl_steps_per_epoch``
        times.  Returns (the trained model, one metrics dict a step)."""
        multihost.maybe_initialize(device=self.device)
        mesh = None
        model_size = self.trainer.mesh_model
        if mesh_requested(self.trainer.mesh_data, model_size):
            data = self.trainer.mesh_data or update_mesh_data(
                multihost.process_count(), model_size, self.micro_batch_size)
            mesh = make_mesh(data, model_size, device_type=torch.device(self.device).type)
        cfg = self.model.build_config()
        model = self.model.build_params(cfg, self.device)  # fp32, as the JAX init
        tokenizer = self.tokenizer.build_tokenizer()
        updater = GRPOUpdater(cfg, self.grpo, model, learning_rate=self.rl_learning_rate,
                              temperature=self.rollout.temperature, mesh=mesh)
        pid, nproc = process_rank_and_count()
        host_rng = np.random.default_rng(self.trainer.seed + pid)
        generator = torch.Generator(device=self.device).manual_seed(self.trainer.seed + pid)
        actor = self._make_actor(cfg, model, tokenizer)
        loader = (self.rl_data.build_loader(self.env, self.trainer.seed)
                  if self.rl_data.schedule == "epoch" else None)
        history = []
        for epoch in range(self.rl_epochs):
            if loader is not None:
                loader.set_epoch(epoch)
                batches = iter(loader)
            for step in range(self.rl_steps_per_epoch):
                if loader is not None:
                    try:
                        base = next(batches)
                    except StopIteration:
                        batches = iter(loader)
                        base = next(batches)
                    tasks, trials, seeds, groups, n_groups = self.rl_data.expand_groups(
                        base, host_rng)
                else:
                    tasks, trials, seeds, groups, n_groups = self.rl_data.sample_env_batch(
                        self.env, host_rng)
                groups = np.asarray(groups) + pid * n_groups  # unique across processes
                envs = create_env_batch(self.env.env_type, self.env.task_suite_name, tasks,
                                        trials, seeds, self.env,
                                        threaded=self.env.env_type != "mock")
                # wall seconds of each phase, reported as timing/<phase>_s
                timing: dict = {}
                t0 = time.perf_counter()
                with updater.gathered():
                    buf = collect_rollouts(envs, actor, self.rollout, generator,
                                           group_index=groups)
                for e in envs:
                    e.close()
                timing["gen"] = time.perf_counter() - t0

                t0 = time.perf_counter()
                buf = allgather_rollouts(buf, pad_prompt_to=self.tokenizer.model_max_length)
                n_groups = n_groups * nproc
                idx, new_groups = filter_and_redistribute(buf, self.grpo, self.rollout, n_groups)
                timing["filter"] = time.perf_counter() - t0
                # reorder the episodes by the redistributed indices, then flatten
                buf.obs = {k: v[idx] for k, v in buf.obs.items()}
                buf.bins = buf.bins[idx]
                buf.old_logp = buf.old_logp[idx]
                buf.chunk_count = buf.chunk_count[idx]
                buf.success = buf.success[idx]
                buf.truncated = buf.truncated[idx]
                buf.group_index = new_groups
                buf.input_ids = buf.input_ids[idx]
                buf.prompt_valid = buf.prompt_valid[idx]
                flat = flatten_rollouts(buf)
                batch = prepare_update_batch(flat, self.grpo, n_groups,
                                             episode_success=buf.success,
                                             episode_group=buf.group_index)
                t0 = time.perf_counter()
                model, metrics = updater.update(model, batch, self.micro_batch_size)
                timing["update"] = time.perf_counter() - t0
                metrics["success_rate"] = float(buf.success.mean())
                metrics["truncated_frac"] = float(buf.truncated.mean())
                metrics["num_rollouts"] = int(buf.success.shape[0])
                metrics["mean_chunks_per_episode"] = float(buf.chunk_count.mean())
                for k, v in timing.items():
                    metrics[f"timing/{k}_s"] = round(v, 3)
                metrics["epoch"] = epoch
                metrics["step"] = step
                history.append(metrics)
                if pid == 0:
                    print(metrics)
        return model, history


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--task", default="train", choices=["train"])
    parser.parse_known_args()
    SimpleVLARLExp().train_rl()
