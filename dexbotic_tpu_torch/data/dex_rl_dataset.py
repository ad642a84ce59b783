"""RL env-config dataset and buffered loader (port of
dexbotic_tpu/data/dex_rl_dataset.py).

The dataset enumerates every (task, trial) env configuration of a suite as
one epoch; the loader shuffles it each epoch with a seed of its own, gives
each process a disjoint, equally sized slice of that order (the
DistributedSampler contract: padded cyclically unless ``drop_last``),
repeats each config ``env_dup`` times in a row and keeps an experience
buffer.  Rank and world size come from ``torch.distributed`` when it is
initialised, else 0 and 1.

GRPO grouping: each base config of a batch is one prompt group; the exp asks
for ``n_samples`` rollouts of each group.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """One environment configuration."""

    env_type: str
    task_suite_name: str
    task_name: str
    task_id: int
    trial_id: int
    trial_seed: int = -1
    data_source: str = ""
    uid: str = ""


class DexRLDataset:
    """Every task x trial of a suite, in order (shuffling and n_samples are
    the loader's and the exp's)."""

    def __init__(
        self,
        task_names: list[str],
        num_trials_per_task: int = 50,
        env_type: str = "libero",
        task_suite_name: str = "",
    ):
        if num_trials_per_task <= 0:
            raise ValueError(f"num_trials_per_task must be positive, got {num_trials_per_task}")
        self.configs: list[EnvSpec] = []
        for task_id, task in enumerate(task_names):
            for trial in range(num_trials_per_task):
                self.configs.append(
                    EnvSpec(
                        env_type=env_type,
                        task_suite_name=task_suite_name or task,
                        task_name=task,
                        task_id=task_id,
                        trial_id=trial,
                        data_source=f"{task}_task_{task_id}_trial_{trial}",
                        uid=str(uuid.uuid5(uuid.NAMESPACE_OID, f"{task}/{task_id}/{trial}")),
                    )
                )

    def __len__(self) -> int:
        return len(self.configs)

    def __getitem__(self, idx: int) -> EnvSpec:
        return self.configs[idx]


def process_rank_and_count() -> tuple[int, int]:
    """(rank, world size) of an initialised ``torch.distributed``, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class BufferedRLDataLoader:
    """Epoch iteration over env configs with per-process slices, env_dup
    repeats and an experience buffer.

    Each batch is ``batch_size`` base configs, each repeated ``env_dup``
    times in a row ([c0, c0, c1, c1, ...])."""

    def __init__(
        self,
        dataset: DexRLDataset,
        batch_size: int,
        env_dup: int = 1,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 42,
        rank: int | None = None,
        world_size: int | None = None,
    ):
        if rank is None or world_size is None:
            r, w = process_rank_and_count()
            rank = r if rank is None else rank
            world_size = w if world_size is None else world_size
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a world of {world_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.env_dup = env_dup
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0
        self.buffer: list[Any] = []

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for ``epoch`` (the DistributedSampler set_epoch contract)."""
        self.epoch = epoch

    def _rank_indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        if self.drop_last:
            per_rank = n // self.world_size
            order = order[: per_rank * self.world_size]
        else:
            # pad cyclically so that every rank gets as many samples
            per_rank = -(-n // self.world_size)
            pad = per_rank * self.world_size - n
            if pad:
                order = np.concatenate([order, order[:pad]])
        return order[self.rank :: self.world_size]

    @property
    def num_batches(self) -> int:
        per_rank = len(self._rank_indices())
        if self.drop_last:
            return per_rank // self.batch_size
        return -(-per_rank // self.batch_size)

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self):
        idx = self._rank_indices()
        for b in range(self.num_batches):
            base = [self.dataset[i] for i in idx[b * self.batch_size : (b + 1) * self.batch_size]]
            yield [spec for spec in base for _ in range(self.env_dup)]

    # -- experience buffer ---------------------------------------------------

    def add_to_buffer(self, experience) -> None:
        self.buffer.append(experience)

    def get_buffer_size(self) -> int:
        return len(self.buffer)

    def clear_buffer(self) -> None:
        self.buffer.clear()

    def sample_from_buffer(self, sample_size: int, rng: np.random.Generator | None = None):
        if sample_size >= len(self.buffer):
            return list(self.buffer)
        rng = rng or np.random.default_rng()
        idx = rng.choice(len(self.buffer), sample_size, replace=False)
        return [self.buffer[i] for i in idx]
