"""Env batch creation and management (port of dexbotic_tpu/sim_envs/factory.py)."""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Type

from dexbotic_tpu_torch.sim_envs.base import BaseEnvWrapper, MockEnvWrapper


def _get_env_class(env_type: str, task_suite_name: str) -> Type[BaseEnvWrapper]:
    if env_type == "mock":
        return MockEnvWrapper
    if env_type == "libero":
        from dexbotic_tpu_torch.sim_envs.libero_env import LiberoEnvWrapper

        return LiberoEnvWrapper
    raise ValueError(f"unknown env type: {env_type}")


def create_env_batch(
    env_type: str,
    task_suite_name: str,
    task_names: List[str],
    trial_ids: List[int],
    trial_seeds: List[int],
    config: Any,
    threaded: bool = True,
) -> List[BaseEnvWrapper]:
    """One env a (task, trial, seed), initialised in threads (a LIBERO env
    starts a process and waits for it) or in turn."""
    cls = _get_env_class(env_type, task_suite_name)
    envs = [
        cls(task_name=t, trial_id=i, trial_seed=s, config=config)
        for t, i, s in zip(task_names, trial_ids, trial_seeds)
    ]
    if threaded and len(envs) > 1:
        threads = [threading.Thread(target=e.initialize) for e in envs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for e in envs:
            e.initialize()
    return envs


def close_env_batch(envs: List[BaseEnvWrapper]) -> None:
    for e in envs:
        try:
            e.close()
        except Exception:  # noqa: BLE001 (closing the rest matters more)
            pass


class EnvBatchManager:
    def __init__(self, env_type: str, task_suite_name: str, config: Any, **kw):
        self.env_type = env_type
        self.task_suite_name = task_suite_name
        self.config = config
        self.envs: List[BaseEnvWrapper] = []

    def create_batch(self, task_names, trial_ids, trial_seeds, threaded=True):
        self.envs = create_env_batch(
            self.env_type, self.task_suite_name, task_names, trial_ids, trial_seeds,
            self.config, threaded=threaded,
        )
        return self.envs

    def close_batch(self) -> None:
        close_env_batch(self.envs)
        self.envs = []

    def get_active_environments(self) -> List[BaseEnvWrapper]:
        return [e for e in self.envs if e.is_active()]

    def get_batch_statistics(self) -> Dict[str, int]:
        return {
            "total": len(self.envs),
            "active": sum(e.is_active() for e in self.envs),
            "complete": sum(e.is_complete() for e in self.envs),
        }

    def __del__(self):
        try:
            self.close_batch()
        except Exception:  # noqa: BLE001 (interpreter teardown)
            pass
