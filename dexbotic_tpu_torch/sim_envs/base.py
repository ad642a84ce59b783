"""Environment wrapper interface and the mock env (port of
dexbotic_tpu/sim_envs/base.py).

The reference's surface: initialize / get_obs / get_instruction / step /
close, with active / complete / finish_step state and a lock made on first
use (so that a wrapper can be pickled for a spawned process).  Numpy only:
the mock env draws from ``np.random.default_rng(trial_seed)`` and gives the
JAX package's observations and outcomes bit for bit.
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Tuple

import numpy as np


def extract_rgb(obs) -> np.ndarray:
    """The policy camera's frame out of an observation, whatever the
    backend's schema: the mock's nested dicts, or LIBERO's flat keys, whose
    frame is rendered upside down and flipped here."""
    if "observation" in obs:  # mock / robotwin-style
        return obs["observation"]["head_camera"]["rgb"]
    if "agentview_image" in obs:  # libero
        return obs["agentview_image"][::-1]
    raise KeyError(f"no rgb in obs keys {list(obs)}")


class BaseEnvWrapper(ABC):
    def __init__(self, task_name: str, trial_id: int, trial_seed: int, config: Any):
        self.task_name = task_name
        self.trial_id = trial_id
        self.trial_seed = trial_seed
        self.config = config

        self.env = None
        self.active = True
        self.complete = False
        self.finish_step = 0
        self._lock = None
        self.instruction = None

    @property
    def lock(self):
        # re-entrant: step() calls get_obs() while holding it
        if self._lock is None:
            self._lock = threading.RLock()
        return self._lock

    @abstractmethod
    def initialize(self) -> None: ...

    @abstractmethod
    def get_obs(self) -> Dict[str, Any]: ...

    @abstractmethod
    def get_instruction(self) -> str: ...

    @abstractmethod
    def step(self, action: np.ndarray) -> Tuple[Optional[Dict[str, Any]], bool]: ...

    @abstractmethod
    def close(self) -> None: ...

    def is_active(self) -> bool:
        return self.active

    def is_complete(self) -> bool:
        return self.complete

    def get_step_count(self) -> int:
        return self.finish_step


class MockEnvWrapper(BaseEnvWrapper):
    """An env of random observations and outcomes, deterministic in
    ``trial_seed``: the RL loop runs without a simulator.  An episode ends
    at ``max_episode_steps`` or, after any step, with probability 0.01; it
    succeeds with probability ``mock_success_prob``."""

    def __init__(self, task_name: str, trial_id: int, trial_seed: int, config: Any):
        super().__init__(task_name, trial_id, trial_seed, config)
        self.max_steps = getattr(config, "max_episode_steps", 100)
        self.obs_dim = getattr(config, "obs_dim", (224, 224, 3))
        self.success_prob = getattr(config, "mock_success_prob", 0.5)
        self._rng = np.random.default_rng(trial_seed)

    def initialize(self) -> None:
        with self.lock:
            self.instruction = f"Mock task: {self.task_name}"

    def get_obs(self) -> Dict[str, Any]:
        with self.lock:
            return {
                "observation": {
                    "head_camera": {
                        "rgb": self._rng.integers(0, 255, self.obs_dim, dtype=np.uint8)
                    }
                },
                "joint_action": {"vector": self._rng.standard_normal(7).astype(np.float32)},
            }

    def get_instruction(self) -> str:
        return self.instruction or f"Mock task: {self.task_name}"

    def step(self, action: np.ndarray) -> Tuple[Optional[Dict[str, Any]], bool]:
        with self.lock:
            action = np.asarray(action)
            self.finish_step += action.shape[0] if action.ndim > 0 else 1
            done = self.finish_step >= self.max_steps or self._rng.random() < 0.01
            if done:
                self.active = False
                self.complete = bool(self._rng.random() < self.success_prob)
            obs = None if done else self.get_obs()
            return obs, done

    def close(self) -> None:
        with self.lock:
            self.env = None
            self.active = False
