"""LIBERO environment wrapper: one spawned process an env (port of
dexbotic_tpu/sim_envs/libero_env.py).

Each env runs :func:`libero_env_worker` in its own process, fed through an
input and an output queue: an action array steps it, ``None`` asks for a
fresh initial state, ``"close"`` ends it; a failure comes back as
``{"type": "error"}``.  The ``libero`` package is needed at run time only:
this module imports without it, and :class:`LiberoEnvWrapper` raises an
ImportError when it is constructed without it (``MockEnvWrapper`` runs the
RL loop where it is absent).
"""

from __future__ import annotations

import importlib.util
import multiprocessing as mp
from typing import Any, Dict, Optional, Tuple

import numpy as np

from dexbotic_tpu_torch.sim_envs.base import BaseEnvWrapper

_INIT_LOCK = mp.Lock()  # LIBERO's global init is not thread- or process-safe


def libero_env_worker(task_suite_name, task_name, trial_seed, config, in_q, out_q):
    """The worker process: owns one LIBERO env and serves init/step requests."""
    try:
        from libero.libero import benchmark  # type: ignore
        from libero.libero.envs import OffScreenRenderEnv  # type: ignore
    except ImportError as e:  # pragma: no cover
        out_q.put({"type": "error", "error": f"libero not installed: {e}"})
        return

    try:
        bm = benchmark.get_benchmark_dict()[task_suite_name]()
        task_id = [t.name for t in bm.tasks].index(task_name)
        task = bm.get_task(task_id)
        init_states = bm.get_task_init_states(task_id)
        env = OffScreenRenderEnv(
            bddl_file_name=bm.get_task_bddl_file_path(task_id),
            camera_heights=getattr(config, "camera_height", 256),
            camera_widths=getattr(config, "camera_width", 256),
        )
        env.seed(trial_seed)

        def fresh_init():
            env.reset()
            obs = env.set_init_state(init_states[trial_seed % len(init_states)])
            for _ in range(10):  # let the objects settle
                obs, *_ = env.step(np.zeros(7))
            return obs

        obs = fresh_init()
        out_q.put({"type": "ready", "obs": _pack_obs(obs), "instruction": task.language})

        while True:
            msg = in_q.get()
            if msg is None:
                obs = fresh_init()
                out_q.put({"type": "obs", "obs": _pack_obs(obs), "done": False, "success": False})
                continue
            if isinstance(msg, str) and msg == "close":
                break
            done = False
            success = False
            for a in np.atleast_2d(np.asarray(msg)):
                obs, reward, done, info = env.step(a)
                success = bool(done)
                if done:
                    break
            out_q.put({"type": "obs", "obs": _pack_obs(obs) if not done else None,
                       "done": done, "success": success})
        env.close()
    except Exception as e:  # noqa: BLE001 (reported to the wrapper)
        out_q.put({"type": "error", "error": str(e)})


def _pack_obs(obs) -> Dict[str, Any]:
    return {
        "agentview_image": np.asarray(obs["agentview_image"]),
        "robot0_eye_in_hand_image": np.asarray(obs.get("robot0_eye_in_hand_image")),
        "robot0_joint_pos": np.asarray(obs.get("robot0_joint_pos")),
        "robot0_eef_pos": np.asarray(obs.get("robot0_eef_pos")),
        "robot0_gripper_qpos": np.asarray(obs.get("robot0_gripper_qpos")),
    }


class LiberoEnvWrapper(BaseEnvWrapper):
    QUEUE_TIMEOUT = 300

    def __init__(self, task_name: str, trial_id: int, trial_seed: int, config: Any):
        if importlib.util.find_spec("libero") is None:
            raise ImportError("LiberoEnvWrapper needs the `libero` package (LIBERO's "
                              "simulator), which is not installed; env_type='mock' runs "
                              "the RL loop without it")
        super().__init__(task_name, trial_id, trial_seed, config)
        self.task_suite_name = getattr(config, "task_suite_name", "libero_spatial")
        self.proc: Optional[mp.Process] = None
        self.in_q = None
        self.out_q = None
        self._last_obs = None

    def initialize(self) -> None:
        with _INIT_LOCK:
            ctx = mp.get_context("spawn")
            self.in_q = ctx.Queue()
            self.out_q = ctx.Queue()
            self.proc = ctx.Process(
                target=libero_env_worker,
                args=(self.task_suite_name, self.task_name, self.trial_seed,
                      self.config, self.in_q, self.out_q),
                daemon=True,
            )
            self.proc.start()
        msg = self.out_q.get(timeout=self.QUEUE_TIMEOUT)
        if msg["type"] == "error":
            self.active = False
            raise RuntimeError(f"libero worker failed: {msg['error']}")
        self.instruction = msg["instruction"]
        self._last_obs = msg["obs"]

    def get_obs(self) -> Dict[str, Any]:
        return self._last_obs

    def get_instruction(self) -> str:
        return self.instruction

    def step(self, action: np.ndarray) -> Tuple[Optional[Dict[str, Any]], bool]:
        with self.lock:
            self.in_q.put(np.asarray(action))
            msg = self.out_q.get(timeout=self.QUEUE_TIMEOUT)
            if msg["type"] == "error":
                self.active = False
                return None, True
            self.finish_step += len(np.atleast_2d(action))
            if msg["done"]:
                self.active = False
                self.complete = msg["success"]
            self._last_obs = msg["obs"]
            return msg["obs"], msg["done"]

    def close(self) -> None:
        with self.lock:
            self.active = False
            try:
                if self.in_q is not None:
                    self.in_q.put("close")
                if self.proc is not None:
                    self.proc.join(timeout=5)
                    if self.proc.is_alive():
                        self.proc.terminate()
            except Exception:  # noqa: BLE001 (the process may be gone)
                pass
