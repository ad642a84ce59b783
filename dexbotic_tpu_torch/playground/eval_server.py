"""Success-rate evaluation harness (port of playground/eval_server.py): drive
a deployed action server with sim envs and report each task's success.

Usage:
    # terminal 1: a policy server, e.g.
    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_cogact --task inference
    # terminal 2:
    python -m dexbotic_tpu_torch.playground.eval_server --env_type mock \
        --task_names task_0 task_1 --episodes_per_task 10 \
        --url http://localhost:7891/process_frame

Works against any server speaking the /process_frame protocol.  Episode
``ep`` of a task runs with trial id and seed ``ep``; ``--env_type mock``
needs no simulator (its observations and outcomes follow the seed alone),
``--env_type libero`` needs the ``libero`` package.  The report holds the
success rate of each task (``per_task``) and over all episodes
(``average``), the episodes, the frames sent through the client and the
wall time in seconds.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np

from dexbotic_tpu_torch.client import DexClient
from dexbotic_tpu_torch.sim_envs.base import extract_rgb
from dexbotic_tpu_torch.sim_envs.factory import create_env_batch


def evaluate(
    url: str,
    env_type: str,
    task_suite: str,
    task_names: list[str],
    episodes_per_task: int,
    max_steps: int,
    execute_steps: int,
    config,
) -> dict:
    """Run ``episodes_per_task`` episodes of each task, one env at a time,
    each until it is done or has taken ``max_steps`` steps; the client asks
    the server for a chunk every ``execute_steps`` actions."""
    client = DexClient(url=url, execute_steps=execute_steps)
    results = defaultdict(list)
    t_start = time.time()
    frames = 0

    for task in task_names:
        for ep in range(episodes_per_task):
            env = create_env_batch(env_type, task_suite, [task], [ep], [ep], config,
                                   threaded=False)[0]
            client.reset()
            obs = env.get_obs()
            instruction = env.get_instruction()
            done = False
            while not done and env.get_step_count() < max_steps:
                action = client.act(extract_rgb(obs), instruction)
                frames += 1
                obs, done = env.step(np.asarray(action)[None])
            results[task].append(float(env.is_complete()))
            env.close()

    return {
        "per_task": {t: float(np.mean(v)) for t, v in results.items()},
        "average": float(np.mean([x for v in results.values() for x in v])),
        "episodes": sum(len(v) for v in results.values()),
        "frames": frames,
        "wall_s": round(time.time() - t_start, 1),
    }


class EvalConfig:
    """The env settings of a harness run (the attributes the env wrappers read)."""

    def __init__(self, task_suite: str, max_steps: int):
        self.task_suite_name = task_suite
        self.max_episode_steps = max_steps
        self.obs_dim = (224, 224, 3)
        self.camera_height = 256
        self.camera_width = 256
        self.mock_success_prob = 0.5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="http://localhost:7891/process_frame")
    ap.add_argument("--env_type", default="mock", choices=["mock", "libero"])
    ap.add_argument("--task_suite", default="libero_spatial")
    ap.add_argument("--task_names", nargs="+", default=["task_0"])
    ap.add_argument("--episodes_per_task", type=int, default=10)
    ap.add_argument("--max_steps", type=int, default=512)
    ap.add_argument("--execute_steps", type=int, default=8)
    args = ap.parse_args()

    report = evaluate(
        args.url, args.env_type, args.task_suite, args.task_names, args.episodes_per_task,
        args.max_steps, args.execute_steps, EvalConfig(args.task_suite, args.max_steps),
    )
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
