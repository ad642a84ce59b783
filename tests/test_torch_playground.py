"""The port's playground twins against the JAX package's files.

The benchmark recipes (CALVIN, ManiSkill2, RoboTwin2.0, SimplerEnv) and the
two examples hold the JAX recipes' values in every field the two exps
share; the success-rate harness, JAX's and the port's, gives the same
report against one tiny port server with the mock env; the SO-101 bridge's
worker, JAX's and the port's, puts the same (timestep, action) pairs on its
queue for the same observations.
"""

import dataclasses
import importlib
import queue
import threading

import numpy as np
import pytest
import torch

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
from dexbotic_tpu_torch.exp.serve import CogActServer

torch.set_num_threads(2)

TWINS = [  # (path under playground/, exp class)
    ("benchmarks.calvin.calvin_cogact", "CalvinCogActExp"),
    ("benchmarks.calvin.calvin_oft", "CalvinOFTExp"),
    ("benchmarks.maniskill2.maniskill2_cogact", "ManiskillCogActExp"),
    ("benchmarks.maniskill2.maniskill2_oft", "ManiskillOFTExp"),
    ("benchmarks.maniskill2.maniskill2_pi0", "Maniskill2Pi0Exp"),
    ("benchmarks.robotwin2.robotwin2_cogact", "RoboTwin2CogActExp"),
    ("benchmarks.simpler.simpler_cogact", "SimplerCogActExp"),
    ("benchmarks.simpler.simpler_memvla", "SimplerMemVLAExp"),
    ("benchmarks.simpler.simpler_oft", "SimplerOFTExp"),
    ("example_exp", "MyExp"),
    ("example_memvla_exp", "MyMemVLAExp"),
]


@pytest.mark.parametrize("path,cls", TWINS, ids=[p.rsplit(".", 1)[-1] for p, _ in TWINS])
def test_twin_matches_jax_recipe(path, cls):
    """Every field the two exps share holds the JAX recipe's value, the
    shared fields are at least half of each JAX config's, and the exp name
    and the ManiSkill2 recipes' suite list are the same."""
    jmod = importlib.import_module(f"playground.{path}")
    tmod = importlib.import_module(f"dexbotic_tpu_torch.playground.{path}")
    j, t = getattr(jmod, cls)(), getattr(tmod, cls)()
    assert t.exp_name == j.exp_name
    for part in ("model", "data", "action", "tokenizer", "optimizer", "trainer"):
        jd, td = dataclasses.asdict(getattr(j, part)), dataclasses.asdict(getattr(t, part))
        common = sorted(set(jd) & set(td))
        assert len(common) >= len(jd) // 2, (part, sorted(set(jd) - set(td)))
        assert {k: td[k] for k in common} == {k: jd[k] for k in common}, part
    assert getattr(tmod, "MANISKILL_SUITES", None) == getattr(jmod, "MANISKILL_SUITES", None)


@pytest.fixture(scope="module")
def tiny_server():
    """A tiny CogACT served on the CPU through the port's /process_frame."""
    exp = CogActExp(
        model=CogActModelConfig(llm_preset="test", vit_preset="test", action_model_type="DiT-S",
                                chunk_size=8, seed=7),
        tokenizer=base_exp.TokenizerConfig(model_max_length=96),
        data=base_exp.DataConfig(image_processor="28"),
        device="cpu",
    )
    cfg, model, norms = exp.load_for_inference()
    server = CogActServer(exp, cfg, model, exp.tokenizer.build_tokenizer(), norms,
                          host="127.0.0.1", port=0)
    httpd = server.serve_background()
    yield server, f"http://127.0.0.1:{httpd.server_address[1]}/process_frame"
    httpd.shutdown()
    httpd.server_close()


def test_harness_matches_jax(tiny_server):
    """Both harnesses with the mock env, 2 tasks x 2 episodes, against one
    port server: equal reports but for the wall time, and the same number
    of requests (one every ``execute_steps`` frames of an episode).  The
    arguments are chip_smoke phase 15e's, and so are the report and the
    requests that phase holds the card's run to."""
    pytest.importorskip("requests")  # the JAX client's transport
    import chip_smoke
    from dexbotic_tpu_torch.playground import eval_server as teval
    from playground import eval_server as jeval

    server, url = tiny_server
    tasks, episodes, max_steps, execute = chip_smoke.HARNESS_ARGS
    args = (url, "mock", "libero_spatial", list(tasks), episodes, max_steps, execute,
            teval.EvalConfig("libero_spatial", max_steps))
    reports, requests = [], []
    for harness in (jeval, teval):
        calls = server.host_calls
        reports.append(harness.evaluate(*args))
        requests.append(server.host_calls - calls)
    jrep, trep = reports
    assert set(trep) == set(jrep) == {"per_task", "average", "episodes", "frames", "wall_s"}
    assert {k: v for k, v in trep.items() if k != "wall_s"} == \
        {k: v for k, v in jrep.items() if k != "wall_s"}
    assert trep["episodes"] == 4 and set(trep["per_task"]) == {"task_0", "task_1"}
    assert requests[0] == requests[1] == chip_smoke.HARNESS_REQUESTS
    assert {k: v for k, v in jrep.items() if k != "wall_s"} == chip_smoke.HARNESS_REPORT


class _StubClient:
    """Answers ``act`` with an action computed from the image and the state,
    and records the instruction of every call."""

    def __init__(self):
        self.calls = []

    def act(self, image, instruction, state=None):
        self.calls.append(instruction)
        img = np.asarray(image, np.float64)
        st = np.zeros(7) if state is None else np.asarray(state, np.float64)
        return np.concatenate([[img.mean(), img.std()], st[:5]]) * (1 + len(self.calls))


def _run_bridge(state_cls, observations):
    state = state_cls(_StubClient(), "pick up the block", "front", "joints")
    worker = threading.Thread(target=state.worker, daemon=True)
    worker.start()
    for item in observations:
        state.obs_queue.put(item)  # waits while two observations are queued
    out = [state.action_queue.get(timeout=30) for _ in observations]
    state.running = False
    worker.join(timeout=5)
    assert not worker.is_alive()
    with pytest.raises(queue.Empty):
        state.action_queue.get_nowait()
    return out, state.client.calls


def test_bridge_worker_matches_jax():
    from dexbotic_tpu_torch.playground.so101.bridge_server import BridgeState
    from hardware.so101.bridge_server import BridgeState as JBridgeState

    rng = np.random.default_rng(4)
    observations = [(ts, {"front": rng.integers(0, 256, (12, 16, 3), dtype=np.uint8),
                          "joints": rng.standard_normal(6).astype(np.float32)})
                    for ts in (3, 4, 7, 9)]
    observations.append((11, {"front": rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)}))
    (jout, jcalls), (tout, tcalls) = (_run_bridge(cls, observations)
                                      for cls in (JBridgeState, BridgeState))
    assert [ts for ts, _ in tout] == [ts for ts, _ in jout] == [3, 4, 7, 9, 11]
    for (_, a), (_, b) in zip(tout, jout):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)
    assert tcalls == jcalls == ["pick up the block"] * 5
