"""The port's MemVLA training against the JAX package, on the CPU in fp32.

* ``bank_step_sequential`` over 6 rows of one episode, the bank emptied
  before rows 0 and 3: both roles' fused tokens and the final bank.
* ``memvla_loss`` in both bank modes (a bank a row with one row reset, and
  the sequential single bank), the diffusion timesteps and noise injected:
  the loss, the new bank, and the gradients of the projector, the SE
  bottleneck, the bank's modules and the DiT against ``jax.value_and_grad``.
* The schedules of ``exp/mem_trainer.py``: ``episode_batches`` in its three
  modes and over 2 shards, and ``length_grouped_batches``, index for index.
* Three steps of the port's ``Trainer(aux_state=...)`` against the JAX
  ``Trainer(aux_state=...)`` on the same batches (``gradient_accumulation_steps``
  set and ignored by both): loss and grad_norm a step, every parameter, the
  carried bank.
* ``MemVLAExp.train()`` on a tiny synthetic suite in 'parallel_stream' and
  'group' mode, and the LIBERO MemVLA twin's fields against the JAX recipe.

Weights come from the JAX init with the zero (or ~0) outputs redrawn: the
DiT's final layer, its cross-attention out-projections and the fusion
gates.  Tolerance 1e-3 (fp32); indices and counts exact.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dexbotic_tpu.constants import IMAGE_TOKEN_INDEX
from dexbotic_tpu.data.registry import register_dataset
from dexbotic_tpu.exp import mem_trainer as jsched
from dexbotic_tpu.exp import optim as joptim
from dexbotic_tpu.exp import trainer as jtrainer
from dexbotic_tpu.models import memvla as jmem
from dexbotic_tpu.models import presets as jpresets
from dexbotic_tpu.models import vlm as jvlm
from dexbotic_tpu_torch.data import registry as tregistry
from dexbotic_tpu_torch.exp import mem_trainer as tsched
from dexbotic_tpu_torch.exp import optim as toptim
from dexbotic_tpu_torch.exp import trainer as ttrainer
from dexbotic_tpu_torch.models import memvla as tmem
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

torch.set_num_threads(2)
TOL = 1e-3
CHUNK, ADIM = 4, 3


def _pair(**kw):
    """(JAX config, port config) of a tiny MemVLA (2-layer test LLM, 4 per
    tokens of 16 channels, a bank of 3 entries so that rows consolidate, DiT-S)."""
    kw = dict(dict(action_model_type="DiT-S", action_dim=ADIM, chunk_size=CHUNK,
                   per_token_size=16, mem_length=3, repeated_diffusion_steps=2), **kw)
    return tuple(m.MemVLAConfig(vlm=v.VLMConfig(llm=p.LLM_TEST, vit=p.VIT_TEST,
                                                projector_type="mlp2x_gelu"), **kw)
                 for m, v, p in ((jmem, jvlm, jpresets), (tmem, tvlm, tpresets)))


def _jax_params(jcfg, seed=0):
    params = jax.device_get(jmem.init_memvla(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    head = params["action_head"]
    for leaf in ("w", "b"):
        head["final"][leaf] = rng.normal(0, 0.2, head["final"][leaf].shape).astype(np.float32)
        o = head["blocks"]["xattn"]["o"]
        o[leaf] = rng.normal(0, 0.05, o[leaf].shape).astype(np.float32)
    for role in ("per", "cog"):
        g = params["mem_bank"][role]["gate"]["proj"]
        g["w"] = rng.normal(0, 0.3, g["w"].shape).astype(np.float32)
    return params


def _port_model(tcfg, params):
    model = tmem.build_memvla(tcfg, "cpu", seed=1)
    load_jax_params(model, params)
    return model


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL, err_msg=what)


def _state_close(tstate, jstate):
    for role in ("per", "cog"):
        for key in ("feats", "times"):
            _close(tstate[role][key], jstate[role][key], f"{role}.{key}")
        np.testing.assert_array_equal(tstate[role]["count"].numpy(),
                                      np.asarray(jstate[role]["count"]))


def _batch(jcfg, seed, B, resets=None, t0=0):
    """A collated batch with 'timesteps', 'episode_reset' and injected
    diffusion draws (rep-major rows, as the loss tiles them)."""
    rng = np.random.default_rng(seed)
    nt = jcfg.vlm.num_image_tokens
    ids = rng.integers(1, 60, (B, nt + 6)).astype(np.int32)
    ids[:, :nt] = IMAGE_TOKEN_INDEX
    mask = np.ones(ids.shape, np.int32)
    mask[-1, -2:] = 0
    ids[mask == 0] = 0
    rows = B * jcfg.repeated_diffusion_steps
    return {
        "input_ids": ids, "attention_mask": mask,
        "images": rng.standard_normal((B, 1, 28, 28, 3)).astype(np.float32),
        "actions": np.tanh(rng.standard_normal((B, CHUNK, ADIM))).astype(np.float32),
        "timesteps": (t0 + np.arange(B)).astype(np.float32),
        "episode_reset": np.asarray(resets if resets is not None else [False] * B, bool),
        "diff_t": rng.integers(0, 100, (rows,)).astype(np.int32),
        "diff_noise": rng.standard_normal((rows, CHUNK, ADIM)).astype(np.float32),
    }


def _filled_state(jcfg, params, B, steps=2, seed=3):
    """A bank with entries in it: ``steps`` bank steps of random tokens (JAX)."""
    rng = np.random.default_rng(seed)
    state = jmem.init_mem_state(jcfg, B)
    H, P, N = jcfg.vlm.llm.hidden_size, jcfg.per_token_size, jcfg.num_per_tokens
    for s in range(steps):
        per = jnp.asarray(rng.normal(size=(B, N, P)).astype(np.float32))
        cog = jnp.asarray(rng.normal(size=(B, 1, H)).astype(np.float32))
        _, _, state = jmem.bank_step(params, jcfg, state, per, cog,
                                     jnp.full((B,), float(s), jnp.float32))
    return jax.device_get(state)


def _to_port_state(state):
    return {r: {k: _t(np.array(v)) for k, v in st.items()} for r, st in state.items()}


def test_bank_step_sequential_matches_jax():
    """6 consecutive frames of one episode against a single bank of 3 (it
    fills, consolidates, is emptied before row 3 and refills)."""
    jcfg, tcfg = _pair()
    params = _jax_params(jcfg)
    model = _port_model(tcfg, params)
    rng = np.random.default_rng(5)
    B, N = 6, jcfg.num_per_tokens
    per = rng.normal(size=(B, N, jcfg.per_token_size)).astype(np.float32)
    cog = rng.normal(size=(B, 1, jcfg.vlm.llm.hidden_size)).astype(np.float32)
    t = np.array([0, 1, 2, 0, 1, 2], np.float32)
    resets = np.array([True, False, False, True, False, False])
    state = _filled_state(jcfg, params, 1)
    jp, jc, jstate = jmem.bank_step_sequential(params, jcfg, state, *map(jnp.asarray,
                                               (per, cog, t, resets)))
    with torch.no_grad():
        tp, tc, tstate = tmem.bank_step_sequential(model, tcfg, _to_port_state(state),
                                                   *map(_t, (per, cog, t, resets)))
    _close(tp, jp, "fused per")
    _close(tc, jc, "fused cog")
    _state_close(tstate, jstate)
    assert int(tstate["per"]["count"][0]) == 3


def _watched(name: str) -> bool:
    return name.startswith(("vlm.projector.", "per_compr.", "mem_bank.", "action_head."))


@pytest.mark.parametrize("sequential", [False, True])
def test_memvla_loss_and_grads_match_jax(sequential):
    """The loss, the new bank and the gradients of the projector, the SE
    bottleneck, both roles' bank modules and the DiT, on injected t and noise."""
    jcfg, tcfg = _pair()
    params = _jax_params(jcfg)
    model = _port_model(tcfg, params).requires_grad_(True)
    B = 3
    batch = _batch(jcfg, 11, B, resets=[False, True, False], t0=2)
    state = _filled_state(jcfg, params, 1 if sequential else B)

    def jloss(p):
        loss, _, new = jmem.memvla_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                        state, jax.random.PRNGKey(0), sequential_bank=sequential,
                                        diffusion_t=jnp.asarray(batch["diff_t"]),
                                        diffusion_noise=jnp.asarray(batch["diff_noise"]))
        return loss, new

    (jl, jnew), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tb = {k: _t(v) for k, v in batch.items()}
    tl, metrics, tnew = tmem.memvla_loss(model, tcfg, tb, _to_port_state(state),
                                         sequential_bank=sequential, diffusion_t=tb["diff_t"],
                                         diffusion_noise=tb["diff_noise"])
    tl.backward()
    _close(tl, jl, "loss")
    assert set(metrics) == {"action_loss", "loss"}
    _state_close(tnew, jnew)
    got = dict(model.named_parameters())
    n = 0
    for name, val, _ in port_arrays(jax.device_get(jgrads)):
        if _watched(name):  # a parameter the loss does not reach has no .grad: JAX's zeros
            grad = got[name].grad
            _close(torch.zeros_like(got[name]) if grad is None else grad, val, name)
            n += 1
    assert n > 40 and np.abs(np.asarray(jgrads["mem_bank"]["per"]["gate"]["proj"]["w"])).max() > 0


class _Index:
    """A dataset stand-in: ``global_index`` of (dataset, file, frame)."""

    def __init__(self, lens, shuffle_seed=0):
        rows = [(0, f, t) for f, n in enumerate(lens) for t in range(n)]
        np.random.default_rng(shuffle_seed).shuffle(rows)
        self.global_index = [tuple(int(x) for x in r) for r in rows]


@pytest.mark.parametrize("mode,shards", [("stream", 1), ("group", 1), ("parallel_stream", 1),
                                         ("parallel_stream", 2), ("group", 2)])
def test_episode_batches_match_jax(mode, shards):
    ds = _Index([7, 3, 12, 5, 9, 4])
    assert tsched.build_episode_index(ds) == jsched.build_episode_index(ds)
    for shard in range(shards):
        kw = dict(mode=mode, group_size=4, seed=7, shard=shard, num_shards=shards)
        want = list(jsched.episode_batches(ds, 3, **kw))
        got = list(tsched.episode_batches(ds, 3, **kw))
        assert got == want and len(got) > 2
    with pytest.raises(ValueError):
        list(tsched.episode_batches(ds, 3, mode="shuffle"))


@pytest.mark.parametrize("batch_size,group_factor", [(4, 8), (3, 2)])
def test_length_grouped_batches_match_jax(batch_size, group_factor):
    lengths = np.random.default_rng(2).integers(10, 500, 101).tolist()
    for seed in (0, 42):
        want = jsched.length_grouped_batches(lengths, batch_size, seed, group_factor)
        got = tsched.length_grouped_batches(lengths, batch_size, seed, group_factor)
        assert got == want and all(len(b) == batch_size for b in got)


@pytest.mark.parametrize("sequential", [False, True])
def test_trainer_aux_carry_three_steps_match_jax(tmp_path, sequential):
    """Three steps with the bank as the aux state: loss and grad_norm each
    step, every parameter after them and the carried bank.  Both trainers
    are given gradient_accumulation_steps=2, which the aux step ignores."""
    jcfg, tcfg = _pair()
    params = _jax_params(jcfg)
    B = 3
    heads = ([True, False, False], [False, False, True], [False, False, False])
    batches = [_batch(jcfg, 20 + i, B, resets=heads[i], t0=i) for i in range(3)]
    tcfg_kw = dict(max_steps=3, gradient_accumulation_steps=2, logging_steps=1, save_steps=100,
                   bf16=False, resume=False)
    ocfg = dict(learning_rate=1e-3, max_grad_norm=1.0, freeze_mm_vision=True)

    def jloss(p, batch, rng, aux):
        return jmem.memvla_loss(p, jcfg, batch, aux, rng, sequential_bank=sequential,
                                diffusion_t=batch["diff_t"], diffusion_noise=batch["diff_noise"])

    def tloss(model, batch, gen, aux):
        return tmem.memvla_loss(model, tcfg, batch, aux, gen, sequential_bank=sequential,
                                diffusion_t=batch["diff_t"], diffusion_noise=batch["diff_noise"])

    nb = 1 if sequential else B
    jt = jtrainer.Trainer(jloss, params, jtrainer.TrainerConfig(
        output_dir=str(tmp_path / "jax"), mesh_data=1, **tcfg_kw), joptim.OptimizerConfig(**ocfg),
        aux_state=jmem.init_mem_state(jcfg, nb))
    jt.train(iter(batches))
    model = _port_model(tcfg, params)
    tt = ttrainer.Trainer(tloss, model, ttrainer.TrainerConfig(output_dir=str(tmp_path / "port"),
                                                               **tcfg_kw),
                          toptim.OptimizerConfig(**ocfg), aux_state=tmem.init_mem_state(tcfg, nb))
    tt.train(iter(batches))
    tt.close()
    logs = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "metrics.jsonl") as f:
            logs[side] = [json.loads(line) for line in f]
    assert [r["step"] for r in logs["port"]] == [1, 2, 3]
    for j, t in zip(logs["jax"], logs["port"]):
        for key in ("loss", "grad_norm", "action_loss"):
            np.testing.assert_allclose(t[key], j[key], rtol=TOL, atol=TOL, err_msg=key)
    got = dict(model.named_parameters())
    for name, val, _ in port_arrays(jax.device_get(jt.params)):
        _close(got[name], val, name)
    _state_close(tt.aux_state, jax.device_get(jt.aux_state))
    assert not tt.aux_state["cog"]["feats"].requires_grad
    # the counts the batches' resets leave: parallel rows restart where reset
    counts = tt.aux_state["per"]["count"].tolist()
    assert counts == ([3] if sequential else [3, 3, 2])
    assert sorted(os.listdir(tmp_path / "port" / "checkpoint-3")) == [
        "opt_state.pt", "params.pt", "trainer_state.json"]


@pytest.fixture
def nav_free_suite(tmp_path):
    """A 3-episode Dexdata suite (5, 4 and 6 frames of 7-dof states)."""
    root = str(tmp_path / "data" / "memsuite")
    os.makedirs(root)
    rng = np.random.RandomState(0)
    for e, n in enumerate((5, 4, 6)):
        lines = []
        for t in range(n):
            Image.new("RGB", (40, 32), (e * 60, t * 20, 90)).save(f"{root}/e{e}f{t}.png")
            lines.append(json.dumps({
                "images_1": {"type": "image", "url": f"e{e}f{t}.png"},
                "state": (np.cos(np.arange(7) + t * 0.4) + 0.01 * rng.randn(7)).tolist(),
                "prompt": "open the drawer", "is_robot": True}))
        with open(f"{root}/e{e}.jsonl", "w") as f:
            f.write("\n".join(lines))
    for register in (register_dataset, tregistry.register_dataset):
        register({"suite": {"data_path_prefix": root, "annotations": root, "frequency": 1}},
                 prefix="mem", meta_data={"non_delta_mask": [6], "periodic_mask": None,
                                          "periodic_range": None})
    return root


@pytest.mark.parametrize("mode", ["parallel_stream", "group"])
def test_exp_train_runs(tmp_path, nav_free_suite, monkeypatch, mode):
    """``MemVLAExp.train()`` for three steps: the Trainer's metric keys, finite
    values, a checkpoint without the bank; each batch's 'timesteps' are the
    rows' frames and 'episode_reset' the schedule's episode starts."""
    from dexbotic_tpu_torch.exp import base_exp
    from dexbotic_tpu_torch.exp.memvla_exp import MemVLAExp, MemVLAModelConfig

    monkeypatch.chdir(tmp_path)
    exp = MemVLAExp(
        model=MemVLAModelConfig(llm_preset="test", vit_preset="test", action_model_type="DiT-S",
                                chunk_size=4, per_token_size=16, mem_length=3,
                                dataloader_type=mode, group_size=2),
        action=base_exp.ActionConfig(trajectory_length=4, padding_action=True),
        data=base_exp.DataConfig(dataset_name="mem_suite", image_processor="28"),
        tokenizer=base_exp.TokenizerConfig(model_max_length=96),
        trainer=ttrainer.TrainerConfig(output_dir=str(tmp_path / "out"), max_steps=3,
                                       per_device_batch_size=2, logging_steps=1, save_steps=3,
                                       bf16=False, resume=False, gradient_checkpointing=True),
        optimizer=toptim.OptimizerConfig(learning_rate=1e-4), device="cpu")
    seen = []
    step = ttrainer.Trainer.train_step

    def recorded(self, batch):
        seen.append((batch["timesteps"].tolist(), batch["episode_reset"].tolist()))
        out = step(self, batch)
        seen[-1] += (self.aux_state["per"]["count"].tolist(),)
        return out

    monkeypatch.setattr(ttrainer.Trainer, "train_step", recorded)
    log = exp.train()
    assert log["step"] == 3
    assert set(log) == {"loss", "action_loss", "grad_norm", "step", "steps_per_sec",
                        "data_wait_s"}
    assert all(np.isfinite(log[k]) for k in ("loss", "action_loss", "grad_norm"))
    assert sorted(os.listdir(tmp_path / "out" / "checkpoint-3")) == [
        "norm_stats.json", "opt_state.pt", "params.pt", "trainer_state.json"]
    assert len(seen) == 3
    for times, resets, counts in seen:
        if mode == "group":  # one shared bank; the group's head always resets
            assert resets[0] and counts == [2] and times[1] == times[0] + 1
        else:  # a bank a row: a reset row restarts at 1, the others rise by one
            assert all(t == 0 for t, r in zip(times, resets) if r)
    if mode == "parallel_stream":
        counts = [c for _, _, c in seen]
        for (times, resets, _), prev, now in zip(seen[1:], counts, counts[1:]):
            assert now == [1 if r else min(p + 1, 3) for r, p in zip(resets, prev)]


def test_libero_memvla_twin_matches_jax_recipe():
    """The port's LIBERO MemVLA twin holds the JAX recipe's values in every
    field the two share, dataloader_type='parallel_stream' among them."""
    from dexbotic_tpu_torch.playground.benchmarks.libero.libero_memvla import LiberoMemVLAExp
    from playground.benchmarks.libero.libero_memvla import LiberoMemVLAExp as JRecipe

    j, t = JRecipe(), LiberoMemVLAExp()
    assert t.model.dataloader_type == "parallel_stream" and t.exp_name == j.exp_name
    for part in ("model", "data", "action", "tokenizer", "optimizer", "trainer"):
        jd, td = dataclasses.asdict(getattr(j, part)), dataclasses.asdict(getattr(t, part))
        common = sorted(set(jd) & set(td))
        assert len(common) >= len(jd) // 2, (part, sorted(set(jd) - set(td)))
        assert {k: td[k] for k in common} == {k: jd[k] for k in common}, part
