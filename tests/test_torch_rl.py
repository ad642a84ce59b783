"""The port's SimpleVLA-RL (GRPO) path against the JAX package.

* ``exp/rl/grpo.py``: advantages (mixed, single-member and all-single
  groups), the PPO-clip loss, the token rewards, the response mask and the
  accuracy filter on the same seeded inputs.
* ``exp/rl/rl_trainer.py``: the filter and redistribution (the truncation
  filter, the nothing-survives branch), ``flatten_rollouts`` and
  ``prepare_update_batch`` (advantages over episodes, not padded chunk
  rows), ``collect_rollouts`` on mock envs with one deterministic actor given
  to both packages, one ``GRPOUpdater.update`` on a tiny OFT-Discrete with a
  tail that needs padding (metrics, gradients and updated parameters).
* The sampled path: the port's actor builds the JAX actor's prompt and
  images, and its log-probs of the bins it drew are JAX's log-probs of
  those bins (torch cannot reproduce ``jax.random.categorical``).
* ``data/dex_rl_dataset.py`` over 2 ranks, ``sim_envs`` (the mock env bit
  for bit, the LIBERO import gate) and ``SimpleVLARLExp.train_rl()`` on mock
  envs for both schedules against the JAX loop's schema and env outcomes.

fp32 on the CPU at the tiny presets; tolerance 1e-3, integers exact.
"""

import dataclasses
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dexbotic_tpu.constants import IMAGE_TOKEN_INDEX
from dexbotic_tpu.data import dex_rl_dataset as jdata
from dexbotic_tpu.exp.rl import grpo as jgrpo
from dexbotic_tpu.exp.rl import rl_trainer as jrl
from dexbotic_tpu.models import oft as joft
from dexbotic_tpu.models import presets as jpresets
from dexbotic_tpu.models import vlm as jvlm
from dexbotic_tpu.sim_envs import base as jbase
from dexbotic_tpu.sim_envs import factory as jfactory
from dexbotic_tpu_torch.data import dex_rl_dataset as tdata
from dexbotic_tpu_torch.exp.rl import grpo as tgrpo
from dexbotic_tpu_torch.exp.rl import rl_trainer as trl
from dexbotic_tpu_torch.models import oft as toft
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.sim_envs import base as tbase
from dexbotic_tpu_torch.sim_envs import factory as tfactory
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

torch.set_num_threads(2)
TOL = 1e-3


def _close(got, want, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL, **kw)


# ---------------------------------------------------------------------------
# grpo.py
# ---------------------------------------------------------------------------

ADV_CASES = {  # group ids of 9 rollouts
    "mixed": [0, 0, 0, 1, 1, 2, 2, 2, 3],  # group 3 has one member
    "single_member": [0, 0, 0, 0, 1, 1, 1, 1, 2],
    "all_single": list(range(9)),
}


@pytest.mark.parametrize("case", sorted(ADV_CASES))
def test_grpo_outcome_advantage_matches_jax(case):
    rng = np.random.default_rng(0)
    index = np.asarray(ADV_CASES[case])
    B, T, G = len(index), 6, int(index.max()) + 1
    lens = rng.integers(1, T + 1, B)
    eos = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    rewards = np.zeros((B, T), np.float32)
    rewards[np.arange(B), lens - 1] = 5.0 * rng.integers(0, 2, B) + rng.normal(0, 0.1, B)
    want = jgrpo.grpo_outcome_advantage(jnp.asarray(rewards), jnp.asarray(eos),
                                        jnp.asarray(index), G)
    got = tgrpo.grpo_outcome_advantage(rewards, eos, index, G)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (B, T)
        _close(g, w)


def test_ppo_rewards_mask_and_filter_match_jax():
    rng = np.random.default_rng(1)
    B, T = 5, 7
    old = np.log(rng.uniform(0.05, 0.95, (B, T))).astype(np.float32)
    new = (old + rng.normal(0, 0.5, (B, T))).astype(np.float32)  # ratios on both sides of the clip
    adv = rng.normal(size=(B, T)).astype(np.float32)
    lens = rng.integers(1, T + 1, B)
    eos = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    want = jgrpo.ppo_clip_loss(*(jnp.asarray(a) for a in (old, new, adv, eos)), 0.2, 0.28)
    got = tgrpo.ppo_clip_loss(*(torch.from_numpy(a) for a in (old, new, adv, eos)), 0.2, 0.28)
    for g, w in zip(got, want):
        _close(g, w)
    assert 0 < float(got[1]) < 1  # some tokens were clipped, some not

    success = np.array([1.0, 0.0, 1.0, 1.0, 0.0], np.float32)
    steps = np.array([3, 2, 9, 1, 0])  # 9 x 2 tokens runs past max_tokens: clamped
    r_want = jgrpo.outcome_token_rewards(jnp.asarray(success), jnp.asarray(steps), 2, 8, 5.0)
    r_got = tgrpo.outcome_token_rewards(success, steps, 2, 8, 5.0)
    np.testing.assert_array_equal(r_got.numpy(), np.asarray(r_want))
    np.testing.assert_array_equal(tgrpo.response_mask(steps, 2, 8).numpy(),
                                  np.asarray(jgrpo.response_mask(jnp.asarray(steps), 2, 8)))

    index = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    succ = np.array([1, 1, 0, 1, 0, 0, 1, 0], np.float32)
    for low, high in ((0.0, 1.0), (0.5, 1.0), (0.0, 0.5), (-1.0, 2.0)):  # strict (low, high)
        want = jgrpo.accuracy_filter(jnp.asarray(succ), jnp.asarray(index), 4, low, high)
        got = tgrpo.accuracy_filter(succ, index, 4, low, high)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# rl_trainer.py: host-side functions
# ---------------------------------------------------------------------------


def _buffers(success, group_index, truncated, chunk_count, seed=0):
    """The same filled RolloutBuffer in both packages."""
    rng = np.random.default_rng(seed)
    N, C, T = len(success), 3, 6
    out = []
    for mod in (jrl, trl):
        buf = mod.RolloutBuffer(num_envs=N, max_chunks=C, obs_shapes={"images": (4, 4, 3)},
                                tokens_per_chunk=T)
        out.append(buf)
    images = rng.normal(size=(N, C, 4, 4, 3)).astype(np.float32)
    bins = rng.integers(0, 31, (N, C, T)).astype(np.int32)
    logp = rng.normal(-3, 1, (N, C, T)).astype(np.float32)
    ids = rng.integers(1, 400, (N, 5))
    for buf in out:
        buf.obs["images"][:] = images
        buf.bins[:], buf.old_logp[:] = bins, logp
        buf.input_ids, buf.prompt_valid = ids.copy(), np.ones((N, 5), bool)
        buf.success = np.asarray(success, np.float32)
        buf.group_index = np.asarray(group_index, np.int32)
        buf.truncated = np.asarray(truncated, np.float32)
        buf.chunk_count = np.asarray(chunk_count, np.int32)
    return out


REDISTRIBUTE_CASES = {
    # (success, groups, truncated, filter_truncated, bounds)
    "accuracy": ([1, 0, 1, 1, 0, 1, 0, 0], [0, 0, 1, 1, 2, 2, 3, 3], [0] * 8, False, (0.0, 1.0)),
    "truncated": ([1, 0, 1, 1, 0, 1], [0, 0, 1, 1, 2, 2], [0, 0, 1, 0, 0, 0], True, (-1.0, 2.0)),
    "truncated_and_accuracy": ([1, 0, 1, 0, 0, 1], [0, 0, 1, 1, 2, 2], [0, 0, 1, 0, 0, 0], True,
                               (0.0, 1.0)),
    "nothing_survives": ([1, 1, 0, 0], [0, 0, 1, 1], [0, 0, 0, 0], False, (0.0, 1.0)),
    "uneven_groups": ([1, 0, 0, 1, 1, 0, 1], [0, 0, 0, 1, 1, 2, 2], [0] * 7, False, (0.0, 1.0)),
}


@pytest.mark.parametrize("case", sorted(REDISTRIBUTE_CASES))
def test_filter_and_redistribute_matches_jax(case):
    success, groups, truncated, filt, (low, high) = REDISTRIBUTE_CASES[case]
    jbuf, tbuf = _buffers(success, groups, truncated, [3] * len(success))
    n_groups = max(groups) + 1
    rkw = dict(filter_truncated=filt, accuracy_lower_bound=low, accuracy_upper_bound=high)
    want = jrl.filter_and_redistribute(jbuf, jgrpo.GRPOConfig(), jrl.RolloutConfig(**rkw),
                                       n_groups)
    got = trl.filter_and_redistribute(tbuf, tgrpo.GRPOConfig(), trl.RolloutConfig(**rkw),
                                      n_groups)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    if case == "nothing_survives":
        np.testing.assert_array_equal(got[0], np.arange(len(success)))
        np.testing.assert_array_equal(got[1], groups)
    if case.startswith("truncated"):
        assert 1 not in np.asarray(groups)[got[0]]  # the group with a truncated run is gone


def test_flatten_and_update_batch_match_jax():
    """Episodes of 1, 3, 2 and 3 valid chunks: the advantages are each
    episode's z-score over the episode scores of its group, on its valid
    chunks only, in both packages."""
    jbuf, tbuf = _buffers([1, 0, 1, 0], [0, 0, 1, 1], [0, 0, 0, 1], [1, 3, 2, 3])
    jflat, tflat = jrl.flatten_rollouts(jbuf), trl.flatten_rollouts(tbuf)
    assert set(jflat) == set(tflat)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
        assert tflat[k].dtype == jflat[k].dtype, k
    cfg_j, cfg_t = jgrpo.GRPOConfig(entropy_coeff=0.01), tgrpo.GRPOConfig(entropy_coeff=0.01)
    for kw in ({}, {"episode_success": tbuf.success, "episode_group": tbuf.group_index}):
        want = jrl.prepare_update_batch(jflat, cfg_j, 2, **kw)
        got = trl.prepare_update_batch(tflat, cfg_t, 2, **kw)
        assert set(got) == set(want)
        for k in want:
            if np.issubdtype(np.asarray(want[k]).dtype, np.floating):
                _close(got[k], want[k], err_msg=k)
            else:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    adv = got["advantages"].numpy()
    expect = 2.5 / (np.std([5.0, 0.0], ddof=1) + 1e-6)
    np.testing.assert_allclose(adv[0], expect, rtol=1e-5)  # episode 0's one valid chunk
    np.testing.assert_array_equal(adv[1:3], 0.0)  # its padding chunks
    np.testing.assert_allclose(adv[3:6], -expect, rtol=1e-5)  # episode 1: same z on every chunk


class _EnvCfg:
    max_episode_steps = 16
    obs_dim = (28, 28, 3)
    mock_success_prob = 0.5


def test_mock_env_matches_jax_bit_for_bit():
    """Observations, instructions, step outcomes and statistics of the mock
    env and the env batch in both packages, from the same seeds."""
    args = ("mock", "suite", ["t0", "t0", "t1"], [0, 1, 2], [10, 11, 12], _EnvCfg())
    jenvs = jfactory.create_env_batch(*args, threaded=True)
    tenvs = tfactory.create_env_batch(*args, threaded=True)
    for je, te in zip(jenvs, tenvs):
        assert te.get_instruction() == je.get_instruction()
        for _ in range(6):
            jo, to = je.get_obs(), te.get_obs()
            np.testing.assert_array_equal(tbase.extract_rgb(to), jbase.extract_rgb(jo))
            np.testing.assert_array_equal(to["joint_action"]["vector"], jo["joint_action"]["vector"])
            if not je.is_active():
                break
            (jo2, jdone), (to2, tdone) = je.step(np.zeros((4, 3))), te.step(np.zeros((4, 3)))
            assert (jdone, je.is_complete(), je.get_step_count()) == (
                tdone, te.is_complete(), te.get_step_count())
    jm = jfactory.EnvBatchManager("mock", "suite", _EnvCfg())
    tm = tfactory.EnvBatchManager("mock", "suite", _EnvCfg())
    for m in (jm, tm):
        m.create_batch(["a", "b"], [0, 1], [3, 4], threaded=False)
        m.envs[0].step(np.zeros((16, 3)))  # runs out its steps
    assert tm.get_batch_statistics() == jm.get_batch_statistics()
    assert len(tm.get_active_environments()) == 1
    tm.close_batch()
    assert tm.envs == []
    libero = {"agentview_image": np.arange(2 * 3 * 3).reshape(2, 3, 3)}
    np.testing.assert_array_equal(tbase.extract_rgb(libero), jbase.extract_rgb(libero))
    with pytest.raises(KeyError):
        tbase.extract_rgb({"state": 0})


def _deterministic_actor(pkg_arrays):
    """One actor for both packages' collect_rollouts: its outputs are a
    function of the observations alone (the key / generator is unused)."""

    def actor_fn(obs_list, instructions, _rng):
        B = len(obs_list)
        imgs = np.stack([o["observation"]["head_camera"]["rgb"].astype(np.float32) / 255.0
                         for o in obs_list])
        mean = imgs.mean(axis=(1, 2, 3))
        bins = (np.floor(mean[:, None] * 97 + np.arange(12)[None, :] * 7) % 31).astype(np.int32)
        logp = (-np.log(31.0) + 0.01 * bins).astype(np.float32)
        actions = (bins.reshape(B, 4, 3) / 15.0 - 1.0).astype(np.float32)
        ids = np.full((B, 9), 7, np.int64)
        ids[:, :4] = IMAGE_TOKEN_INDEX
        ids[:, -1 - (np.arange(B) % 3)] = 0
        valid = ids != 0
        return pkg_arrays(actions), pkg_arrays(bins), pkg_arrays(logp), ids, valid, imgs

    return actor_fn


@pytest.mark.parametrize("budget", [16, 8])
def test_collect_rollouts_matches_jax(budget):
    """Lock-step chunks over 6 mock envs: equal buffers, finished envs not
    stepped, runs that reach the budget marked truncated (budget 8)."""
    args = ("mock", "suite", ["t0"] * 3 + ["t1"] * 3, list(range(6)), [5, 6, 7, 8, 9, 10],
            _EnvCfg())
    groups = np.array([0, 0, 0, 1, 1, 1])
    want = jrl.collect_rollouts(
        jfactory.create_env_batch(*args, threaded=False), _deterministic_actor(jnp.asarray),
        jrl.RolloutConfig(max_env_steps=budget, chunk_steps=4), jax.random.PRNGKey(0),
        group_index=groups)
    got = trl.collect_rollouts(
        tfactory.create_env_batch(*args, threaded=False), _deterministic_actor(torch.from_numpy),
        trl.RolloutConfig(max_env_steps=budget, chunk_steps=4), torch.Generator().manual_seed(0),
        group_index=groups)
    for name in ("bins", "old_logp", "chunk_count", "success", "truncated", "group_index",
                 "input_ids", "prompt_valid"):
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.dtype == w.dtype, name
    np.testing.assert_array_equal(got.obs["images"], want.obs["images"])
    assert got.max_chunks == want.max_chunks == budget // 4
    if budget == 8:
        assert got.truncated.sum() > 0


# ---------------------------------------------------------------------------
# the update on a tiny OFT-Discrete
# ---------------------------------------------------------------------------


def _oft_pair():
    return tuple(m.OFTConfig(vlm=v.VLMConfig(llm=p.LLM_TEST, vit=p.VIT_TEST),
                             action_model_type="Discrete", action_dim=3, chunk_size=4,
                             num_bins=32)
                 for m, v, p in ((joft, jvlm, jpresets), (toft, tvlm, tpresets)))


def _update_batch(jcfg, n, seed=0):
    rng = np.random.default_rng(seed)
    nt = jcfg.vlm.num_image_tokens
    ids = rng.integers(1, 400, (n, nt + 4)).astype(np.int64)
    ids[:, :nt] = IMAGE_TOKEN_INDEX
    valid = np.ones_like(ids, dtype=bool)
    valid[1::3, -2:] = False  # right-padded prompts: the pads sit mid-row before the segment
    ids[~valid] = 0
    T = jcfg.num_action_tokens
    mask = np.ones((n, T), np.float32)
    mask[2::4] = 0.0  # padding chunks
    return {
        "input_ids": ids, "prompt_valid": valid,
        "images": rng.normal(size=(n, 28, 28, 3)).astype(np.float32),
        "bins": rng.integers(0, joft.decode_slots(jcfg), (n, T)).astype(np.int32),
        "old_logp": rng.normal(-3.5, 0.3, (n, T)).astype(np.float32),
        "advantages": (rng.normal(size=(n, 1)) * mask).astype(np.float32),
        "token_mask": mask,
    }


def test_grpo_update_matches_jax():
    """One GRPOUpdater.update over 12 rows at micro-batch 8 (the tail padded
    to 16 with zero-weight repeats: two micro-steps), entropy bonus on, the
    rollout temperature 1.6: the averaged metrics, the first micro-step's
    gradients (against jax.grad of rl_policy_loss) and every updated
    parameter against JAX's optax chain."""
    jcfg, tcfg = _oft_pair()
    params = jax.device_get(joft.init_oft(jax.random.PRNGKey(0), jcfg))
    before = {name: val for name, val, _ in port_arrays(params)}
    batch = _update_batch(jcfg, 12)
    gj, gt = jgrpo.GRPOConfig(entropy_coeff=0.01), tgrpo.GRPOConfig(entropy_coeff=0.01)
    kw = dict(learning_rate=1e-3, temperature=1.6)

    jgrads = jax.grad(lambda p: jrl.rl_policy_loss(
        p, jcfg, gj, {k: jnp.asarray(v[:8]) for k, v in batch.items()}, 1.6)[0])(params)
    model = toft.build_oft(tcfg, "cpu", seed=1)
    load_jax_params(model, params)
    updater = trl.GRPOUpdater(tcfg, gt, model, **kw)
    _, grads = updater.grads(model, {k: torch.from_numpy(v[:8]) for k, v in batch.items()})
    for name, val, _ in port_arrays(jgrads):
        g = grads[name]
        _close(np.zeros_like(val) if g is None else g, val, err_msg=name)

    jupd = jrl.GRPOUpdater(jcfg, gj, params, **kw)
    jparams, jmetrics = jupd.update(jax.tree.map(jnp.asarray, params),
                                    {k: jnp.asarray(v) for k, v in batch.items()}, 8)
    model, metrics = updater.update(model, {k: torch.from_numpy(v) for k, v in batch.items()}, 8)
    assert set(metrics) == set(jmetrics) == {"pg_loss", "clip_frac", "approx_kl", "entropy",
                                              "loss", "grad_norm"}
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=TOL, atol=TOL, err_msg=k)
    assert updater.optimizer.count == 2
    got = dict(model.named_parameters())
    moved = 0.0
    for name, val, _ in port_arrays(jax.device_get(jparams)):
        _close(got[name], val, err_msg=name)
        moved = max(moved, float(np.abs(val - before[name]).max()))
    assert moved > 5e-4  # two Adam steps of lr 1e-3 moved the weights


def test_update_refuses_a_mesh():
    _, tcfg = _oft_pair()
    model = toft.build_oft(tcfg, "cpu", seed=1)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        trl.GRPOUpdater(tcfg, tgrpo.GRPOConfig(), model, mesh=object())
    assert trl.allgather_rollouts("buf") == "buf"  # one process: the buffer as it is


def test_actor_prompt_images_and_log_probs_match_jax():
    """The sampled path: the port's actor builds the JAX actor's prompt ids,
    validity and images; the log-probs it returns for the bins it drew are
    JAX's oft_action_log_probs of those bins at the rollout temperature."""
    from dexbotic_tpu.exp import base_exp as jbase_exp
    from dexbotic_tpu.exp.simplevla_rl_exp import SimpleVLARLExp as JExp
    from dexbotic_tpu.tokenization.tokenize import SimpleTokenizer as JTok
    from dexbotic_tpu_torch.exp import base_exp as tbase_exp
    from dexbotic_tpu_torch.exp.simplevla_rl_exp import SimpleVLARLExp as TExp
    from dexbotic_tpu_torch.tokenization.tokenize import SimpleTokenizer as TTok

    jcfg, tcfg = _oft_pair()
    params = jax.device_get(joft.init_oft(jax.random.PRNGKey(0), jcfg))
    model = toft.build_oft(tcfg, "cpu", seed=1)
    load_jax_params(model, params)
    exps = []
    for cls, base_mod in ((JExp, jbase_exp), (TExp, tbase_exp)):
        exp = cls.__new__(cls)  # only _make_actor's fields
        exp.prompt_text_len = 6
        exp.rollout = jrl.RolloutConfig(temperature=1.6)
        exp.data = base_mod.DataConfig(image_processor="28")
        exps.append(exp)
    envs = tfactory.create_env_batch("mock", "s", ["pick the cup", "t"], [0, 1], [1, 2],
                                     _EnvCfg(), threaded=False)
    obs, inst = [e.get_obs() for e in envs], ["pick up the red cup", "go"]
    jact = exps[0]._make_actor(jcfg, params, JTok(model_max_length=64))
    tact = exps[1]._make_actor(tcfg, model, TTok(model_max_length=64))
    _, _, _, jids, jvalid, jimgs = jact(obs, inst, jax.random.PRNGKey(3))
    actions, bins, logp, ids, valid, imgs = tact(obs, inst, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(valid, jvalid)
    assert ids.shape == (2, jcfg.vlm.num_image_tokens + 6) and not valid[1].all()
    np.testing.assert_allclose(imgs, jimgs, atol=1e-6)
    assert actions.shape == (2, 4, 3) and bins.shape == logp.shape == (2, 12)
    want, _ = joft.oft_action_log_probs(params, jcfg, jnp.asarray(ids), jnp.asarray(valid),
                                        jnp.asarray(imgs)[:, None], None,
                                        jnp.asarray(bins.numpy()), temperature=1.6)
    _close(logp, want)
    _close(actions, np.asarray(joft.bins_to_continuous(jnp.asarray(bins.numpy()), jcfg)))


# ---------------------------------------------------------------------------
# the loader, the LIBERO gate and the exp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drop_last", [False, True])
def test_buffered_loader_epoch_contract_over_two_ranks(drop_last):
    jds = jdata.DexRLDataset(["a", "b", "c"], num_trials_per_task=5, env_type="mock")
    tds = tdata.DexRLDataset(["a", "b", "c"], num_trials_per_task=5, env_type="mock")
    assert [dataclasses.astuple(s) for s in tds.configs] == [
        dataclasses.astuple(s) for s in jds.configs]
    seen = []
    for rank in (0, 1):
        jl = jdata.BufferedRLDataLoader(jds, batch_size=2, env_dup=2, seed=7, rank=rank,
                                        world_size=2, drop_last=drop_last)
        tl = tdata.BufferedRLDataLoader(tds, batch_size=2, env_dup=2, seed=7, rank=rank,
                                        world_size=2, drop_last=drop_last)
        assert len(tl) == len(jl)
        for epoch in (0, 1, 2):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            jb = [[s.data_source for s in b] for b in jl]
            tb = [[s.data_source for s in b] for b in tl]
            assert tb == jb
            assert all(b[0::2] == b[1::2] for b in tb)  # env_dup: each config twice in a row
            if epoch == 0:
                seen.append([s for b in tb for s in b[0::2]])
    assert not drop_last or not set(seen[0]) & set(seen[1])  # disjoint slices
    # drop_last: 7 configs a rank, 3 whole batches of 2; else 8 (one cyclic repeat), 4 batches
    assert len(set(seen[0]) | set(seen[1])) == (12 if drop_last else 15)
    assert tdata.BufferedRLDataLoader(tds, 2).world_size == 1  # no torch.distributed: one rank


def test_libero_env_import_gate():
    """The LIBERO wrapper's module imports without `libero`; constructing the
    wrapper without it raises a clear ImportError."""
    mod = importlib.import_module("dexbotic_tpu_torch.sim_envs.libero_env")
    if importlib.util.find_spec("libero") is not None:
        pytest.skip("libero is installed here")  # the gate is what this test holds
    with pytest.raises(ImportError, match="libero"):
        mod.LiberoEnvWrapper("task", 0, 0, _EnvCfg())
    with pytest.raises(ImportError, match="libero"):
        tfactory.create_env_batch("libero", "libero_spatial", ["t"], [0], [0], _EnvCfg())
    assert "libero" not in sys.modules


def _exps(schedule):
    """The same tiny SimpleVLARLExp in both packages (mock envs, 2 groups of 2)."""
    from dexbotic_tpu.exp import base_exp as jb
    from dexbotic_tpu.exp import oft_exp as jo
    from dexbotic_tpu.exp import simplevla_rl_exp as js
    from dexbotic_tpu.exp.trainer import TrainerConfig as JTrainer
    from dexbotic_tpu_torch.exp import base_exp as tb
    from dexbotic_tpu_torch.exp import oft_exp as to
    from dexbotic_tpu_torch.exp import simplevla_rl_exp as ts
    from dexbotic_tpu_torch.exp.trainer import TrainerConfig as TTrainer

    out = []
    for b, o, s, trainer, g, r, extra in (
            (jb, jo, js, JTrainer, jgrpo, jrl, {}), (tb, to, ts, TTrainer, tgrpo, trl,
                                                     {"device": "cpu"})):
        out.append(s.SimpleVLARLExp(
            model=o.OFTModelConfig(llm_preset="test", vit_preset="test",
                                   action_model_type="Discrete", action_dim=3, chunk_size=4,
                                   num_bins=32),
            data=b.DataConfig(image_processor="28"),
            env=s.RLEnvConfig(env_type="mock", task_names=("t0", "t1"), num_envs=4,
                              max_episode_steps=12, obs_dim=(28, 28, 3)),
            rl_data=s.RLDataLoaderConfig(n_samples=2, schedule=schedule, num_trials_per_task=3),
            rollout=r.RolloutConfig(max_env_steps=12, chunk_steps=4, temperature=1.6),
            grpo=g.GRPOConfig(entropy_coeff=0.001), rl_epochs=1, rl_steps_per_epoch=2,
            micro_batch_size=4, prompt_text_len=8, trainer=trainer(seed=0), **extra))
    return out


@pytest.mark.parametrize("schedule", ["random", "epoch"])
def test_train_rl_on_mock_envs_matches_jax_loop(schedule):
    """train_rl() end to end on the CPU: two steps, the JAX loop's metric
    keys, finite metrics, the same env outcomes (the mock env's draws do not
    depend on the sampled actions), and the weights moved."""
    jexp, texp = _exps(schedule)
    _, jhist = jexp.train_rl()
    model, hist = texp.train_rl()
    assert len(hist) == len(jhist) == 2
    for h, jh in zip(hist, jhist):
        assert set(h) == set(jh) == chip_smoke.RL_METRICS  # the keys chip_smoke 10b holds
        for k, v in h.items():
            assert np.isfinite(v), k
        for k in ("success_rate", "truncated_frac", "num_rollouts", "mean_chunks_per_episode",
                  "epoch", "step"):
            assert h[k] == jh[k], k
        assert h["timing/gen_s"] > 0 and h["timing/update_s"] > 0
    init = toft.build_oft(texp.model.build_config(), "cpu", seed=texp.model.seed)
    moved = max(float((a.detach() - b).abs().max())
                for a, b in zip(model.parameters(), init.parameters()))
    assert moved > 0
