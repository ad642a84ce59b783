"""The port's host decode workers (data/loader.py), the hybrid CogACT exp and
the Trainer's wandb hook, against the JAX package and the in-line path.

* ``DataLoader`` in thread and process mode yields the batches of JAX's
  ``DataLoader`` and of the port's in-line ``data_iterator`` on the same
  seed, in the same order, across an epoch boundary; the per-process slice
  of every global batch; a worker's error is raised in the consumer.
* ``_index_stream`` and ``__len__`` equal JAX's at its defaults under
  shuffle and ``process_count``; ``PREFETCH_BATCHES`` sets the depth in
  flight as JAX's default does; the ``BaseExp`` feed is bit for bit the
  in-line path's.
* ``device_prefetch`` on the CPU device: tensors equal to the arrays, an
  error passed on, the source closed when the consumer stops, a fixed depth
  staged ahead.
* ``CogActExp.train()`` with ``num_workers=2`` (both modes) gives the
  in-line run's losses (augmentation off; the first batches hold no
  episode's last frame, which the dataset redraws from the process-global
  ``random``, so that draws in forked workers differ, as in JAX).
* ``HybridCogActExp``: a mixed robot + text batch of tests/test_hybrid.py's
  suite equals the JAX exp's, and its loss (text + gated action) equals
  JAX ``cogact_loss(with_text_loss=True)`` on the same weights and draws.
* The wandb hook is a no-op when ``wandb`` is absent (it is on both the
  CPU and the GPU machine, so only that path is tested).
"""

import dataclasses
import json
import os
import random
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dexbotic_tpu.data import loader as jloader
from dexbotic_tpu.data.collator import Collator as JCollator
from dexbotic_tpu.data.registry import register_dataset as jregister
from dexbotic_tpu_torch.data import loader as tloader
from dexbotic_tpu_torch.data import registry as tregistry
from dexbotic_tpu_torch.data.collator import Collator as TCollator
from dexbotic_tpu_torch.exp.base_exp import data_iterator
from dexbotic_tpu_torch.exp.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)
TOL = 1e-3


class _Items:
    """A deterministic dataset of tokenised rows with an image and an action."""

    def __init__(self, n=10, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"bad item {i}")
        rng = np.random.default_rng(i)
        return {"input_ids": np.arange(i % 5 + 3) + 10 * i, "labels": np.full(i % 5 + 3, -100),
                "image": rng.standard_normal((4, 4, 3)).astype(np.float32),
                "action": rng.standard_normal(6).astype(np.float32)}


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def _take(it, n):
    out = [next(it) for _ in range(n)]
    close = getattr(it, "close", None)
    if close is not None:
        close()
    return out


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_matches_jax_and_inline(mode, shuffle):
    """Five batches of 3 over 10 items (an epoch boundary after the third)."""
    ds = _Items()
    got = _take(iter(tloader.DataLoader(ds, TCollator(0, 12), 3, shuffle=shuffle, num_workers=2,
                                        seed=7, worker_mode=mode)), 5)
    jax_batches = _take(iter(jloader.DataLoader(ds, JCollator(0, 12), 3, shuffle=shuffle,
                                                num_workers=2, seed=7, worker_mode=mode)), 5)
    inline = _take(data_iterator(ds, TCollator(0, 12), 3, seed=7, shuffle=shuffle), 5)
    _assert_batches_equal(got, jax_batches)
    _assert_batches_equal(got, inline)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_per_process_slice(mode):
    """Two processes' loaders each yield their contiguous half of every global
    batch, as JAX's do."""
    ds = _Items(12)
    halves = [_take(iter(tloader.DataLoader(ds, TCollator(0, 12), 4, num_workers=2, seed=3,
                                            worker_mode=mode, process_id=p, process_count=2)),
                    4) for p in (0, 1)]
    whole = _take(iter(tloader.DataLoader(ds, TCollator(0, 12), 4, num_workers=2, seed=3,
                                          worker_mode=mode)), 4)
    for a, b, w in zip(*halves, whole):
        for k in w:
            np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), w[k], err_msg=k)
    jax_half = _take(iter(jloader.DataLoader(ds, JCollator(0, 12), 4, num_workers=2, seed=3,
                                             worker_mode=mode, process_id=1,
                                             process_count=2)), 4)
    _assert_batches_equal(halves[1], jax_half)
    with pytest.raises(ValueError):
        tloader.DataLoader(ds, TCollator(0, 12), 5, process_count=2)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_worker_error_surfaces(mode):
    """An item that raises stops the loader with that error: no batch is
    skipped and nothing falls back to in-line loading."""
    ds = _Items(10, fail_at=4)
    order = list(range(10))
    random.Random(7).shuffle(order)
    bad_batch = order.index(4) // 2
    it = iter(tloader.DataLoader(ds, TCollator(0, 12), 2, num_workers=2, seed=7,
                                 worker_mode=mode))
    for _ in range(bad_batch):
        next(it)
    with pytest.raises((RuntimeError, ValueError), match="bad item 4"):
        next(it)


class _SlowItems(_Items):
    """Items that take ``delay`` seconds each, but for those of ``fast``."""

    def __init__(self, n, fail_at, fast, delay=0.3):
        super().__init__(n, fail_at)
        self.fast, self.delay = set(fast), delay

    def __getitem__(self, i):
        if i not in self.fast:
            time.sleep(self.delay)
        return super().__getitem__(i)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_worker_error_surfaces_in_batch_order(mode):
    """A worker's error that arrives before the batches ahead of it (their
    items slow, the failing batch fast) is raised only once those batches
    are yielded."""
    order = list(range(10))
    random.Random(7).shuffle(order)
    bad_batch = order.index(4) // 2
    assert bad_batch >= 1
    ds = _SlowItems(10, fail_at=4, fast=order[2 * bad_batch: 2 * bad_batch + 2])
    it = iter(tloader.DataLoader(ds, TCollator(0, 12), 2, num_workers=2, seed=7,
                                 worker_mode=mode))
    for _ in range(bad_batch):
        assert next(it)["input_ids"].shape[0] == 2
    with pytest.raises((RuntimeError, ValueError), match="bad item 4"):
        next(it)


class _BigItems(_Items):
    """Items of 4 MiB, so that a collated batch is more than a pipe holds."""

    def __getitem__(self, i):
        item = super().__getitem__(i)
        item["image"] = np.full((512, 512, 4), i, np.float32)
        return item


def test_process_loader_closes_at_once_with_batches_in_flight():
    """Closing a process-mode loader while its workers still hold collated
    batches (each blocked on a pipe it cannot fill) stops every worker at
    once, rather than waiting for them to read a stop sentinel."""
    import multiprocessing as mp
    import time

    before = set(mp.active_children())
    it = iter(tloader.DataLoader(_BigItems(12), TCollator(0, 12), 2, num_workers=3, seed=1,
                                 worker_mode="process"))
    next(it)
    time.sleep(0.5)  # the workers decode the batches in flight and block on the pipe
    t0 = time.perf_counter()
    it.close()
    assert time.perf_counter() - t0 < 2.0
    assert set(mp.active_children()) <= before


def test_device_prefetch_on_the_cpu():
    batches = [{"a": np.arange(6).reshape(2, 3), "m": np.array([True, False]), "names": ["x"]}
               for _ in range(3)]
    out = list(tloader.device_prefetch(iter(batches), "cpu"))
    assert len(out) == 3
    for o, b in zip(out, batches):
        assert set(o) == {"a", "m"}  # only the arrays move
        assert o["a"].device.type == "cpu" and torch.equal(o["a"], torch.from_numpy(b["a"]))
        assert o["m"].dtype == torch.bool

    def failing():
        yield batches[0]
        raise ValueError("decode failed")

    it = tloader.device_prefetch(failing(), "cpu")
    next(it)
    with pytest.raises(ValueError, match="decode failed"):
        next(it)

    closed = []

    def endless():
        try:
            while True:
                yield batches[0]
        finally:
            closed.append(True)

    it = tloader.device_prefetch(endless(), "cpu")
    next(it)
    it.close()  # stops the producer, which closes its source
    assert closed == [True]


# ---------------------------------------------------------------------------
# The index stream, the length, the depth in flight, the Trainer's feed
# ---------------------------------------------------------------------------


def _wait_for(count, want, timeout=10.0):
    """Poll ``count()`` until it reaches ``want`` (or the time is up), then
    give the producer a moment to overshoot; returns the final count."""
    t0 = time.monotonic()
    while count() < want and time.monotonic() - t0 < timeout:
        time.sleep(0.01)
    time.sleep(0.3)
    return count()


@pytest.mark.parametrize("n", [11, 12])
@pytest.mark.parametrize("process_count", [1, 2])
@pytest.mark.parametrize("shuffle", [True, False])
def test_index_stream_and_len_match_jax(shuffle, process_count, n):
    """Global batches of 4 over ``n`` items: each process's index lists over
    the first 3 epochs, the partial batch dropped, and the per-epoch length
    are JAX's at its defaults (``drop_last=True``, ``epochs=None``)."""
    ds = _Items(n)
    kw = dict(batch_size=4, shuffle=shuffle, seed=5, process_count=process_count)
    for p in range(process_count):
        port = tloader.DataLoader(ds, None, process_id=p, **kw)
        ref = jloader.DataLoader(ds, None, process_id=p, **kw)
        assert len(port) == len(ref) == n // 4
        assert _take(port._index_stream(), 3 * len(ref)) == _take(ref._index_stream(), 3 * len(ref))


class _CountedItems(_Items):
    """Items that append a line to ``log`` when fetched, from any process."""

    def __init__(self, n, log):
        super().__init__(n)
        self.log = log

    def __getitem__(self, i):
        with open(self.log, "a") as f:
            f.write(f"{i}\n")
        return super().__getitem__(i)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_depth_in_flight(mode, tmp_path):
    """While the consumer holds the first batch, the thread mode has fetched
    ``PREFETCH_BATCHES`` + 1 batches and the process mode ``num_workers`` +
    ``PREFETCH_BATCHES``, as JAX's loader does at its default depth."""
    log = str(tmp_path / "fetched")
    open(log, "w").close()
    it = iter(tloader.DataLoader(_CountedItems(40, log), TCollator(0, 12), 2, num_workers=2,
                                 seed=1, worker_mode=mode))

    def fetched():
        with open(log) as f:
            return len(f.read().split())

    next(it)
    depth = tloader.PREFETCH_BATCHES
    want = 2 * (depth + 1 if mode == "thread" else 2 + depth)
    try:
        assert _wait_for(fetched, want) == want
    finally:
        it.close()


def test_device_prefetch_depth():
    """The producer stages ``PREFETCH_BATCHES`` batches in its queue and holds
    one more ready to put, and takes the next from its source only as the
    consumer takes one."""
    pulled = []

    def source():
        for i in range(20):
            pulled.append(i)
            yield {"a": np.full(3, i)}

    it = tloader.device_prefetch(source(), "cpu")
    ahead = tloader.PREFETCH_BATCHES + 1
    try:
        for taken in (1, 2):
            assert int(next(it)["a"][0]) == taken - 1
            assert _wait_for(lambda: len(pulled), taken + ahead) == taken + ahead
    finally:
        it.close()


class _FeedTrainer:
    """Stands in for the Trainer: takes the feed's first batches."""

    taken: list = []

    def __init__(self, *args, **kwargs):
        self.data_rank, self.data_size, self.device = 0, 1, torch.device("cpu")

    def train(self, batches):
        _FeedTrainer.taken = [next(batches) for _ in range(7)]
        return {}

    def close(self):
        pass


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_base_exp_feed_is_unchanged(mode, tmp_path, monkeypatch):
    """``BaseExp.train``'s loader feed (``DataLoader`` through
    ``device_prefetch``) yields bit for bit, across two epoch boundaries, the
    batches of the in-line ``data_iterator``: endless seeded epochs, the
    partial batch dropped."""
    from dexbotic_tpu_torch.exp import base_exp

    stats = tmp_path / "norm_stats.json"
    stats.write_text("{}")
    monkeypatch.setattr(base_exp, "Trainer", _FeedTrainer)
    exp = base_exp.BaseExp(data=base_exp.DataConfig(num_workers=2, worker_mode=mode),
                           action=base_exp.ActionConfig(statistic_mapping=str(stats)),
                           trainer=TrainerConfig(per_device_batch_size=3, seed=11),
                           device="cpu")
    ds = _Items(10)
    exp.build_model = lambda tokenizer: (None, None, None)
    exp.data.build_data = lambda tokenization, action_fn: ds
    exp.action.build_action_process_func = lambda: None
    exp.train()
    tok = exp.tokenizer.build_tokenizer()
    collator = TCollator(pad_token_id=tok.pad_token_id, max_length=exp.tokenizer.model_max_length)
    want = _take(data_iterator(ds, collator, 3, seed=11), 7)
    assert len(_FeedTrainer.taken) == 7
    for got, w in zip(_FeedTrainer.taken, want):
        assert set(got) == {k for k, v in w.items() if isinstance(v, np.ndarray)}
        for k, t in got.items():
            assert torch.equal(t, torch.from_numpy(w[k])), k


# ---------------------------------------------------------------------------
# Training through the workers
# ---------------------------------------------------------------------------


@pytest.fixture
def mini_suite(tmp_path):
    root = str(tmp_path / "data" / "mini" / "mini_loader")
    os.makedirs(root)
    rng = np.random.RandomState(0)
    for e in range(3):
        lines = []
        for t in range(12):
            Image.new("RGB", (64, 48), (e * 30, t * 15, 80)).save(f"{root}/e{e}f{t}.png")
            lines.append(json.dumps({
                "images_1": {"type": "image", "url": f"e{e}f{t}.png"},
                "state": (np.sin(np.arange(7) + t * 0.3) + 0.01 * rng.randn(7)).tolist(),
                "prompt": "stack the bowls", "is_robot": True}))
        with open(f"{root}/e{e}.jsonl", "w") as f:
            f.write("\n".join(lines))
    tregistry.register_dataset({"loader": {"data_path_prefix": root, "annotations": root,
                                           "frequency": 1}},
                               prefix="mini", meta_data={"non_delta_mask": [6],
                                                         "periodic_mask": None,
                                                         "periodic_range": None})
    return "mini_loader"


def _cogact_exp(tmp_path, dataset, out, **data):
    from dexbotic_tpu_torch.exp import base_exp
    from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
    from dexbotic_tpu_torch.exp.optim import OptimizerConfig

    return CogActExp(
        model=CogActModelConfig(llm_preset="test", vit_preset="test", action_model_type="DiT-S",
                                chunk_size=4),
        action=base_exp.ActionConfig(trajectory_length=4, padding_action=True),
        data=base_exp.DataConfig(dataset_name=dataset, image_processor="28",
                                 aug_policy="identity", **data),
        tokenizer=base_exp.TokenizerConfig(model_max_length=96),
        trainer=TrainerConfig(output_dir=str(tmp_path / out), max_steps=2,
                              per_device_batch_size=2, logging_steps=1, save_steps=100,
                              bf16=False, resume=False),
        optimizer=OptimizerConfig(learning_rate=1e-4), device="cpu")


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_cogact_train_with_workers_matches_inline(mode, tmp_path, mini_suite, monkeypatch):
    monkeypatch.chdir(tmp_path)
    inline = _cogact_exp(tmp_path, mini_suite, "inline")
    workers = _cogact_exp(tmp_path, mini_suite, "workers", num_workers=2, worker_mode=mode)
    # the batches of the two steps hold no episode's last frame (redrawn from `random`)
    order = list(range(36))
    random.Random(inline.trainer.seed).shuffle(order)
    assert all(i % 12 != 11 for i in order[:4])
    logs = []
    for exp in (inline, workers):
        exp.train()
        with open(os.path.join(exp.trainer.output_dir, "metrics.jsonl")) as f:
            logs.append([json.loads(line) for line in f])
    assert [r["step"] for r in logs[1]] == [1, 2]
    for a, b in zip(*logs):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=1e-5, atol=1e-6)
        assert b["data_wait_s"] >= 0.0


# ---------------------------------------------------------------------------
# Hybrid CogACT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hybrid_suite(tmp_path_factory):
    """tests/test_hybrid.py's suite: robot episodes (states -> actions, the
    default answer) and 'general' VQA episodes (an answer, no state)."""
    root = str(tmp_path_factory.mktemp("data") / "hyb" / "hyb_torch")
    os.makedirs(root)
    rng = np.random.RandomState(3)
    for e in range(2):
        lines = []
        for t in range(8):
            Image.new("RGB", (64, 48), (e * 40, t * 20, 90)).save(f"{root}/r{e}f{t}.png")
            lines.append(json.dumps({
                "images_1": {"type": "image", "url": f"r{e}f{t}.png"},
                "state": (np.sin(np.arange(7) + t * 0.4) + 0.01 * rng.randn(7)).tolist(),
                "prompt": "stack the bowls", "is_robot": True}))
        with open(f"{root}/r{e}.jsonl", "w") as f:
            f.write("\n".join(lines))
    troot = str(tmp_path_factory.mktemp("data2") / "vqa" / "general_vqatorch")
    os.makedirs(troot)
    for e in range(2):
        lines = []
        for t in range(8):
            Image.new("RGB", (64, 48), (200, e * 50, t * 25)).save(f"{troot}/t{e}f{t}.png")
            lines.append(json.dumps({
                "images_1": {"type": "image", "url": f"t{e}f{t}.png"},
                "prompt": "what color is the bowl?", "answer": "red"}))
        with open(f"{troot}/t{e}.jsonl", "w") as f:
            f.write("\n".join(lines))
    meta = {"non_delta_mask": [6], "periodic_mask": None, "periodic_range": None}
    for register in (jregister, tregistry.register_dataset):
        register({"torch": {"data_path_prefix": root, "annotations": root, "frequency": 1}},
                 prefix="hyb", meta_data=meta)
        register({"vqatorch": {"data_path_prefix": troot, "annotations": troot, "frequency": 1}},
                 prefix="general", meta_data=meta)
    return "hyb_torch+general_vqatorch"


def _hybrid_exps(dataset, stats):
    from dexbotic_tpu.exp import base_exp as jbase
    from dexbotic_tpu.exp import cogact_exp as jcog
    from dexbotic_tpu.exp import hybrid_cogact_exp as jhyb
    from dexbotic_tpu_torch.exp import base_exp as tbase
    from dexbotic_tpu_torch.exp import cogact_exp as tcog
    from dexbotic_tpu_torch.exp import hybrid_cogact_exp as thyb

    exps = []
    for base, cog, hyb in ((jbase, jcog, jhyb), (tbase, tcog, thyb)):
        exps.append(hyb.HybridCogActExp(
            model=cog.CogActModelConfig(llm_preset="test", vit_preset="test",
                                        action_model_type="DiT-S", action_dim=7, chunk_size=4),
            action=hyb.HybridActionConfig(trajectory_length=4, delta=False, padding_action=True,
                                          empty_action_dim=28, statistic_mapping=stats),
            data=base.DataConfig(dataset_name=dataset, image_processor="28",
                                 aug_policy="identity",
                                 data_keys=["input_ids", "labels", "action", "image",
                                            "has_action", "has_text"]),
            # long enough for the VQA answer's labels (96 cuts them off)
            tokenizer=base.TokenizerConfig(model_max_length=256)))
    return exps


def test_hybrid_mixed_batch_loss_matches_jax(tmp_path, hybrid_suite, monkeypatch):
    from dexbotic_tpu.exp import base_exp as jbase
    from dexbotic_tpu.models import cogact as jcogact
    from dexbotic_tpu_torch.models import cogact as tcogact
    from dexbotic_tpu_torch.utils.bridge import load_jax_params

    monkeypatch.chdir(tmp_path)
    stats = jbase.ComputeNormActionConfig(delta=False, norm_save_path=str(tmp_path / "stats")
                                          ).compute_norm_stats(hybrid_suite)
    jexp, texp = _hybrid_exps(hybrid_suite, stats)
    assert dataclasses.asdict(texp.action) == {k: v for k, v in dataclasses.asdict(
        jexp.action).items() if k in dataclasses.asdict(texp.action)}
    batches = []
    for exp, Collator in ((jexp, JCollator), (texp, TCollator)):
        tok = exp.tokenizer.build_tokenizer()
        ds = exp.data.build_data(exp.build_tokenization(tok), exp.action.build_action_process_func())
        random.seed(3)  # an episode's last frame is redrawn from the process-global `random`
        items = [ds[i] for i in range(len(ds))]
        robot = next(i for i, it in enumerate(items) if np.any(it["has_action"]))
        text = next(i for i, it in enumerate(items) if np.any(it["has_text"]))
        batches.append(Collator(pad_token_id=tok.pad_token_id, max_length=256)(
            [items[robot], items[text]]))
    jb, tb = batches
    assert set(tb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]), err_msg=k)
    assert tb["has_action"].reshape(-1).tolist() == [1, 0]
    assert tb["has_text"].reshape(-1).tolist() == [0, 1]

    jcfg = jexp.model.build_config()
    tcfg = texp.model.build_config()
    params = jax.device_get(jcogact.init_cogact(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    final = params["action_head"]["final"]  # zero at init: the action loss would not see the DiT
    for leaf in ("w", "b"):
        final[leaf] = rng.normal(0, 0.02, final[leaf].shape).astype(np.float32)
    rows = 2 * jcfg.repeated_diffusion_steps
    t = rng.integers(0, jcfg.diffusion_steps, rows).astype(np.int32)
    noise = rng.standard_normal((rows, jcfg.chunk_size, jcfg.action_dim)).astype(np.float32)
    jloss, jm = jcogact.cogact_loss(params, jcfg, {k: jnp.asarray(v) for k, v in jb.items()},
                                    jax.random.PRNGKey(0), with_text_loss=True,
                                    diffusion_t=jnp.asarray(t), diffusion_noise=jnp.asarray(noise))
    model = tcogact.build_cogact(tcfg, "cpu", seed=1)
    load_jax_params(model, params)
    tloss, tm = tcogact.cogact_loss(model, tcfg, {k: torch.as_tensor(v) for k, v in tb.items()},
                                    with_text_loss=True, diffusion_t=torch.from_numpy(t),
                                    diffusion_noise=torch.from_numpy(noise))
    for key in ("action_loss", "text_loss", "loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=TOL, atol=TOL,
                                   err_msg=key)
    assert float(tm["text_loss"]) > 0 and float(tm["action_loss"]) > 0


# ---------------------------------------------------------------------------
# W&B
# ---------------------------------------------------------------------------


def test_wandb_hook_is_a_noop_without_wandb(tmp_path, monkeypatch):
    """With a project set and ``wandb`` not importable the run is None and
    metrics.jsonl is still written."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    model = torch.nn.Linear(3, 1)

    def loss_fn(model, batch, generator):
        loss = model(batch["x"]).square().mean()
        return loss, {"loss": loss}

    from dexbotic_tpu_torch.exp.optim import OptimizerConfig

    trainer = Trainer(loss_fn, model, TrainerConfig(output_dir=str(tmp_path), max_steps=2,
                                                    logging_steps=1, save_steps=100, bf16=False,
                                                    resume=False, wandb_project="dexbotic"),
                      OptimizerConfig())
    assert trainer._wandb is None
    trainer.train(iter([{"x": np.ones((2, 3), np.float32)}] * 2))
    trainer.close()
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2] and all("data_wait_s" in r for r in rows)
