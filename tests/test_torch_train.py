"""The port's CogACT training slice against the JAX package, on the CPU.

* ``cogact_loss`` and every parameter's gradient against
  ``jax.value_and_grad(cogact_loss)``, timesteps and noise injected on both
  sides (torch cannot reproduce the JAX streams), with and without the text
  loss and its has_action/has_text gating, and under each remat mode.
* Three steps of the port's ``Trainer`` against the JAX ``Trainer`` on the
  same batches and injected loss closure: loss and grad_norm per step, then
  every parameter through utils/bridge.py's mapping; with gradient
  accumulation, with frozen groups (unchanged, no moments) and with weight
  decay; and in bf16 under JAX's rule on both sides (the stacked norm scales
  within two bf16 spacings of JAX's at every order of drawing them, and at
  lr 2e-5 exactly where they started).  The optimizer's schedules, group labels and freeze masks against
  ``dexbotic_tpu.exp.optim``; the experiment layer's norm statistics and
  batches against ``dexbotic_tpu.exp.base_exp``.
* The port's own contracts: a step's randomness depends on (seed, step) only,
  so a resumed run equals an uninterrupted one, in fp32 and in bf16 (whose
  checkpoint keeps JAX's dtypes and serves unchanged); adapter-only
  checkpoints; and
  ``CogActExp.train()`` -> ``checkpoint-3`` -> ``load_for_inference`` -> one
  ``/process_frame`` request.

Weights come from the JAX init (the DiT's zero final layer redrawn so that
the loss sees the model); tolerance 1e-3, the repo's parity pin (bf16: 2e-2).
"""

import dataclasses
import io
import itertools
import json
import os
import random
import shutil
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dexbotic_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from dexbotic_tpu.data.registry import register_dataset
from dexbotic_tpu.exp import optim as joptim
from dexbotic_tpu.exp import trainer as jtrainer
from dexbotic_tpu.models import cogact as jcogact
from dexbotic_tpu.models import vlm as jvlm
from dexbotic_tpu.nn import transformer as jtransformer
from dexbotic_tpu.nn import vit as jvit
from dexbotic_tpu_torch.data import registry as tregistry
from dexbotic_tpu_torch.exp import optim as toptim
from dexbotic_tpu_torch.exp import trainer as ttrainer
from dexbotic_tpu_torch.models import cogact as tcogact
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.nn import transformer as ttransformer
from dexbotic_tpu_torch.nn import vit as tvit
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

torch.set_num_threads(2)
TOL = 1e-3
# bf16 weights on both sides, rounded at every update and multiplied in
# another order: losses and grad norms to 2 %
BF16_TOL = 2e-2

LLM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=8, intermediate_size=64, attn_impl="xla")
VIT = dict(image_size=28, patch_size=14, hidden_size=24, num_layers=2, num_heads=4,
           intermediate_size=48, select_layer=None)
CHUNK, REP = 4, 4


def _cfgs():
    kw = dict(action_model_type="DiT-S", action_dim=7, chunk_size=CHUNK)
    j = jcogact.CogActConfig(vlm=jvlm.VLMConfig(llm=jtransformer.TransformerConfig(**LLM),
                                                vit=jvit.ViTConfig(**VIT)), **kw)
    t = tcogact.CogActConfig(vlm=tvlm.VLMConfig(llm=ttransformer.TransformerConfig(**LLM),
                                                vit=tvit.ViTConfig(**VIT)), **kw)
    return j, t


JCFG, TCFG = _cfgs()


def _jax_params(seed=0):
    params = jax.device_get(jcogact.init_cogact(jax.random.PRNGKey(seed), JCFG))
    final = params["action_head"]["final"]
    rng = np.random.default_rng(seed)
    for leaf in ("w", "b"):
        final[leaf] = rng.normal(0, 0.02, final[leaf].shape).astype(np.float32)
    return params


def _port_model(params):
    model = tcogact.build_cogact(TCFG, "cpu")
    load_jax_params(model, params)
    return model


def _batch(seed, B=4, pad=True):
    """A collated batch plus per-sample injected diffusion draws [B, REP, ...]."""
    rng = np.random.default_rng(seed)
    nt = JCFG.vlm.num_image_tokens
    ids = rng.integers(1, 60, (B, nt + 6)).astype(np.int32)
    ids[:, :nt] = IMAGE_TOKEN_INDEX
    mask = np.ones(ids.shape, bool)
    if pad:
        mask[-1, -2:] = False
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids).astype(np.int32)
    labels[:, : nt + 2] = IGNORE_INDEX
    return {
        "input_ids": ids, "attention_mask": mask, "labels": labels,
        "images": rng.standard_normal((B, 1, 28, 28, 3)).astype(np.float32),
        "actions": np.tanh(rng.standard_normal((B, CHUNK, 7))).astype(np.float32),
        "has_action": np.array([1, 0, 1, 1][:B], np.int32),
        "has_text": np.array([0, 1, 0, 0][:B], np.int32),
        "diff_t": rng.integers(0, 100, (B, REP)).astype(np.int32),
        "diff_noise": rng.standard_normal((B, REP, CHUNK, 7)).astype(np.float32),
    }


def _rep_major(x):
    """[B, REP, ...] -> [REP * B, ...], the order of the loss's tiled rows."""
    return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))


def _jax_loss(text, gate=True):
    def loss_fn(params, batch, rng):
        b = {k: v for k, v in batch.items() if gate or k not in ("has_action", "has_text")}
        t = jnp.swapaxes(batch["diff_t"], 0, 1).reshape(-1)
        n = jnp.swapaxes(batch["diff_noise"], 0, 1).reshape((-1, CHUNK, 7))
        return jcogact.cogact_loss(params, JCFG, b, rng, with_text_loss=text,
                                   diffusion_t=t, diffusion_noise=n)
    return loss_fn


def _port_loss(text, gate=True, remat=False):
    def loss_fn(model, batch, generator):
        b = {k: v for k, v in batch.items() if gate or k not in ("has_action", "has_text")}
        return tcogact.cogact_loss(model, TCFG, b, generator, remat=remat, with_text_loss=text,
                                   diffusion_t=_rep_major(batch["diff_t"]),
                                   diffusion_noise=_rep_major(batch["diff_noise"]))
    return loss_fn


def _assert_tree_close(model, tree, what):
    """Every leaf of a JAX tree against the port's parameter (or .grad) of that name."""
    params = dict(model.named_parameters())
    for name, val, _ in port_arrays(tree):
        got = params[name] if what == "param" else params[name].grad
        got = np.zeros_like(val) if got is None else got.detach().numpy()
        np.testing.assert_allclose(got, val, rtol=TOL, atol=TOL, err_msg=f"{what} {name}")


@pytest.mark.parametrize("text,gate,remat", [
    (False, False, False), (True, False, False), (True, True, False),
    (False, False, True), (False, False, "dots"),
])
def test_cogact_loss_and_grads_match_jax(text, gate, remat):
    params = _jax_params()
    batch = _batch(1)
    (jloss, jmetrics), jgrads = jax.value_and_grad(_jax_loss(text, gate), has_aux=True)(
        params, batch, jax.random.PRNGKey(0))
    model = _port_model(params).requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = _port_loss(text, gate, remat)(model, tbatch, None)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL, atol=TOL)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]),
                                   rtol=TOL, atol=TOL)
    _assert_tree_close(model, jax.device_get(jgrads), "grad")


def _stacked_norm_scales(model) -> list:
    """The port names of the JAX tree's stacked norm scales ([L, D] leaves
    there): every norm's ``weight`` in a ``layers``/``blocks`` list."""
    from dexbotic_tpu_torch.ops.norms import LayerNorm, RMSNorm
    from dexbotic_tpu_torch.ops.quant import jax_stack

    return [f"{m}.weight" for m, mod in model.named_modules()
            if isinstance(mod, (LayerNorm, RMSNorm))
            and jax_stack(model, f"{m}.weight") is not None]


def _bf16_spacing(x: np.ndarray) -> np.ndarray:
    """The distance between bf16 neighbours at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _draw_stacked_scales(params, scales, order) -> None:
    """Draw the stacked norm scales around 1 (in ``params``, in place): the
    JAX tree's leaves of ``scales`` in sorted path order, or permuted by
    ``order``, one rng (seed 5) for all."""
    paths = sorted({tuple(p) for n, _, p in port_arrays(params) if n in scales})
    rng = np.random.default_rng(5)
    for i in order or range(len(paths)):
        leaf = params
        for k in paths[i][:-1]:
            leaf = leaf[k]
        leaf[paths[i][-1]] = rng.normal(1.0, 0.2, leaf[paths[i][-1]].shape).astype(np.float32)


# The stacked norm scales of a bf16 run against JAX's after three steps, in
# bf16 spacings at JAX's value.  Each side rounds three updates; over the 24
# orders of drawing the scales (SCALE_DRAW_ORDERS) they part by 2 spacings at
# two elements, and there an fp64 run of the same three AdamW steps
# (script/witness_bf16_scales.py) sits between them, 0.85-1.15 spacings from
# each: neither side is the one off.
BF16_SPACINGS = 2


# max_grad_norm 1e-6 makes the clip visible through AdamW's eps (the update is
# otherwise nearly invariant to the gradient's scale).  bf16 runs JAX's rule on
# both sides (the stacked norm scales and biases train in bf16): "scales"
# draws the stacked norm scales around 1 and takes lr 1e-2, so that a step
# moves them; "lr2e-5" keeps the init's scales of 1.0 at the LIBERO recipes'
# lr (playground/benchmarks/libero/libero_cogact.py), where a step is below
# half a bf16 spacing of 1.0 and rounds away.
@pytest.mark.parametrize("accum,freeze,clip,wd,bf16", [
    pytest.param(2, False, 1.0, 0.0, None, id="2-False-1.0-0.0"),
    pytest.param(1, True, 1e-6, 0.0, None, id="1-True-1e-06-0.0"),
    pytest.param(1, False, 1.0, 0.1, None, id="1-False-1.0-0.1"),
    pytest.param(2, False, 1.0, 0.1, "scales", id="bf16-scales"),
    pytest.param(1, False, 1.0, 0.0, "lr2e-5", id="bf16-lr2e-5"),
])
def test_trainer_three_steps_match_jax(tmp_path, accum, freeze, clip, wd, bf16):
    _three_steps_match_jax(tmp_path, accum, freeze, clip, wd, bf16)


# every order of drawing the four stacked norm scales; a set of their paths
# gave (2, 1, 3, 0) under PYTHONHASHSEED 8 and 15, which put the port two
# spacings from JAX
SCALE_DRAW_ORDERS = list(itertools.permutations(range(4)))


@pytest.mark.parametrize("order", SCALE_DRAW_ORDERS, ids=lambda o: "".join(map(str, o)))
def test_trainer_bf16_scale_draws_match_jax(tmp_path, order):
    """The bf16-scales case of the three-step comparison at each order of
    drawing the stacked norm scales."""
    _three_steps_match_jax(tmp_path, 2, False, 1.0, 0.1, "scales", order)


def _three_steps_match_jax(tmp_path, accum, freeze, clip, wd, bf16, order=None):
    params = _jax_params()
    batches = [_batch(10 + i) for i in range(3)]
    lr = {None: 1e-3, "scales": 1e-2, "lr2e-5": 2e-5}[bf16]
    scales = _stacked_norm_scales(_port_model(params))
    if bf16 == "scales":
        _draw_stacked_scales(params, scales, order)
    ocfg = dict(learning_rate=lr, freeze_llm=freeze, freeze_mm_vision=freeze, max_grad_norm=clip,
                weight_decay=wd)
    tcfg = dict(max_steps=3, gradient_accumulation_steps=accum, logging_steps=1, save_steps=100,
                bf16=bf16 is not None, resume=False)
    jt = jtrainer.Trainer(_jax_loss(False), params,
                          jtrainer.TrainerConfig(output_dir=str(tmp_path / "jax"), mesh_data=1,
                                                 **tcfg), joptim.OptimizerConfig(**ocfg))
    jt.train(iter(batches))
    model = _port_model(params)
    tt = ttrainer.Trainer(_port_loss(False), model,
                          ttrainer.TrainerConfig(output_dir=str(tmp_path / "port"), **tcfg),
                          toptim.OptimizerConfig(**ocfg))
    tt.train(iter(batches))
    tt.close()

    logs = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "metrics.jsonl") as f:
            logs[side] = [json.loads(line) for line in f]
        shutil.rmtree(tmp_path / side / "checkpoint-3")  # ~100 MB a side, read by no check
    assert [r["step"] for r in logs["port"]] == [1, 2, 3]
    tol = TOL if bf16 is None else BF16_TOL
    for j, t in zip(logs["jax"], logs["port"]):
        for key in ("loss", "grad_norm", "action_loss"):
            np.testing.assert_allclose(t[key], j[key], rtol=tol, atol=tol, err_msg=key)
    init = {n: v for n, v, _ in port_arrays(params)}
    got = dict(model.named_parameters())
    final = {n: v for n, v, _ in port_arrays(jax.device_get(jt.params))}
    if bf16 is None:
        _assert_tree_close(model, jax.device_get(jt.params), "param")
        # the updates themselves, to 1 % of one step's size
        for name, val in final.items():
            np.testing.assert_allclose(got[name].detach().numpy() - init[name], val - init[name],
                                       rtol=0, atol=1e-2 * lr, err_msg=name)
    else:
        assert {n: str(p.dtype).removeprefix("torch.") for n, p in got.items()} == \
            {n: str(v.dtype) for n, v in final.items()}
        assert scales and all(got[n].dtype == torch.bfloat16 for n in scales)
        # AdamW keeps their moments in fp32 and rounds each update once
        assert all(tt.optimizer.mu[n].dtype == tt.optimizer.nu[n].dtype == torch.float32
                   for n in scales)
        for name in scales:
            want = final[name].astype(np.float32)
            off = np.abs(got[name].detach().float().numpy() - want)
            assert (off <= BF16_SPACINGS * _bf16_spacing(want)).all(), (name, off.max())
            if bf16 == "lr2e-5":  # a step rounds away: the scales stay exactly 1.0
                assert (want == 1.0).all() and (got[name] == 1.0).all(), name
            else:
                assert not np.array_equal(want, init[name]), name

    before = dict(_port_model(params).named_parameters())
    moved = {n for n, p in model.named_parameters() if not torch.equal(p.float(), before[n])}
    frozen = {n for n in before if n.startswith(("vlm.llm.layers", "vlm.llm.embed", "vlm.vit"))}
    assert "action_head.final.weight" in moved and "vlm.projector.fc0.weight" in moved
    if freeze:
        assert not moved & frozen
        assert not any(n in tt.optimizer.mu for n in frozen)
    else:
        assert moved & frozen


@pytest.mark.parametrize("total", [3, 100])
@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_optax(kind, total):
    """optax's schedules, read at the update count before each update."""
    jsched = joptim.make_schedule(joptim.OptimizerConfig(lr_scheduler_type=kind, warmup_ratio=0.1),
                                  2e-5, total)
    tsched = toptim.make_schedule(toptim.OptimizerConfig(lr_scheduler_type=kind, warmup_ratio=0.1),
                                  2e-5, total)
    assert tsched(0) == 0.0
    for count in range(total + 3):
        np.testing.assert_allclose(tsched(count), float(jsched(count)), rtol=1e-5, atol=1e-11,
                                   err_msg=f"count {count}")


@pytest.mark.parametrize("flags", [{}, {"freeze_llm": True},
                                   {"freeze_mm_projector": True, "freeze_mm_vision": True}])
def test_group_labels_and_freezing_match_jax(flags):
    jcfg, tcfg = joptim.OptimizerConfig(**flags), toptim.OptimizerConfig(**flags)
    groups = set()
    for name, _, path in port_arrays(_jax_params()):
        assert toptim.group_of(name) == joptim._group_of(path), name
        assert toptim.is_frozen(name, tcfg) == joptim._is_frozen(path, jcfg), name
        groups.add(toptim.group_of(name))
    assert groups == {"base", "mm_projector", "mm_vision", "action_head"}


def _tiny_port_trainer(out, max_steps, seed_model=0, bf16=False, **kw):
    model = _port_model(_jax_params(seed_model))

    def loss_fn(model, batch, generator):  # draws t, noise and dropout from the generator
        return tcogact.cogact_loss(model, TCFG, batch, generator)

    cfg = ttrainer.TrainerConfig(output_dir=str(out), max_steps=max_steps, logging_steps=1,
                                 bf16=bf16, **kw)
    return ttrainer.Trainer(loss_fn, model, cfg, toptim.OptimizerConfig(learning_rate=1e-3))


def _resumed_equals_straight(tmp_path, bf16: bool):
    """4 steps straight, and 2 + 2 resumed from checkpoint-2 into a model of
    other weights: the same parameters bit for bit.  Returns the resumed
    trainer and checkpoint-2's directory."""
    batches = [_batch(20 + i) for i in range(4)]
    straight = _tiny_port_trainer(tmp_path / "a", 4, bf16=bf16, save_steps=100, resume=False)
    straight.train(iter(batches))
    first = _tiny_port_trainer(tmp_path / "b", 2, bf16=bf16, save_steps=2, resume=False)
    first.train(iter(batches[:2]))
    resumed = _tiny_port_trainer(tmp_path / "b", 4, seed_model=1, bf16=bf16, save_steps=100,
                                 resume=True)
    resumed.train(iter(batches[2:]))
    assert resumed.step == 4
    for (name, a), b in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    for t in (straight, first, resumed):
        t.close()
    return resumed, str(tmp_path / "b" / "checkpoint-2")


def test_step_randomness_is_resume_invariant(tmp_path):
    _resumed_equals_straight(tmp_path, bf16=False)


def test_bf16_checkpoint_resumes_and_serves_in_jax_dtypes(tmp_path):
    """At ``bf16=True`` the checkpoint holds JAX's dtypes (the stacked norm
    scales and biases bf16, the other vectors fp32), resume restores them
    and equals the uninterrupted run, and the serving rule loads the trained
    tree unchanged."""
    from dexbotic_tpu_torch.exp.base_exp import BaseExp, fill_weights_

    resumed, ckpt = _resumed_equals_straight(tmp_path, bf16=True)
    scales = _stacked_norm_scales(resumed.model)
    jt = jtrainer.Trainer(_jax_loss(False), _jax_params(),
                          jtrainer.TrainerConfig(output_dir=str(tmp_path / "jax"), mesh_data=1,
                                                 bf16=True, resume=False),
                          joptim.OptimizerConfig())
    want = {n: str(v.dtype) for n, v, _ in port_arrays(jax.device_get(jt.params))}
    saved = ttrainer.load_checkpoint_params(ckpt)
    assert {n: str(v.dtype).removeprefix("torch.") for n, v in saved.items()} == want
    assert scales and all(saved[n].dtype == torch.bfloat16 for n in scales)
    trained = ttrainer.load_checkpoint_params(resumed.latest_checkpoint())
    served = tcogact.build_cogact(TCFG, "cpu", prepare=BaseExp().prepare_inference_params)
    fill_weights_(served, resumed.latest_checkpoint(), None, TCFG)
    for name, p in served.named_parameters():
        assert p.dtype == trained[name].dtype, name
        torch.testing.assert_close(p, trained[name], rtol=0, atol=0, msg=name)


def test_adapter_checkpoint_round_trip(tmp_path):
    t = _tiny_port_trainer(tmp_path, 3, save_steps=3, resume=False, adapter_save=True,
                           save_optimizer=False)
    t.train(iter([_batch(30 + i) for i in range(3)]))
    t.close()
    ckpt = t.latest_checkpoint()
    assert sorted(os.listdir(ckpt)) == ["adapter.pt", "trainer_state.json"]
    base = {n: p.detach().clone() for n, p in _port_model(_jax_params(1)).named_parameters()}
    merged = ttrainer.load_checkpoint_params(ckpt, base_params=base)
    adapter = ttrainer.extract_adapter(t.model)
    assert adapter and all(n.startswith("vlm.projector.") for n in adapter)
    for name, value in merged.items():
        torch.testing.assert_close(value, adapter.get(name, base[name]), rtol=0, atol=0)
    with pytest.raises(ValueError):
        ttrainer.load_checkpoint_params(ckpt)
    again = _tiny_port_trainer(tmp_path, 3, seed_model=1, resume=True)
    assert again.maybe_resume() and again.step == 3
    for name, value in adapter.items():
        torch.testing.assert_close(dict(again.model.named_parameters())[name], value)


@pytest.fixture
def mini_suite(tmp_path):
    root = str(tmp_path / "data" / "mini" / "mini_torch")
    os.makedirs(root)
    rng = np.random.RandomState(0)
    for e in range(3):
        lines = []
        for t in range(12):
            Image.new("RGB", (64, 48), (e * 30, t * 15, 80)).save(f"{root}/e{e}f{t}.png")
            lines.append(json.dumps({
                "images_1": {"type": "image", "url": f"e{e}f{t}.png"},
                "state": (np.sin(np.arange(7) + t * 0.3) + 0.01 * rng.randn(7)).tolist(),
                "prompt": "stack the bowls", "is_robot": True,
            }))
        with open(f"{root}/e{e}.jsonl", "w") as f:
            f.write("\n".join(lines))
    # the JAX package's DexDataset and the port's copy each read their own registry
    for register in (register_dataset, tregistry.register_dataset):
        register({"torch": {"data_path_prefix": root, "annotations": root, "frequency": 1}},
                 prefix="mini", meta_data={"non_delta_mask": [6], "periodic_mask": None,
                                           "periodic_range": None})
    return root


def test_exp_train_checkpoint_then_serve(tmp_path, mini_suite, monkeypatch):
    from dexbotic_tpu_torch.exp import base_exp
    from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
    from dexbotic_tpu_torch.exp.serve import CogActServer

    monkeypatch.chdir(tmp_path)

    def make_exp(**model_kw):
        return CogActExp(
            model=CogActModelConfig(llm_preset="test", vit_preset="test",
                                    action_model_type="DiT-S", chunk_size=4, **model_kw),
            action=base_exp.ActionConfig(trajectory_length=4, padding_action=True),
            data=base_exp.DataConfig(dataset_name="mini_torch", image_processor="28"),
            tokenizer=base_exp.TokenizerConfig(model_max_length=96),
            trainer=ttrainer.TrainerConfig(output_dir=str(tmp_path / "out"), max_steps=3,
                                           per_device_batch_size=2, logging_steps=1,
                                           save_steps=3, bf16=False, resume=False,
                                           gradient_checkpointing=True),
            optimizer=toptim.OptimizerConfig(learning_rate=1e-4),
            device="cpu",
        )

    log = make_exp().train()
    assert log["step"] == 3 and np.isfinite(log["loss"]) and np.isfinite(log["grad_norm"])
    ckpt = tmp_path / "out" / "checkpoint-3"
    assert sorted(os.listdir(ckpt)) == ["norm_stats.json", "opt_state.pt", "params.pt",
                                        "trainer_state.json"]

    exp = make_exp(model_name_or_path=str(ckpt))
    cfg, model, norms = exp.load_for_inference()
    assert norms is not None and len(norms["min"]) == 7
    trained = torch.load(ckpt / "params.pt", weights_only=True)
    torch.testing.assert_close(model.action_head.final.weight,
                               trained["action_head.final.weight"].to(torch.bfloat16))
    server = CogActServer(exp, cfg, model, exp.tokenizer.build_tokenizer(), norms,
                          host="127.0.0.1", port=0)
    httpd = server.serve_background()
    try:
        buf = io.BytesIO()
        Image.new("RGB", (64, 48), (40, 90, 10)).save(buf, "PNG")
        b = "XBX"
        body = (f"--{b}\r\nContent-Disposition: form-data; name=\"text\"\r\n\r\n"
                "stack the bowls\r\n"
                f"--{b}\r\nContent-Disposition: form-data; name=\"im\"; filename=\"f.png\"\r\n"
                "Content-Type: image/png\r\n\r\n").encode() + buf.getvalue() + \
            f"\r\n--{b}--\r\n".encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/process_frame", data=body,
            headers={"Content-Type": f"multipart/form-data; boundary={b}"})
        with urllib.request.urlopen(req, timeout=120) as r:
            chunk = np.asarray(json.loads(r.read()))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert chunk.shape == (4, 7) and np.isfinite(chunk).all()
    lo, hi = np.asarray(norms["min"]), np.asarray(norms["max"])
    assert np.all(chunk >= lo - 1e-6) and np.all(chunk <= hi + 1e-6)


def test_norm_stats_and_batches_match_jax(tmp_path, mini_suite, monkeypatch):
    """The experiment layer's data path (re-declared in the port because the
    JAX exp modules import JAX), over the port's copies of the data and
    tokenization modules, gives the JAX package's norm stats and batches."""
    from dexbotic_tpu.data.collator import Collator as JCollator
    from dexbotic_tpu.exp import base_exp as jbase
    from dexbotic_tpu.exp import cogact_exp as jexp
    from dexbotic_tpu_torch.data.collator import Collator as TCollator
    from dexbotic_tpu_torch.exp import base_exp as tbase
    from dexbotic_tpu_torch.exp import cogact_exp as texp

    monkeypatch.chdir(tmp_path)
    stats = {}
    for side, base in (("jax", jbase), ("port", tbase)):
        cfg = base.ComputeNormActionConfig(norm_save_path=str(tmp_path / side))
        with open(cfg.compute_norm_stats("mini_torch")) as f:
            stats[side] = json.load(f)
    assert stats["port"] == stats["jax"]

    batches = {}
    for side, base, mod, Collator in (("jax", jbase, jexp, JCollator),
                                      ("port", tbase, texp, TCollator)):
        exp = mod.CogActExp(
            model=mod.CogActModelConfig(llm_preset="test", vit_preset="test",
                                        action_model_type="DiT-S", chunk_size=4),
            action=base.ActionConfig(trajectory_length=4, padding_action=True,
                                     statistic_mapping=str(tmp_path / "jax" / "norm_stats.json")),
            data=base.DataConfig(dataset_name="mini_torch", image_processor="28"),
            tokenizer=base.TokenizerConfig(model_max_length=96))
        tok = exp.tokenizer.build_tokenizer()
        ds = exp.data.build_data(exp.build_tokenization(tok), exp.action.build_action_process_func())
        it = base.data_iterator(ds, Collator(pad_token_id=tok.pad_token_id, max_length=96), 4,
                                seed=7)
        # each DexDataset replaces an episode's last frame by one drawn from
        # the process-global `random` (data/dexdata.py:181-186)
        random.seed(3)
        batches[side] = [next(it) for _ in range(3)]
    for bj, bt in zip(batches["jax"], batches["port"]):
        assert set(bt) == set(bj)
        for k in bj:
            np.testing.assert_array_equal(np.asarray(bt[k]), np.asarray(bj[k]), err_msg=k)


@pytest.mark.parametrize("shuffle", [True, False])
def test_data_iterator_order(shuffle):
    from dexbotic_tpu_torch.exp.base_exp import data_iterator

    batches = list(data_iterator(list(range(6)), list, 2, seed=7, epochs=2, shuffle=shuffle))
    epochs = [sum(batches[:3], []), sum(batches[3:], [])]
    assert all(sorted(e) == list(range(6)) for e in epochs)
    if shuffle:
        assert epochs[0] != epochs[1]  # a fresh order each epoch
    else:
        assert epochs == [list(range(6))] * 2
