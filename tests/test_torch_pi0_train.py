"""The port's flow-VLA training slice (pi0, pi0.5, DM0, DM0-Prog) against the JAX package.

* ``flow_vla_loss`` and every parameter's gradient against
  ``jax.value_and_grad(flow_vla_loss)`` at the tiny presets, with the noise
  and the flow times injected on both sides (torch cannot reproduce the JAX
  streams), with and without remat.
* Three steps of the port's ``Trainer`` on pi0 against the JAX ``Trainer``
  on the same batches and injected draws: loss and grad_norm per step, then
  every parameter, with gradient accumulation and with the clip visible.
* Group labels and freeze masks on the flow-VLA parameter names against
  ``dexbotic_tpu.exp.optim`` (the action expert is ``expert``, which both put
  in the base group).
* The Beta(1.5, 1) flow-time draw: its mean and quantiles against the CDF
  t^1.5 over 10^5 draws, reproducible from a seeded generator.
* ``Pi0Exp.train()`` on a 3-view mini suite (one view missing in an episode)
  -> ``checkpoint-3`` -> ``Pi0Exp.load_for_inference`` -> one
  ``/process_frame`` request.

fp32 on the CPU; tolerance 1e-3, the repo's parity pin.  Weights come from
the JAX init through utils/bridge.py, pi0.5's zero-initialised adaRMS
``dense`` leaves redrawn so that the time condition reaches the loss.
"""

import dataclasses
import io
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dexbotic_tpu.exp import optim as joptim
from dexbotic_tpu.exp import trainer as jtrainer
from dexbotic_tpu.models import flow_vla as jflow
from dexbotic_tpu.models import presets as jpresets
from dexbotic_tpu_torch.data import registry as tregistry
from dexbotic_tpu_torch.exp import optim as toptim
from dexbotic_tpu_torch.exp import trainer as ttrainer
from dexbotic_tpu_torch.models import flow_vla as tflow
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

torch.set_num_threads(2)
TOL = 1e-3
KINDS = ["pi0", "pi05", "dm0", "dm0_prog"]


def _pair(kind):
    """(JAX config, port config) of a tiny flow VLA."""
    jmk = {"pi0": jflow.pi0_config, "pi05": jflow.pi05_config, "dm0": jflow.dm0_config,
           "dm0_prog": jflow.dm0_prog_config}[kind]
    tmk = {"pi0": tflow.pi0_config, "pi05": tflow.pi05_config, "dm0": tflow.dm0_config,
           "dm0_prog": tflow.dm0_prog_config}[kind]
    expert = "EXPERT_TEST_ADARMS" if kind == "pi05" else "EXPERT_TEST"
    qk = kind.startswith("dm0")  # DM0's Qwen3 pair: qk-norm in both streams
    cfgs = []
    for mod, mk in ((jpresets, jmk), (tpresets, tmk)):
        llm = dataclasses.replace(mod.LLM_TEST, qk_norm=qk)
        exp = dataclasses.replace(getattr(mod, expert), qk_norm=qk)
        cfgs.append(mk(llm, exp, mod.VIT_TEST, action_dim=8, chunk_size=5,
                       projector_type="linear"))
    return cfgs


def _jax_params(jcfg, seed=0):
    params = jax.device_get(jflow.init_flow_vla(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def redraw(tree):  # the adaRMS ``dense`` leaves are zero at init
        if not isinstance(tree, dict):
            return tree
        return {k: ({kk: rng.normal(0, 0.05, vv.shape).astype(np.float32) for kk, vv in v.items()}
                    if k == "dense" else redraw(v)) for k, v in tree.items()}

    return redraw(params)


def _port_model(tcfg, params):
    model = tflow.build_flow_vla(tcfg, "cpu")
    load_jax_params(model, params)
    return model


def _batch(cfg, seed, B=2, n_views=2, text_len=7):
    """A collated flow-VLA batch plus the injected draws ``flow_noise`` and
    ``flow_time``; the second row lacks its second view, the first has a
    padded text tail."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.llm.vocab_size, (B, text_len)).astype(np.int32)
    text_mask = np.ones((B, text_len), bool)
    text_mask[0, -2:] = False
    ids[~text_mask] = 0
    image_masks = np.ones((B, n_views), np.int32)
    image_masks[1, 1:] = 0
    return {
        "input_ids": ids, "attention_mask": text_mask, "image_masks": image_masks,
        "images": rng.standard_normal((B, n_views, 28, 28, 3)).astype(np.float32),
        "states": rng.standard_normal((B, cfg.action_dim)).astype(np.float32),
        "actions": np.tanh(rng.standard_normal((B, cfg.chunk_size, cfg.action_dim))).astype(np.float32),
        "flow_noise": rng.standard_normal((B, cfg.chunk_size, cfg.action_dim)).astype(np.float32),
        "flow_time": rng.uniform(0.001, 1.0, B).astype(np.float32),
    }


def _jax_loss(jcfg, remat=False):
    def loss_fn(params, batch, rng):
        return jflow.flow_vla_loss(params, jcfg, batch, rng, remat=remat,
                                   noise=batch["flow_noise"], time=batch["flow_time"])
    return loss_fn


def _port_loss(tcfg, remat=False):
    def loss_fn(model, batch, generator):
        return tflow.flow_vla_loss(model, tcfg, batch, generator, remat=remat,
                                   noise=batch["flow_noise"], time=batch["flow_time"])
    return loss_fn


def _assert_tree_close(model, tree, what):
    """Every leaf of a JAX tree against the port's parameter (or .grad) of that name."""
    params = dict(model.named_parameters())
    for name, val, _ in port_arrays(tree):
        got = params[name] if what == "param" else params[name].grad
        got = np.zeros_like(val) if got is None else got.detach().numpy()
        np.testing.assert_allclose(got, val, rtol=TOL, atol=TOL, err_msg=f"{what} {name}")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_flow_vla_loss_and_grads_match_jax(kind, remat):
    jcfg, tcfg = _pair(kind)
    params = _jax_params(jcfg)
    batch = _batch(jcfg, 1)
    (jloss, jmetrics), jgrads = jax.value_and_grad(_jax_loss(jcfg, remat), has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    model = _port_model(tcfg, params).requires_grad_(True)
    loss, metrics = _port_loss(tcfg, remat)(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                            None)
    loss.backward()
    assert loss.dtype == torch.float32 and set(metrics) == set(jmetrics) == {"loss", "action_loss"}
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL, atol=TOL)
    _assert_tree_close(model, jax.device_get(jgrads), "grad")
    # every stream takes a gradient: the prefix through the joint attention too
    for name in ("vlm.vit.patch_embed.weight", "vlm.llm.layers.0.attn.q.weight",
                 "expert.layers.0.attn.q.weight", "action_in_proj.weight"):
        grad = dict(model.named_parameters())[name].grad
        assert grad is not None and grad.abs().max() > 0, name


def test_loss_draws_noise_and_time_from_the_generator():
    """Without injected draws the loss takes them from the generator: one
    seed gives one loss, another seed another."""
    jcfg, tcfg = _pair("pi0")
    model = _port_model(tcfg, _jax_params(jcfg))
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg, 2).items()
             if not k.startswith("flow_")}
    with torch.no_grad():
        a, b, c = (tflow.flow_vla_loss(model, tcfg, batch, torch.Generator().manual_seed(s))[0]
                   for s in (3, 3, 4))
    assert torch.isfinite(a) and a == b and a != c


# max_grad_norm 1e-6 makes the clip visible through AdamW's eps (the update is
# otherwise nearly invariant to the gradient's scale)
@pytest.mark.parametrize("accum,clip", [(2, 1.0), (1, 1e-6)])
def test_pi0_trainer_three_steps_match_jax(tmp_path, accum, clip):
    jcfg, tcfg = _pair("pi0")
    params = _jax_params(jcfg)
    batches = [_batch(jcfg, 10 + i, B=4) for i in range(3)]
    lr = 1e-3
    ocfg = dict(learning_rate=lr, max_grad_norm=clip)
    tcfg_kw = dict(max_steps=3, gradient_accumulation_steps=accum, logging_steps=1, save_steps=100,
                   bf16=False, resume=False, gradient_checkpointing=True)
    jt = jtrainer.Trainer(_jax_loss(jcfg, remat=True), params,
                          jtrainer.TrainerConfig(output_dir=str(tmp_path / "jax"), mesh_data=1,
                                                 **tcfg_kw), joptim.OptimizerConfig(**ocfg))
    jt.train(iter(batches))
    model = _port_model(tcfg, params)
    tt = ttrainer.Trainer(_port_loss(tcfg, remat=True), model,
                          ttrainer.TrainerConfig(output_dir=str(tmp_path / "port"), **tcfg_kw),
                          toptim.OptimizerConfig(**ocfg))
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
    _assert_tree_close(model, jax.device_get(jt.params), "param")
    init = {n: v for n, v, _ in port_arrays(params)}
    got = dict(model.named_parameters())
    for name, val, _ in port_arrays(jax.device_get(jt.params)):  # the updates, to 1 % of a step
        if name.endswith("attn.k.bias"):
            # a key bias shifts a query's scores by one constant: its gradient
            # is 0 but for rounding, which AdamW scales up to +-lr
            continue
        np.testing.assert_allclose(got[name].detach().numpy() - init[name], val - init[name],
                                   rtol=0, atol=1e-2 * lr, err_msg=name)


@pytest.mark.parametrize("flags", [{}, {"freeze_llm": True},
                                   {"freeze_mm_projector": True, "freeze_mm_vision": True}])
@pytest.mark.parametrize("kind", ["pi0", "pi05", "dm0_prog"])
def test_flow_group_labels_and_freezing_match_jax(kind, flags):
    jcfg, tcfg = _pair(kind)
    jopt, topt = joptim.OptimizerConfig(**flags), toptim.OptimizerConfig(**flags)
    groups, frozen = {}, set()
    for name, _, path in port_arrays(_jax_params(jcfg)):
        assert toptim.group_of(name) == joptim._group_of(path), name
        assert toptim.is_frozen(name, topt) == joptim._is_frozen(path, jopt), name
        groups.setdefault(toptim.group_of(name), set()).add(name.split(".")[0])
        if toptim.is_frozen(name, topt):
            frozen.add(".".join(name.split(".")[:2]))
    # the expert, the projections and the time MLP train with the base lr
    assert set(groups) == {"base", "mm_projector", "mm_vision"}
    assert {"expert", "action_in_proj", "action_out_proj", "time_mlp_in"} <= groups["base"]
    want = {"freeze_llm": {"vlm.llm"}, "freeze_mm_vision": {"vlm.vit"},
            "freeze_mm_projector": {"vlm.projector"}}
    assert frozen == set().union(*(want[f] for f in flags))


def test_flow_time_draw_is_beta_1_5_1():
    """t = U^(1/1.5) * 0.999 + 0.001: (t - 0.001) / 0.999 has the CDF x^1.5,
    mean 0.6; the draw repeats from a seeded generator."""
    n = 10 ** 5
    t = tflow.sample_flow_time(n, torch.Generator().manual_seed(0), "cpu")
    again = tflow.sample_flow_time(n, torch.Generator().manual_seed(0), "cpu")
    assert t.dtype == torch.float32 and t.shape == (n,) and torch.equal(t, again)
    assert t.min() >= 0.001 and t.max() < 1.0
    x = ((t.double() - 0.001) / 0.999).numpy()
    # standard errors: the mean's sqrt(var / n) = 6.3e-4, a quantile's <= 1.6e-3
    assert abs(x.mean() - 0.6) < 4e-3
    qs = np.array([0.05, 0.25, 0.5, 0.75, 0.95])
    np.testing.assert_allclose(np.quantile(x, qs), qs ** (1 / 1.5), rtol=0, atol=8e-3)
    # and the JAX draw's law, on the same quantiles
    jt = np.asarray(jax.random.beta(jax.random.PRNGKey(0), 1.5, 1.0, (n,)), np.float64)
    np.testing.assert_allclose(np.quantile(x, qs), np.quantile(jt, qs), rtol=0, atol=1e-2)


@pytest.fixture
def suite3(tmp_path):
    """3 episodes of 12 frames, 3 views each, except the last episode's third view."""
    root = str(tmp_path / "data" / "mini3" / "views_torch")
    os.makedirs(root)
    rng = np.random.RandomState(0)
    for e in range(3):
        lines = []
        for t in range(12):
            row = {"state": (np.sin(np.arange(7) + t * 0.3) + 0.01 * rng.randn(7)).tolist(),
                   "prompt": "put the bowl on the plate", "is_robot": True}
            for v in range(1, 4 if e < 2 else 3):
                Image.new("RGB", (40, 30), (e * 30, t * 15, 40 * v)).save(f"{root}/e{e}f{t}v{v}.png")
                row[f"images_{v}"] = {"type": "image", "url": f"e{e}f{t}v{v}.png"}
            lines.append(json.dumps(row))
        with open(f"{root}/e{e}.jsonl", "w") as f:
            f.write("\n".join(lines))
    tregistry.register_dataset(
        {"views_torch": {"data_path_prefix": root, "annotations": root, "frequency": 1}},
        prefix="mini3", meta_data={"non_delta_mask": [6], "periodic_mask": None,
                                   "periodic_range": None})
    return root


def test_pi0_exp_train_checkpoint_then_serve(tmp_path, suite3, monkeypatch):
    from dexbotic_tpu_torch.data.collator import Collator
    from dexbotic_tpu_torch.exp.pi0_exp import FlowModelConfig, Pi0ActionConfig, Pi0Exp
    from dexbotic_tpu_torch.exp.serve import FlowVLAServer

    monkeypatch.chdir(tmp_path)
    # pi0-format statistics (mean/std of the padded action and state), as a
    # user hands them over: the computed CogACT-format min/max cannot feed
    # pi0's mean/std ActionNorm, in the JAX package as here
    rng = np.random.default_rng(4)
    norms = {key: {"mean": rng.normal(0, 0.1, 8).tolist(), "std": rng.uniform(0.5, 2, 8).tolist()}
             for key in ("action", "state")}
    stats_path = tmp_path / "pi0_norm_stats.json"
    stats_path.write_text(json.dumps({"norm_stats": norms}))

    def make_exp(**model_kw):
        base = Pi0Exp()
        return Pi0Exp(
            model=FlowModelConfig(llm_preset="test", vit_preset="test", expert_preset="test",
                                  action_dim=8, chunk_size=5, num_flow_steps=3, seed=5, **model_kw),
            action=Pi0ActionConfig(load_multimodal_masks=True, prompt_template="{prompt}",
                                   trajectory_length=5, action_ndim=8,
                                   statistic_mapping=str(stats_path)),
            data=dataclasses.replace(base.data, dataset_name="mini3_views_torch",
                                     image_processor="28"),
            trainer=ttrainer.TrainerConfig(output_dir=str(tmp_path / "out"), max_steps=3,
                                           per_device_batch_size=2, gradient_accumulation_steps=2,
                                           logging_steps=1, save_steps=3, bf16=False, resume=False,
                                           gradient_checkpointing=True),
            optimizer=toptim.OptimizerConfig(learning_rate=1e-4),
            device="cpu",
        )

    exp = make_exp()
    # the collated batch the loss sees: 3 views with their masks, states and
    # actions padded to action_dim, text padded to the 48 tokens
    tok = exp.tokenizer.build_tokenizer()
    ds = exp.data.build_data(exp.build_tokenization(tok), exp.action.build_action_process_func())
    batch = Collator(pad_token_id=tok.pad_token_id, max_length=48)([ds[0], ds[len(ds) - 1]])
    assert batch["images"].shape == (2, 3, 28, 28, 3) and batch["input_ids"].shape == (2, 48)
    assert batch["image_masks"].astype(int).tolist() == [[1, 1, 1], [1, 1, 0]]
    assert batch["states"].shape == (2, 8) and batch["actions"].shape == (2, 5, 8)

    log = exp.train()
    assert log["step"] == 3 and np.isfinite(log["loss"]) and np.isfinite(log["grad_norm"])
    ckpt = tmp_path / "out" / "checkpoint-3"
    assert sorted(os.listdir(ckpt)) == ["norm_stats.json", "opt_state.pt", "params.pt",
                                        "trainer_state.json"]

    exp = make_exp(model_name_or_path=str(ckpt))
    cfg, model, served_norms = exp.load_for_inference()
    assert served_norms == norms
    trained = torch.load(ckpt / "params.pt", weights_only=True)
    for name in ("expert.layers.0.attn.q.weight", "action_out_proj.weight"):
        served = dict(model.named_parameters())[name]
        torch.testing.assert_close(served, trained[name].to(served.dtype))
    fresh = dict(make_exp().model.build_params(cfg, "cpu").named_parameters())
    assert not torch.equal(fresh["action_out_proj.weight"], trained["action_out_proj.weight"])
    server = FlowVLAServer(exp, cfg, model, exp.tokenizer.build_tokenizer(), served_norms,
                           host="127.0.0.1", port=0)
    httpd = server.serve_background()
    try:
        b = "XBX"
        body = (f"--{b}\r\nContent-Disposition: form-data; name=\"text\"\r\n\r\n"
                "put the bowl on the plate\r\n"
                f"--{b}\r\nContent-Disposition: form-data; name=\"states\"\r\n\r\n"
                "[0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 1.0]\r\n").encode()
        for v in range(3):
            buf = io.BytesIO()
            Image.new("RGB", (40, 30), (40, 90, 30 * v)).save(buf, "PNG")
            body += (f"--{b}\r\nContent-Disposition: form-data; name=\"im\"; filename=\"f.png\"\r\n"
                     "Content-Type: image/png\r\n\r\n").encode() + buf.getvalue() + b"\r\n"
        body += f"--{b}--\r\n".encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/process_frame", data=body,
            headers={"Content-Type": f"multipart/form-data; boundary={b}"})
        with urllib.request.urlopen(req, timeout=120) as r:
            chunk = np.asarray(json.loads(r.read()))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert chunk.shape == (5, 7) and np.isfinite(chunk).all()


def test_bridged_weights_through_a_checkpoint_serve_as_jax(tmp_path):
    """JAX weights carried by utils/bridge.py into the port, written as the
    Trainer writes a checkpoint, loaded back by ``Pi0Exp`` for serving (bf16
    matrices, fp32 activations): the chunk of the JAX package on the same
    bf16-valued weights and noise."""
    from dexbotic_tpu_torch.exp.pi0_exp import FlowModelConfig, Pi0Exp

    jcfg, tcfg = _pair("pi0")
    params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)),
                          _jax_params(jcfg, seed=3))
    trainer = ttrainer.Trainer(_port_loss(tcfg), _port_model(tcfg, params),
                               ttrainer.TrainerConfig(output_dir=str(tmp_path), bf16=False,
                                                      save_optimizer=False),
                               toptim.OptimizerConfig())
    ckpt = trainer.save_checkpoint()
    exp = Pi0Exp(model=FlowModelConfig(llm_preset="test", vit_preset="test", expert_preset="test",
                                       action_dim=8, chunk_size=5, model_name_or_path=ckpt),
                 device="cpu")
    cfg, model, _ = exp.load_for_inference()
    assert cfg == tcfg and model.expert.layers[0].attn.q.weight.dtype == torch.bfloat16
    b = _batch(jcfg, 5)
    args = (b["input_ids"], b["attention_mask"].astype(np.int32), b["images"], b["image_masks"],
            b["states"])
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16) if a.ndim >= 2 else jnp.asarray(a),
                           params)
    ref = jflow.flow_vla_inference_action(jparams, jcfg, *map(jnp.asarray, args),
                                          jax.random.PRNGKey(0), noise=jnp.asarray(b["flow_noise"]))
    got = tflow.flow_vla_inference_action(model, cfg, *map(torch.from_numpy, args),
                                          noise=torch.from_numpy(b["flow_noise"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)
