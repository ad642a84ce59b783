"""Pipeline parallelism in the port (``parallel/pipeline.py``): the GPipe
schedule over a ('stage', 'data') mesh of gloo processes on the CPU.

The JAX package's tests (tests/test_pipeline.py), with its inputs, held at
2 processes (stage=2) and 4 (stage=2 x data=2, and stage=4): each data
rank passes its own rows, and this process holds

* the pipelined decoder's hidden states against one process's
  ``transformer_forward`` at 1e-5 and JAX's ``pipeline_transformer_forward``
  at 1e-3, at n_micro 2, and at stage=4 with n_micro 1 and 4;
* the pipelined causal-LM loss on fp32 embeddings (``_fp32_pipeline_loss``)
  and every gradient (averaged over 'data') against one process's loss at
  1e-5, and against JAX's pipeline
  (``pipeline_transformer_forward`` under ``jax.value_and_grad``, with
  the JAX loss's CE on fp32 embeddings: the JAX loss itself embeds in bf16,
  whose roundings two implementations do not share) at 1e-3;
* ``pp_param_shardings`` (the layers split over the stages) and two AdamW
  steps on each stage's own layers and the replicated leaves: the loss
  falls, a stage's layers move, the other stage's stay;
* ``pipeline_mot_forward`` (π0's prefix and suffix streams riding together)
  against ``mot_forward`` at 1e-5 and JAX at 1e-3;
* ``pipeline_flow_vla_loss`` and every gradient, for π0 and π0.5 (the
  adaRMS conditions, whose gradients are summed over the stages), against
  one process's ``flow_vla_loss`` at 1e-5 and JAX's (its noise and time
  drawn from the JAX key and injected) at 1e-3.
"""

import dataclasses
import inspect
import textwrap

import numpy as np
import pytest
import torch

from _gloo import results, spawn
from dexbotic_tpu_torch.models import flow_vla as tflow
from dexbotic_tpu_torch.models import losses as tlosses
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.nn import transformer as tt
from dexbotic_tpu_torch.parallel import pipeline as tpipe
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

try:  # the JAX references; the card's machine has no JAX, and there they skip
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from dexbotic_tpu.models import flow_vla as jflow
    from dexbotic_tpu.models import presets as jpresets
    from dexbotic_tpu.nn import transformer as jt
    from dexbotic_tpu.parallel import pipeline as jpipe
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="the JAX package is not installed")

EXACT, TOL = 1e-5, 1e-3
CFG = dict(vocab_size=256, hidden_size=64, num_layers=8, num_heads=4, num_kv_heads=2,
           head_dim=16, intermediate_size=128, attn_impl="xla")
FLOW = ("pi0", "pi05")


def _inputs(B=4, T=16, seed=0):
    r = np.random.RandomState(seed)
    ids = r.randint(1, 250, (B, T))
    valid = np.ones((B, T), np.int32)
    positions = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    return ids, valid, positions, (positions * valid).astype(np.int32)


def _flow_cfgs(kind):
    """(JAX config, port config) of the JAX test's 2-layer π0 / π0.5."""
    out = []
    for mod, flow in ((jpresets, jflow) if jax is not None else (None, None), (tpresets, tflow)):
        if mod is None:
            out.append(None)
            continue
        expert = mod.EXPERT_TEST_ADARMS if kind == "pi05" else mod.EXPERT_TEST
        make = flow.pi05_config if kind == "pi05" else flow.pi0_config
        out.append(make(dataclasses.replace(mod.LLM_TEST, num_layers=2),
                        dataclasses.replace(expert, num_layers=2), mod.VIT_TEST, action_dim=8,
                        chunk_size=5, projector_type="linear"))
    return out


def _flow_batch(action_dim=8, chunk=5, B=4, seed=3):
    r = np.random.RandomState(seed)
    return {"input_ids": r.randint(1, 400, (B, 6)), "attention_mask": np.ones((B, 6), np.int32),
            "images": r.randn(B, 2, 28, 28, 3).astype(np.float32),
            "image_masks": np.ones((B, 2), np.int32),
            "actions": r.randn(B, chunk, action_dim).astype(np.float32),
            "states": r.randn(B, action_dim).astype(np.float32)}


def _fp32_pipeline_loss(model, cfg, batch, mesh, n_micro):
    """``pipeline_causal_lm_loss`` on fp32 embeddings: the same decoder
    pipeline and loss, composed from the module's public functions."""
    valid = batch["attention_mask"].to(torch.int32)
    pos = torch.cumsum(valid, 1, dtype=torch.int32) - 1
    x = tt.embed_tokens(model, cfg, batch["input_ids"], dtype=torch.float32)
    hidden = tpipe.pipeline_transformer_forward(cfg, model, x, pos, pos * valid, valid, mesh,
                                                n_micro=n_micro)
    return tpipe.lm_loss(model, cfg, hidden, batch)


PP_WORKER = inspect.getsource(_fp32_pipeline_loss) + textwrap.dedent('''
    import dataclasses

    from dexbotic_tpu_torch.exp import optim as toptim
    from dexbotic_tpu_torch.models import flow_vla as tflow
    from dexbotic_tpu_torch.models import losses
    from dexbotic_tpu_torch.nn import transformer as tt
    from dexbotic_tpu_torch.parallel import pipeline as tpipe

    SPEC = load("spec")
    CFG = tt.TransformerConfig(**SPEC["cfg"])


    def _rows(a, i, n):
        a = torch.as_tensor(a)
        return a[len(a) * i // n: len(a) * (i + 1) // n]


    def _decoder():
        model = tt.Transformer(CFG)
        model.load_state_dict(SPEC["decoder"])
        return model


    def _mesh(stage):
        mesh = pmesh.make_pipeline_mesh(stage, WORLD // stage)
        return mesh, mesh.get_local_rank("data"), pmesh.axis_size(mesh, "data")


    def _data_mean_grads(model, mesh):
        """{name: gradient averaged over 'data'} of the parameters that have one."""
        n = pmesh.axis_size(mesh, "data")
        out = {}
        for k, p in model.named_parameters():
            if p.grad is not None:
                g = p.grad.clone()
                torch.distributed.all_reduce(g, group=mesh.get_group("data"))
                out[k] = g / n
        return out


    def case_fwd():
        model = _decoder()
        runs = [(2, 2)] + ([(4, 1), (4, 4)] if WORLD == 4 else [])
        out = {}
        for stage, n_micro in runs:
            mesh, d, n = _mesh(stage)
            ids, valid, pos, grp = (_rows(a, d, n) for a in SPEC["fwd"])
            with torch.no_grad():
                x = tt.embed_tokens(model, CFG, ids)
                out[(stage, n_micro)] = tpipe.pipeline_transformer_forward(
                    CFG, model, x, pos, grp, valid, mesh, n_micro=n_micro)
        save("fwd", out)


    def case_loss():
        model = _decoder()
        mesh, d, n = _mesh(2)
        batch = {k: _rows(v, d, n) for k, v in SPEC["loss"].items()}
        with losses.data_parallel(mesh.get_group("data"), n):
            loss = _fp32_pipeline_loss(model, CFG, batch, mesh, n_micro=2)
        loss.backward()
        save("loss", {"loss": float(loss.detach()), "grads": _data_mean_grads(model, mesh)})


    def case_train():
        model = _decoder()
        mesh, d, n = _mesh(2)
        stage = mesh.get_local_rank("stage")
        owner = tpipe.pp_param_shardings(model, CFG, mesh)
        mine = [(k, p) for k, p in model.named_parameters() if owner[k] in (None, stage)]
        opt = toptim.Optimizer(toptim.OptimizerConfig(learning_rate=1e-4, lr_scheduler_type="fixed"), mine, 2)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        batch = {k: _rows(v, d, n) for k, v in SPEC["train"].items()}
        loss_values = []
        for _ in range(2):
            with losses.data_parallel(mesh.get_group("data"), n):
                loss = tpipe.pipeline_causal_lm_loss(model, CFG, batch, mesh, n_micro=2)
            loss.backward()
            grads = _data_mean_grads(model, mesh)
            opt.step_(dict(mine), {k: grads.get(k) for k, _ in mine})
            model.zero_grad()
            v = loss.detach().clone()
            torch.distributed.all_reduce(v, group=mesh.get_group("data"))
            loss_values.append(float(v) / n)
        moved = {k: not torch.equal(p.detach(), before[k]) for k, p in model.named_parameters()}
        save("train", {"owner": owner, "stage": stage, "losses": loss_values, "moved": moved})


    def _flow_model(kind):
        cfg = SPEC["flow"][kind]["cfg"]
        model = tflow.build_flow_vla(cfg, "cpu")
        model.load_state_dict(SPEC["flow"][kind]["state"])
        return cfg, model.requires_grad_(True)


    def case_mot():
        cfg, model = _flow_model("pi0")
        mesh, d, n = _mesh(2)
        f = SPEC["flow"]["pi0"]
        b = {k: _rows(v, d, n) for k, v in f["batch"].items()}
        with torch.no_grad():
            pt, pm, par = tflow.embed_prefix(model, cfg, b["images"], b["image_masks"],
                                             b["input_ids"], b["attention_mask"])
            time = torch.full((len(pt),), 0.5)
            st, sm, sar, cond = tflow.embed_suffix(model, cfg, b["states"], _rows(f["x_t"], d, n),
                                                   time, dtype=pt.dtype)
            mask, grp, pos = tflow._positions_and_grp(pm, par, sm, sar)
            outs = tpipe.pipeline_mot_forward((cfg.llm, cfg.expert), (model.vlm.llm, model.expert),
                                              (pt, st), pos, grp, mask, mesh, n_micro=2)
        save("mot", outs)


    def case_flow():
        out = {}
        for kind in SPEC["flow"]:
            cfg, model = _flow_model(kind)
            f = SPEC["flow"][kind]
            mesh, d, n = _mesh(2)
            b = {k: _rows(v, d, n) for k, v in f["batch"].items()}
            loss, _ = tpipe.pipeline_flow_vla_loss(model, cfg, b, mesh, n_micro=2,
                                                   noise=_rows(f["noise"], d, n),
                                                   time=_rows(f["time"], d, n))
            loss.backward()
            v = loss.detach().clone()
            torch.distributed.all_reduce(v, group=mesh.get_group("data"))
            out[kind] = {"loss": float(v) / n, "grads": _data_mean_grads(model, mesh)}
        save("flow", out)
''')


def _jax_flow_draws(batch, B, chunk, action_dim, rng):
    """The noise and flow times JAX's flow loss draws from ``rng``."""
    k_n, k_t = jax.random.split(rng)
    noise = jax.random.normal(k_n, (B, chunk, action_dim), jnp.float32)
    time = jax.random.beta(k_t, 1.5, 1.0, (B,)).astype(jnp.float32) * 0.999 + 0.001
    return np.asarray(noise), np.asarray(time)


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    """The JAX inits bridged, the worker runs at 2 and 4 processes, and the
    one-process references."""
    tmp = tmp_path_factory.mktemp("pipeline")
    (tmp / "in").mkdir()
    cfg = tt.TransformerConfig(**CFG)
    decoder = tt.Transformer(cfg)
    jparams = {}
    if jax is not None:
        jparams["decoder"] = jax.device_get(jt.init_transformer(jax.random.PRNGKey(2),
                                                                jt.TransformerConfig(**CFG)))
        load_jax_params(decoder, jparams["decoder"])
    else:
        tt.init_transformer_(decoder, torch.Generator().manual_seed(2))
    ids, valid, _, _ = _inputs(B=4, T=12, seed=7)
    loss_batch = {"input_ids": ids, "attention_mask": valid,
                  "labels": np.where(valid == 1, ids, -100)}
    tids, tvalid, _, _ = _inputs(B=8, T=12, seed=9)
    spec = {"cfg": CFG, "decoder": decoder.state_dict(), "fwd": _inputs(), "loss": loss_batch,
            "train": {"input_ids": tids, "attention_mask": tvalid,
                      "labels": np.where(tvalid == 1, tids, -100)}, "flow": {}}
    for kind in FLOW:
        jcfg, fcfg = _flow_cfgs(kind)
        model = tflow.build_flow_vla(fcfg, "cpu")
        batch = _flow_batch()
        B = len(batch["actions"])
        if jax is not None:
            jparams[kind] = jax.device_get(jflow.init_flow_vla(jax.random.PRNGKey(0), jcfg))
            load_jax_params(model, jparams[kind])
            noise, time = _jax_flow_draws(batch, B, 5, 8, jax.random.PRNGKey(9))
        else:
            g = np.random.default_rng(9)
            noise, time = g.standard_normal((B, 5, 8)).astype(np.float32), np.full(B, 0.4, np.float32)
        x_t = np.random.RandomState(4).randn(B, 5, 8).astype(np.float32)
        spec["flow"][kind] = {"cfg": fcfg, "state": model.state_dict(), "batch": batch,
                              "noise": noise, "time": time, "x_t": x_t}
    torch.save(spec, tmp / "in" / "spec.pt")
    spawn(tmp, 2, PP_WORKER, ["fwd", "loss"])
    got = {2: {"fwd": results(tmp, "fwd", 2), "loss": results(tmp, "loss", 2)}}
    spawn(tmp, 4, PP_WORKER, ["fwd", "loss", "train", "mot", "flow"])
    got[4] = {k: results(tmp, k, 4) for k in ("fwd", "loss", "train", "mot", "flow")}

    ref = {}
    with torch.no_grad():
        ids, valid, pos, grp = (torch.as_tensor(a) for a in spec["fwd"])
        ref["fwd"] = tt.transformer_forward(cfg, decoder, tt.embed_tokens(decoder, cfg, ids),
                                            pos, grp, valid)
    decoder.requires_grad_(True)
    decoder.zero_grad()
    loss = _fp32_pipeline_loss(decoder, cfg, {k: torch.as_tensor(v) for k, v in loss_batch.items()},
                               None, n_micro=1)
    loss.backward()
    ref["loss"] = {"loss": float(loss.detach()),
                   "grads": {k: p.grad.clone() for k, p in decoder.named_parameters()}}
    plain = _plain_causal_loss(decoder, cfg, loss_batch)
    ref["plain_loss"] = plain
    ref["flow"] = {}
    for kind in FLOW:
        f = spec["flow"][kind]
        model = tflow.build_flow_vla(f["cfg"], "cpu")
        model.load_state_dict(f["state"])
        model.requires_grad_(True)
        b = {k: torch.as_tensor(v) for k, v in f["batch"].items()}
        loss, _ = tflow.flow_vla_loss(model, f["cfg"], b, noise=torch.as_tensor(f["noise"]),
                                      time=torch.as_tensor(f["time"]))
        loss.backward()
        ref["flow"][kind] = {"loss": float(loss.detach()),
                             "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                                       if p.grad is not None}}
        if kind == "pi0":
            with torch.no_grad():
                cfg0 = f["cfg"]
                pt, pm, par = tflow.embed_prefix(model, cfg0, b["images"], b["image_masks"],
                                                 b["input_ids"], b["attention_mask"])
                st, sm, sar, cond = tflow.embed_suffix(model, cfg0, b["states"],
                                                       torch.as_tensor(f["x_t"]),
                                                       torch.full((len(pt),), 0.5), dtype=pt.dtype)
                mask, grp, pos = tflow._positions_and_grp(pm, par, sm, sar)
                ref["mot"], _ = tt.mot_forward(tflow._streams(model, cfg0, pt, st, cond),
                                               positions=pos, q_grp=grp, q_valid=mask)
                ref["mot_inputs"] = (pt, st, pos, grp, mask)
    return {"spec": spec, "got": got, "ref": ref, "jparams": jparams}


def _plain_causal_loss(decoder, cfg, batch):
    """The unpipelined loss (transformer_forward), fp32: the pipelined one's reference."""
    ids, valid = (torch.as_tensor(batch[k]) for k in ("input_ids", "attention_mask"))
    pos = torch.cumsum(valid, 1, dtype=torch.int32) - 1
    with torch.no_grad():
        h = tt.transformer_forward(cfg, decoder, tt.embed_tokens(decoder, cfg, ids), pos,
                                   pos * valid, valid)
        logits = tt.lm_logits(decoder, cfg, h).float()
    return float(tlosses.causal_lm_loss(logits, torch.as_tensor(batch["labels"])))


def _rows_of(outs: list, world: int, stage: int, key) -> torch.Tensor:
    """The data ranks' rows, in order, from the ranks of stage 0 (rank = stage
    x data + data rank on a ('stage', 'data') mesh)."""
    data = world // stage
    return torch.cat([outs[d][key] for d in range(data)])


def _close(got, want, what="", rtol=EXACT, atol=EXACT):
    got, want = (x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                 for x in (got, want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("world,stage,n_micro", [(2, 2, 2), (4, 2, 2), (4, 4, 1), (4, 4, 4)])
def test_pp_forward_matches_one_process(pp, world, stage, n_micro):
    """Every rank (every stage) holds the last stage's hidden states of its
    rows, equal to transformer_forward's."""
    outs = pp["got"][world]["fwd"]
    data = world // stage
    for r, o in enumerate(outs):
        d = r % data
        rows = slice(4 * d // data, 4 * (d + 1) // data)
        _close(o[(stage, n_micro)], pp["ref"]["fwd"][rows], f"rank {r}")


@needs_jax
def test_pp_forward_matches_jax(pp):
    """The stage=2 x data=2 hidden states against JAX's pipeline on its
    test's stage=4 x data=2 mesh of the virtual devices."""
    ids, valid, pos, grp = pp["spec"]["fwd"]
    jcfg = jt.TransformerConfig(**CFG)
    params = pp["jparams"]["decoder"]
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("stage", "data"))
    x = jt.embed_tokens(params, jcfg, jnp.asarray(ids))
    want = jax.jit(lambda p, x: jpipe.pipeline_transformer_forward(
        jcfg, p, x, pos, grp, valid, mesh, n_micro=2))(params, x)
    got = _rows_of(pp["got"][4]["fwd"], 4, 2, (2, 2))
    _close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_pp_loss_and_grads_match(pp, world):
    """The pipelined causal-LM loss on fp32 embeddings at stage=2 (x data=2 at 4 processes):
    the loss (the data ranks' mean) and every gradient a rank holds equal one
    process's at 1e-5; the loss equals the unpipelined one."""
    ref = pp["ref"]["loss"]
    np.testing.assert_allclose(ref["loss"], pp["ref"]["plain_loss"], rtol=EXACT)
    outs = pp["got"][world]["loss"]
    data = world // 2
    np.testing.assert_allclose(np.mean([o["loss"] for o in outs[:data]]), ref["loss"], rtol=EXACT)
    for r, o in enumerate(outs):
        stage = r // data
        owned = {k for k in ref["grads"] if not k.startswith("layers.")
                 or int(k.split(".")[1]) // 4 == stage}
        assert set(o["grads"]) == owned, r
        for k, g in o["grads"].items():
            _close(g, ref["grads"][k], k)


@needs_jax
def test_pp_loss_and_grads_match_jax(pp):
    """The fp32 loss at stage=2 x data=2 and every gradient against JAX's
    pipelined decoder on its test's stage=4 x data=2 mesh, with the JAX
    loss's CE, at 1e-3."""
    b = pp["spec"]["loss"]
    ids, valid, labels = (jnp.asarray(b[k]) for k in ("input_ids", "attention_mask", "labels"))
    jcfg = jt.TransformerConfig(**CFG)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("stage", "data"))

    def loss(p):
        pos = jnp.cumsum(valid, axis=1) - 1
        hidden = jpipe.pipeline_transformer_forward(jcfg, p, jt.embed_tokens(p, jcfg, ids), pos,
                                                    pos * valid, valid, mesh, n_micro=2)
        logp = jax.nn.log_softmax(jt.lm_logits(p, jcfg, hidden[:, :-1]).astype(jnp.float32), -1)
        mask = (labels[:, 1:] != -100) & (valid[:, 1:] == 1)
        nll = -jnp.take_along_axis(logp, jnp.where(mask, labels[:, 1:], 0)[..., None], -1)[..., 0]
        return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1)

    jl, jg = jax.jit(jax.value_and_grad(loss))(pp["jparams"]["decoder"])
    outs = pp["got"][4]["loss"]
    np.testing.assert_allclose(np.mean([o["loss"] for o in outs[:2]]), float(jl), rtol=TOL)
    grads = {}
    for o in outs:
        grads.update(o["grads"])
    for name, val, _ in port_arrays(jax.device_get(jg)):
        _close(grads[name], val, name, rtol=TOL, atol=TOL)


def test_pp_param_shardings_and_train_step(pp):
    """pp_param_shardings puts layers 0-3 on stage 0, 4-7 on stage 1 and the
    rest on every stage; two AdamW steps of each stage's own parameters lower
    the loss, move the stage's layers and leave the other stage's."""
    for o in pp["got"][4]["train"]:
        owner, stage = o["owner"], o["stage"]
        assert owner["layers.0.attn.q.weight"] == 0 and owner["layers.7.mlp.down.weight"] == 1
        assert owner["embed.weight"] is None and owner["norm.weight"] is None
        l1, l2 = o["losses"]
        assert np.isfinite(l1) and l2 < l1
        for k, moved in o["moved"].items():
            if owner[k] is not None:
                assert moved == (owner[k] == stage), k


def test_pp_mot_forward_matches_mot(pp):
    """pipeline_mot_forward (stage=2 x data=2): both streams' outputs equal
    mot_forward's."""
    outs = pp["got"][4]["mot"]
    for i in range(2):
        got = torch.cat([outs[0][i], outs[1][i]])
        _close(got, pp["ref"]["mot"][i], f"stream {i}")


@needs_jax
def test_pp_mot_forward_matches_jax(pp):
    jcfg, _ = _flow_cfgs("pi0")
    pt, st, pos, grp, mask = (np.asarray(t) for t in pp["ref"]["mot_inputs"])
    params = pp["jparams"]["pi0"]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("stage", "data"))
    want = jax.jit(lambda p: jpipe.pipeline_mot_forward(
        (jcfg.llm, jcfg.expert), (p["vlm"]["llm"], p["expert"]), (pt, st), pos, grp, mask, mesh,
        n_micro=2))(params)
    outs = pp["got"][4]["mot"]
    for i in range(2):
        _close(torch.cat([outs[0][i], outs[1][i]]), want[i], f"stream {i}", rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", FLOW)
def test_pp_flow_vla_loss_and_grads_match(pp, kind):
    """pipeline_flow_vla_loss at stage=2 x data=2: the loss and every
    gradient a rank holds (π0.5's adaRMS path included) equal flow_vla_loss
    in one process on the same noise and times."""
    ref = pp["ref"]["flow"][kind]
    outs = [o[kind] for o in pp["got"][4]["flow"]]
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["loss"], ref["loss"], rtol=EXACT)
        for k, g in o["grads"].items():  # a leaf the loss does not reach: None there, 0 here
            _close(g, ref["grads"].get(k, torch.zeros_like(g)), f"rank {r} {k}")
    held = set().union(*(o["grads"] for o in outs))
    assert held >= set(ref["grads"])


@needs_jax
@pytest.mark.parametrize("kind", FLOW)
def test_pp_flow_vla_loss_matches_jax(pp, kind):
    """The same against JAX's pipeline_flow_vla_loss (its test's mesh, key
    and batch), loss and every gradient, at 1e-3."""
    jcfg, _ = _flow_cfgs(kind)
    batch = {k: jnp.asarray(v) for k, v in pp["spec"]["flow"][kind]["batch"].items()}
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("stage", "data"))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jpipe.pipeline_flow_vla_loss(
        p, jcfg, batch, jax.random.PRNGKey(9), mesh, n_micro=2)[0]))(pp["jparams"][kind])
    outs = [o[kind] for o in pp["got"][4]["flow"]]
    np.testing.assert_allclose(outs[0]["loss"], float(jl), rtol=TOL)
    grads = {}
    for o in outs:
        grads.update(o["grads"])
    n = 0
    for name, val, _ in port_arrays(jax.device_get(jg)):
        if name in grads:  # the tower and projector sit outside the pipeline: one process's
            _close(grads[name], val, name, rtol=TOL, atol=TOL)
            n += 1
    assert n == len(grads)


def test_decoder_layer_is_a_layer_of_transformer_forward():
    """decoder_layer over the stack, then the final norm, is transformer_forward."""
    from dexbotic_tpu_torch.ops.rope import rope_cos_sin

    cfg = tt.TransformerConfig(**CFG)
    model = tt.Transformer(cfg)
    tt.init_transformer_(model, torch.Generator().manual_seed(4))
    ids, valid, pos, grp = (torch.as_tensor(a) for a in _inputs(seed=5))
    seg = (pos >= 9).int()
    with torch.no_grad():
        x = tt.embed_tokens(model, cfg, ids)
        want = tt.transformer_forward(cfg, model, x, pos, grp, valid, q_seg=seg)
        cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
        for lp in model.layers:
            x = tpipe.decoder_layer(cfg, lp, x, cos, sin, grp, valid, seg)
        got = tt._apply_norm(model.norm, cfg, x, None)[0]
    assert torch.equal(got, want)
