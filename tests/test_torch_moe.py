"""The Mixture-of-Experts FFN in the port (``nn/moe.py``), the MoE layer of
``nn/transformer.mot_forward(want_aux=True)`` and expert parallelism.

The JAX package's tests (tests/test_moe.py) held here against JAX through
the bridge (the JAX init carried into the port by ``utils/bridge.py``),
fp32 at 1e-5 unless stated:

* identical experts and a capacity over every token equal the dense gated
  MLP, and JAX's layer;
* capacity overflow drops assignments (zero weight), never NaN, as JAX;
* a uniform router's balance loss is 1;
* the MoE decoder's loss with the balance term, and every gradient (router
  and experts included), against ``jax.value_and_grad``;
* padding takes no slot and no statistic, and comes out 0;
* tied router probabilities pick the lower expert first, as
  ``jax.lax.top_k`` (``torch.topk`` promises no order);
* expert parallelism on a ('data', 'expert', 'model') mesh of 2 x 2 x 1
  gloo processes (``parallel/mesh.place_experts``: a rank holds 2 of the 4
  experts; FSDP2 holds the rest of each layer over 'data'): the outputs,
  the balance loss and every gradient equal one process's unsharded layer
  at 1e-5, with a capacity that drops assignments (the slot order and the
  capacity are the global batch's); two Trainer steps equal one process's,
  and the expert stacks stay sharded on 'expert' through the updates, their
  moments the local shards.
"""

import textwrap

import numpy as np
import pytest
import torch

from _gloo import results, spawn
from dexbotic_tpu_torch.nn import core as tcore
from dexbotic_tpu_torch.nn import moe as tmoe
from dexbotic_tpu_torch.nn import transformer as ttransformer
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

try:  # the JAX references; the card's machine has no JAX, and there they skip
    import jax
    import jax.numpy as jnp

    from dexbotic_tpu.nn import core as jcore
    from dexbotic_tpu.nn import moe as jmoe
    from dexbotic_tpu.nn import transformer as jtransformer
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="the JAX package is not installed")

EXACT = 1e-5
MOE = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
           intermediate_size=48, attn_impl="xla", moe_num_experts=4, moe_top_k=2,
           moe_capacity_factor=2.0)
TIGHT = dict(MOE, moe_capacity_factor=0.5)  # capacity 8 of 32 tokens' 64 assignments: drops


def _close(got, want, what="", tol=EXACT):
    got, want = (x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                 for x in (got, want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _layer(H, I, E, seed):
    """(JAX params, the port's MoE bridged from them)."""
    p = jax.device_get(jmoe.moe_init(jax.random.PRNGKey(seed), H, I, E))
    m = tmoe.MoE(H, I, E)
    load_jax_params(m, p)
    return p, m


def _both(p, m, x, **kw):
    jy, jaux = jmoe.moe_mlp(p, jnp.asarray(x), **{k: jnp.asarray(v) if k == "valid" else v
                                                   for k, v in kw.items()})
    ty, taux = tmoe.moe_mlp(m, torch.from_numpy(x), **{k: torch.from_numpy(v) if k == "valid"
                                                        else v for k, v in kw.items()})
    return (np.asarray(jy), float(jaux)), (ty, taux)


@needs_jax
def test_identical_experts_match_dense():
    H, I, E = 16, 24, 4
    dense = jax.device_get(jcore.gated_mlp_init(jax.random.PRNGKey(0), H, I))
    p, _ = _layer(H, I, E, 1)
    for name in ("gate", "up", "down"):
        p[name]["w"] = np.broadcast_to(dense[name]["w"][None], (E,) + dense[name]["w"].shape).copy()
    m = tmoe.MoE(H, I, E)
    load_jax_params(m, p)
    x = np.random.RandomState(2).randn(2, 7, H).astype(np.float32)
    (jy, jaux), (ty, taux) = _both(p, m, x, top_k=2, capacity_factor=float(E))
    mlp = tcore.GatedMLP(H, I)
    load_jax_params(mlp, dense)
    _close(ty, mlp(torch.from_numpy(x)), "MoE vs dense", tol=2e-5)
    _close(ty, jy, "vs JAX")
    assert np.isfinite(float(taux)) and abs(float(taux) - jaux) < EXACT


@needs_jax
def test_capacity_overflow_drops_not_nans():
    H, I, E = 8, 12, 4
    p, m = _layer(H, I, E, 0)
    x = np.random.RandomState(1).randn(4, 16, H).astype(np.float32)
    stats = {}
    ty, taux = tmoe.moe_mlp(m, torch.from_numpy(x), top_k=2, capacity_factor=0.25, stats=stats)
    jy, jaux = jmoe.moe_mlp(p, jnp.asarray(x), top_k=2, capacity_factor=0.25)
    assert torch.isfinite(ty).all() and np.isfinite(float(taux))
    assert tmoe.expert_capacity(64, E, 2, 0.25) < 64 * 2 // E
    assert stats["capacity"] == tmoe.expert_capacity(64, E, 2, 0.25) and stats["dropped_share"] > 0
    _close(ty, jy, "dropped assignments as JAX's")
    assert abs(float(taux) - float(jaux)) < EXACT


@needs_jax
def test_uniform_router_aux_is_one():
    H, I, E = 8, 12, 4
    p, m = _layer(H, I, E, 0)
    p["router"]["w"] = np.zeros_like(p["router"]["w"])
    with torch.no_grad():
        m.router.weight.zero_()
    x = np.random.RandomState(1).randn(2, 8, H).astype(np.float32)
    (jy, jaux), (ty, taux) = _both(p, m, x, top_k=2)
    assert float(taux) == pytest.approx(1.0, abs=1e-5) and jaux == pytest.approx(1.0, abs=1e-5)
    _close(ty, jy)


@needs_jax
def test_tied_router_logits_pick_the_lower_expert_first():
    """Router rows whose probabilities tie (all equal; two equal for the
    second place) route as jax.lax.top_k: the lower index first."""
    H, I, E = 8, 12, 6
    p, m = _layer(H, I, E, 3)
    w = np.zeros((H, E), np.float32)
    w[0] = [0.0, 2.0, 1.0, 1.0, 0.0, 2.0]  # x[0] scales: experts 1/5 tie first, 2/3 and 0/4 next
    w[1] = [1.0, 0.0, 0.0, 1.0, 1.0, 0.0]
    p["router"]["w"] = w
    with torch.no_grad():
        m.router.weight.copy_(torch.from_numpy(w.T))
    x = np.zeros((1, 6, H), np.float32)
    x[0, :, 0] = [1.0, 0.0, 2.0, 0.0, 1.0, -1.0]
    x[0, :, 1] = [0.0, 0.0, 1.0, 3.0, 1.0, 0.0]
    x[0, :, 2:] = np.random.RandomState(4).randn(6, H - 2) * 1e-3  # no router weight there
    probs = torch.softmax(torch.from_numpy(x[0] @ w), -1)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    _, tidx = tmoe._top_k(probs, 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    (jy, jaux), (ty, taux) = _both(p, m, x, top_k=2, capacity_factor=1.0)
    _close(ty, jy, "tied routing as JAX's")
    assert abs(float(taux) - jaux) < EXACT


def _causal(B, S, seed=1):
    r = np.random.RandomState(seed)
    ids = r.randint(0, 64, (B, S))
    valid = np.ones((B, S), np.int32)
    grp = np.cumsum(valid, 1).astype(np.int32)
    return ids, grp - 1, grp, valid


@needs_jax
def test_transformer_moe_forward_and_grads():
    jcfg, tcfg = jtransformer.TransformerConfig(**MOE), ttransformer.TransformerConfig(**MOE)
    params = jax.device_get(jtransformer.init_transformer(jax.random.PRNGKey(0), jcfg))
    assert params["layers"]["mlp"]["gate"]["w"].shape == (2, 4, 32, 48)
    model = ttransformer.Transformer(tcfg)
    load_jax_params(model, params)
    assert model.layers[1].mlp.router.weight.shape == (4, 32)
    ids, pos, grp, valid = _causal(2, 10)

    def jloss(p):
        x = jtransformer.embed_tokens(p, jcfg, jnp.asarray(ids))
        outs, _, aux = jtransformer.mot_forward([jtransformer.Stream(jcfg, p, x)], pos, grp,
                                                valid, want_aux=True)
        return jnp.mean(jtransformer.lm_logits(p, jcfg, outs[0]) ** 2) + 0.01 * aux["moe_aux"]

    jl, jg = jax.value_and_grad(jloss)(params)
    x = ttransformer.embed_tokens(model, tcfg, torch.from_numpy(ids))
    outs, _, aux = ttransformer.mot_forward([ttransformer.Stream(tcfg, model, x)],
                                            *(torch.from_numpy(a) for a in (pos, grp, valid)),
                                            want_aux=True)
    loss = (ttransformer.lm_logits(model, tcfg, outs[0]) ** 2).mean() + 0.01 * aux["moe_aux"]
    loss.backward()
    _close(loss, jl, "loss")
    got = dict(model.named_parameters())
    for name, val, _ in port_arrays(jax.device_get(jg)):
        _close(got[name].grad, val, name)
    assert got["layers.0.mlp.router.weight"].grad.abs().max() > 0
    assert got["layers.0.mlp.down.weight"].grad.abs().max() > 0
    # transformer_forward(want_aux=True) is the one-stream case
    _, aux1 = ttransformer.transformer_forward(tcfg, model, x.detach(),
                                               *(torch.from_numpy(a) for a in (pos, grp, valid)),
                                               want_aux=True)
    _close(aux1["moe_aux"], aux["moe_aux"])


@needs_jax
def test_valid_mask_excludes_padding():
    """Invalid tokens take no slot and no statistic, and are 0; the valid
    rows equal a run over the valid prefix alone at a capacity of the same
    slots; all as JAX."""
    H, I, E = 16, 24, 4
    p, m = _layer(H, I, E, 3)
    B, T = 2, 8
    x = np.random.RandomState(4).randn(B, T, H).astype(np.float32)
    valid = np.ones((B, T), np.int32)
    valid[:, T // 2:] = 0
    (jy, jaux), (ty, taux) = _both(p, m, x, top_k=2, capacity_factor=2.0, valid=valid)
    assert not ty[:, T // 2:].any()
    _close(ty, jy)
    prefix, _ = tmoe.moe_mlp(m, torch.from_numpy(x[:, : T // 2].copy()), top_k=2,
                             capacity_factor=1.0)
    tight, tight_aux = tmoe.moe_mlp(m, torch.from_numpy(x), top_k=2, capacity_factor=0.5,
                                    valid=torch.from_numpy(valid))
    assert tmoe.expert_capacity(B * T, E, 2, 0.5) == tmoe.expert_capacity(B * T // 2, E, 2, 1.0)
    _close(tight[:, : T // 2], prefix)
    (jy2, jaux2), _ = _both(p, m, x, top_k=2, capacity_factor=0.5, valid=valid)
    _close(tight, jy2)
    assert abs(float(tight_aux) - jaux2) < EXACT


EP_WORKER = textwrap.dedent('''
    from torch.distributed.tensor import DTensor

    from dexbotic_tpu_torch.exp import optim as toptim
    from dexbotic_tpu_torch.exp import trainer as ttrainer
    from dexbotic_tpu_torch.models import losses
    from dexbotic_tpu_torch.nn import transformer as tt


    def _rows(a, i, n):
        return a[len(a) * i // n: len(a) * (i + 1) // n]


    def case_forward():
        """The MoE decoder's loss and gradients on a (WORLD / 2) x 2 x 1 expert
        mesh, each data rank on its rows, the capacity dropping assignments."""
        spec = load("ep")
        pmesh.FSDP_MIN_SIZE = 256
        mesh = pmesh.make_mesh(data=WORLD // 2, expert=2)
        cfg = tt.TransformerConfig(**spec["cfg"])
        model = tt.Transformer(cfg)
        model.load_state_dict(spec["state"])
        sharded = pmesh.shard_model(model, mesh)
        w = model.layers[0].mlp.gate.weight
        placed = (isinstance(w, DTensor) and tuple(w.to_local().shape) == (2, 32, 48)
                  and w.device_mesh.mesh_dim_names == ("expert",))
        d, n = sharded.data_rank, sharded.data_size
        ids, pos, grp, valid = (torch.from_numpy(_rows(a, d, n)) for a in spec["inputs"])
        with losses.data_parallel(sharded.data_group, n):
            logits, aux = sharded(lambda m: spec_loss(m, cfg, ids, pos, grp, valid))
            sq = losses.batch_mean((logits.float() ** 2).sum(), torch.tensor(float(logits.numel())))
            loss = sq + 0.01 * aux
        loss.backward()
        sharded.reduce_grads()
        grads = {k: multihost.host_copy(p.grad) for k, p in model.named_parameters()}
        save("forward", {"logits": logits.detach(), "aux": float(aux), "loss": float(loss),
                         "grads": grads, "placed": placed, "fsdp_layers": len(sharded.layers)})


    def spec_loss(m, cfg, ids, pos, grp, valid):
        x = tt.embed_tokens(m, cfg, ids)
        outs, _, aux = tt.mot_forward([tt.Stream(cfg, m, x)], pos, grp, valid, want_aux=True)
        return tt.lm_logits(m, cfg, outs[0]), aux["moe_aux"]


    def case_train():
        """Two Trainer steps on the expert mesh; the stacks' placement after."""
        spec = load("ep")
        pmesh.FSDP_MIN_SIZE = 256
        mesh = pmesh.make_mesh(data=2, expert=2)
        cfg = tt.TransformerConfig(**spec["cfg"])
        model = tt.Transformer(cfg)
        model.load_state_dict(spec["state"])
        tr = ttrainer.Trainer(train_loss(cfg), model, ttrainer.TrainerConfig(**spec["trainer"]),
                              toptim.OptimizerConfig(learning_rate=1e-3), mesh=mesh)
        tr.train(({k: _rows(v, tr.data_rank, tr.data_size) for k, v in b.items()}
                  for b in spec["batches"]))
        tr.close()
        w = tr.params["layers.1.mlp.down.weight"]
        save("train", {
            "placed": isinstance(w, DTensor) and w.placements[0].is_shard(0)
                      and tuple(w.to_local().shape) == (2, 48, 32),
            "moment": tuple(tr.optimizer.mu["layers.1.mlp.down.weight"].shape),
            "params": {k: multihost.host_copy(p.detach()) for k, p in tr.params.items()}})


    def train_loss(cfg):
        def loss_fn(model, batch, generator):
            logits, aux = spec_loss(model, cfg, batch["ids"], batch["pos"], batch["grp"],
                                    batch["valid"])
            sq = losses.batch_mean((logits.float() ** 2).sum(),
                                   torch.tensor(float(logits.numel())))
            return sq + 0.01 * aux, {"moe_aux": aux}
        return loss_fn
''')


def _ep_spec(model):
    ids, pos, grp, valid = _causal(4, 8, seed=7)
    valid = valid.copy()
    valid[3, 6:] = 0  # padding takes no slot
    batches = []
    for s in range(2):
        b_ids, b_pos, b_grp, b_valid = _causal(4, 8, seed=20 + s)
        batches.append({"ids": b_ids, "pos": b_pos, "grp": b_grp, "valid": b_valid})
    return {"cfg": TIGHT, "state": model.state_dict(), "inputs": (ids, pos, grp, valid),
            "batches": batches,
            "trainer": dict(output_dir="ep_out", max_steps=2, logging_steps=1, save_steps=2,
                            bf16=False, resume=False)}


def _ref_loss(cfg):
    def loss_fn(model, batch, generator):
        x = ttransformer.embed_tokens(model, cfg, torch.as_tensor(batch["ids"]))
        outs, _, aux = ttransformer.mot_forward(
            [ttransformer.Stream(cfg, model, x)],
            *(torch.as_tensor(batch[k]) for k in ("pos", "grp", "valid")), want_aux=True)
        logits = ttransformer.lm_logits(model, cfg, outs[0])
        return (logits.float() ** 2).mean() + 0.01 * aux["moe_aux"], {"moe_aux": aux["moe_aux"]}
    return loss_fn


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    """The expert-parallel workers (4 processes) and the one-process references."""
    from dexbotic_tpu_torch.exp import optim as toptim
    from dexbotic_tpu_torch.exp import trainer as ttrainer

    tmp = tmp_path_factory.mktemp("moe")
    (tmp / "in").mkdir()
    cfg = ttransformer.TransformerConfig(**TIGHT)
    model = ttransformer.Transformer(cfg)
    ttransformer.init_transformer_(model, torch.Generator().manual_seed(0))
    spec = _ep_spec(model)
    torch.save(spec, tmp / "in" / "ep.pt")
    spawn(tmp, 2, EP_WORKER, ["forward"])
    got = {"forward2": results(tmp, "forward", 2)}
    spawn(tmp, 4, EP_WORKER, ["forward", "train"])
    got.update(forward4=results(tmp, "forward", 4), train=results(tmp, "train", 4))
    # one process, unsharded
    ids, pos, grp, valid = spec["inputs"]
    loss_fn = _ref_loss(cfg)
    loss, metrics = loss_fn(model, {"ids": ids, "pos": pos, "grp": grp, "valid": valid}, None)
    loss.backward()
    x = ttransformer.embed_tokens(model, cfg, torch.from_numpy(ids))
    with torch.no_grad():
        outs, _ = ttransformer.mot_forward([ttransformer.Stream(cfg, model, x)],
                                           *(torch.from_numpy(a) for a in (pos, grp, valid)))
        logits = ttransformer.lm_logits(model, cfg, outs[0])
    ref = {"loss": float(loss.detach()), "aux": float(metrics["moe_aux"]), "logits": logits,
           "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}
    fresh = ttransformer.Transformer(cfg)
    fresh.load_state_dict(spec["state"])
    trainer = ttrainer.Trainer(loss_fn, fresh,
                               ttrainer.TrainerConfig(**dict(spec["trainer"],
                                                             output_dir=str(tmp / "ref"))),
                               toptim.OptimizerConfig(learning_rate=1e-3))
    trainer.train(iter(spec["batches"]))
    trainer.close()
    ref["params"] = {k: p.detach().clone() for k, p in trainer.params.items()}
    return {"got": got, "ref": ref}


@pytest.mark.parametrize("world", [2, 4])
def test_moe_ep_sharded_matches_unsharded(ep, world):
    """expert=2 at data=1 (2 processes) and data=2 (4): each data rank's
    logits are its rows of the unsharded layer's, the balance loss and the
    loss are the global batch's, and every gradient (the expert stacks
    gathered) equals one process's."""
    outs, ref = ep["got"][f"forward{world}"], ep["ref"]
    data = world // 2
    assert all(o["placed"] for o in outs) and outs[0]["fsdp_layers"] == (2 if data > 1 else 0)
    logits = torch.cat([outs[2 * d]["logits"] for d in range(data)])  # rank 2d: data rank d
    _close(logits, ref["logits"], "logits")
    for o in outs:
        assert abs(o["aux"] - ref["aux"]) < EXACT
        for k, g in o["grads"].items():
            _close(g, ref["grads"][k], k)
    np.testing.assert_allclose(np.mean([o["loss"] for o in outs]), ref["loss"], rtol=EXACT)


def test_moe_ep_train_step(ep):
    """Two Trainer steps on the expert mesh equal one process's; the expert
    stacks stay sharded on 'expert' (2 of 4 experts a rank) through the
    updates, and their moments are the local shards."""
    for o in ep["got"]["train"]:
        assert o["placed"] and o["moment"] == (2, 48, 32)
        for k, p in o["params"].items():
            _close(p, ep["ref"]["params"][k], k)
