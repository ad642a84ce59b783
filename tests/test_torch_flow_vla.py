"""The flow-VLA serving slice of the port (pi0, pi0.5, DM0, DM0-Prog) vs the JAX package.

Weights come from the JAX ``init_flow_vla``/``init_transformer`` through
utils/bridge.py, with the zero-initialised adaRMS ``dense`` leaves redrawn
(otherwise pi0.5's time condition would change nothing); inputs and the
Euler noise are numpy arrays handed to both sides.  fp32 on the CPU; the
slice at atol 1e-3 (ROADMAP's parity pin), the modules at 1e-4, the golden
chunk at its own rtol 1e-4 / atol 1e-5.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexbotic_tpu.exp import pi0_exp as jexp
from dexbotic_tpu.models import flow_vla as jflow
from dexbotic_tpu.models import presets as jpresets
from dexbotic_tpu.nn import transformer as jtransformer
from dexbotic_tpu.ops import diffusion as jdiffusion
from dexbotic_tpu.ops import norms as jnorms
from dexbotic_tpu_torch.exp import pi0_exp as texp
from dexbotic_tpu_torch.models import flow_vla as tflow
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.nn import core
from dexbotic_tpu_torch.nn import transformer as ttransformer
from dexbotic_tpu_torch.ops import diffusion as tdiffusion
from dexbotic_tpu_torch.ops import norms as tnorms
from dexbotic_tpu_torch.utils.bridge import STACKED, load_jax_params

torch.set_num_threads(2)
SLICE_ATOL, MODULE_ATOL = 1e-3, 1e-4


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


def _redraw_adarms(params, rng):
    """The adaRMS ``dense`` leaves are zero at init: give them values to check."""
    if isinstance(params, dict):
        return {k: ({kk: rng.normal(0, 0.05, vv.shape).astype(np.float32) for kk, vv in v.items()}
                    if k == "dense" else _redraw_adarms(v, rng)) for k, v in params.items()}
    return params


def _bridged(kind, seed=0):
    jcfg, tcfg = _pair(kind)
    params = jax.device_get(jflow.init_flow_vla(jax.random.PRNGKey(seed), jcfg))
    params = _redraw_adarms(params, np.random.default_rng(seed))
    model = tflow.build_flow_vla(tcfg, "cpu")
    mapping = load_jax_params(model, params)
    return jcfg, tcfg, params, model, mapping


@pytest.fixture(scope="module", params=["pi0", "pi05", "dm0", "dm0_prog"])
def bridged(request):
    return (request.param, *_bridged(request.param))


def _inputs(cfg, B=2, n_views=2, text_len=7, seed=1):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, n_views, 28, 28, 3)).astype(np.float32)
    image_masks = np.ones((B, n_views), np.int32)
    image_masks[1, 1:] = 0  # the second row's other views are missing
    ids = rng.integers(1, cfg.llm.vocab_size, (B, text_len)).astype(np.int32)
    text_mask = np.ones((B, text_len), np.int32)
    text_mask[0, -2:] = 0  # a padded text tail
    ids[text_mask == 0] = 0
    states = rng.standard_normal((B, cfg.action_dim)).astype(np.float32)
    noise = rng.standard_normal((B, cfg.chunk_size, cfg.action_dim)).astype(np.float32)
    progress = rng.uniform(0, 1, (B, 1, 1)).astype(np.float32)
    return images, image_masks, ids, text_mask, states, noise, progress


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def test_flow_inference_matches_jax(bridged):
    """pi0, pi0.5, DM0 and DM0-Prog: the whole chunk (and DM0-Prog's
    progress) from the same weights and injected noise."""
    kind, jcfg, tcfg, params, model, _ = bridged
    images, masks, ids, tmask, states, noise, progress = _inputs(jcfg)
    prog = progress if kind == "dm0_prog" else None
    ref = jflow.flow_vla_inference_action(
        params, jcfg, jnp.asarray(ids), jnp.asarray(tmask), jnp.asarray(images), jnp.asarray(masks),
        jnp.asarray(states), jax.random.PRNGKey(0), noise=jnp.asarray(noise),
        progress=None if prog is None else jnp.asarray(prog))
    got = tflow.flow_vla_inference_action(
        model, tcfg, *_t(ids, tmask, images, masks, states), noise=torch.from_numpy(noise),
        progress=None if prog is None else torch.from_numpy(prog))
    if prog is not None:
        (ref, ref_prog), (got, got_prog) = ref, got
        np.testing.assert_allclose(got_prog.numpy(), np.asarray(ref_prog), atol=SLICE_ATOL, rtol=0)
    assert got.shape == (2, 5, 8) and np.abs(np.asarray(ref) - noise).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=SLICE_ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["pi0", "pi05"])
def test_bf16_weights_compute_in_fp32_as_jax(kind):
    """Served weights: the JAX serving dtype rule (matrices in bf16) on both
    sides.  The prefix is embedded in the images' fp32, so the decoder, the
    expert and the KV cache compute in fp32 (each layer casts its bf16
    weight up) and the chunk matches JAX at the fp32 pin."""
    jcfg, tcfg, params, model, _ = _bridged(kind)
    # every leaf rounded to bf16 values, so that either side's dtype holds them exactly
    params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)),
                          params)
    load_jax_params(model, params)
    core.cast_like_jax_(model, torch.bfloat16)
    assert model.expert.layers[0].attn.q.weight.dtype == torch.bfloat16
    # a stacked layer's norm scales (π0.5's adaRMS: its dense bias) are [L, D]
    # leaves in JAX's tree, which casts them too
    assert model.vlm.llm.layers[0].ln1.weight.dtype == torch.bfloat16
    vectors = [p for p in model.expert.layers[0].parameters() if p.ndim == 1]
    assert vectors and all(p.dtype == torch.bfloat16 for p in vectors)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16) if a.ndim >= 2 else jnp.asarray(a),
                           params)
    images, masks, ids, tmask, states, noise, _ = _inputs(jcfg)
    ref = jflow.flow_vla_inference_action(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(tmask), jnp.asarray(images),
        jnp.asarray(masks), jnp.asarray(states), jax.random.PRNGKey(0), noise=jnp.asarray(noise))
    with torch.no_grad():
        tokens = tflow.embed_prefix(model, tcfg, *_t(images, masks, ids, tmask))[0]
    assert tokens.dtype == torch.float32
    got = tflow.flow_vla_inference_action(model, tcfg, *_t(ids, tmask, images, masks, states),
                                          noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=SLICE_ATOL, rtol=0)


def test_prefix_and_suffix_embeddings_match_jax(bridged):
    kind, jcfg, tcfg, params, model, _ = bridged
    images, masks, ids, tmask, states, noise, progress = _inputs(jcfg)
    ref = jflow.embed_prefix(params, jcfg, jnp.asarray(images), jnp.asarray(masks),
                             jnp.asarray(ids), jnp.asarray(tmask))
    got = tflow.embed_prefix(model, tcfg, *_t(images, masks, ids, tmask))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=MODULE_ATOL, rtol=0)
    time = np.array([1.0, 0.3], np.float32)
    prog = progress if kind == "dm0_prog" else None
    ref = jflow.embed_suffix(params, jcfg, jnp.asarray(states), jnp.asarray(noise),
                             jnp.asarray(time), progress=None if prog is None else jnp.asarray(prog))
    got = tflow.embed_suffix(model, tcfg, *_t(states, noise, time),
                             progress=None if prog is None else torch.from_numpy(prog))
    assert (got[3] is None) == (ref[3] is None) == (kind != "pi05")
    for g, r in zip(got, ref):
        if r is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=MODULE_ATOL, rtol=0)


def test_cached_suffix_matches_joint():
    """One Euler step over the frozen cache equals the joint forward's
    velocity on the same noise (the JAX package's own check, on the port)."""
    _, tcfg, _, model, _ = _bridged("pi0")
    images, masks, ids, tmask, states, noise = _t(*_inputs(tcfg)[:6])
    one = tflow.flow_vla_inference_action(model, tcfg, ids, tmask, images, masks, states,
                                          num_steps=1, noise=noise)
    with torch.no_grad():
        prefix, pmask, par = tflow.embed_prefix(model, tcfg, images, masks, ids, tmask)
        suffix, smask, sar, cond = tflow.embed_suffix(model, tcfg, states, noise,
                                                      torch.ones(2), dtype=prefix.dtype)
        mask, grp, pos = tflow._positions_and_grp(pmask, par, smask, sar)
        outs, _ = ttransformer.mot_forward(tflow._streams(model, tcfg, prefix, suffix, cond),
                                           positions=pos, q_grp=grp, q_valid=mask)
        v = model.action_out_proj(outs[1][:, -tcfg.chunk_size:])
    np.testing.assert_allclose(one.numpy(), (noise - v).numpy(), rtol=2e-3, atol=2e-4)


def test_golden_pi0_actions():
    """tests/golden_outputs.npz:pi0_actions, from the JAX init, inputs and noise."""
    jcfg = jflow.pi0_config(jpresets.LLM_TEST, jpresets.EXPERT_TEST, jpresets.VIT_TEST,
                            action_dim=8, chunk_size=5, projector_type="linear")
    tcfg = tflow.pi0_config(tpresets.LLM_TEST, tpresets.EXPERT_TEST, tpresets.VIT_TEST,
                            action_dim=8, chunk_size=5, projector_type="linear")
    model = tflow.build_flow_vla(tcfg, "cpu")
    load_jax_params(model, jax.device_get(jflow.init_flow_vla(jax.random.PRNGKey(0), jcfg)))
    ids = np.arange(1, 7).reshape(1, -1).astype(np.int32)
    imgs = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 2, 28, 28, 3)))
    states = np.array(jax.random.normal(jax.random.PRNGKey(3), (1, 8)))
    # flow_vla_inference_action draws its noise from the rng it is given
    noise = np.array(jax.random.normal(jax.random.PRNGKey(2), (1, 5, 8), jnp.float32))
    got = tflow.flow_vla_inference_action(
        model, tcfg, torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.int32),
        torch.from_numpy(imgs), torch.ones((1, 2), dtype=torch.int32), torch.from_numpy(states),
        noise=torch.from_numpy(noise)).numpy()
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden_outputs.npz"))["pi0_actions"]
    np.testing.assert_allclose(got, golden, rtol=1e-4, atol=1e-5)


def test_bridge_round_trip(bridged):
    """Every JAX leaf (adaRMS dense ones included) lands in exactly one port
    parameter, per layer for a stack, and comes back unchanged."""
    kind, _, _, params, model, mapping = bridged
    port = dict(model.named_parameters())
    assert set(mapping) == set(port)
    if kind == "pi05":
        assert "expert.layers.1.ln2.dense.weight" in port and "expert.norm.dense.bias" in port

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix, np.asarray(tree)

    n = 0
    for path, arr in leaves(params):
        names = sorted((k for k, v in mapping.items() if v == "/".join(path)),
                       key=lambda s: [int(p) if p.isdigit() else p for p in s.split(".")])
        stacked = any(k in STACKED for k in path)
        assert len(names) == (arr.shape[0] if stacked else 1), path
        vals = [port[k].detach().numpy() for k in names]
        if path[-1] == "w" and arr.ndim - stacked == 2:
            vals = [v.T for v in vals]
        np.testing.assert_array_equal(np.stack(vals) if stacked else vals[0], arr)
        n += len(names)
    assert n == len(port)


# ---------------------------------------------------------------------------
# The leaf ops
# ---------------------------------------------------------------------------


def test_posemb_sincos_matches_jax():
    t = np.array([0.0, 0.05, 0.5, 0.999, 1.0], np.float32)
    for dim in (16, 1024):
        ref = jflow.posemb_sincos(jnp.asarray(t), dim)
        got = tflow.posemb_sincos(torch.from_numpy(t), dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=MODULE_ATOL, rtol=0)


@pytest.mark.parametrize("offset,cond_ndim", [(0.0, 2), (1.0, 3)])
def test_ada_rms_norm_matches_jax(offset, cond_ndim):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    w = rng.normal(0, 0.2, 32).astype(np.float32)
    cond = rng.normal(0, 0.3, (3, 32) if cond_ndim == 2 else (3, 1, 32)).astype(np.float32)
    ref = jnorms.ada_rms_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(cond), 1e-6, offset)
    got = tnorms.ada_rms_norm(*_t(x, w, cond), 1e-6, offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=MODULE_ATOL, rtol=0)


@pytest.mark.parametrize("steps", [1, 10])
def test_flow_euler_sample_matches_jax(steps):
    rng = np.random.default_rng(6)
    noise = rng.standard_normal((2, 5, 8)).astype(np.float32)
    a = rng.standard_normal((5, 8)).astype(np.float32)
    ref = jdiffusion.flow_euler_sample(lambda x, t: jnp.tanh(x * t) + jnp.asarray(a) * t,
                                       jnp.asarray(noise), steps)
    got = tdiffusion.flow_euler_sample(lambda x, t: torch.tanh(x * t) + torch.from_numpy(a) * t,
                                       torch.from_numpy(noise), steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=MODULE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# mot_forward: two streams, an adaRMS one, in each cache mode
# ---------------------------------------------------------------------------


def _mot_pair(seed=7):
    """(JAX streams' configs/params, port modules): a Gemma-flavoured LLM
    stream and an adaRMS expert of the same attention geometry."""
    llm = dict(dataclasses.asdict(jpresets.LLM_TEST), norm_offset=1.0, act="gelu_tanh")
    jl, tl = jtransformer.TransformerConfig(**llm), ttransformer.TransformerConfig(**llm)
    je, te = jpresets.EXPERT_TEST_ADARMS, tpresets.EXPERT_TEST_ADARMS
    rng = np.random.default_rng(seed)
    out = []
    for k, (jc, tc) in enumerate(((jl, tl), (je, te))):
        p = jax.device_get(jtransformer.init_transformer(jax.random.PRNGKey(seed + k), jc))
        p = jax.tree.map(lambda a: a + rng.normal(0, 0.1, a.shape).astype(np.float32)
                         if a.ndim <= 2 else a, p)  # offset norms and dense leaves off zero
        m = ttransformer.Transformer(tc)
        load_jax_params(m, p)
        out.append((jc, tc, p, m))
    return out


def _mot_inputs(B, T, start, seed, hidden=(64, 32), split=None):
    rng = np.random.default_rng(seed)
    valid = np.ones((B, T), np.int32)
    valid[0, -2:] = 0
    ar = (rng.uniform(size=(B, T)) < 0.4).astype(np.int32)
    grp = (np.cumsum(ar, 1) + start).astype(np.int32)
    pos = (np.cumsum(valid, 1) - 1 + start).astype(np.int32)
    split = T // 2 if split is None else split
    embeds = [rng.standard_normal((B, n, h)).astype(np.float32)
              for n, h in zip((split, T - split), hidden)]
    cond = rng.standard_normal((B, 32)).astype(np.float32)
    return embeds, pos, grp, valid, cond


def _run_mot(pair, embeds, cond, pos, grp, valid, jcache=None, tcache=None, update=False):
    (jl, tl, pl, ml), (je, te, pe, me) = pair
    jstreams = [jtransformer.Stream(jl, pl, None if embeds[0] is None else jnp.asarray(embeds[0])),
                jtransformer.Stream(je, pe, None if embeds[1] is None else jnp.asarray(embeds[1]),
                                    jnp.asarray(cond))]
    tstreams = [ttransformer.Stream(tl, ml, None if embeds[0] is None else torch.from_numpy(embeds[0])),
                ttransformer.Stream(te, me, None if embeds[1] is None else torch.from_numpy(embeds[1]),
                                    torch.from_numpy(cond))]
    jouts, jc = jtransformer.mot_forward(jstreams, jnp.asarray(pos), jnp.asarray(grp),
                                         jnp.asarray(valid), cache=jcache, update_cache=update)
    with torch.no_grad():
        touts, tc = ttransformer.mot_forward(tstreams, *_t(pos, grp, valid), cache=tcache,
                                             update_cache=update)
    for j, t in zip(jouts, touts):
        assert (j is None) == (t is None)
        if j is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=MODULE_ATOL, rtol=0)
    return jc, tc


def _check_cache(jc, tc):
    assert int(jc["length"]) == int(tc["length"])
    for key in ("k", "v", "grp", "valid"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), atol=MODULE_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "prefill_given_cache", "frozen_prefix"])
def test_mot_forward_modes_match_jax(mode):
    pair = _mot_pair()
    B = 2
    if mode == "no_cache":  # the joint forward of both streams
        embeds, pos, grp, valid, cond = _mot_inputs(B, 13, 0, 1)
        jc, tc = _run_mot(pair, embeds, cond, pos, grp, valid)
        assert jc is None and tc is None
        return
    # prefill of the LLM stream alone into a fresh cache of its length
    embeds, pos, grp, valid, cond = _mot_inputs(B, 11, 0, 2, split=11)
    jc, tc = _run_mot(pair, [embeds[0], None], cond, pos, grp, valid, update=True)
    _check_cache(jc, tc)
    if mode == "prefill_given_cache":  # both streams appended at the cursor of a larger cache
        (jl, tl, _, _), _ = pair
        jbuf = jtransformer.init_kv_cache(jl, B, 24, dtype=jnp.float32)
        tbuf = ttransformer.init_kv_cache(tl, B, 24, dtype=torch.float32)
        jc, tc = _run_mot(pair, [embeds[0], None], cond, pos, grp, valid, jbuf, tbuf, update=True)
        e2, pos2, grp2, valid2, cond2 = _mot_inputs(B, 9, 11, 3)
        jc2, tc2 = _run_mot(pair, e2, cond2, pos2, grp2, valid2, jc, tc, update=True)
        _check_cache(jc2, tc2)
        assert int(tc2["length"]) == 20
        assert tc2["k"] is tc["k"] and tc2["v"] is tc["v"]  # the given K/V are written in place
        np.testing.assert_allclose(tc2["k"].numpy()[:, :, :11], np.asarray(jc["k"])[:, :, :11],
                                   atol=MODULE_ATOL, rtol=0)
    if mode == "frozen_prefix":  # the adaRMS expert's suffix against the frozen cache
        e2, pos2, grp2, valid2, cond2 = _mot_inputs(B, 6, 11, 4, split=0)
        k_before = tc["k"].clone()
        jc2, tc2 = _run_mot(pair, [None, e2[1]], cond2, pos2, grp2, valid2, jc, tc, update=False)
        assert tc2 is tc and torch.equal(tc["k"], k_before)  # never written back


def test_mot_forward_refuses_unported_modes():
    """Per-row cache columns (write_cols, ported with the decode engine)
    need a cache to write into; the MoE parts (nn/moe.py) are ported: an MoE
    decoder builds, and ``want_aux`` returns the load-balance loss (0 without
    an MoE stream)."""
    _, tcfg, _, model, _ = _bridged("pi0")
    x = torch.zeros(1, 3, tcfg.llm.hidden_size)
    ints = torch.zeros(1, 3, dtype=torch.int32)
    stream = [ttransformer.Stream(tcfg.llm, model.vlm.llm, x)]
    with pytest.raises(ValueError, match="write_cols"):
        ttransformer.mot_forward(stream, ints, ints, ints + 1, update_cache=True,
                                 write_cols=torch.zeros(1, dtype=torch.int32))
    _, _, aux = ttransformer.mot_forward(stream, ints, ints, ints + 1, want_aux=True)
    assert float(aux["moe_aux"]) == 0.0
    moe = ttransformer.Transformer(dataclasses.replace(tcfg.llm, moe_num_experts=4))
    assert moe.layers[0].mlp.gate.weight.shape == (4, tcfg.llm.hidden_size,
                                                   tcfg.llm.intermediate_size)


# ---------------------------------------------------------------------------
# Configs and presets
# ---------------------------------------------------------------------------


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = f.default
        if default is dataclasses.MISSING and f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
            if dataclasses.is_dataclass(default):
                default = (type(default).__name__, dataclasses.asdict(default))
        out.append((f.name, default))
    return out


@pytest.mark.parametrize("name", ["FlowModelConfig", "Pi0ActionConfig", "Pi0InferenceConfig",
                                  "Pi0Exp", "Pi05Exp", "DM0Exp"])
def test_exp_config_fields_match_jax(name):
    """Field names and defaults of the exp configs (the port's DataConfig has
    no ``seed``/``worker_mode`` and its TokenizerConfig no
    ``use_special_tokens``: those nested values are compared by their shared
    fields; the port's BaseExp adds ``device``)."""
    jf = _fields(getattr(jexp, name))
    tf = [(n, v) for n, v in _fields(getattr(texp, name)) if n != "device"]
    assert [n for n, _ in tf] == [n for n, _ in jf]
    for (n, tv), (_, jv) in zip(tf, jf):
        if isinstance(tv, tuple) and isinstance(jv, tuple):
            assert tv[0] == jv[0], n
            assert {k: v for k, v in tv[1].items() if k in jv[1]} == \
                {k: v for k, v in jv[1].items() if k in tv[1]}, n
        elif n in ("optimizer", "trainer"):
            continue  # the training configs, compared by the training tests
        else:
            assert tv == jv, n


def test_flow_config_fields_and_presets_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(tflow.FlowVLAConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jflow.FlowVLAConfig)]
    for table in ("LLM_PRESETS", "EXPERT_PRESETS", "VIT_PRESETS"):
        t, j = getattr(tpresets, table), getattr(jpresets, table)
        assert set(t) == set(j), table
        for key in t:
            assert dataclasses.asdict(t[key]) == dataclasses.asdict(j[key]), (table, key)
    for variant in ("pi0", "pi05", "dm0"):
        j = jexp.FlowModelConfig(variant=variant, llm_preset="test", vit_preset="test",
                                 expert_preset="test_adarms" if variant == "pi05" else "test")
        t = texp.FlowModelConfig(**dataclasses.asdict(j))
        jc, tc = j.build_config(), t.build_config()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.suffix_len == jc.suffix_len and tc.vlm.num_image_tokens == jc.vlm.num_image_tokens


@pytest.mark.parametrize("key", ["pi05_served_suffix", "pi05_train", "dm0_served_prefix",
                                 "dm0_served_suffix", "dm0_prog_served_suffix", "dm0_train"])
def test_chip_smoke_flow_k1_inputs_match_the_model(key, monkeypatch):
    """chip_smoke phase 3b's pi0.5 / DM0 / DM0-Prog K1 inputs (FLOW_CASES via
    flow_attn_inputs) carry the query and key rows and the group and valid
    masks that the model gives its decoder attention at that call: a tiny
    model of the variant, 3 views of 4 image tokens, the case's text slots
    and valid ids and its suffix; the first call of the prefill, of the
    first Euler step, or of the training loss."""
    import chip_smoke
    from dexbotic_tpu_torch.nn import transformer

    cases = {c[0]: c for c in chip_smoke.FLOW_CASES}
    assert set(cases) == {"pi05_served_suffix", "pi05_train", "dm0_served_prefix",
                          "dm0_served_suffix", "dm0_prog_served_suffix", "dm0_train"}
    _, variant, B, text, n_valid, part = cases[key]
    chunk = chip_smoke.FLOW_TRAIN[variant][1] if part == "train" else 50
    cfg = dataclasses.replace(_pair(variant)[1], chunk_size=chunk)
    model = tflow.build_flow_vla(cfg, "cpu")
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.standard_normal((B, 3, 28, 28, 3)).astype(np.float32))
    masks = torch.ones((B, 3), dtype=torch.int32)
    ids = torch.from_numpy(rng.integers(1, cfg.llm.vocab_size, (B, text)).astype(np.int32))
    ids[:, n_valid:] = 0
    tmask = (ids != 0).to(torch.int32)
    calls = []
    attn = transformer.attention

    def recorded(q, k, v, q_grp, kv_grp, kv_valid, *args, **kw):
        calls.append((q.shape[1], k.shape[1], q_grp, kv_grp, kv_valid))
        return attn(q, k, v, q_grp, kv_grp, kv_valid, *args, **kw)

    monkeypatch.setattr(transformer, "attention", recorded)
    with torch.no_grad():
        if part == "train":
            batch = {"images": images, "image_masks": masks, "input_ids": ids,
                     "attention_mask": tmask,
                     "actions": torch.randn(B, chunk, cfg.action_dim, generator=torch.Generator())}
            tflow.flow_vla_loss(model, cfg, batch, torch.Generator().manual_seed(0))
        else:
            prog = torch.full((B, 1, 1), 0.3) if variant == "dm0_prog" else None
            tflow.flow_vla_inference_action(model, cfg, ids, tmask, images, masks, None,
                                            generator=torch.Generator().manual_seed(0),
                                            num_steps=1, progress=prog)
    got = calls[cfg.llm.num_layers if part == "suffix" else 0]
    _, q, k, _, want, _ = chip_smoke.flow_attn_inputs(variant, B, text, n_valid, part,
                                                      torch.Generator().manual_seed(0),
                                                      views=3 * 4, device="cpu")
    assert got[:2] == (q.shape[1], k.shape[1])
    for w, g in zip(want, got[2:]):
        assert torch.equal(g.to(torch.int64).expand(w.shape), w.to(torch.int64))
