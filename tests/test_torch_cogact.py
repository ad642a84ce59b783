"""The CogACT serving slice of the port vs the JAX package, end to end and per module.

Weights come from the JAX ``init_*`` functions through utils/bridge.py, with
the DiT's zero-initialised final layer redrawn (otherwise eps = 0 and the
chunk checks nothing but the noise); the same numpy noise is injected on
both sides.  fp32 on the CPU; the slice at atol 1e-3 (ROADMAP's pin), the
modules at 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexbotic_tpu.constants import IMAGE_TOKEN_INDEX
from dexbotic_tpu.models import cogact as jcogact
from dexbotic_tpu.models import dit as jdit
from dexbotic_tpu.models import presets as jpresets
from dexbotic_tpu.models import vlm as jvlm
from dexbotic_tpu.nn import projector as jprojector
from dexbotic_tpu.nn import transformer as jtransformer
from dexbotic_tpu.nn import vit as jvit
from dexbotic_tpu_torch.models import cogact as tcogact
from dexbotic_tpu_torch.models import dit as tdit
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.nn import projector as tprojector
from dexbotic_tpu_torch.nn import transformer as ttransformer
from dexbotic_tpu_torch.nn import vit as tvit
from dexbotic_tpu_torch.utils.bridge import STACKED, load_jax_params

torch.set_num_threads(2)

LLM = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=16, intermediate_size=128, attn_impl="xla")
VIT = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=3, num_heads=4,
           intermediate_size=64, act="quick_gelu", ln_eps=1e-5, use_cls=True, pre_ln=True,
           select_layer=-2)  # CLIP style: CLS, pre-LN, quick_gelu, penultimate layer


def _cfgs(**kw):
    j = jcogact.CogActConfig(vlm=jvlm.VLMConfig(llm=jtransformer.TransformerConfig(**LLM),
                                                vit=jvit.ViTConfig(**VIT)),
                             action_model_type="DiT-S", **kw)
    t = tcogact.CogActConfig(vlm=tvlm.VLMConfig(llm=ttransformer.TransformerConfig(**LLM),
                                                vit=tvit.ViTConfig(**VIT)),
                             action_model_type="DiT-S", **kw)
    return j, t


@pytest.fixture(scope="module")
def bridged():
    jcfg, tcfg = _cfgs()
    params = jax.device_get(jcogact.init_cogact(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    final = params["action_head"]["final"]
    for leaf in ("w", "b"):
        final[leaf] = rng.normal(0, 0.02, final[leaf].shape).astype(np.float32)
    model = tcogact.build_cogact(tcfg, "cpu")
    mapping = load_jax_params(model, params)
    return params, model, mapping


def _inputs(cfg, B=2, n_text=10, pad=3):
    rng = np.random.default_rng(1)
    nt = cfg.vlm.num_image_tokens
    ids = rng.integers(1, 500, (B, nt + n_text)).astype(np.int32)
    ids[:, :nt] = IMAGE_TOKEN_INDEX
    valid = np.ones_like(ids)
    valid[-1, -pad:] = 0  # a right-padded row
    imgs = rng.standard_normal((B, 1, 28, 28, 3)).astype(np.float32)
    noise = rng.standard_normal((B, cfg.chunk_size, cfg.action_dim)).astype(np.float32)
    return ids, valid, imgs, noise


@pytest.mark.parametrize("sampler,steps,cfg_scale", [("ddim", 10, 1.5), ("dpm", 5, 1.0)])
def test_slice_matches_jax(bridged, sampler, steps, cfg_scale):
    params, model, _ = bridged
    jcfg, tcfg = _cfgs(sampler=sampler, ddim_steps=steps, cfg_scale=cfg_scale)
    ids, valid, imgs, noise = _inputs(jcfg)
    ref = np.asarray(jcogact.cogact_inference_action(
        params, jcfg, jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(imgs),
        jax.random.PRNGKey(0), noise=jnp.asarray(noise)))
    got = tcogact.cogact_inference_action(
        model, tcfg, torch.from_numpy(ids), torch.from_numpy(valid), torch.from_numpy(imgs),
        noise=torch.from_numpy(noise)).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_vit_and_projector_match_jax(bridged):
    params, model, _ = bridged
    jcfg, tcfg = _cfgs()
    imgs = _inputs(jcfg)[2][:, 0]
    ref = jvit.vit_forward(params["vlm"]["vit"], jcfg.vlm.vit, jnp.asarray(imgs))
    got = tvit.vit_forward(model.vlm.vit, tcfg.vlm.vit, torch.from_numpy(imgs))
    assert got.shape == (2, 4, 32)  # CLS dropped
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    ref_p = jprojector.apply_projector(params["vlm"]["projector"], ref, "mlp2x_gelu")
    got_p = tprojector.apply_projector(model.vlm.projector, got, "mlp2x_gelu")
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), atol=1e-4, rtol=0)


def test_cognition_feature_matches_jax(bridged):
    params, model, _ = bridged
    jcfg, tcfg = _cfgs()
    ids, valid, imgs, _ = _inputs(jcfg)
    ref, ref_h = jcogact.cognition_feature(params, jcfg, jnp.asarray(ids), jnp.asarray(valid),
                                           jnp.asarray(imgs))
    got, got_h = tcogact.cognition_feature(model, tcfg, torch.from_numpy(ids),
                                           torch.from_numpy(valid), torch.from_numpy(imgs))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_dit_forward_matches_jax(bridged):
    params, model, _ = bridged
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16, 7)).astype(np.float32)
    t = np.array([0, 9, 50, 99], np.int32)
    z = rng.standard_normal((4, 1, 64)).astype(np.float32)
    ref = jdit.dit_forward(params["action_head"], jcfg.dit, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(z))
    got = tdit.dit_forward(model.action_head, tcfg.dit, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(z))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_decoder_flavour_flags_match_jax():
    """attn_bias, qk_norm, norm_offset, embed_scale and a tied embedding."""
    flags = dict(LLM, act="gelu_tanh", attn_bias=True, qk_norm=True, norm_offset=1.0,
                 embed_scale=True, tie_embeddings=True, rope_theta=1e6)
    jcfg, tcfg = jtransformer.TransformerConfig(**flags), ttransformer.TransformerConfig(**flags)
    params = jax.device_get(jtransformer.init_transformer(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)
    params = jax.tree.map(  # the offset norms init to 0: give them values to check
        lambda a: a + rng.normal(0, 0.1, a.shape).astype(np.float32) if a.ndim <= 2 else a, params)
    llm = ttransformer.Transformer(tcfg)
    load_jax_params(llm, params)
    assert not hasattr(llm, "lm_head")
    ids = rng.integers(0, 512, (2, 12)).astype(np.int32)
    valid = np.ones_like(ids)
    valid[1, -4:] = 0
    grp = np.cumsum(valid, 1).astype(np.int32)
    pos = grp - 1
    emb = jtransformer.embed_tokens(params, jcfg, jnp.asarray(ids))
    ref, _ = jtransformer.transformer_forward(jcfg, params, emb, jnp.asarray(pos), jnp.asarray(grp),
                                             jnp.asarray(valid))
    ref_logits = jtransformer.lm_logits(params, jcfg, ref)
    temb = ttransformer.embed_tokens(llm, tcfg, torch.from_numpy(ids))
    with torch.no_grad():
        got = ttransformer.transformer_forward(tcfg, llm, temb, torch.from_numpy(pos),
                                               torch.from_numpy(grp), torch.from_numpy(valid))
        got_logits = ttransformer.lm_logits(llm, tcfg, got)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(ref_logits), atol=1e-4, rtol=0)


def test_bridge_round_trip(bridged):
    """Every JAX leaf lands in exactly one port parameter (per layer for a
    stack) and comes back unchanged."""
    params, model, mapping = bridged
    port = dict(model.named_parameters())
    assert set(mapping) == set(port)

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
        back = np.stack(vals) if stacked else vals[0]
        np.testing.assert_array_equal(back, arr)
        n += len(names)
    assert n == len(port)


def test_golden_cogact_actions():
    """tests/golden_outputs.npz:cogact_actions, from the JAX init and the JAX noise."""
    jcfg = jcogact.CogActConfig(vlm=jvlm.VLMConfig(llm=jpresets.LLM_TEST, vit=jpresets.VIT_TEST),
                                action_model_type="DiT-S", action_dim=7, chunk_size=4)
    tcfg = tcogact.CogActConfig(vlm=tvlm.VLMConfig(llm=tpresets.LLM_TEST, vit=tpresets.VIT_TEST),
                                action_model_type="DiT-S", action_dim=7, chunk_size=4)
    model = tcogact.build_cogact(tcfg, "cpu")
    load_jax_params(model, jax.device_get(jcogact.init_cogact(jax.random.PRNGKey(0), jcfg)))
    nt = tcfg.vlm.num_image_tokens
    ids = np.arange(1, nt + 9).reshape(1, -1).astype(np.int32)
    ids[:, :nt] = IMAGE_TOKEN_INDEX
    imgs = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 1, 28, 28, 3)))
    noise = np.array(jax.random.normal(jax.random.PRNGKey(2), (1, 4, 7), jnp.float32))
    got = tcogact.cogact_inference_action(
        model, tcfg, torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.int32),
        torch.from_numpy(imgs), noise=torch.from_numpy(noise)).numpy()
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden_outputs.npz"))["cogact_actions"]
    np.testing.assert_allclose(got, golden, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["TransformerConfig", "ViTConfig", "DiTConfig", "VLMConfig",
                                  "CogActConfig"])
def test_config_fields_match_jax(name):
    jmod = {"TransformerConfig": jtransformer, "ViTConfig": jvit, "DiTConfig": jdit,
            "VLMConfig": jvlm, "CogActConfig": jcogact}[name]
    tmod = {"TransformerConfig": ttransformer, "ViTConfig": tvit, "DiTConfig": tdit,
            "VLMConfig": tvlm, "CogActConfig": tcogact}[name]
    jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jmod, name))]
    tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tmod, name))]
    assert tf == jf


@pytest.mark.parametrize("name", ["LLAMA2_7B", "CLIP_VIT_L_336", "LLM_TEST", "VIT_TEST", "GEMMA_2B",
                                  "GEMMA_300M_EXPERT", "GEMMA_300M_EXPERT_ADARMS", "QWEN3_1_7B",
                                  "QWEN3_06B_EXPERT", "SIGLIP_SO400M_224", "EXPERT_TEST_ADARMS"])
def test_presets_match_jax(name):
    assert dataclasses.asdict(getattr(tpresets, name)) == dataclasses.asdict(getattr(jpresets, name))


def test_preset_tables_and_dit_sizes_match_jax():
    assert tdit.DIT_SIZES == jdit.DIT_SIZES
    for key, cfg in tpresets.LLM_PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jpresets.LLM_PRESETS[key])
    for key, cfg in tpresets.VIT_PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jpresets.VIT_PRESETS[key])
    assert set(tpresets.EXPERT_PRESETS) == set(jpresets.EXPERT_PRESETS)
    jc, tc = _cfgs()
    assert dataclasses.asdict(tc.dit) == dataclasses.asdict(jc.dit)
    assert tc.vlm.num_image_tokens == jc.vlm.num_image_tokens == 4


def test_denorm_actions_matches_jax():
    a = np.random.default_rng(4).uniform(-1.5, 1.5, (16, 7)).astype(np.float32)
    lo, hi = np.linspace(-1, 0, 7), np.linspace(1, 3, 7)
    np.testing.assert_allclose(tcogact.denorm_actions(a, lo, hi),
                               np.asarray(jcogact.denorm_actions(jnp.asarray(a), lo, hi)),
                               rtol=1e-6, atol=1e-6)


def test_decoder_prefill_cache_matches_jax():
    """transformer_forward, the N=1 case of mot_forward, keeps CogACT's
    numbers; its prefill into a KV cache writes what the JAX cache holds."""
    jcfg, tcfg = jtransformer.TransformerConfig(**LLM), ttransformer.TransformerConfig(**LLM)
    params = jax.device_get(jtransformer.init_transformer(jax.random.PRNGKey(4), jcfg))
    llm = ttransformer.Transformer(tcfg)
    load_jax_params(llm, params)
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((2, 10, 64)).astype(np.float32)
    valid = np.ones((2, 10), np.int32)
    valid[0, -3:] = 0
    grp = np.cumsum(valid, 1).astype(np.int32)
    ref, cache = jtransformer.transformer_forward(jcfg, params, jnp.asarray(emb), jnp.asarray(grp - 1),
                                                 jnp.asarray(grp), jnp.asarray(valid),
                                                 update_cache=True)
    args = [torch.from_numpy(a) for a in (emb, grp - 1, grp, valid)]
    with torch.no_grad():
        got = ttransformer.transformer_forward(tcfg, llm, *args)
        outs, tcache = ttransformer.mot_forward([ttransformer.Stream(tcfg, llm, args[0])], *args[1:],
                                                update_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(outs[0].numpy(), got.numpy())
    assert tcache["length"] == int(cache["length"]) == 10
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(cache[key]), atol=1e-4, rtol=0)
