"""Checkpoint import of the port (dexbotic_tpu_torch/utils/convert.py) vs the JAX package.

* Tiny ``transformers`` models built from a config with random weights (no
  download): the port's converters and modules against HF's logits and
  features, at tests/test_convert.py's tolerances (2e-3 to 3e-3).
* A full-policy round trip for CogACT, pi0, pi0.5 (adaRMS) and DM0 (the
  Qwen3 pair): seeded JAX params -> the port model (utils/bridge.py) ->
  reference key names by chip_smoke's writer (.safetensors in fp32 and bf16,
  .bin) -> (a) the JAX converter on the file read into fp32 numpy gives the
  JAX tree back exactly, which holds the writer against the reference
  converter; (b) the port's converter gives the bridged model's parameters
  back; (c) its chunk matches JAX's on the injected noise at 1e-3.
* The port's safetensors parser against ``safetensors.torch.save_file``,
  bit for bit, without the ``safetensors`` package on the port's side.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dexbotic_tpu.models import cogact as jcogact
from dexbotic_tpu.models import flow_vla as jflow
from dexbotic_tpu.models import presets as jpresets
from dexbotic_tpu.models import vlm as jvlm
from dexbotic_tpu.nn import transformer as jtransformer
from dexbotic_tpu.nn import vit as jvit
from dexbotic_tpu.utils import convert as jconvert
from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
from dexbotic_tpu_torch.exp.pi0_exp import FlowModelConfig, Pi0Exp
from dexbotic_tpu_torch.models import cogact as tcogact
from dexbotic_tpu_torch.models import flow_vla as tflow
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.nn import transformer as ttransformer
from dexbotic_tpu_torch.nn import vit as tvit
from dexbotic_tpu_torch.ops.quant import jax_stack
from dexbotic_tpu_torch.utils import convert as tconvert
from dexbotic_tpu_torch.utils.bridge import load_jax_params

torch.set_num_threads(2)
transformers = pytest.importorskip("transformers")


def _hf_logits_vs_port(hf, sd, cfg, ids, tol, prefix="model."):
    params = tconvert.attach_lm_head(tconvert.convert_llm(sd, cfg, prefix=prefix), sd, cfg)
    llm = ttransformer.Transformer(cfg)
    load_jax_params(llm, params)
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids)).logits.numpy()
        x = ttransformer.embed_tokens(llm, cfg, torch.tensor(ids))
        valid = torch.ones(ids.shape, dtype=torch.int32)
        grp = torch.cumsum(valid, 1, dtype=torch.int32)
        out = ttransformer.transformer_forward(cfg, llm, x, grp - 1, grp, valid)
        got = ttransformer.lm_logits(llm, cfg, out).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_llama_parity():
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    hf = LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rms_norm_eps=1e-5, rope_theta=10000.0, attention_dropout=0.0,
        tie_word_embeddings=False)).eval()
    cfg = ttransformer.TransformerConfig(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
        intermediate_size=64, rms_eps=1e-5, tie_embeddings=False, attn_impl="xla")
    ids = np.random.RandomState(0).randint(0, 128, (2, 10))
    _hf_logits_vs_port(hf, hf.state_dict(), cfg, ids, 2e-3)


def test_qwen3_parity():
    from transformers import Qwen3Config, Qwen3ForCausalLM

    torch.manual_seed(1)
    hf = Qwen3ForCausalLM(Qwen3Config(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, max_position_embeddings=64,
        rms_norm_eps=1e-6, rope_theta=1e6, tie_word_embeddings=False)).eval()
    cfg = ttransformer.TransformerConfig(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
        intermediate_size=64, rms_eps=1e-6, rope_theta=1e6, qk_norm=True,
        tie_embeddings=False, attn_impl="xla")
    ids = np.random.RandomState(1).randint(0, 128, (2, 8))
    _hf_logits_vs_port(hf, hf.state_dict(), cfg, ids, 2e-3)


def test_gemma_parity():
    """Tied: HF's state dict also holds lm_head.weight, which the port leaves out."""
    from transformers import GemmaConfig, GemmaForCausalLM

    torch.manual_seed(2)
    hf = GemmaForCausalLM(GemmaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, head_dim=8, max_position_embeddings=64,
        rms_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True)).eval()
    cfg = ttransformer.TransformerConfig(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=1, head_dim=8,
        intermediate_size=64, rms_eps=1e-6, act="gelu_tanh", norm_offset=1.0, embed_scale=True,
        tie_embeddings=True, attn_impl="xla", attn_scale=8**-0.5)
    sd = hf.state_dict()
    assert "lm_head.weight" in sd
    ids = np.random.RandomState(2).randint(0, 128, (1, 8))
    _hf_logits_vs_port(hf, sd, cfg, ids, 3e-3)


def _vit_vs_port(hf_vision, cfg, imgs, want):
    params = tconvert.convert_vit(hf_vision.state_dict(), cfg, prefix="vision_model.")
    vit = tvit.ViT(cfg)
    load_jax_params(vit, params)
    with torch.no_grad():
        got = tvit.vit_forward(vit, cfg, torch.from_numpy(imgs.transpose(0, 2, 3, 1))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_clip_vit_parity():
    """CLIP: no patch bias (zeros), pre_layrnorm, the penultimate layer, CLS dropped."""
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(3)
    hf = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
        image_size=28, patch_size=14, hidden_act="quick_gelu", layer_norm_eps=1e-5)).eval()
    cfg = tvit.ViTConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=3, num_heads=4,
                         intermediate_size=64, act="quick_gelu", ln_eps=1e-5, use_cls=True,
                         pre_ln=True, select_layer=-2, drop_cls=True)
    imgs = np.random.RandomState(3).randn(2, 3, 28, 28).astype(np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.tensor(imgs), output_hidden_states=True).hidden_states[-2]
    _vit_vs_port(hf, cfg, imgs, want.numpy()[:, 1:])


def test_siglip_vit_parity():
    from transformers import SiglipVisionConfig, SiglipVisionModel

    torch.manual_seed(4)
    hf = SiglipVisionModel(SiglipVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        image_size=28, patch_size=14, hidden_act="gelu_pytorch_tanh",
        layer_norm_eps=1e-6)).eval()
    cfg = tvit.ViTConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
                         intermediate_size=64, act="gelu_tanh", ln_eps=1e-6, select_layer=None)
    imgs = np.random.RandomState(4).randn(2, 3, 28, 28).astype(np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.tensor(imgs)).last_hidden_state.numpy()
    _vit_vs_port(hf, cfg, imgs, want)


def test_llava_full_vlm_splice_parity():
    """The whole VLM, splice included, against HF Llava (mlp2x_gelu projector)."""
    from transformers import (CLIPVisionConfig, LlamaConfig, LlavaConfig,
                              LlavaForConditionalGeneration)

    from dexbotic_tpu_torch.constants import IMAGE_TOKEN_INDEX

    vc = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=4, image_size=28, patch_size=14,
                          hidden_act="quick_gelu")
    tc = LlamaConfig(vocab_size=128, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5,
                     tie_word_embeddings=False)
    torch.manual_seed(5)
    hf = LlavaForConditionalGeneration(LlavaConfig(
        vision_config=vc, text_config=tc, image_token_index=120, vision_feature_layer=-2,
        vision_feature_select_strategy="default", projector_hidden_act="gelu")).eval()
    sd = hf.state_dict()
    cfg = tvlm.VLMConfig(
        llm=ttransformer.TransformerConfig(
            vocab_size=128, hidden_size=48, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=12, intermediate_size=96, rms_eps=1e-5, tie_embeddings=False,
            attn_impl="xla"),
        vit=tvit.ViTConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
                           num_heads=4, intermediate_size=64, act="quick_gelu", ln_eps=1e-5,
                           use_cls=True, pre_ln=True, select_layer=-2, drop_cls=True),
        projector_type="mlp2x_gelu")
    # the HF projector's two Linears under a Sequential's names (indices 0 and 2)
    proj = {f"p.{2 * i}.{leaf}": sd[f"model.multi_modal_projector.linear_{i + 1}.{leaf}"]
            for i in range(2) for leaf in ("weight", "bias")}
    params = {
        "llm": tconvert.attach_lm_head(
            tconvert.convert_llm(sd, cfg.llm, prefix="model.language_model."), sd, cfg.llm),
        "vit": tconvert.convert_vit(sd, cfg.vit, prefix="model.vision_tower.vision_model."),
        "projector": tconvert.convert_projector(proj, "mlp2x_gelu", prefix="p."),
    }
    vlm = tvlm.VLM(cfg)
    load_jax_params(vlm, params)
    ids = np.array([[1, 120, 120, 120, 120, 5, 6, 7]])
    px = torch.randn(1, 3, 28, 28)
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids), pixel_values=px).logits.numpy()
        ours = torch.from_numpy(np.where(ids == 120, IMAGE_TOKEN_INDEX, ids).astype(np.int32))
        hidden = tvlm.vlm_forward(vlm, cfg, ours, torch.ones_like(ours),
                                  images=px.permute(0, 2, 3, 1)[:, None])
        got = ttransformer.lm_logits(vlm.llm, cfg.llm, hidden).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("projector_type,keys", [
    ("linear", ["weight", "bias"]), ("linear", ["0.weight", "0.bias"]),
    ("linear4x", ["weight"]), ("mlp3x_gelu", ["0.weight", "0.bias", "2.weight", "2.bias",
                                                "4.weight", "4.bias"]),
    ("mlp_downsample", ["1.weight", "1.bias", "2.weight", "2.bias", "4.weight", "4.bias"])])
def test_projector_layouts_match_jax(projector_type, keys):
    rng = np.random.default_rng(6)
    sd = {f"mm_projector.{k}": rng.standard_normal((6, 4) if k.endswith("weight") and
                                                   not k.startswith("1.") else (4,))
          .astype(np.float32) for k in keys}
    want = jconvert.convert_projector(sd, projector_type)
    got = tconvert.convert_projector({k: torch.from_numpy(v) for k, v in sd.items()},
                                     projector_type)
    _assert_trees_equal(got, want)


def test_memvla_dit_raises():
    """MemVLA's DiT (each block's packed per_attn and norm3, the head's
    per_token_embedder) converts to JAX's tree, and kernel K2 raises on the
    DiT it fills: its memory cross-attention takes the plain sampler."""
    from dexbotic_tpu.models import dit as jdit
    from dexbotic_tpu_torch.models import dit as tdit
    from dexbotic_tpu_torch.ops.diffusion import DiffusionSchedule
    from dexbotic_tpu_torch.ops.dit_fused import fused_dit_sample

    kw = dict(hidden_size=32, depth=2, num_heads=4, in_channels=3, token_size=16, chunk_size=4,
              mem_cross_attn=True)
    jcfg, tcfg = jdit.DiTConfig(**kw), tdit.DiTConfig(**kw)
    rng = np.random.default_rng(0)
    shapes = {"x_embedder.linear": (32, 3), "t_embedder.mlp.0": (32, 256),
              "t_embedder.mlp.2": (32, 32), "z_embedder.linear": (32, 16),
              "final_layer.linear": (3, 32), "per_token_embedder.linear": (32, 8)}
    for i in range(2):
        shapes.update({f"blocks.{i}.attn.qkv": (96, 32), f"blocks.{i}.attn.proj": (32, 32),
                       f"blocks.{i}.mlp.fc1": (128, 32), f"blocks.{i}.mlp.fc2": (32, 128),
                       f"blocks.{i}.per_attn.out_proj": (32, 32)})
    sd = {}
    for name, (o, i) in shapes.items():
        sd[name + ".weight"], sd[name + ".bias"] = rng.normal(size=(o, i)), rng.normal(size=o)
    for i in range(2):
        sd[f"blocks.{i}.per_attn.in_proj_weight"] = rng.normal(size=(96, 32))
        sd[f"blocks.{i}.per_attn.in_proj_bias"] = rng.normal(size=96)
        sd[f"blocks.{i}.norm3.weight"], sd[f"blocks.{i}.norm3.bias"] = rng.normal(size=(2, 32))
    sd["positional_embedding"] = rng.normal(size=(5, 32))
    sd["z_embedder.uncondition"] = rng.normal(size=(1, 16))
    sd = {"action_head.net." + k: np.asarray(v, np.float32) for k, v in sd.items()}
    want = jconvert.convert_dit(sd, jcfg)
    got = tconvert.convert_dit({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    _assert_trees_equal(got, want)
    head = tdit.DiT(tcfg)
    head.per_token_embedder = tdit.core.Linear(8, 32)
    load_jax_params(head, got)
    with pytest.raises(NotImplementedError, match="K2"):
        fused_dit_sample(head, tcfg, torch.zeros(1, 1, 16), torch.zeros(1, 4, 3),
                         DiffusionSchedule.create(100), steps=2, cfg_scale=1.5)


# ---------------------------------------------------------------------------
# Full policies: JAX params -> port model -> reference files -> both converters
# ---------------------------------------------------------------------------

LLM = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=16, intermediate_size=128, attn_impl="xla")
CLIP = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=3, num_heads=4,
            intermediate_size=64, act="quick_gelu", ln_eps=1e-5, use_cls=True, pre_ln=True,
            select_layer=-2)
POLICIES = ["cogact", "pi0", "pi05", "dm0"]
FORMATS = ["safetensors_fp32", "safetensors_bf16", "bin"]


def _configs(policy):
    """(JAX config, port config) of a tiny policy."""
    if policy == "cogact":
        return tuple(m.CogActConfig(vlm=v.VLMConfig(llm=t.TransformerConfig(**LLM),
                                                    vit=vt.ViTConfig(**CLIP)),
                                    action_model_type="DiT-S")
                     for m, v, t, vt in ((jcogact, jvlm, jtransformer, jvit),
                                         (tcogact, tvlm, ttransformer, tvit)))
    expert = "EXPERT_TEST_ADARMS" if policy == "pi05" else "EXPERT_TEST"
    qk = policy == "dm0"
    out = []
    for mod, fl in ((jpresets, jflow), (tpresets, tflow)):
        llm = dataclasses.replace(mod.LLM_TEST, qk_norm=qk)
        exp = dataclasses.replace(getattr(mod, expert), qk_norm=qk)
        out.append(getattr(fl, f"{policy}_config")(llm, exp, mod.VIT_TEST, action_dim=8,
                                                   chunk_size=5, projector_type="linear"))
    return tuple(out)


def _jax_params(policy, jcfg):
    """Seeded JAX params (numpy) with the zero-initialised leaves redrawn: the
    DiT's final layer, the adaRMS dense layers."""
    rng = np.random.default_rng(0)
    if policy == "cogact":
        params = jax.device_get(jcogact.init_cogact(jax.random.PRNGKey(0), jcfg))
        for leaf in ("w", "b"):
            final = params["action_head"]["final"]
            final[leaf] = rng.normal(0, 0.02, final[leaf].shape).astype(np.float32)
        return params
    params = jax.device_get(jflow.init_flow_vla(jax.random.PRNGKey(0), jcfg))

    def redraw(t):
        if isinstance(t, dict):
            return {k: ({kk: rng.normal(0, 0.05, vv.shape).astype(np.float32)
                         for kk, vv in v.items()} if k == "dense" else redraw(v))
                    for k, v in t.items()}
        return np.asarray(t)

    return redraw(params)


def _port_model(policy, tcfg, prepare=None):
    build = tcogact.build_cogact if policy == "cogact" else tflow.build_flow_vla
    return build(tcfg, "cpu", seed=1, prepare=prepare)


@pytest.fixture(scope="module", params=POLICIES)
def bridged(request):
    policy = request.param
    jcfg, tcfg = _configs(policy)
    params = _jax_params(policy, jcfg)
    model = _port_model(policy, tcfg)
    load_jax_params(model, params)
    return policy, jcfg, tcfg, params, model


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _as_numpy(v):
    """A port leaf as fp32 numpy: a list of per-layer tensors stands for their stack."""
    if isinstance(v, list):
        v = torch.stack(v)
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_trees_equal(got, want):
    g = {p: _as_numpy(v) for p, v in _leaves(got)}
    w = {p: np.asarray(v) for p, v in _leaves(want)}
    assert set(g) == set(w), sorted(set(g) ^ set(w))
    for p in w:
        np.testing.assert_array_equal(g[p], w[p], err_msg="/".join(p))


def _bf16(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)),
                        tree)


def _export(model, tcfg, fmt, out_dir):
    sd = chip_smoke.reference_state_dict(model, tcfg)
    kind, _, dt = fmt.partition("_")
    dtype = torch.bfloat16 if dt == "bf16" else None
    # a small shard size: several files, and an index beside them
    chip_smoke.write_checkpoint(sd, str(out_dir), fmt=kind, dtype=dtype, shard_bytes=1 << 16)
    return dtype


def _jax_convert(policy, sd_np, jcfg):
    return (jconvert.convert_cogact if policy == "cogact" else jconvert.convert_flow_vla)(
        sd_np, jcfg)


@pytest.mark.parametrize("fmt", FORMATS)
def test_reference_files_convert_back_in_both_packages(bridged, fmt, tmp_path):
    """The JAX converter on the exported files gives the JAX tree back exactly
    (bf16 files: the tree rounded to bf16), and the port's converter the
    bridged model's parameters (rounded alike)."""
    policy, jcfg, tcfg, params, model = bridged
    dtype = _export(model, tcfg, fmt, tmp_path)
    files = sorted(os.listdir(tmp_path))
    assert len([f for f in files if f.endswith((".safetensors", ".bin"))]) > 1, files
    sd = tconvert.load_torch_state_dict(str(tmp_path))
    assert all(v.dtype == (dtype or torch.float32) for v in sd.values())
    want = _bf16(params) if dtype == torch.bfloat16 else params
    _assert_trees_equal(_jax_convert(policy, {k: v.float().numpy() for k, v in sd.items()},
                                     jcfg), want)
    _assert_trees_equal(tconvert.convert_cogact(sd, tcfg) if policy == "cogact"
                        else tconvert.convert_flow_vla(sd, tcfg), want)
    fresh = _port_model(policy, tcfg)
    load_jax_params(fresh, tconvert.convert_cogact(sd, tcfg) if policy == "cogact"
                    else tconvert.convert_flow_vla(sd, tcfg))
    ref = dict(model.named_parameters())
    for name, p in fresh.named_parameters():
        expect = ref[name].detach()
        if dtype is not None:
            expect = expect.to(dtype).float()
        assert torch.equal(p.detach(), expect), name


def _chunks(policy, jcfg, tcfg, jparams, model):
    rng = np.random.default_rng(1)
    if policy == "cogact":
        from dexbotic_tpu.constants import IMAGE_TOKEN_INDEX

        nt = jcfg.vlm.num_image_tokens
        ids = rng.integers(1, 500, (2, nt + 10)).astype(np.int32)
        ids[:, :nt] = IMAGE_TOKEN_INDEX
        valid = np.ones_like(ids)
        valid[-1, -3:] = 0
        imgs = rng.standard_normal((2, 1, 28, 28, 3)).astype(np.float32)
        noise = rng.standard_normal((2, jcfg.chunk_size, jcfg.action_dim)).astype(np.float32)
        ref = jcogact.cogact_inference_action(jparams, jcfg, jnp.asarray(ids), jnp.asarray(valid),
                                              jnp.asarray(imgs), jax.random.PRNGKey(0),
                                              noise=jnp.asarray(noise))
        got = tcogact.cogact_inference_action(
            model, tcfg, *map(torch.from_numpy, (ids, valid, imgs)), noise=torch.from_numpy(noise))
        return np.asarray(ref), got.numpy(), noise
    images = rng.standard_normal((2, 2, 28, 28, 3)).astype(np.float32)
    masks = np.ones((2, 2), np.int32)
    masks[1, 1:] = 0
    ids = rng.integers(1, jcfg.llm.vocab_size, (2, 7)).astype(np.int32)
    tmask = np.ones((2, 7), np.int32)
    tmask[0, -2:] = 0
    ids[tmask == 0] = 0
    states = rng.standard_normal((2, jcfg.action_dim)).astype(np.float32)
    noise = rng.standard_normal((2, jcfg.chunk_size, jcfg.action_dim)).astype(np.float32)
    ref = jflow.flow_vla_inference_action(
        jparams, jcfg, *map(jnp.asarray, (ids, tmask, images, masks, states)),
        jax.random.PRNGKey(0), noise=jnp.asarray(noise))
    got = tflow.flow_vla_inference_action(
        model, tcfg, *map(torch.from_numpy, (ids, tmask, images, masks, states)),
        noise=torch.from_numpy(noise))
    return np.asarray(ref), got.numpy(), noise


def test_converted_checkpoint_chunk_matches_jax(bridged, tmp_path):
    """A released-layout checkpoint (bf16 safetensors, the usual release
    dtype) served by the port's exp and by JAX from its own converter: the
    chunks agree at 1e-3 on the injected noise."""
    policy, jcfg, tcfg, params, model = bridged
    _export(model, tcfg, "safetensors_bf16", tmp_path)
    sd = tconvert.load_torch_state_dict(str(tmp_path))
    jparams = _jax_convert(policy, {k: v.float().numpy() for k, v in sd.items()}, jcfg)
    fresh = _port_model(policy, tcfg)
    load_jax_params(fresh, tconvert.convert_cogact(sd, tcfg) if policy == "cogact"
                    else tconvert.convert_flow_vla(sd, tcfg))
    ref, got, noise = _chunks(policy, jcfg, tcfg, jparams, fresh)
    assert np.abs(ref - noise).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def _tiny_exp(policy, path):
    if policy == "cogact":
        return CogActExp(model=CogActModelConfig(
            llm_preset="test", vit_preset="test", action_model_type="DiT-S", chunk_size=4,
            model_name_or_path=path), data=base_exp.DataConfig(image_processor="28"),
            device="cpu")
    return Pi0Exp(model=FlowModelConfig(llm_preset="test", expert_preset="test",
                                        vit_preset="test", action_dim=8, chunk_size=5,
                                        model_name_or_path=path),
                  data=base_exp.DataConfig(num_images=2, image_processor="28",
                                           image_pad_mode="zero", image_aspect_ratio=None),
                  device="cpu")


@pytest.mark.parametrize("policy", ["cogact", "pi0"])
def test_exp_serves_a_release_checkpoint_in_the_serving_dtypes(policy, tmp_path):
    """``model_name_or_path`` naming a released checkpoint: load_for_inference
    converts it into the serving build's own dtypes (JAX's serving rule casts
    leaves of >= 2 dims to bf16 and keeps 1-D ones as loaded: matrices and
    the vectors of a layer the JAX tree stacks, whose leaves are [L, D], in
    bf16, every other vector fp32), holding the file's values, and reads its
    norm_stats.json."""
    seeded = _tiny_exp(policy, None)
    cfg, want, _ = seeded.load_for_inference()
    for p in want.parameters():  # new values, so that a load that did nothing would show
        p.add_(0.5)
    chip_smoke.write_checkpoint(chip_smoke.reference_state_dict(want, cfg), str(tmp_path))
    norms = {"min": [-1.0] * 7, "max": [2.0] * 7}
    with open(tmp_path / "norm_stats.json", "w") as f:
        json.dump({"norm_stats": {"default": norms}}, f)
    assert tconvert.is_release_checkpoint(str(tmp_path))
    _, got, got_norms = _tiny_exp(policy, str(tmp_path)).load_for_inference()
    dtypes = {n: p.dtype for n, p in got.named_parameters()}
    assert dtypes == {n: p.dtype for n, p in want.named_parameters()}
    jax_ndim = {n: got.get_parameter(n).ndim + (jax_stack(got, n) is not None) for n in dtypes}
    assert {d for n, d in dtypes.items() if jax_ndim[n] >= 2} == {torch.bfloat16}
    assert {d for n, d in dtypes.items() if jax_ndim[n] < 2} == {torch.float32}
    assert any(got.get_parameter(n).ndim < 2 and jax_ndim[n] >= 2 for n in dtypes)
    for (n, p), (_, q) in zip(got.named_parameters(), want.named_parameters()):
        assert torch.equal(p, q), n
    assert got_norms == (norms if policy == "cogact" else {"default": norms})
    assert set(got.checkpoint_times) == {"load_s", "convert_s"}
    assert min(got.checkpoint_times.values()) >= 0.0


def test_converted_layer_stacks_are_views_of_the_checkpoint():
    """A converted ``layers`` leaf is the list of the state dict's per-layer
    tensors (transposed views), not a stacked copy; the bridge fills each
    layer's parameter from its own tensor."""
    jcfg, tcfg = _configs("cogact")
    model = _port_model("cogact", tcfg)
    load_jax_params(model, _jax_params("cogact", jcfg))
    sd = chip_smoke.reference_state_dict(model, tcfg)
    params = tconvert.convert_cogact(sd, tcfg)
    q = params["vlm"]["llm"]["layers"]["attn"]["q"]["w"]
    assert isinstance(q, list) and len(q) == tcfg.vlm.llm.num_layers
    for i, w in enumerate(q):
        assert w.data_ptr() == sd[f"model.llm.layers.{i}.self_attn.q_proj.weight"].data_ptr()
    blocks = params["action_head"]["blocks"]["mlp"]["fc0"]["w"]
    assert [w.data_ptr() for w in blocks] == [
        sd[f"model.action_head.net.blocks.{i}.mlp.fc1.weight"].data_ptr()
        for i in range(tcfg.dit.depth)]
    fresh = _port_model("cogact", tcfg)
    load_jax_params(fresh, params)
    for name, p in fresh.named_parameters():
        assert torch.equal(p, model.get_parameter(name)), name


def test_port_checkpoint_dir_is_not_a_release(tmp_path):
    (tmp_path / "params.pt").write_bytes(b"")
    (tmp_path / "opt_state.pt").write_bytes(b"")
    assert not tconvert.is_release_checkpoint(str(tmp_path))
    assert tconvert.is_release_checkpoint(str(tmp_path / "model.safetensors"))


# ---------------------------------------------------------------------------
# The safetensors parser
# ---------------------------------------------------------------------------

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8, torch.int64]


def _tensors():
    g = torch.Generator().manual_seed(0)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = (3, 5) if i % 2 else (7,)  # odd byte counts: int8 of 7 is followed by others
        if dt.is_floating_point:
            out[f"t{i}"] = torch.randn(shape, generator=g).to(dt)
        else:
            out[f"t{i}"] = torch.randint(-100, 100, shape, generator=g).to(dt)
    out["scalar"] = torch.tensor(3.5)
    out["empty"] = torch.zeros((0, 4))
    return out


def _assert_bitwise(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k].reshape(-1).view(torch.uint8) if v.numel() else got[k],
                           v.reshape(-1).view(torch.uint8) if v.numel() else v), k


def test_parser_reads_safetensors_files_bit_for_bit(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    want = _tensors()
    st.save_file(want, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    _assert_bitwise(tconvert.read_safetensors(str(tmp_path / "a.safetensors")), want)
    # one tensor per file, int8 first: every later tensor starts off its element boundary
    want_odd = {"a_int8": torch.arange(7, dtype=torch.int8), "b_f32": torch.randn(5),
                "c_bf16": torch.randn(3).bfloat16(), "d_i64": torch.arange(3)}
    chip_smoke.write_safetensors(str(tmp_path / "odd.safetensors"), want_odd)
    _assert_bitwise(tconvert.read_safetensors(str(tmp_path / "odd.safetensors")), want_odd)
    _assert_bitwise(st.load_file(str(tmp_path / "odd.safetensors")), want_odd)


def test_writer_output_reads_back_with_the_safetensors_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    want = _tensors()
    chip_smoke.write_safetensors(str(tmp_path / "w.safetensors"), want)
    _assert_bitwise(st.load_file(str(tmp_path / "w.safetensors")), want)
    _assert_bitwise(tconvert.load_torch_state_dict(str(tmp_path / "w.safetensors")), want)


def test_loader_reads_a_directory_of_mixed_shards(tmp_path):
    """.safetensors, .bin and .pt shards of one checkpoint, each in its dtype."""
    want = _tensors()
    keys = sorted(want)
    chip_smoke.write_safetensors(str(tmp_path / "model-1.safetensors"),
                                 {k: want[k] for k in keys[:3]})
    torch.save({k: want[k] for k in keys[3:5]}, tmp_path / "pytorch_model-2.bin")
    torch.save({k: want[k] for k in keys[5:]}, tmp_path / "extra.pt")
    (tmp_path / "config.json").write_text("{}")
    _assert_bitwise(tconvert.load_torch_state_dict(str(tmp_path)), want)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tconvert.load_torch_state_dict(str(tmp_path / "empty"))


@pytest.mark.parametrize("policy", ["cogact", "pi0"])
def test_replay_script_runs_a_release_checkpoint(policy, tmp_path):
    """script/replay_checkpoint_torch.py's functions on a tiny release: the
    exp comes from the LIBERO recipe twin with the config.json dims, the
    converted model holds the file's weights in the serving dtypes, and the
    replayed chunk is the source model's on the same frame and noise."""
    from script import replay_checkpoint_torch as replay

    seeded = _tiny_exp(policy, None)
    cfg, source, _ = seeded.load_for_inference()
    dims = {"action_dim": cfg.action_dim, "chunk_size": cfg.chunk_size}
    chip_smoke.write_checkpoint(chip_smoke.reference_state_dict(source, cfg), str(tmp_path),
                                config=dims)
    exp = replay.build_exp(policy, str(tmp_path), device="cpu")
    assert (exp.model.action_dim, exp.model.chunk_size) == (cfg.action_dim, cfg.chunk_size)
    assert exp.model.model_name_or_path == str(tmp_path)
    # the recipe's 7B-class presets, cut to the tiny ones the file holds
    exp.model = dataclasses.replace(exp.model, **{
        k: getattr(seeded.model, k) for k in ("llm_preset", "vit_preset", "expert_preset",
                                              "action_model_type") if hasattr(exp.model, k)})
    exp.data = seeded.data
    got_cfg, model, norms, times = replay.load_converted(exp)
    assert norms is None and set(times) == {"load_s", "convert_s"}
    for (n, p), (_, q) in zip(model.named_parameters(), source.named_parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), n
    frame = replay.load_image(None)
    run = replay.replay_cogact if policy == "cogact" else replay.replay_flow
    chunk, den = run(exp, got_cfg, model, None, frame, "stack the bowls")
    want, _ = run(exp, got_cfg, source, None, frame, "stack the bowls")
    assert chunk.shape == (cfg.chunk_size, cfg.action_dim) and den is None
    np.testing.assert_array_equal(chunk, want)


@pytest.mark.parametrize("recipe,cls", [("cogact", "LiberoCogActExp"), ("pi0", "LiberoPi0Exp"),
                                        ("pi05", "LiberoPi05Exp"), ("dm0", "LiberoDM0Exp")])
def test_libero_recipes_match_jax(recipe, cls):
    """The port's LIBERO twins hold the JAX recipes' values in every field
    the two exps share (the pi0.5 and DM0 recipes' fresh action configs
    included: mean/std statistics, no image masks, as in JAX)."""
    import importlib

    j = getattr(importlib.import_module(f"playground.benchmarks.libero.libero_{recipe}"), cls)()
    t = getattr(importlib.import_module(
        f"dexbotic_tpu_torch.playground.benchmarks.libero.libero_{recipe}"), cls)()
    assert t.exp_name == j.exp_name
    for part in ("model", "data", "action", "tokenizer", "optimizer", "trainer"):
        jd, td = dataclasses.asdict(getattr(j, part)), dataclasses.asdict(getattr(t, part))
        common = sorted(set(jd) & set(td))
        assert len(common) >= len(jd) // 2, (part, sorted(set(jd) - set(td)))
        assert {k: td[k] for k in common} == {k: jd[k] for k in common}, part


def test_parser_reads_bf16_without_the_safetensors_package(monkeypatch, tmp_path):
    """The card machine has no ``safetensors``: with its import blocked, a bf16
    release (the usual dtype) reads back in bf16, bit for bit, and converts."""
    import sys

    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401
    jcfg, tcfg = _configs("cogact")
    model = _port_model("cogact", tcfg)
    load_jax_params(model, _jax_params("cogact", jcfg))
    want = {k: v.bfloat16() for k, v in chip_smoke.reference_state_dict(model, tcfg).items()}
    chip_smoke.write_checkpoint(want, str(tmp_path))
    got = tconvert.load_torch_state_dict(str(tmp_path))
    _assert_bitwise(got, want)
    fresh = _port_model("cogact", tcfg)
    load_jax_params(fresh, tconvert.convert_cogact(got, tcfg))
    for name, p in fresh.named_parameters():
        assert torch.equal(p, model.get_parameter(name).bfloat16().float()), name
