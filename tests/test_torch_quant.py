"""Weight-only int8 serving in the port (ops/quant.py, ops/quant_matmul.py, the
int8 layers of nn/core.py, K2's int8 operands) against the JAX package.

Sizes follow tests/test_quant.py: a 2-layer LLM of width 32, a ViT of width
24, DiT-S, chunk 4.  Inputs and noise come from numpy seeds and are handed to
both sides.  Quantization is compared bit for bit; products in fp32 at 2e-5
(the JAX kernel test's tolerance), W8A8 at 1e-5, the sampler at 2e-4 (as PR 1's
sampler tests) and the slice at 1e-3 (ROADMAP's pin).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dexbotic_tpu.constants import IMAGE_TOKEN_INDEX
from dexbotic_tpu.exp import base_exp as jbase
from dexbotic_tpu.exp import cogact_exp as jexp
from dexbotic_tpu.models import cogact as jcogact
from dexbotic_tpu.models import dit as jdit
from dexbotic_tpu.models import vlm as jvlm
from dexbotic_tpu.nn import core as jcore
from dexbotic_tpu.nn import transformer as jtransformer
from dexbotic_tpu.nn import vit as jvit
from dexbotic_tpu.ops import quant as jquant
from dexbotic_tpu.ops import quant_matmul as jqm
from dexbotic_tpu.ops.diffusion import DiffusionSchedule as JSchedule
from dexbotic_tpu.ops.dit_fused import fused_dit_sample as jax_fused_dit_sample
from dexbotic_tpu_torch.exp import base_exp as tbase
from dexbotic_tpu_torch.exp import cogact_exp as texp
from dexbotic_tpu_torch.models import cogact as tcogact
from dexbotic_tpu_torch.models import dit as tdit
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.nn import core as tcore
from dexbotic_tpu_torch.nn import transformer as ttransformer
from dexbotic_tpu_torch.nn import vit as tvit
from dexbotic_tpu_torch.ops import quant as tquant
from dexbotic_tpu_torch.ops import quant_matmul as tqm
from dexbotic_tpu_torch.ops.diffusion import DiffusionSchedule
from dexbotic_tpu_torch.ops.dit_fused import fused_dit_sample, prepare
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

torch.set_num_threads(2)

LLM = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=8, intermediate_size=64, attn_impl="xla")
VIT = dict(image_size=28, patch_size=14, hidden_size=24, num_layers=2, num_heads=4,
           intermediate_size=48, select_layer=None)
# one LLM layer's q weight is 32 x 32 = 1024 elements, its 2-layer stack 2048:
# JAX judges the stacked leaf, so this threshold quantizes it
BETWEEN = 1500


def _cfgs(**kw):
    j = jcogact.CogActConfig(vlm=jvlm.VLMConfig(llm=jtransformer.TransformerConfig(**LLM),
                                                vit=jvit.ViTConfig(**VIT)),
                             action_model_type="DiT-S", action_dim=7, chunk_size=4, **kw)
    t = tcogact.CogActConfig(vlm=tvlm.VLMConfig(llm=ttransformer.TransformerConfig(**LLM),
                                                vit=tvit.ViTConfig(**VIT)),
                             action_model_type="DiT-S", action_dim=7, chunk_size=4, **kw)
    return j, t


@pytest.fixture(scope="module")
def jparams():
    """A JAX CogACT tree (numpy), the DiT's zero final layer redrawn."""
    jcfg, _ = _cfgs()
    params = jax.device_get(jcogact.init_cogact(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    for leaf in ("w", "b"):
        final = params["action_head"]["final"]
        final[leaf] = rng.normal(0, 0.02, final[leaf].shape).astype(np.float32)
    return params


def _port_model(params, min_size=None):
    """The port's CogACT filled from a JAX tree; quantized structure first when
    ``min_size`` is given (the tree then being a quantized one)."""
    _, tcfg = _cfgs()
    model = tcogact.build_cogact(tcfg, "cpu")
    if min_size is not None:
        tquant.quantize_model_(model, min_size=min_size)
    load_jax_params(model, params)
    return model


def _leaves(tree):
    return {name: val for name, val, _ in port_arrays(tree)}


@pytest.mark.parametrize("min_size,dtype", [(0, "float32"), (0, "bfloat16"),
                                            (BETWEEN, "float32"),
                                            (tquant.DEFAULT_MIN_SIZE, "float32")])
def test_quantization_bit_exact_vs_jax(jparams, min_size, dtype):
    """The same leaves quantize, to the same int8 values and the same scales,
    when the port quantizes module by module and JAX quantizes the tree."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jdt))
                          if a.ndim >= 2 else a, jparams)
    want = _leaves(jax.device_get(jquant.quantize_params(params, min_size=min_size,
                                                         pad_cols=False)))
    model = _port_model(jparams)
    if dtype == "bfloat16":  # the serving cast, JAX's rule on JAX's tree, as above
        tcore.cast_like_jax_(model, torch.bfloat16)
    # a stacked norm scale is an [L, D] leaf of the JAX tree: cast with the matrices
    assert model.vlm.llm.layers[0].ln1.weight.dtype == getattr(torch, dtype)
    tquant.quantize_model_(model, min_size=min_size)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    quantized = [n for n in got if n.endswith((".q", ".s"))]
    assert quantized if min_size < tquant.DEFAULT_MIN_SIZE else True
    if min_size == BETWEEN:  # judged by the stacked leaf, not one layer
        assert "vlm.llm.layers.0.attn.q.q" in got and "vlm.projector.fc0.weight" in got
    if min_size == tquant.DEFAULT_MIN_SIZE:  # DiT-S blocks quantize, the tiny VLM does not
        assert "action_head.blocks.0.attn.qkv.q" in got and "vlm.llm.embed.weight" in got
    for name, t in got.items():
        w = np.asarray(want[name])
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), name
        if t.dtype == torch.bfloat16:
            w = np.asarray(jnp.asarray(w).astype(jnp.float32))
            t = t.float()
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
    if dtype == "float32":
        jtree = jax.device_get(jquant.quantize_params(params, min_size=min_size, pad_cols=False))
        assert tquant.quantized_bytes(model) == jquant.quantized_bytes(jtree)


def _quant_linear_module(jp):
    """A module with one QuantLinear ``lin`` filled from a JAX {"w": {"q","s"}, "b"}."""
    N = np.asarray(jp["w"]["s"]).shape[-1]
    K = np.asarray(jp["w"]["q"]).shape[0]
    m = nn.Module()
    m.lin = tcore.QuantLinear(torch.zeros(N, K, dtype=torch.int8), torch.zeros(N),
                              nn.Parameter(torch.zeros(N), requires_grad=False))
    load_jax_params(m, {"lin": jp})
    return m


@pytest.mark.parametrize("padded", [True, False])
def test_quant_linear_matches_jax(padded):
    rng = np.random.default_rng(1)
    M, K, N = 35, 256, 200  # M unaligned; N pads to 256 for the TPU kernel
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jp = jax.device_get({"w": jquant.quantize_weight(jnp.asarray(w), pad_cols=padded), "b": b})
    assert np.asarray(jp["w"]["q"]).shape == (K, 256 if padded else N)
    refs = [np.asarray(jqm.quant_linear(jp, jnp.asarray(x)))]  # the XLA dequant formulation
    if padded:  # the Pallas kernel needs a 128-multiple out-dim
        refs.append(np.asarray(jqm.quant_linear(jp, jnp.asarray(x), interpret=True)))
    m = _quant_linear_module(jp)
    assert m.lin.q.shape == (N, K) and m.lin.s.shape == (N,)
    xt = torch.from_numpy(x)
    n0 = tqm.quant_matmul.launches
    with torch.no_grad():
        got = m.lin(xt).numpy()
        plain = (tqm.quant_matmul_ref(xt, m.lin.q, m.lin.s) + m.lin.bias).numpy()
        wrapped = (tqm.quant_matmul(xt, m.lin.q, m.lin.s) + m.lin.bias).numpy()
    assert tqm.quant_matmul.launches == n0  # a CPU tensor takes the plain version
    np.testing.assert_array_equal(wrapped, plain)
    for ref in refs:
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
        np.testing.assert_allclose(plain, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("M,K,N,eligible,splits", [
    (1, 4096, 768, True, 16), (64, 11008, 4096, True, None),
    (65, 4096, 768, True, None),  # past JAX's TPU guard (its _MAX_M = 64)
    (tqm._MAX_M, 4096, 4096, True, None),  # the card's row limit ...
    (tqm._MAX_M + 1, 4096, 4096, False, None),  # ... and one row past it
    (16, 588, 1024, False, None),  # the ViT patch embedding's K
    (10, 256, 200, True, 1),  # ragged N is masked by the kernel
    (2, 4096, 768, True, 16),  # z_embed at N=768: 16 splits of 4 k steps fill the card
    (64, 4096, 11008, True, 2), (10, 256, 768, True, 1), (10, 3072, 768, True, None),
    (5, 64, 200, True, 1)])
def test_quant_matmul_eligibility_and_splits(M, K, N, eligible, splits):
    """The dispatch rule is one of shape: 1.._MAX_M rows and K a multiple of
    64; the plan's K splits stay within 4 k steps a split."""
    assert tqm.quant_matmul_eligible(M, K, N) == eligible
    if eligible:
        p = tqm.plan(M, K, N)
        assert 1 <= p.splits <= max(1, K // 64 // 4)
        if splits is not None:
            assert p.splits == splits


def test_w8a8_matches_jax_and_dispatches_at_the_row_threshold():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 96)) * 0.05).astype(np.float32)
    jp = jax.device_get({"w": jquant.quantize_weight(jnp.asarray(w))})
    m = nn.Module()
    m.lin = tcore.QuantLinear(torch.zeros(96, 128, dtype=torch.int8), torch.zeros(96), None)
    load_jax_params(m, {"lin": jp})
    xt = torch.from_numpy(x)
    want = np.asarray(jqm.w8a8_matmul(jnp.asarray(x), jp["w"]["q"], jp["w"]["s"]))
    got = tqm.w8a8_matmul(xt, m.lin.q, m.lin.s).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    old = (jqm.W8A8_MIN_ROWS, tqm.W8A8_MIN_ROWS)
    try:
        for rows in (64, 65):  # at the threshold: W8A8; one row short: the dequant path
            jqm.W8A8_MIN_ROWS = tqm.W8A8_MIN_ROWS = rows
            want = np.asarray(jqm.quant_linear(jp, jnp.asarray(x)))
            with torch.no_grad():
                got = m.lin(xt).numpy()
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
            ref = tqm.w8a8_matmul(xt, m.lin.q, m.lin.s) if rows == 64 else \
                tqm.quant_matmul_ref(xt, m.lin.q, m.lin.s)
            np.testing.assert_array_equal(got, ref.numpy())
    finally:
        jqm.W8A8_MIN_ROWS, tqm.W8A8_MIN_ROWS = old


def test_int8_embed_and_tied_lm_logits_match_jax():
    flags = dict(LLM, tie_embeddings=True)
    jcfg, tcfg = jtransformer.TransformerConfig(**flags), ttransformer.TransformerConfig(**flags)
    params = jax.device_get(jtransformer.init_transformer(jax.random.PRNGKey(3), jcfg))
    qp = jax.device_get(jquant.quantize_params(params, min_size=0, pad_cols=False))
    llm = ttransformer.Transformer(tcfg)
    tquant.quantize_model_(llm, min_size=0)
    load_jax_params(llm, qp)
    assert isinstance(llm.embed, tcore.QuantEmbedding) and not hasattr(llm, "lm_head")
    assert llm.embed.s.shape == (128, 1)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, (2, 9)).astype(np.int32)
    hidden = rng.standard_normal((2, 9, 32)).astype(np.float32)
    emb = jtransformer.embed_tokens(qp, jcfg, jnp.asarray(ids))
    with torch.no_grad():
        temb = ttransformer.embed_tokens(llm, tcfg, torch.from_numpy(ids))
        logits = ttransformer.lm_logits(llm, tcfg, torch.from_numpy(hidden))
    np.testing.assert_allclose(temb.numpy(), np.asarray(emb), atol=1e-6, rtol=0)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jtransformer.lm_logits(qp, jcfg, jnp.asarray(hidden))),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(jcore.embed(qp["embed"], jnp.asarray(ids))),
                               tcore.embed(llm.embed, torch.from_numpy(ids)).numpy(), atol=1e-6)


DIT = dict(hidden_size=64, depth=2, num_heads=4, in_channels=7, token_size=96, chunk_size=16)
# stacked block weights: qkv 24576, o 8192, fc0 and fc1 32768 elements, so at
# MIXED every block layer but o is quantized (and x_embed, final are not)
MIXED = 10000


@functools.lru_cache(maxsize=None)
def qheads(min_size):
    """A JAX DiT quantized at ``min_size`` (0: x_embed and final too) and its port."""
    jcfg, tcfg = jdit.DiTConfig(**DIT), tdit.DiTConfig(**DIT)
    jhead = jax.device_get(jdit.init_dit(jax.random.PRNGKey(0), jcfg, jnp.float32))
    rng = np.random.default_rng(0)
    for leaf in ("w", "b"):
        jhead["final"][leaf] = rng.normal(0, 0.02, jhead["final"][leaf].shape).astype(np.float32)
    qhead = jax.device_get(jquant.quantize_params(jhead, min_size=min_size, pad_cols=False))
    thead = tdit.DiT(tcfg)
    tquant.quantize_model_(thead, min_size=min_size)
    load_jax_params(thead, qhead)
    return jcfg, tcfg, qhead, thead


@pytest.mark.parametrize("sampler,steps,cfg_scale,B,min_size", [
    ("ddim", 10, 1.5, 1, 0), ("dpm", 5, 1.5, 1, 0), ("ddim", 10, 1.0, 2, 0), ("dpm", 5, 1.0, 1, 0),
    ("ddim", 10, 1.5, 1, MIXED)])
def test_quantized_sampler_matches_jax_fused(sampler, steps, cfg_scale, B, min_size):
    jcfg, tcfg, qhead, thead = qheads(min_size)
    rng = np.random.default_rng(B)
    z = rng.standard_normal((B, 1, DIT["token_size"])).astype(np.float32)
    noise = rng.standard_normal((B, DIT["chunk_size"], DIT["in_channels"])).astype(np.float32)
    ref = np.asarray(jax_fused_dit_sample(
        qhead, jcfg, jnp.asarray(z), jnp.asarray(noise), JSchedule.create(100), steps=steps,
        cfg_scale=cfg_scale, sampler=sampler, interpret=True))
    got = fused_dit_sample(thead, tcfg, torch.from_numpy(z), torch.from_numpy(noise),
                           DiffusionSchedule.create(100), steps=steps, cfg_scale=cfg_scale,
                           sampler=sampler)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("min_size", [0, MIXED])
def test_int8_kernel_operands_dequantize_to_the_dense_stacks(min_size):
    """K2's int8 operands ([depth, out, in] int8 + [depth, out] scales) are the
    dense [depth, out, in] stacks of a head holding q * s, which the dense
    operands' emulation test (test_torch_dit_sampler.py) pins to JAX.  With
    some block layers left dense (MIXED), K2 gets dense stacks, the quantized
    layers dequantized once."""
    _, tcfg, _, thead = qheads(min_size)
    z = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 1, 96)).astype(np.float32))
    p = prepare(thead, tcfg, z, DiffusionSchedule.create(100), 10, 1.5, "ddim")
    for name, lin in (("qkv", "attn.qkv"), ("o", "attn.o"), ("fc0", "mlp.fc0"), ("fc1", "mlp.fc1")):
        for j, blk in enumerate(thead.blocks):
            mod = blk.get_submodule(lin)
            if min_size == MIXED:
                assert isinstance(mod, tcore.QuantLinear) == (name != "o")
                want = mod.weight if name == "o" else tquant.dequantize_weight(mod.q, mod.s)
                torch.testing.assert_close(p["w" + name][j], want, rtol=0, atol=0)
                continue
            assert p["w" + name].dtype == torch.int8 and p["s" + name].dtype == torch.float32
            torch.testing.assert_close(p["w" + name][j], mod.q, rtol=0, atol=0)
            dense = p["w" + name][j].float() * p["s" + name][j][:, None]
            torch.testing.assert_close(dense, tquant.dequantize_weight(mod.q, mod.s))
    if min_size == 0:  # x_embed and final, quantized, are dequantized once by the wrapper
        torch.testing.assert_close(
            p["xw"], tquant.dequantize_weight(thead.x_embed.q, thead.x_embed.s).t())


@pytest.mark.parametrize("sampler,steps,cfg_scale,padded", [("ddim", 10, 1.5, False),
                                                            ("dpm", 5, 1.0, True)])
def test_int8_slice_matches_jax(jparams, sampler, steps, cfg_scale, padded):
    """cogact_inference_action on an int8 tree (min_size 0: every matrix but
    the positional embeddings), port against JAX in fp32."""
    jcfg, tcfg = _cfgs(sampler=sampler, ddim_steps=steps, cfg_scale=cfg_scale)
    qp = jax.device_get(jquant.quantize_params(jparams, min_size=0, pad_cols=padded))
    model = _port_model(qp, min_size=0)
    assert isinstance(model.vlm.llm.embed, tcore.QuantEmbedding)
    assert isinstance(model.action_head.blocks[0].mlp.fc1, tcore.QuantLinear)
    rng = np.random.default_rng(1)
    nt = tcfg.vlm.num_image_tokens
    ids = rng.integers(1, 100, (2, nt + 6)).astype(np.int32)
    ids[:, :nt] = IMAGE_TOKEN_INDEX
    valid = np.ones_like(ids)
    valid[-1, -2:] = 0
    imgs = rng.standard_normal((2, 1, 28, 28, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 4, 7)).astype(np.float32)
    ref = np.asarray(jcogact.cogact_inference_action(
        qp, jcfg, jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(imgs), jax.random.PRNGKey(0),
        noise=jnp.asarray(noise)))
    got = tcogact.cogact_inference_action(
        model, tcfg, torch.from_numpy(ids), torch.from_numpy(valid), torch.from_numpy(imgs),
        noise=torch.from_numpy(noise)).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_exp_inference_quantize_on_both_packages(mode):
    """CogActExp(inference_quantize=...) loads, quantizes and serves a frame
    through inference_single in the JAX package and in the port."""
    old = (jqm.W8A8_MIN_ROWS, tqm.W8A8_MIN_ROWS)
    try:
        outs = {}
        for side, base, mod in (("jax", jbase, jexp), ("port", tbase, texp)):
            kw = dict(device="cpu") if side == "port" else {}
            exp = mod.CogActExp(
                model=mod.CogActModelConfig(llm_preset="test", vit_preset="test",
                                            action_model_type="DiT-S", chunk_size=4),
                tokenizer=base.TokenizerConfig(model_max_length=96),
                data=base.DataConfig(image_processor="28"),
                inference_quantize=mode, inference_quantize_min_size=0, **kw)
            outs[side] = np.asarray(exp.inference_single(prompt="stack the bowls"))
            assert (jqm if side == "jax" else tqm).W8A8_MIN_ROWS == (2048 if mode == "w8a8"
                                                                     else old[side == "port"])
        for out in outs.values():
            assert out.shape == (4, 7) and np.isfinite(out).all()
        _, model, _ = exp.load_for_inference()
        _, bf16, _ = dataclasses.replace(exp, inference_quantize="").load_for_inference()
        assert any(p.dtype == torch.int8 for p in model.parameters())
        assert tquant.quantized_bytes(model) < 0.6 * tquant.quantized_bytes(bf16)
    finally:
        jqm.W8A8_MIN_ROWS, tqm.W8A8_MIN_ROWS = old


W8A8_TEST_ROWS = 16  # tiny prefixes (>= 16 rows) take W8A8, the 5-6 suffix rows do not


@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("mode", ["int8", "w8a8"])
@pytest.mark.parametrize("variant", ["pi0", "pi05", "dm0"])
def test_flow_exp_inference_quantize_matches_jax(variant, mode, padded, monkeypatch):
    """Pi0Exp / Pi05Exp / DM0Exp(inference_quantize=...) against the JAX exps'
    inference_single on one seeded JAX tree: JAX's serving dtype rule and
    quantization (out-dims padded to 128 for the TPU kernel, or not), the int8 tree
    copied into the port's quantized model, the same frame, state and
    injected noise; W8A8 from 16 rows in both packages, so that the prefix
    takes int8 activations and the suffix does not (mode "w8a8")."""
    from dexbotic_tpu.exp import pi0_exp as jpi0
    from dexbotic_tpu.models import flow_vla as jflow
    from dexbotic_tpu.ops import quant as jquant_mod
    from dexbotic_tpu_torch.exp import pi0_exp as tpi0
    from dexbotic_tpu_torch.models import flow_vla as tflow

    monkeypatch.setattr(jquant_mod, "quantize_params",
                        functools.partial(jquant_mod.quantize_params, pad_cols=padded))
    from dexbotic_tpu.models import presets as jpresets
    from dexbotic_tpu_torch.models import presets as tpresets

    name = {"pi0": "Pi0Exp", "pi05": "Pi05Exp", "dm0": "DM0Exp"}[variant]
    exps = {}
    for side, mod, base, presets in (("jax", jpi0, jbase, jpresets),
                                     ("port", tpi0, tbase, tpresets)):
        # an FFN width of 160: padded to 256 columns for the TPU kernel (a width < 128 is not)
        monkeypatch.setitem(presets.LLM_PRESETS, "test_ffn160",
                            dataclasses.replace(presets.LLM_TEST, intermediate_size=160))
        cls = getattr(mod, name)
        model = dataclasses.replace(cls().model, llm_preset="test_ffn160", vit_preset="test",
                                    expert_preset="test_adarms" if variant == "pi05" else "test",
                                    action_dim=8, chunk_size=5)
        kw = dict(device="cpu") if side == "port" else {}
        exps[side] = cls(model=model, data=base.DataConfig(
            num_images=2, image_processor="28", image_pad_mode="zero", image_aspect_ratio=None),
            inference_quantize=mode, inference_quantize_min_size=0, **kw)
    old = (jqm.W8A8_MIN_ROWS, tqm.W8A8_MIN_ROWS)
    try:
        jcfg, jq, _ = exps["jax"].load_for_inference()
        tcfg, model, _ = exps["port"].load_for_inference()
        load_jax_params(model, jax.device_get(jq))
        assert isinstance(model.expert.layers[0].mlp.gate, tcore.QuantLinear)
        gate = jq["vlm"]["llm"]["layers"]["mlp"]["gate"]["w"]
        assert gate["q"].shape[-1] == (256 if padded else 160) and gate["s"].shape[-1] == 160
        if mode == "w8a8":
            assert jqm.W8A8_MIN_ROWS == tqm.W8A8_MIN_ROWS == 2048
            jqm.W8A8_MIN_ROWS = tqm.W8A8_MIN_ROWS = W8A8_TEST_ROWS
        noise = np.random.default_rng(4).standard_normal((1, 5, 8)).astype(np.float32)
        monkeypatch.setattr(exps["jax"], "load_for_inference", lambda: (jcfg, jq, None),
                            raising=False)
        monkeypatch.setattr(exps["jax"], "make_infer_fn", lambda cfg, params: (
            lambda *a: jflow.flow_vla_inference_action(params, cfg, *a[:5], a[5],
                                                       noise=jnp.asarray(noise))), raising=False)
        monkeypatch.setattr(exps["port"], "load_for_inference", lambda: (tcfg, model, None),
                            raising=False)
        monkeypatch.setattr(exps["port"], "make_infer_fn", lambda cfg, m: (
            lambda *a: tflow.flow_vla_inference_action(m, cfg, *a[:5],
                                                       noise=torch.from_numpy(noise))),
            raising=False)
        frame = np.random.default_rng(5).integers(0, 256, (28, 28, 3), dtype=np.uint8)
        state = np.random.default_rng(6).standard_normal(8)
        outs = {side: np.asarray(e.inference_single(images=[frame], prompt="stack the bowls",
                                                    states=state))
                for side, e in exps.items()}
    finally:
        jqm.W8A8_MIN_ROWS, tqm.W8A8_MIN_ROWS = old
    assert outs["port"].shape == (5, 8) and np.abs(outs["jax"] - noise[0]).max() > 0.05
    np.testing.assert_allclose(outs["port"], outs["jax"], atol=1e-3, rtol=0)
