"""Port DiT sampler (dexbotic_tpu_torch/ops/dit_fused.py) vs the JAX Pallas sampler.

The JAX fused sampler runs in interpret mode; the port's wrapper takes its
plain version on CPU tensors.  The DiT's final layer is redrawn from a
seeded normal(0, 0.02): at init it is zero, eps is 0 and the chunk would
depend on the noise alone.  A torch emulation of the kernel's algorithm on
the wrapper's prepared operands (coefficient table, condition tokens,
[depth, out, in] weight stacks) pins the layouts the CUDA kernel reads.
K2's shape rule (``k2_serves``) and its item planner (``plan``) are checked
at DiT-B's widths: the rule admits CogACT's 8-frame micro-batch (16 rows
with CFG), and every plan covers each product's N x K once, in k order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dexbotic_tpu.models import dit as jdit
from dexbotic_tpu.ops.diffusion import DiffusionSchedule as JSchedule
from dexbotic_tpu.ops.dit_fused import fused_dit_sample as jax_fused_dit_sample
from dexbotic_tpu_torch.models import dit as tdit
from dexbotic_tpu_torch.ops.diffusion import DiffusionSchedule
from dexbotic_tpu_torch.constants import IMAGE_TOKEN_INDEX
from dexbotic_tpu_torch.models import cogact as tcogact
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.nn import transformer as ttransformer
from dexbotic_tpu_torch.nn import vit as tvit
from dexbotic_tpu_torch.ops import dit_fused
from dexbotic_tpu_torch.ops.dit_fused import fused_dit_sample, k2_serves, plan, prepare, products
from dexbotic_tpu_torch.ops.norms import layer_norm
from dexbotic_tpu_torch.utils.bridge import load_jax_params

torch.set_num_threads(2)
ATOL = 2e-4  # as tests/test_dit_fused.py
GEOM = dict(hidden_size=64, depth=2, num_heads=4, in_channels=7, token_size=96, chunk_size=16)
JCFG, TCFG = jdit.DiTConfig(**GEOM), tdit.DiTConfig(**GEOM)
CASES = [("ddim", 10, 1.5, 1), ("dpm", 5, 1.5, 1), ("ddim", 10, 1.0, 1),
         ("ddim", 10, 1.5, 2), ("dpm", 5, 1.0, 2),
         ("ddim", 10, 1.5, 8)]  # 16 rows: CogACT's 8-frame micro-batch with CFG


@pytest.fixture(scope="module")
def heads():
    jhead = jax.device_get(jdit.init_dit(jax.random.PRNGKey(0), JCFG, jnp.float32))
    rng = np.random.default_rng(0)
    for leaf in ("w", "b"):
        jhead["final"][leaf] = rng.normal(0, 0.02, jhead["final"][leaf].shape).astype(np.float32)
    thead = tdit.DiT(TCFG)
    load_jax_params(thead, jhead)
    return jhead, thead


def _inputs(B):
    rng = np.random.default_rng(B)
    z = rng.standard_normal((B, 1, GEOM["token_size"])).astype(np.float32)
    noise = rng.standard_normal((B, GEOM["chunk_size"], GEOM["in_channels"])).astype(np.float32)
    return z, noise


def _jax(jhead, z, noise, sampler, steps, cfg_scale):
    return np.asarray(jax_fused_dit_sample(
        jhead, JCFG, jnp.asarray(z), jnp.asarray(noise), JSchedule.create(100), steps=steps,
        cfg_scale=cfg_scale, sampler=sampler, interpret=True))


@pytest.mark.parametrize("sampler,steps,cfg_scale,B", CASES)
def test_plain_sampler_matches_jax_fused(heads, sampler, steps, cfg_scale, B):
    jhead, thead = heads
    z, noise = _inputs(B)
    ref = _jax(jhead, z, noise, sampler, steps, cfg_scale)
    got = fused_dit_sample(thead, TCFG, torch.from_numpy(z), torch.from_numpy(noise),
                           DiffusionSchedule.create(100), steps=steps, cfg_scale=cfg_scale,
                           sampler=sampler)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def _emulate_kernel(p, cfg, noise, cfg_scale, sampler):
    """What csrc/dit_sampler.cu computes, in fp32 torch, from prepare()'s operands."""
    B, T, A = noise.shape
    pair = cfg_scale > 1.0
    H, heads = cfg.hidden_size, cfg.num_heads
    dh = H // heads
    x, xp = noise.clone(), torch.zeros_like(noise)
    for i in range(p["coef"].shape[0]):
        xe = x @ p["xw"] + p["xb"]
        if pair:
            xe = torch.cat([xe, xe])
        h = torch.cat([p["cond"][i][:, None, :], xe], dim=1) + p["pos"][None]
        rows, S = h.shape[:2]
        for j in range(cfg.depth):
            qkv = layer_norm(h) @ p["wqkv"][j].t() + p["bqkv"][j]
            q, k, v = (qkv[..., n * H:(n + 1) * H].reshape(rows, S, heads, dh).transpose(1, 2)
                       for n in range(3))
            a = torch.softmax(q * dh ** -0.5 @ k.transpose(-1, -2), dim=-1) @ v
            h = h + a.transpose(1, 2).reshape(rows, S, H) @ p["wo"][j].t() + p["bo"][j]
            m = F.gelu(layer_norm(h) @ p["wfc0"][j].t() + p["bfc0"][j], approximate="tanh")
            h = h + m @ p["wfc1"][j].t() + p["bfc1"][j]
        eps = layer_norm(h)[:, 1:] @ p["fw"] + p["fb"]
        if pair:
            eps = eps[B:] + cfg_scale * (eps[:B] - eps[B:])
        c = p["coef"][i]
        if sampler == "ddim":
            x = (x - c[1] * eps) / c[0] * c[2] + c[3] * eps
        else:
            x0 = (x - c[1] * eps) / c[0]
            x, xp = c[2] * x + c[3] * ((1 + c[4]) * x0 - c[4] * xp), x0
    return x


@pytest.mark.parametrize("sampler,steps,cfg_scale,B", [CASES[1], CASES[3], CASES[5]])
def test_kernel_operands_reproduce_jax_fused(heads, sampler, steps, cfg_scale, B):
    jhead, thead = heads
    z, noise = _inputs(B)
    ref = _jax(jhead, z, noise, sampler, steps, cfg_scale)
    p = prepare(thead, TCFG, torch.from_numpy(z), DiffusionSchedule.create(100), steps,
                cfg_scale, sampler)
    with torch.no_grad():
        got = _emulate_kernel(p, TCFG, torch.from_numpy(noise), cfg_scale, sampler)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_stacked_weights_follow_in_place_updates(heads):
    _, thead = heads
    z = torch.from_numpy(_inputs(1)[0])
    p0 = prepare(thead, TCFG, z, DiffusionSchedule.create(100), 10, 1.5, "ddim")
    assert p0["wqkv"] is prepare(thead, TCFG, z, DiffusionSchedule.create(100), 10, 1.5,
                                 "ddim")["wqkv"]  # cached
    w = thead.blocks[1].mlp.fc1.weight
    with torch.no_grad():
        w.add_(1.0)
    try:
        p1 = prepare(thead, TCFG, z, DiffusionSchedule.create(100), 10, 1.5, "ddim")
        torch.testing.assert_close(p1["wfc1"][1], w)  # K-major: [out, in]
    finally:
        with torch.no_grad():
            w.sub_(1.0)


def test_zero_final_layer_hides_the_model():
    """Why every comparison redraws `final`: with the init's zero final layer
    the sampled chunk is a function of the noise alone."""
    head = tdit.DiT(TCFG)
    tdit.init_dit_(head, torch.Generator().manual_seed(0))
    z, noise = (torch.from_numpy(a) for a in _inputs(1))
    kw = dict(steps=10, cfg_scale=1.5, sampler="ddim")
    a = fused_dit_sample(head, TCFG, z, noise, DiffusionSchedule.create(100), **kw)
    b = fused_dit_sample(head, TCFG, -z, noise, DiffusionSchedule.create(100), **kw)
    torch.testing.assert_close(a, b)


DIT_B = dict(T=16, A=7, H=768, M=3072, heads=12)  # CogACT's DiT-B: chunk 16, action dim 7


@pytest.mark.parametrize("rows,T,A,H,M,heads,served", [
    (16, 16, 7, 768, 3072, 12, True),  # the 8-frame micro-batch with CFG: 272 tokens
    (1, 16, 7, 768, 3072, 12, True), (2, 16, 7, 768, 3072, 12, True),
    (17, 16, 7, 768, 3072, 12, False),  # 289 tokens: past four N tiles of 72
    (2, 16, 17, 768, 3072, 12, False),  # A > 16
    (2, 16, 7, 704, 2816, 11, False),  # H % 128 != 0
    (2, 16, 7, 768, 3008, 12, False),  # M % 128 != 0
    (2, 31, 7, 768, 3072, 12, True), (2, 32, 7, 768, 3072, 12, False),  # S <= 32
])
def test_k2_serves_at_dit_b(rows, T, A, H, M, heads, served):
    assert k2_serves(rows, T, A, H, M, heads) is served


def test_cogact_dispatches_by_k2_serves(monkeypatch):
    """cogact_inference_action asks k2_serves with its rows (2 B with CFG) and
    the head's shape; on the CPU it then runs the plain sampler."""
    LLM = dict(vocab_size=512, hidden_size=64, num_layers=1, num_heads=4, num_kv_heads=2,
               head_dim=16, intermediate_size=128, attn_impl="xla")
    VIT = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=1, num_heads=4,
               intermediate_size=64)
    cfg = tcogact.CogActConfig(vlm=tvlm.VLMConfig(llm=ttransformer.TransformerConfig(**LLM),
                                                  vit=tvit.ViTConfig(**VIT)),
                               action_model_type="DiT-S", ddim_steps=2)
    model = tcogact.build_cogact(cfg, "cpu")
    seen = []

    def spy(*args):
        seen.append(args)
        return k2_serves(*args)

    monkeypatch.setattr(tcogact, "k2_serves", spy)
    B, n = 8, cfg.vlm.num_image_tokens + 4
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 500, (B, n)).astype(np.int32))
    ids[:, :cfg.vlm.num_image_tokens] = IMAGE_TOKEN_INDEX
    valid = torch.ones_like(ids)
    imgs = torch.from_numpy(rng.standard_normal((B, 1, 28, 28, 3)).astype(np.float32))
    n0 = fused_dit_sample.launches
    out = tcogact.cogact_inference_action(model, cfg, ids, valid, imgs,
                                          generator=torch.Generator().manual_seed(0))
    d = cfg.dit
    assert seen == [(16, cfg.chunk_size, cfg.action_dim, d.hidden_size, d.mlp_dim, d.num_heads)]
    assert tcogact.k2_uses(cfg, B, cfg.cfg_scale) and not tcogact.k2_uses(cfg, 9, cfg.cfg_scale)
    assert out.shape == (B, cfg.chunk_size, cfg.action_dim) and fused_dit_sample.launches == n0


@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM, H100 PCIe
def test_plan_covers_every_product_once_in_k_order(rows, sms):
    """Every product's items cover its N channels x K steps x N tiles exactly
    once; each chunk is one plane of partials, its k range after the previous
    chunk's; the padded rows hold the tokens; and the layer's partial bytes
    stay under its bf16 weight bytes."""
    T, H, M = DIT_B["T"], DIT_B["H"], DIT_B["M"]
    pl = plan(rows, T, H, M, sms)
    assert pl.bn in dit_fused.BN_TILES and rows * (T + 1) <= pl.rp <= 288
    assert pl.bn == min(b for b in dit_fused.BN_TILES if b >= min(rows * (T + 1), 72))
    assert pl.rp - rows * (T + 1) < pl.bn  # no tile of padding alone
    for (name, N, K), nc in zip(products(H, M), pl.chunks):
        cover = np.zeros((N // 128, K // 64, pl.nt), np.int64)
        ranges = {}
        for walk in pl.items(N, K, nc, sms):
            for c, cb, rt, k0, k1 in walk:
                assert k1 > k0
                cover[cb, k0:k1, rt] += 1
                assert ranges.setdefault(c, (k0, k1)) == (k0, k1)
        assert (cover == 1).all(), name
        bounds = [ranges[c] for c in range(nc)]
        assert bounds[0][0] == 0 and bounds[-1][1] == K // 64
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert sum(pl.partial_bytes(H, M).values()) <= 2 * sum(N * K for _, N, K in products(H, M))
