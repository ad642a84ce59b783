"""The port's MUVLA and PE-ViT against the JAX package, on the CPU in fp32.

* ``fuse_obs_with_history`` with history views (the QFormer) and without.
* ``muvla_loss`` with a reward (reward-weighted CE + 0.5 x the expectile
  regression) and without, and every gradient, against ``jax.value_and_grad``.
* ``muvla_generate``, greedy: tokens exact, log-probs within 2e-3 (both
  packages' bf16 caches).
* ``MUVLAServer`` with and without ``continuous_batching`` (the engine's
  embeds route) against the JAX server's texts; concurrent requests through
  the port's engine coalesce; the 4-view full-width prompt (LLaMA-2-7B, two
  CLIP-L/336 towers: 576 + 192 fused slots) fits the server's max_prompt.
* ``convert_muvla`` in both packages on one synthetic state dict under the
  reference's names (torch MultiheadAttention's packed in_proj): both fill
  the port's model bit for bit.
* ``pe_vit_forward`` with and without attention pooling.

Tiny models: the 2-layer test LLM, the test ViT for both towers, a fuser of
width 32 and 6 history queries.  Tolerance 1e-3 unless stated.
"""

import dataclasses
import re
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _engine import hold_admissions
from dexbotic_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from dexbotic_tpu.exp import base_exp as jbase
from dexbotic_tpu.exp import muvla_exp as jexp
from dexbotic_tpu.exp import serve as jserve
from dexbotic_tpu.models import muvla as jmu
from dexbotic_tpu.nn import pe_vit as jpe
from dexbotic_tpu.utils import convert as jconvert
from dexbotic_tpu_torch.exp import base_exp as tbase
from dexbotic_tpu_torch.exp import muvla_exp as texp
from dexbotic_tpu_torch.exp import serve as tserve
from dexbotic_tpu_torch.models import muvla as tmu
from dexbotic_tpu_torch.nn import pe_vit as tpe
from dexbotic_tpu_torch.utils import convert as tconvert
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

torch.set_num_threads(2)
TOL = 1e-3
TINY = dict(llm_preset="test", vit_preset="test", obs_vit_preset="test", inter_dim=32,
            num_history_queries=6, fuse_heads=4)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, what="", tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _exps():
    j = jexp.MUVLAExp(model=jexp.MUVLAModelConfig(**TINY),
                      data=jbase.DataConfig(image_processor="28"))
    t = texp.MUVLAExp(model=texp.MUVLAModelConfig(**TINY),
                      data=tbase.DataConfig(image_processor="28"), device="cpu")
    return j, t


@pytest.fixture(scope="module")
def pair():
    jx, tx = _exps()
    jcfg, tcfg = jx.model.build_config(), tx.model.build_config()
    params = jax.device_get(jmu.init_muvla(jax.random.PRNGKey(0), jcfg))
    model = tmu.build_muvla(tcfg, "cpu", seed=4)
    load_jax_params(model, params)
    return jx, tx, jcfg, tcfg, params, model


def _batch(views=3, B=2, reward=True, seed=0):
    rs = np.random.RandomState(seed)
    n_fused = 4 + (6 if views > 1 else 0)
    ids = rs.randint(1, 400, (B, n_fused + 8)).astype(np.int32)
    ids[:, :n_fused] = IMAGE_TOKEN_INDEX
    labels = ids.copy()
    labels[:, : n_fused + 4] = IGNORE_INDEX
    mask = np.ones(ids.shape, np.int32)
    mask[1, -2:] = 0
    labels[1, -2:] = IGNORE_INDEX
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels,
             "map_images": rs.randn(B, 28, 28, 3).astype(np.float32),
             "obs_images": rs.randn(B, views, 28, 28, 3).astype(np.float32)}
    if reward:
        batch["reward"] = rs.randn(B).astype(np.float32)
    return batch


@pytest.mark.parametrize("views", [1, 3])
def test_fuse_obs_with_history_matches_jax(pair, views):
    _, _, jcfg, tcfg, params, model = pair
    b = _batch(views)
    want = jmu.fuse_obs_with_history(params, jcfg, jnp.asarray(b["map_images"]),
                                     jnp.asarray(b["obs_images"]))
    got = tmu.fuse_obs_with_history(model, tcfg, _t(b["map_images"]), _t(b["obs_images"]))
    assert got.shape == (2, tcfg.num_fused_tokens(views), 64) == want.shape
    _close(got, want)


@pytest.mark.parametrize("reward", [True, False])
def test_loss_and_grads_match_jax(pair, reward):
    _, _, jcfg, tcfg, params, model = pair
    b = _batch(reward=reward, seed=1)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jmu.muvla_loss(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()}),
        has_aux=True)(params)
    model.requires_grad_(True)
    try:
        loss, m = tmu.muvla_loss(model, tcfg, {k: _t(v) for k, v in b.items()})
        loss.backward()
        assert set(m) == set(jm)
        for k in m:
            _close(m[k], jm[k], k)
        grads = dict(model.named_parameters())
        n = 0
        for name, val, _ in port_arrays(jgrads):
            got = grads[name].grad
            got = np.zeros_like(val) if got is None else got.numpy()
            np.testing.assert_allclose(got, val, rtol=TOL, atol=TOL, err_msg=name)
            n += 1
        assert n == len(grads)
        head = grads["reward_head.weight"].grad
        assert (head is not None and float(head.abs().sum()) > 0) == reward
        assert float(grads["qformer.queries"].grad.abs().sum()) > 0
    finally:
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)


def test_generate_matches_jax(pair):
    _, _, jcfg, tcfg, params, model = pair
    b = _batch(seed=2)
    jt, jl = jmu.muvla_generate(params, jcfg, jnp.asarray(b["input_ids"]),
                                jnp.asarray(b["attention_mask"]), jnp.asarray(b["map_images"]),
                                jnp.asarray(b["obs_images"]), max_new_tokens=6, eos_token_id=1)
    tt, tl = tmu.muvla_generate(model, tcfg, _t(b["input_ids"]), _t(b["attention_mask"]),
                                _t(b["map_images"]), _t(b["obs_images"]), 6, 1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _close(tl, jl, tol=2e-3)


def _frames(rs, n):
    return [(f"v{i}", rs.randint(0, 255, (28, 28, 3)).astype(np.uint8)) for i in range(n)]


def test_server_with_and_without_the_engine_matches_jax(pair):
    """The same requests (a map view + 2 or 3 observation views) through
    the JAX server and the port's, each with and without the engine: equal
    texts; three concurrent requests through the port's 2-slot engine
    coalesce (the engine admits nothing until all three are queued) and
    give the sequential texts."""
    jx, tx, jcfg, tcfg, params, model = pair
    jtok, ttok = jx.tokenizer.build_tokenizer(), tx.tokenizer.build_tokenizer()
    rs = np.random.RandomState(7)
    reqs = [({"text": t}, _frames(rs, n)) for t, n in (("go to the door", 3), ("turn", 4),
                                                       ("find the red chair", 3))]
    jplain = jserve.MUVLAServer(jx, jcfg, params, jtok, max_new_tokens=4)
    jcb = jserve.MUVLAServer(jx, jcfg, params, jtok, max_new_tokens=4, continuous_batching=2)
    tplain = tserve.MUVLAServer(tx, tcfg, model, ttok, max_new_tokens=4)
    tcb = tserve.MUVLAServer(tx, tcfg, model, ttok, max_new_tokens=4, continuous_batching=2)
    assert tcb.concurrent and not tplain.concurrent
    try:
        want = [jplain.get_response(*r) for r in reqs]
        assert [jcb.get_response(*r) for r in reqs] == want
        assert [tplain.get_response(*r) for r in reqs] == want
        out = [None] * len(reqs)
        hold_admissions(tcb.engine, len(reqs))

        def run(i):
            out[i] = tcb.get_response(*reqs[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert out == want and tcb.engine.batched_steps > 0
        assert all(isinstance(o["text"], str) for o in out)
    finally:
        tcb.close()
        jcb.engine.close()


def test_full_width_prompt_fits_the_engine():
    """The default MUVLA (LLaMA-2-7B, two CLIP-L/336 towers, 192 history
    queries) with a map view and 4 observation views: 768 fused slots; the
    prompt of a served instruction, equal to the JAX server's, fits the
    server's default max_prompt (1024; the JAX engine's 512 does not)."""
    tx, jx = texp.MUVLAExp(device="cpu"), jexp.MUVLAExp()
    host = types.SimpleNamespace(exp=tx, cfg=tx.model.build_config(),
                                 tokenizer=tx.tokenizer.build_tokenizer())
    P = tserve.engine_max_prompt(len(tserve.MUVLAServer.prompt_ids(host, "", 4)))
    jcfg, jtok = jx.model.build_config(), jx.tokenizer.build_tokenizer()
    for text in ("go to the red door", "walk down the corridor and stop at the second office"):
        ids = tserve.MUVLAServer.prompt_ids(host, text, 4)
        conv = jserve.conversation_lib.conv_templates[jx.tokenizer.chat_template].copy()
        conv.append_message(conv.roles[0], "<image>" + text)
        conv.append_message(conv.roles[1], None)
        jids = jserve.tokenizer_image_token(conv.get_prompt(), jtok,
                                            num_image_tokens=jcfg.num_fused_tokens(4))
        assert ids == list(jids) and 512 < len(ids) <= P
        assert sum(i == IMAGE_TOKEN_INDEX for i in ids) == 768
    assert P == 1024


def _reference_state_dict(model, cfg) -> dict:
    """The tiny MUVLA under the reference's names (the inverse of
    convert_muvla): chip_smoke's decoder and tower rules, the towers' conv
    patch embeds, the projector's Sequential indices, torch
    MultiheadAttention's packed in_proj for the fuser and the QFormer."""
    out, packed = {}, {}
    towers = {"vit.": tconvert.VIT_PREFIX,
              "obs_vit.": "model.obs_vision_tower.vision_tower.vision_model."}
    mods = {"fuser.attn.": "model.fuser.cross_attn.", "qformer.attn.": "model.history_qformer.attn."}
    for name, p in model.named_parameters():
        t = p.detach().clone()
        tower = next((k for k in towers if name.startswith(k)), None)
        mha = next((k for k in mods if name.startswith(k)), None)
        if name.startswith("llm."):
            out["model.llm." + chip_smoke._renamed(name[4:], chip_smoke.LLM_RULES)] = t
        elif tower:
            sub = name[len(tower):]
            if sub == "patch_embed.weight":
                t = t.reshape(t.shape[0], 14, 14, 3).permute(0, 3, 1, 2)
            out[towers[tower] + chip_smoke._renamed(sub, chip_smoke.VIT_RULES)] = t
        elif name.startswith("projector."):
            i, leaf = re.match(r"^projector\.fc(\d)\.(weight|bias)$", name).groups()
            out[f"model.mm_projector.{2 * int(i)}.{leaf}"] = t
        elif mha:
            proj, leaf = name[len(mha):].split(".")
            if proj == "o":
                out[mods[mha] + f"out_proj.{leaf}"] = t
            else:
                packed.setdefault((mods[mha], leaf), {})[proj] = t
        else:
            ref = {"fuser.ln": "model.fuser.ln", "qformer.ln": "model.history_qformer.norm",
                   "qformer.input_proj": "model.history_qformer.input_proj",
                   "qformer.queries": "model.history_qformer.query_embeddings",
                   "reward_head": "reward_head"}
            head, _, leaf = name.rpartition(".")
            out[ref[name] if name in ref else f"{ref[head]}.{leaf}"] = t
    for (prefix, leaf), qkv in packed.items():
        out[f"{prefix}in_proj_{leaf}"] = torch.cat([qkv["q"], qkv["k"], qkv["v"]])
    return out


def test_convert_muvla_in_both_packages(pair):
    _, _, jcfg, tcfg, _, model = pair
    sd = _reference_state_dict(model, tcfg)
    assert "model.fuser.cross_attn.in_proj_weight" in sd
    assert "model.history_qformer.attn.in_proj_bias" in sd
    jtree = jconvert.convert_muvla({k: v.numpy() for k, v in sd.items()}, jcfg)
    for tree in (jtree, tconvert.convert_muvla(sd, tcfg)):
        fresh = tmu.build_muvla(tcfg, "cpu", seed=9)
        filled = load_jax_params(fresh, tree)
        assert len(filled) == len(dict(model.named_parameters()))
        for (name, a), b in zip(model.named_parameters(), fresh.parameters()):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("pool", [None, 2])
def test_pe_vit_forward_matches_jax(pool):
    jcfg = jpe.PEViTConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
                           num_heads=4, intermediate_size=64, pool_tokens=pool)
    tcfg = tpe.PEViTConfig(**dataclasses.asdict(jcfg))
    params = jax.device_get(jpe.init_pe_vit(jax.random.PRNGKey(0), jcfg))
    vit = tpe.PEViT(tcfg)
    tpe.init_pe_vit_(vit, tcfg, torch.Generator().manual_seed(1))
    assert float(vit.layers[0].ls1[0].detach()) == np.float32(tcfg.layer_scale_init)
    load_jax_params(vit, params)
    imgs = np.random.default_rng(1).normal(size=(2, 28, 28, 3)).astype(np.float32)
    want = jpe.pe_vit_forward(params, jcfg, jnp.asarray(imgs))
    with torch.no_grad():
        got = tpe.pe_vit_forward(vit, tcfg, _t(imgs))
    assert got.shape == (2, tcfg.num_output_tokens, 32) == want.shape
    _close(got, want)
    cos, sin = tpe.rope2d_tables(tcfg)
    jcos, jsin = jpe._rope2d_tables(jcfg)
    _close(cos, jcos, tol=1e-6)
    _close(sin, jsin, tol=1e-6)


def test_example_exp_matches_jax():
    """The port's example MUVLA exp holds the JAX example's values in every
    field the two share."""
    from dexbotic_tpu_torch.playground.example_muvla_exp import MyMUVLAExp
    from playground.example_muvla_exp import MyMUVLAExp as JExample

    j, t = JExample(), MyMUVLAExp()
    for part in ("model", "data", "trainer"):
        jd, td = dataclasses.asdict(getattr(j, part)), dataclasses.asdict(getattr(t, part))
        common = sorted(set(jd) & set(td))
        assert len(common) >= len(jd) // 2, (part, sorted(set(jd) - set(td)))
        assert {k: td[k] for k in common} == {k: jd[k] for k in common}, part
    assert t.num_image_tokens() == j.num_image_tokens() == 768
