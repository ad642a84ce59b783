"""The port's MemVLA (serving half) against the JAX package.

* The bank's modules: ``se_bottleneck``, ``cross_block``, ``gate_fusion``
  and ``timestep_embed`` on the same weights and inputs.
* ``bank_step`` over 20 frames of 2 episode rows with ToMe and with FIFO
  consolidation (past ``mem_length``), a row reset by ``reset_mem_rows`` in
  the middle: the fused tokens and the whole state each frame.
* The DiT with ``mem_cross_attn``: ``dit_forward`` and the CFG variant
  against JAX, the zero-initialised ``final`` layer and cross-attention
  output projections redrawn; K2 refuses it.
* ``memvla_inference_action`` with and without CFG on injected noise over
  a 3-frame episode, the bank carried between frames.
* ``MemVLAServer``: the required ``episode_first_frame`` field, 'True'
  resetting the bank and the frame counter, each answer equal to a direct
  call on the server's noise.
* ``convert_memvla`` in both packages on a reference-named state dict
  (chip_smoke's writer), and the bridge round trip.
* Int8: an fp32 tree quantized at min_size 0 in both packages (the chunk),
  and ``inference_quantize`` ("int8", "w8a8") quantizing the leaves JAX's
  exp quantizes.

fp32 on the CPU at the tiny presets; tolerance 1e-3, integers exact.
"""

import dataclasses
import io
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from dexbotic_tpu.constants import IMAGE_TOKEN_INDEX
from dexbotic_tpu.models import dit as jdit
from dexbotic_tpu.models import memvla as jmem
from dexbotic_tpu.models import presets as jpresets
from dexbotic_tpu.models import vlm as jvlm
from dexbotic_tpu.ops import quant as jquant
from dexbotic_tpu.utils import convert as jconvert
from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.memvla_exp import MemVLAExp, MemVLAModelConfig
from dexbotic_tpu_torch.models import dit as tdit
from dexbotic_tpu_torch.models import memvla as tmem
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.nn.core import QuantEmbedding, QuantLinear
from dexbotic_tpu_torch.ops.dit_fused import fused_dit_sample
from dexbotic_tpu_torch.ops.quant import quantize_model_
from dexbotic_tpu_torch.utils import convert as tconvert
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

torch.set_num_threads(2)
TOL = 1e-3


def _pair(**kw):
    """(JAX config, port config) of a tiny MemVLA: 4 per tokens of 16
    channels, a bank of 5 entries, DiT-S."""
    kw = dict(dict(action_model_type="DiT-S", action_dim=3, chunk_size=4, per_token_size=16,
                   mem_length=5), **kw)
    return tuple(m.MemVLAConfig(vlm=v.VLMConfig(llm=p.LLM_TEST, vit=p.VIT_TEST,
                                                projector_type="mlp2x_gelu"), **kw)
                 for m, v, p in ((jmem, jvlm, jpresets), (tmem, tvlm, tpresets)))


def _jax_params(jcfg, seed=0):
    """Seeded JAX params (numpy) with the zero-initialised DiT outputs (the
    final layer, each block's cross-attention out-projection) redrawn."""
    params = jax.device_get(jmem.init_memvla(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    head = params["action_head"]
    for leaf in ("w", "b"):
        head["final"][leaf] = rng.normal(0, 0.2, head["final"][leaf].shape).astype(np.float32)
        o = head["blocks"]["xattn"]["o"]
        o[leaf] = rng.normal(0, 0.05, o[leaf].shape).astype(np.float32)
    for role in ("per", "cog"):  # gates of N(0, 1e-3) fuse at ~0.5: make them matter
        g = params["mem_bank"][role]["gate"]["proj"]
        g["w"] = rng.normal(0, 0.3, g["w"].shape).astype(np.float32)
    return params


def _port_model(tcfg, params):
    model = tmem.build_memvla(tcfg, "cpu", seed=1)
    load_jax_params(model, params)
    return model


def _close(got, want, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL, **kw)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_bank_modules_match_jax():
    jcfg, tcfg = _pair()
    params = _jax_params(jcfg)
    model = _port_model(tcfg, params)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 64)).astype(np.float32)
    _close(tmem.se_bottleneck(model.per_compr, _t(x)),
           jmem.se_bottleneck(params["per_compr"], jnp.asarray(x)))
    blk_j, blk_t = params["mem_bank"]["cog"]["retrieval"][0], model.mem_bank["cog"].retrieval[0]
    q = rng.normal(size=(2, 3, 64)).astype(np.float32)
    kv = rng.normal(size=(2, 7, 64)).astype(np.float32)
    valid = (np.arange(7)[None] < np.array([[5], [7]])).astype(np.int32)
    _close(tmem.cross_block(blk_t, _t(q), _t(kv), _t(valid), 4),
           jmem.cross_block(blk_j, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(valid), 4))
    vals = rng.normal(size=(2, 7, 64)).astype(np.float32)
    _close(tmem.cross_block_kv(blk_t, _t(q), _t(kv), _t(vals), _t(valid), 4),
           jmem.cross_block_kv(blk_j, *map(jnp.asarray, (q, kv, vals, valid)), 4))
    x2 = rng.normal(size=(2, 3, 64)).astype(np.float32)
    _close(tmem.gate_fusion(model.mem_bank["cog"].gate, _t(q), _t(x2)),
           jmem.gate_fusion(params["mem_bank"]["cog"]["gate"], jnp.asarray(q), jnp.asarray(x2)))
    t = np.array([0.0, 3.0, 17.5], np.float32)
    _close(tmem.timestep_embed(model.mem_bank["per"].time, _t(t)),
           jmem.timestep_embed(params["mem_bank"]["per"]["time"], jnp.asarray(t)))


def _state_np(state):
    return {r: {k: np.asarray(v) for k, v in st.items()} for r, st in state.items()}


@pytest.mark.parametrize("consolidate", ["tome", "fifo"])
def test_bank_step_over_20_frames_matches_jax(consolidate):
    """Two episode rows through 20 frames of a bank of 5: both roles' fused
    tokens and the whole bank (features, times within 1e-3, counts exact)
    every frame; row 1 is reset at frame 9 and refills."""
    jcfg, tcfg = _pair(consolidate_type=consolidate)
    params = _jax_params(jcfg)
    model = _port_model(tcfg, params)
    rng = np.random.default_rng(2)
    jstate, tstate = jmem.init_mem_state(jcfg, 2), tmem.init_mem_state(tcfg, 2)
    times = np.zeros(2, np.float32)
    base = rng.normal(size=(2, 4, 16)).astype(np.float32)
    for frame in range(20):
        if frame == 9:
            mask = np.array([False, True])
            jstate = jmem.reset_mem_rows(jstate, jnp.asarray(mask))
            tstate = tmem.reset_mem_rows(tstate, torch.from_numpy(mask))
            times[1] = 0.0
        # slowly drifting tokens: adjacent bank entries stay alike, as a video's frames
        per = (base + 0.3 * rng.normal(size=base.shape)).astype(np.float32)
        cog = rng.normal(size=(2, 1, 64)).astype(np.float32)
        jp, jc, jstate = jmem.bank_step(params, jcfg, jstate, jnp.asarray(per), jnp.asarray(cog),
                                        jnp.asarray(times))
        tp, tc, tstate = tmem.bank_step(model, tcfg, tstate, _t(per), _t(cog), _t(times))
        _close(tp, jp, err_msg=f"per, frame {frame}")
        _close(tc, jc, err_msg=f"cog, frame {frame}")
        want = _state_np(jstate)
        for role in ("per", "cog"):
            np.testing.assert_array_equal(tstate[role]["count"].numpy(), want[role]["count"])
            _close(tstate[role]["feats"], want[role]["feats"], err_msg=f"{role} frame {frame}")
            _close(tstate[role]["times"], want[role]["times"], err_msg=f"{role} frame {frame}")
        times += 1.0
    assert tstate["per"]["count"].tolist() == [5, 5]
    if consolidate == "tome":  # merged slots hold averaged (fractional) times
        assert (tstate["per"]["times"].numpy() % 1 != 0).any()
    else:
        np.testing.assert_array_equal(tstate["per"]["times"][0].numpy(), np.arange(15, 20))


def test_mem_dit_matches_jax_and_k2_refuses_it():
    jcfg, tcfg = _pair()
    params = _jax_params(jcfg)
    model = _port_model(tcfg, params)
    head_j, head_t = params["action_head"], model.action_head
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 3)).astype(np.float32)
    t = np.array([5, 80], np.int32)
    z = rng.normal(size=(2, 1, 64)).astype(np.float32)
    mem = rng.normal(size=(2, 4, jcfg.dit.hidden_size)).astype(np.float32)
    mem_valid = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.int32)
    for kw in ({}, {"mem_valid": mem_valid}):
        want = jdit.dit_forward(head_j, jcfg.dit, *map(jnp.asarray, (x, t, z)),
                                mem=jnp.asarray(mem),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
        got = tdit.dit_forward(head_t, tcfg.dit, *map(_t, (x, t, z)), mem=_t(mem),
                               **{k: _t(v) for k, v in kw.items()})
        _close(got, want)
    x2 = np.concatenate([x, x])
    z2 = np.concatenate([z, rng.normal(size=z.shape).astype(np.float32)])
    mem2 = np.concatenate([mem, mem])
    t2 = np.concatenate([t, t])
    want = jdit.dit_forward_with_cfg(head_j, jcfg.dit, *map(jnp.asarray, (x2, t2, z2)), 1.5,
                                     mem=jnp.asarray(mem2))
    _close(tdit.dit_forward_with_cfg(head_t, tcfg.dit, *map(_t, (x2, t2, z2)), 1.5,
                                     mem=_t(mem2)), want)
    # at init the cross-attention's out-projection is zero: the block adds nothing
    fresh = tmem.build_memvla(tcfg, "cpu", seed=2).action_head
    assert all(float(b.xattn.o.weight.abs().max()) == 0 for b in fresh.blocks)
    with pytest.raises(NotImplementedError, match="K2"):
        fused_dit_sample(head_t, tcfg.dit, _t(z), _t(x), tmem.schedule(tcfg), steps=2,
                         cfg_scale=1.5)


def _frames(jcfg, n, seed=4):
    rng = np.random.default_rng(seed)
    nt = jcfg.vlm.num_image_tokens
    ids = rng.integers(1, 400, (1, nt + 7)).astype(np.int32)
    ids[:, :nt] = IMAGE_TOKEN_INDEX
    valid = np.ones_like(ids)
    valid[:, -2:] = 0  # the bucket's padded tail
    ids[valid == 0] = 0
    return [(ids, valid, rng.normal(size=(1, 1, 28, 28, 3)).astype(np.float32),
             rng.normal(size=(1, 4, 3)).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("cfg_scale", [1.5, 1.0])
def test_inference_over_an_episode_matches_jax(cfg_scale):
    """Three frames of one episode, the bank carried from frame to frame,
    the frame index as the bank's timestep, the initial noise injected."""
    jcfg, tcfg = _pair()
    params = _jax_params(jcfg)
    model = _port_model(tcfg, params)
    jstate, tstate = jmem.init_mem_state(jcfg, 1), tmem.init_mem_state(tcfg, 1)
    for i, (ids, valid, imgs, noise) in enumerate(_frames(jcfg, 3)):
        t = np.full((1,), float(i), np.float32)
        want, jstate = jmem.memvla_inference_action(
            params, jcfg, *map(jnp.asarray, (ids, valid, imgs)), jstate, jnp.asarray(t),
            jax.random.PRNGKey(0), cfg_scale=cfg_scale, noise=jnp.asarray(noise))
        got, tstate = tmem.memvla_inference_action(
            model, tcfg, *map(_t, (ids, valid, imgs)), tstate, _t(t), cfg_scale=cfg_scale,
            noise=_t(noise))
        assert got.shape == (1, 4, 3) and got.dtype == torch.float32
        _close(got, want, err_msg=f"frame {i}")
        assert np.abs(np.asarray(want) - noise).max() > 0.05
        assert tstate["per"]["count"].tolist() == [i + 1]
        for role in ("per", "cog"):
            _close(tstate[role]["feats"], jstate[role]["feats"])


# ---------------------------------------------------------------------------
# The server, conversion and int8
# ---------------------------------------------------------------------------


def _exp(**kw):
    return MemVLAExp(model=MemVLAModelConfig(llm_preset="test", vit_preset="test",
                                             action_model_type="DiT-S", action_dim=3,
                                             chunk_size=4, per_token_size=16, mem_length=3),
                     data=base_exp.DataConfig(image_processor="28"), device="cpu", **kw)


def _png(seed):
    img = np.random.default_rng(seed).integers(0, 256, (40, 32, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _post(port, fields, png):
    boundary = "memvlatestboundary"
    body = b""
    for k, v in fields.items():
        body += (f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'
                 ).encode()
    body += (f'--{boundary}\r\nContent-Disposition: form-data; name="image"; '
             f'filename="f.png"\r\nContent-Type: image/png\r\n\r\n').encode() + png + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/process_frame", data=body,
                                 headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_server_episode_first_frame_contract():
    """The field is required ('True' or 'False'); 'True' empties the bank
    and restarts the frame counter; each answer is a direct session call on
    the server's next noise draw."""
    from dexbotic_tpu_torch.exp.memvla_exp import MemVLAInferenceSession
    from dexbotic_tpu_torch.exp.serve import MemVLAServer, _cogact_images, _cogact_prompt_ids

    exp = _exp()
    cfg, model, norms = exp.load_for_inference()
    tok = exp.tokenizer.build_tokenizer()
    server = MemVLAServer(exp, cfg, model, tok, norms, host="127.0.0.1", port=0)
    assert server.micro_batch == 0  # never micro-batched
    httpd = server.serve_background()
    port = httpd.server_address[1]
    twin = MemVLAInferenceSession(exp, cfg, model)
    gen = torch.Generator().manual_seed(exp.model.seed)
    row = _cogact_prompt_ids(exp, cfg, tok, "open the drawer")
    L = -(-len(row) // 64) * 64
    ids = torch.zeros((1, L), dtype=torch.int32)
    ids[0, : len(row)] = torch.tensor(row)
    valid = (torch.arange(L) < len(row)).int()[None]
    try:
        for bad in ({}, {"episode_first_frame": "true"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, {"text": "open the drawer", **bad}, _png(0))
            assert e.value.code == 500 and b"episode_first_frame" in e.value.read()
        firsts = ["True", "False", "False", "False", "False", "True", "False"]
        for i, first in enumerate(firsts):
            png = _png(i)
            out = np.asarray(_post(port, {"text": "open the drawer", "episode_first_frame": first},
                                   png))
            if first == "True":
                twin.reset()
            noise = torch.randn((1, 4, 3), generator=gen)
            imgs = torch.from_numpy(_cogact_images([png], exp.data.build_image_processor()))[None]
            want = twin.step(ids, valid, imgs, noise=noise)[0].numpy()
            assert out.shape == (4, 3)
            np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
            counts = server.session.state["per"]["count"].tolist()
            expect = min(1 + (i if i < 5 else i - 5), cfg.mem_length)
            assert counts == [expect] and server.session.timestep == (i + 1 if i < 5 else i - 4)
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_convert_memvla_matches_jax_and_round_trips():
    """A tiny port MemVLA written under the reference's names (chip_smoke's
    writer: the 1x1 convs, the bank blocks, gates and timestep embedders,
    the DiT's packed per_attn) converts to JAX's tree in both packages and
    loads back bit for bit; its chunk is unchanged."""
    jcfg, tcfg = _pair()
    params = _jax_params(jcfg)
    model = _port_model(tcfg, params)
    sd = chip_smoke.reference_state_dict(model, tcfg)
    assert "model.per_cog_mem_bank.retrieval_blocks.cog.1.ffn.3.weight" in sd
    assert sd["model.per_compr.excite.1.weight"].ndim == 4
    assert sd["model.action_head.net.blocks.0.per_attn.in_proj_weight"].shape == (
        3 * tcfg.dit.hidden_size, tcfg.dit.hidden_size)
    want = jconvert.convert_memvla({k: v.numpy() for k, v in sd.items()}, jcfg)
    got = tconvert.convert_memvla(sd, tcfg)
    jleaves = {name: val for name, val, _ in port_arrays(want)}
    tleaves = {name: np.asarray(val) for name, val, _ in port_arrays(got)}
    assert set(tleaves) == set(jleaves) == {n for n, _ in model.named_parameters()}
    for name, val in jleaves.items():
        np.testing.assert_array_equal(tleaves[name], val, err_msg=name)
    back = tmem.build_memvla(tcfg, "cpu", seed=7)
    load_jax_params(back, got)
    for (n, a), (_, b) in zip(model.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), n
    ids, valid, imgs, noise = _frames(jcfg, 1)[0]
    args = (*map(_t, (ids, valid, imgs)),)
    outs = [tmem.memvla_inference_action(m, tcfg, *args, tmem.init_mem_state(tcfg, 1),
                                         torch.zeros(1), noise=_t(noise))[0]
            for m in (model, back)]
    assert torch.equal(*outs)


def test_int8_chunk_matches_jax():
    """An fp32 tree quantized at min_size 0 in both packages (every matrix
    of the VLM, the SE bottleneck, the bank and the DiT): the chunk over a
    2-frame episode with CFG, in fp32."""
    jcfg, tcfg = _pair()
    params = _jax_params(jcfg)
    qp = jax.device_get(jquant.quantize_params(jax.tree.map(jnp.asarray, params), min_size=0,
                                               pad_cols=False))
    model = tmem.build_memvla(tcfg, "cpu", seed=1)
    quantize_model_(model, min_size=0)
    load_jax_params(model, qp)
    assert isinstance(model.per_compr.reduce.fc1, QuantLinear)
    assert isinstance(model.mem_bank["per"].retrieval[0].k, QuantLinear)
    assert isinstance(model.action_head.blocks[0].xattn.v, QuantLinear)
    assert isinstance(model.action_head.per_token_embedder, QuantLinear)
    jstate, tstate = jmem.init_mem_state(jcfg, 1), tmem.init_mem_state(tcfg, 1)
    for i, (ids, valid, imgs, noise) in enumerate(_frames(jcfg, 2, seed=5)):
        t = np.full((1,), float(i), np.float32)
        want, jstate = jmem.memvla_inference_action(
            qp, jcfg, *map(jnp.asarray, (ids, valid, imgs)), jstate, jnp.asarray(t),
            jax.random.PRNGKey(0), noise=jnp.asarray(noise))
        got, tstate = tmem.memvla_inference_action(model, tcfg, *map(_t, (ids, valid, imgs)),
                                                   tstate, _t(t), noise=_t(noise))
        _close(got, want, err_msg=f"frame {i}")


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_inference_quantize_matches_jax_exp(mode):
    """MemVLAExp(inference_quantize=mode).load_for_inference quantizes the
    leaves the JAX exp's does (its int8 tree fills the port's quantized
    model one to one), in bf16; the served chunk of the two stays within
    bf16's reach of each other (cosine >= 0.999)."""
    from dexbotic_tpu.exp import base_exp as jbase
    from dexbotic_tpu.exp import memvla_exp as jexp_mod
    from dexbotic_tpu.ops import quant_matmul as jqm
    from dexbotic_tpu_torch.ops import quant_matmul as tqm

    old = (jqm.W8A8_MIN_ROWS, tqm.W8A8_MIN_ROWS)
    try:
        jexp = jexp_mod.MemVLAExp(model=jexp_mod.MemVLAModelConfig(
            llm_preset="test", vit_preset="test", action_model_type="DiT-S", action_dim=3,
            chunk_size=4, per_token_size=16, mem_length=3),
            data=jbase.DataConfig(image_processor="28"), inference_quantize=mode,
            inference_quantize_min_size=4096)
        texp = _exp(inference_quantize=mode, inference_quantize_min_size=4096)
        jcfg, jq, _ = jexp.load_for_inference()
        tcfg, model, _ = texp.load_for_inference()
        jq = jax.device_get(jq)
        # one to one: a JAX int8 leaf without a quantized port module (or the
        # reverse) raises here
        filled = load_jax_params(model, jq)
        quant = [m for m in model.modules() if isinstance(m, (QuantLinear, QuantEmbedding))]
        assert len(quant) == sum(n.endswith(".q") for n in filled) > 0
        assert isinstance(model.action_head.per_token_embedder, QuantLinear)  # 16 x 384
        assert isinstance(model.mem_bank["cog"].retrieval[0].q, QuantLinear)  # 64 x 64
        assert not isinstance(model.mem_bank["per"].retrieval[0].q, QuantLinear)  # 16 x 16
        if mode == "w8a8":
            assert jqm.W8A8_MIN_ROWS == tqm.W8A8_MIN_ROWS == 2048
        ids, valid, imgs, noise = _frames(jcfg, 1, seed=6)[0]
        want, _ = jmem.memvla_inference_action(
            jq, jcfg, *map(jnp.asarray, (ids, valid, imgs)), jmem.init_mem_state(jcfg, 1),
            jnp.zeros(1), jax.random.PRNGKey(0), noise=jnp.asarray(noise))
        got, _ = tmem.memvla_inference_action(model, tcfg, *map(_t, (ids, valid, imgs)),
                                              tmem.init_mem_state(tcfg, 1), torch.zeros(1),
                                              noise=_t(noise))
    finally:
        jqm.W8A8_MIN_ROWS, tqm.W8A8_MIN_ROWS = old
    a, b = got.numpy().ravel(), np.asarray(want).ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos >= 0.999, cos
