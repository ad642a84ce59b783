"""The port's OFT policies (L1, Diffusion and Discrete heads) against the JAX package.

* ``oft_loss`` and every parameter's gradient against
  ``jax.value_and_grad(oft_loss)`` for the three heads, with and without the
  proprio token, the diffusion timesteps and noise injected on both sides;
  ``oft_inference_action`` likewise, with the DDIM noise injected.
* Internal consistency: the Diffusion segment against the frozen prompt
  cache equals the joint prompt + segment run; the Discrete decode slice
  (``reference_parity``) and the bin round trip; ``oft_action_log_probs``
  against JAX on the same bins; ``oft_generate_action``'s log-probs equal
  ``oft_action_log_probs`` on the bins it drew.
* The goldens ``oft_l1_actions`` and ``oft_discrete_actions`` of
  ``tests/golden_outputs.npz`` (JAX weights through utils/bridge.py).
* Conversion: the bridge round trip; ``convert_oft`` in both packages on a
  reference-layout state dict written by chip_smoke's writer.
* Int8: the quantized leaves and the chunk against JAX ``quantize_params``
  + ``oft_inference_action``.
* Serving: ``OFTServer``'s /process_frame against a direct call (one frame
  with a state, ``batch_size=2``, micro-batched singles); ``OFTExp.train()``
  on a mini suite -> checkpoint -> one request.

fp32 on the CPU at the tiny presets; tolerance 1e-3, the repo's parity pin.
"""

import concurrent.futures
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

import chip_smoke
from dexbotic_tpu.constants import IMAGE_TOKEN_INDEX
from dexbotic_tpu.models import oft as joft
from dexbotic_tpu.models import presets as jpresets
from dexbotic_tpu.models import vlm as jvlm
from dexbotic_tpu.ops import quant as jquant
from dexbotic_tpu.utils import convert as jconvert
from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.oft_exp import OFTExp, OFTModelConfig, discrete_labels
from dexbotic_tpu_torch.exp.optim import OptimizerConfig
from dexbotic_tpu_torch.exp.serve import OFTServer, _cogact_images, _cogact_prompt_ids
from dexbotic_tpu_torch.exp.trainer import TrainerConfig
from dexbotic_tpu_torch.models import oft as toft
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.nn.core import QuantEmbedding, QuantLinear
from dexbotic_tpu_torch.ops.quant import quantize_model_
from dexbotic_tpu_torch.utils import convert as tconvert
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

torch.set_num_threads(2)
TOL = 1e-3
HEADS = ["L1", "Diffusion", "Discrete"]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_outputs.npz")


def _pair(head, proprio=False, **kw):
    """(JAX config, port config) of a tiny OFT policy."""
    extra = dict(use_proprio=True, proprio_dim=5) if proprio else {}
    return tuple(m.OFTConfig(vlm=v.VLMConfig(llm=p.LLM_TEST, vit=p.VIT_TEST,
                                             projector_type="mlp2x_gelu"),
                             action_model_type=head, action_dim=3, chunk_size=4, num_bins=64,
                             **extra, **kw)
                 for m, v, p in ((joft, jvlm, jpresets), (toft, tvlm, tpresets)))


def _jax_params(jcfg, seed=0):
    """Seeded JAX params (numpy); L1's zero action queries redrawn so that
    each query token differs from the first layer on."""
    params = jax.device_get(joft.init_oft(jax.random.PRNGKey(seed), jcfg))
    if "action_query" in params["action_head"]:
        rng = np.random.default_rng(seed)
        q = params["action_head"]["action_query"]
        params["action_head"]["action_query"] = rng.normal(0, 0.5, q.shape).astype(np.float32)
    return params


def _port_model(tcfg, params):
    model = toft.build_oft(tcfg, "cpu", seed=1)
    load_jax_params(model, params)
    return model


def _batch(cfg, seed=0, B=2):
    """A collated batch whose second row has a padded prompt tail (pads
    mid-row once the segment is appended), with the injected diffusion draws."""
    rng = np.random.default_rng(seed)
    nt = cfg.vlm.num_image_tokens
    ids = rng.integers(1, 400, (B, nt + 8)).astype(np.int32)
    ids[:, :nt] = IMAGE_TOKEN_INDEX
    valid = np.ones_like(ids, dtype=bool)
    valid[1, -3:] = False
    ids[~valid] = 0
    actions = np.tanh(rng.standard_normal((B, cfg.chunk_size, cfg.action_dim))).astype(np.float32)
    batch = {
        "input_ids": ids, "attention_mask": valid,
        "images": rng.standard_normal((B, 1, 28, 28, 3)).astype(np.float32),
        "actions": actions,
        "states": rng.standard_normal((B, 5)).astype(np.float32),
        "diffusion_t": rng.integers(0, cfg.num_diffusion_steps, B).astype(np.int32),
        "diffusion_noise": rng.standard_normal(actions.shape).astype(np.float32),
    }
    bins = np.asarray(joft.continuous_to_bins(jnp.asarray(actions), cfg)).reshape(B, -1)
    batch["action_bins"] = (bins + cfg.vlm.llm.vocab_size - cfg.num_bins).astype(np.int32)
    return batch


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_loss(jcfg):
    def loss(params, batch):
        return joft.oft_loss(params, jcfg, batch, jax.random.PRNGKey(0),
                             diffusion_t=batch["diffusion_t"],
                             diffusion_noise=batch["diffusion_noise"])
    return loss


def _port_loss(model, tcfg, batch):
    return toft.oft_loss(model, tcfg, batch, diffusion_t=batch["diffusion_t"],
                         diffusion_noise=batch["diffusion_noise"])


@pytest.mark.parametrize("proprio", [False, True])
@pytest.mark.parametrize("head", HEADS)
def test_oft_loss_and_grads_match_jax(head, proprio):
    jcfg, tcfg = _pair(head, proprio)
    params = _jax_params(jcfg)
    batch = _batch(jcfg, 1)
    (jloss, _), jgrads = jax.value_and_grad(_jax_loss(jcfg), has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(tcfg, params).requires_grad_(True)
    loss, metrics = _port_loss(model, tcfg, _tensors(batch))
    loss.backward()
    assert float(metrics["action_loss"].detach()) == float(loss.detach())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL, atol=TOL)
    grads = dict(model.named_parameters())
    n = 0
    for name, val, _ in port_arrays(jgrads):
        got = grads[name].grad
        got = np.zeros_like(val) if got is None else got.numpy()
        np.testing.assert_allclose(got, val, rtol=TOL, atol=TOL, err_msg=name)
        n += 1
    assert n == len(grads)
    head_grad = sum(float(p.grad.abs().sum()) for k, p in grads.items()
                    if k.startswith("action_head.") and p.grad is not None)
    assert head == "Discrete" and not proprio or head_grad > 0


def _inference_inputs(cfg, seed=2):
    b = _batch(cfg, seed)
    noise = np.random.default_rng(seed + 10).standard_normal(
        (2, cfg.chunk_size, cfg.action_dim)).astype(np.float32)
    return b, noise


@pytest.mark.parametrize("proprio", [False, True])
@pytest.mark.parametrize("head", HEADS)
def test_oft_inference_matches_jax(head, proprio):
    jcfg, tcfg = _pair(head, proprio)
    params = _jax_params(jcfg)
    b, noise = _inference_inputs(jcfg)
    states = b["states"] if proprio else None
    ref = joft.oft_inference_action(
        params, jcfg, jnp.asarray(b["input_ids"]), jnp.asarray(b["attention_mask"]),
        jnp.asarray(b["images"]), states=None if states is None else jnp.asarray(states),
        noise=jnp.asarray(noise), ddim_steps=3)
    got = toft.oft_inference_action(
        _port_model(tcfg, params), tcfg, torch.from_numpy(b["input_ids"]),
        torch.from_numpy(b["attention_mask"]), torch.from_numpy(b["images"]),
        states=None if states is None else torch.from_numpy(states),
        noise=torch.from_numpy(noise), ddim_steps=3)
    assert got.shape == (2, 4, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    if head == "Diffusion":
        assert np.abs(np.asarray(ref) - noise).max() > 0.05


def test_diffusion_cached_segment_equals_joint():
    """One DDIM step's segment against the frozen prompt cache (positions
    and groups from the prompt's length, its pads invalid) gives the joint
    prompt + segment run's hidden states."""
    _, tcfg = _pair("Diffusion", proprio=True)
    model = toft.build_oft(tcfg, "cpu", seed=3)
    b = _tensors(_batch(tcfg, 4))
    prompt = toft.prompt_embeds(model, tcfg, b["input_ids"], b["images"])
    x = torch.randn((2, 4, 3), generator=torch.Generator().manual_seed(5))
    ts = torch.full((2,), 90, dtype=torch.int32)
    seg = toft.action_segment(model, tcfg, 2, prompt.dtype, b["states"], x,
                              toft.sinusoidal_time_encoding(ts, tcfg.hidden))
    assert seg.shape[1] == tcfg.segment_len == 4 * 3 + 2
    joint = toft.run_with_segment(model, tcfg, prompt, b["attention_mask"], seg)
    cache = toft.prefill_prompt(model, tcfg, prompt, b["attention_mask"])
    assert torch.equal(cache["valid"], b["attention_mask"].int())
    cached = toft.run_with_segment(model, tcfg, None, b["attention_mask"], seg, cache=cache)
    torch.testing.assert_close(cached, joint, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("parity", [True, False])
def test_discrete_decode_slice_and_bins(parity):
    """The decode reads the last num_bins - 1 slots under reference_parity (a
    label's bin decodes one bin lower), all num_bins otherwise; bins round
    trip within one bin."""
    jcfg, tcfg = _pair("Discrete", reference_parity=parity)
    assert toft.decode_slots(tcfg) == joft.decode_slots(jcfg) == 64 - parity
    a = np.linspace(-1, 1, 24, dtype=np.float32).reshape(2, 4, 3)
    bins = toft.continuous_to_bins(torch.from_numpy(a), tcfg)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(joft.continuous_to_bins(
        jnp.asarray(a), jcfg)))
    back = toft.bins_to_continuous(bins.reshape(2, -1), tcfg).numpy()
    np.testing.assert_allclose(back, a, atol=1.1 / 63)
    # logits peaked at each label's vocab slot: decode lands on the label's bin,
    # shifted down by one under parity (the slice starts one slot later)
    V = tcfg.vlm.llm.vocab_size
    labels = bins.reshape(2, -1).long() + V - 64
    logits = torch.full((2, 12, V), -5.0).scatter_(-1, labels[..., None], 5.0)
    decoded = logits[..., -toft.decode_slots(tcfg):].argmax(-1)
    expect = (bins.reshape(2, -1) - int(parity)).clamp_min(0)
    hit = bins.reshape(2, -1) >= int(parity)
    np.testing.assert_array_equal(decoded[hit].numpy(), expect[hit].numpy())


def test_action_log_probs_match_jax_and_generate():
    jcfg, tcfg = _pair("Discrete", proprio=True)
    params = _jax_params(jcfg)
    b = _batch(jcfg, 6)
    bins = np.random.default_rng(7).integers(0, 63, (2, 12)).astype(np.int32)
    args = [b[k] for k in ("input_ids", "attention_mask", "images", "states")]
    ref_lp, ref_ent = joft.oft_action_log_probs(params, jcfg, *map(jnp.asarray, args),
                                               jnp.asarray(bins), temperature=0.7)
    model = _port_model(tcfg, params)
    targs = list(map(torch.from_numpy, args))
    lp, ent = toft.oft_action_log_probs(model, tcfg, *targs, torch.from_numpy(bins),
                                        temperature=0.7)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(ref_lp), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ent.detach().numpy(), np.asarray(ref_ent), rtol=TOL, atol=TOL)
    actions, drawn, logp = toft.oft_generate_action(
        model, tcfg, *targs, generator=torch.Generator().manual_seed(3), temperature=0.7)
    again = toft.oft_generate_action(model, tcfg, *targs,
                                     generator=torch.Generator().manual_seed(3), temperature=0.7)
    assert torch.equal(drawn, again[1]) and drawn.shape == (2, 12)
    assert actions.shape == (2, 4, 3) and torch.equal(actions, toft.bins_to_continuous(drawn, tcfg))
    recomputed, _ = toft.oft_action_log_probs(model, tcfg, *targs, drawn, temperature=0.7)
    torch.testing.assert_close(logp, recomputed.detach(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("head", ["L1", "Discrete"])
def test_goldens(head):
    """tests/golden_outputs.npz (test_golden.py's inputs, the JAX init of
    PRNGKey(0)) through the bridge and the port."""
    golden = np.load(GOLDEN)
    jcfg, tcfg = (dataclasses.replace(c, vlm=dataclasses.replace(
        c.vlm, projector_type="mlp2x_gelu")) for c in _pair(head))
    params = jax.device_get(joft.init_oft(jax.random.PRNGKey(0), jcfg))
    nt = jcfg.vlm.num_image_tokens
    ids = np.arange(1, nt + 9).reshape(1, -1).astype(np.int32)
    ids[:, :nt] = IMAGE_TOKEN_INDEX
    imgs = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 1, 28, 28, 3)))
    got = toft.oft_inference_action(_port_model(tcfg, params), tcfg, torch.from_numpy(ids),
                                    torch.ones(ids.shape, dtype=torch.int32),
                                    torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), golden[f"oft_{head.lower()}_actions"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("head", HEADS)
def test_bridge_round_trip(head):
    """Every JAX leaf lands in one port parameter (the MLPResNet's blocks, a
    Python list in JAX, one by one) and comes back unchanged."""
    jcfg, tcfg = _pair(head, proprio=True)
    params = _jax_params(jcfg)
    model = toft.build_oft(tcfg, "cpu", seed=1)
    mapping = load_jax_params(model, params)
    port = dict(model.named_parameters())
    assert set(mapping) == set(port)
    if head != "Discrete":
        mlp = "mlp" if head == "L1" else "noise_predictor"
        assert mapping[f"action_head.{mlp}.blocks.1.fc.weight"] == \
            f"action_head/{mlp}/blocks/1/fc/w"
    for name, val, _ in port_arrays(params):
        np.testing.assert_array_equal(port[name].detach().numpy(), val, err_msg=name)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list) and tree and isinstance(tree[0], dict):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _as_numpy(v):
    if isinstance(v, list):
        v = torch.stack(v)
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("head", HEADS)
def test_convert_oft_in_both_packages(head, tmp_path):
    """The bridged model under the reference's names (chip_smoke's writer,
    sharded safetensors): the JAX converter gives the JAX tree back exactly,
    the port's converter fills a fresh model with the same parameters."""
    jcfg, tcfg = _pair(head, proprio=True)
    jcfg = dataclasses.replace(jcfg, vlm=dataclasses.replace(
        jcfg.vlm, llm=dataclasses.replace(jcfg.vlm.llm, tie_embeddings=False)))
    tcfg = dataclasses.replace(tcfg, vlm=dataclasses.replace(
        tcfg.vlm, llm=dataclasses.replace(tcfg.vlm.llm, tie_embeddings=False)))
    params = _jax_params(jcfg)
    model = _port_model(tcfg, params)
    sd = chip_smoke.reference_state_dict(model, tcfg)
    assert "lm_head.weight" in sd
    assert any(k.startswith("model.action_head.proprio_projector.") for k in sd)
    chip_smoke.write_checkpoint(sd, str(tmp_path), shard_bytes=1 << 16)
    read = tconvert.load_torch_state_dict(str(tmp_path))
    jtree = jconvert.convert_oft({k: v.numpy() for k, v in read.items()}, jcfg)
    want = {p: np.asarray(v) for p, v in _leaves(params)}
    got = {p: np.asarray(v) for p, v in _leaves(jtree)}
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg="/".join(p))
    ttree = tconvert.convert_oft(read, tcfg)
    assert {p: _as_numpy(v).shape for p, v in _leaves(ttree)} == {p: v.shape
                                                                  for p, v in want.items()}
    fresh = toft.build_oft(tcfg, "cpu", seed=9)
    load_jax_params(fresh, ttree)
    ref = dict(model.named_parameters())
    for name, p in fresh.named_parameters():
        assert torch.equal(p, ref[name]), name


@pytest.mark.parametrize("head", HEADS)
def test_int8_leaves_and_chunk_match_jax(head):
    """quantize_model_ quantizes exactly the leaves JAX quantize_params does
    (the MLPResNet's blocks sized one by one, as the JAX list holds them;
    action_query never) and the int8 chunk matches JAX's on the same noise."""
    jcfg, tcfg = _pair(head, proprio=True)
    params = _jax_params(jcfg)
    min_size = 4096 + 1  # the blocks' 64 x 64 fc stay exact; a stacked pair would not
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, params), min_size=min_size,
                                pad_cols=False)
    model = _port_model(tcfg, params)
    quantize_model_(model, min_size=min_size)
    jax_q = {"/".join(p[:-1]) for p, _ in _leaves(jq) if p[-1] == "q"}
    port_q = {n for n, m in model.named_modules() if isinstance(m, (QuantLinear, QuantEmbedding))}
    port_q_as_jax = set()
    for n in port_q:
        parts = n.split(".")
        if parts[-1] == "embed":
            port_q_as_jax.add("/".join(parts + ["embedding"]))
        else:
            port_q_as_jax.add("/".join(parts + ["w"]))
    jax_q_unstacked = set()
    for p in jax_q:
        parts = p.split("/")
        if "layers" in parts:  # a stacked leaf: one port module a layer
            i = parts.index("layers")
            n = jcfg.vlm.llm.num_layers if parts[1] == "llm" else jcfg.vlm.vit.num_layers
            jax_q_unstacked |= {"/".join(parts[: i + 1] + [str(k)] + parts[i + 1:])
                                for k in range(n)}
        else:
            jax_q_unstacked.add(p)
    assert port_q_as_jax == jax_q_unstacked
    assert not any("blocks" in p for p in port_q_as_jax)
    assert not any("action_query" in p for p in port_q_as_jax)
    b, noise = _inference_inputs(jcfg)
    args = [b[k] for k in ("input_ids", "attention_mask", "images")]
    ref = joft.oft_inference_action(jq, jcfg, *map(jnp.asarray, args),
                                    states=jnp.asarray(b["states"]), noise=jnp.asarray(noise),
                                    ddim_steps=2)
    got = toft.oft_inference_action(model, tcfg, *map(torch.from_numpy, args),
                                    states=torch.from_numpy(b["states"]),
                                    noise=torch.from_numpy(noise), ddim_steps=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# The exp and the server
# ---------------------------------------------------------------------------


def _exp(head="L1", proprio=True, **kw):
    model = dict(llm_preset="test", vit_preset="test", action_model_type=head, action_dim=3,
                 chunk_size=4, num_bins=64, seed=5)
    if proprio:
        model.update(use_proprio=True, proprio_dim=5)
    return OFTExp(model=OFTModelConfig(**{**model, **kw}),
                  data=base_exp.DataConfig(image_processor="28"), device="cpu")


def _png(color) -> bytes:
    buf = io.BytesIO()
    Image.new("RGB", (40, 30), color).save(buf, "PNG")
    return buf.getvalue()


def _post(port, prompt, pngs, states=None, batch_size=1):
    b = "XBX"
    fields = {"text": prompt, "batch_size": str(batch_size)}
    if states is not None:
        fields["states"] = states
    body = b"".join(f"--{b}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n{v}\r\n".encode()
                    for k, v in fields.items())
    for png in pngs:
        body += (f"--{b}\r\nContent-Disposition: form-data; name=\"im\"; filename=\"f.png\"\r\n"
                 f"Content-Type: image/png\r\n\r\n").encode() + png + b"\r\n"
    body += f"--{b}--\r\n".encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/process_frame", data=body,
                                 headers={"Content-Type": f"multipart/form-data; boundary={b}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.asarray(json.loads(r.read()))


def _direct(exp, cfg, model, tok, prompts, pngs, states, gen):
    """The request by hand: ids padded to the 64-token bucket, the frames
    preprocessed on the host, the states as given."""
    rows = [_cogact_prompt_ids(exp, cfg, tok, p) for p in prompts]
    L = -(-max(len(r) for r in rows) // 64) * 64
    ids, valid = np.zeros((len(rows), L), np.int32), np.zeros((len(rows), L), np.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        valid[i, : len(r)] = 1
    imgs = _cogact_images(pngs, exp.data.build_image_processor())[:, None]
    out = toft.oft_inference_action(model, cfg, torch.from_numpy(ids), torch.from_numpy(valid),
                                    torch.from_numpy(imgs), states=torch.from_numpy(states),
                                    generator=gen)
    return out.numpy()


@pytest.fixture(scope="module", params=["L1", "Diffusion"])
def served(request):
    exp = _exp(request.param)
    cfg, model, norms = exp.load_for_inference()
    return exp, cfg, model, exp.tokenizer.build_tokenizer()


def _serve(served, **kw):
    exp, cfg, model, tok = served
    server = OFTServer(exp, cfg, model, tok, None, host="127.0.0.1", port=0, **kw)
    return server, server.serve_background()


def test_process_frame_equals_direct_call(served):
    """One frame with a JSON state, then batch_size=2 with two states (the
    second too long: cut to proprio_dim)."""
    exp, cfg, model, tok = served
    server, httpd = _serve(served)
    port = httpd.server_address[1]
    try:
        one = _post(port, "stack the bowls", [_png((10, 200, 30))], "[0.3, -0.2, 0.1]")
        two = _post(port, "stack the cups;open the drawer", [_png((1, 2, 3)), _png((200, 9, 9))],
                    "[0.1, 0.2];[1, 2, 3, 4, 5, 6, 7]", batch_size=2)
    finally:
        httpd.shutdown()
        httpd.server_close()
    gen = torch.Generator().manual_seed(exp.model.seed)
    s1 = np.zeros((1, 5), np.float32)
    s1[0, :3] = [0.3, -0.2, 0.1]
    want1 = _direct(exp, cfg, model, tok, ["stack the bowls"], [_png((10, 200, 30))], s1, gen)
    s2 = np.zeros((2, 5), np.float32)
    s2[0, :2] = [0.1, 0.2]
    s2[1] = [1, 2, 3, 4, 5]
    want2 = _direct(exp, cfg, model, tok, ["stack the cups", "open the drawer"],
                    [_png((1, 2, 3)), _png((200, 9, 9))], s2, gen)
    assert one.shape == (4, 3) and two.shape == (2, 4, 3)
    np.testing.assert_allclose(one, want1[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(two, want2, rtol=1e-6, atol=1e-6)


def test_micro_batched_requests(served):
    """Three concurrent single frames: one padded device call of micro_batch
    rows (the first row repeated), each request its own state and chunk."""
    exp, cfg, model, tok = served
    server, httpd = _serve(served, micro_batch=4, micro_batch_window_ms=300.0)
    port = httpd.server_address[1]
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=3) as ex:
            outs = list(ex.map(lambda i: _post(port, "stack the bowls", [_png((60, 90, 10))],
                                               json.dumps([float(i), 1.0])), range(3)))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert server.batched_calls >= 1
    assert all(o.shape == (4, 3) and np.isfinite(o).all() for o in outs)
    if cfg.action_model_type == "L1":  # deterministic: each row its own state's chunk
        for i, o in enumerate(outs):
            s = np.zeros((1, 5), np.float32)
            s[0, :2] = [i, 1.0]
            want = _direct(exp, cfg, model, tok, ["stack the bowls"], [_png((60, 90, 10))], s,
                           None)
            np.testing.assert_allclose(o, want[0], rtol=1e-5, atol=1e-5)


def test_exp_has_no_inference_single():
    with pytest.raises(NotImplementedError):
        _exp().inference_single()


@pytest.mark.parametrize("recipe,cls", [("oft", "LiberoOFTExp"),
                                        ("oft_discrete", "LiberoOFTDiscreteExp")])
def test_libero_oft_recipes_match_jax(recipe, cls):
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


def test_discrete_exp_labels_match_jax():
    """OFTDiscreteExp's loss maps the actions to the last num_bins vocab slots
    as the JAX exp's build_model does."""
    jcfg, tcfg = _pair("Discrete")
    a = np.tanh(np.random.default_rng(0).standard_normal((2, 6, 3))).astype(np.float32)
    want = joft.continuous_to_bins(jnp.asarray(a)[:, :4], jcfg).reshape(2, -1) + 512 - 64
    np.testing.assert_array_equal(discrete_labels(torch.from_numpy(a), tcfg).numpy(),
                                  np.asarray(want))


@pytest.fixture
def oft_suite(tmp_path):
    from dexbotic_tpu_torch.data import registry as tregistry

    root = str(tmp_path / "data" / "oft")
    os.makedirs(root)
    rng = np.random.RandomState(0)
    for e in range(3):
        lines = []
        for t in range(12):
            Image.new("RGB", (64, 48), (e * 30, t * 15, 80)).save(f"{root}/e{e}f{t}.png")
            lines.append(json.dumps({
                "images_1": {"type": "image", "url": f"e{e}f{t}.png"},
                "state": (np.sin(np.arange(7) + t * 0.3) + 0.01 * rng.randn(7)).tolist(),
                "prompt": "stack the bowls", "is_robot": True}))
        with open(f"{root}/e{e}.jsonl", "w") as f:
            f.write("\n".join(lines))
    tregistry.register_dataset({"suite": {"data_path_prefix": root, "annotations": root,
                                          "frequency": 1}},
                               prefix="oft", meta_data={"non_delta_mask": [6],
                                                        "periodic_mask": None,
                                                        "periodic_range": None})
    return "oft_suite"


@pytest.mark.parametrize("head", HEADS)
def test_exp_train_checkpoint_then_serve(head, tmp_path, oft_suite, monkeypatch):
    """OFTExp.train() (proprio from the suite's 7-dof states) -> checkpoint-2
    -> load_for_inference -> one /process_frame request with a state."""
    monkeypatch.chdir(tmp_path)

    def make_exp(**kw):
        exp = _exp(head, proprio=True, action_dim=7, proprio_dim=7, **kw)
        exp.action = base_exp.ActionConfig(trajectory_length=4, padding_action=True)
        exp.data = base_exp.DataConfig(dataset_name=oft_suite, image_processor="28",
                                       data_keys=["input_ids", "labels", "action", "image",
                                                  "state"])
        exp.tokenizer = base_exp.TokenizerConfig(model_max_length=96)
        exp.trainer = TrainerConfig(output_dir=str(tmp_path / "out"), max_steps=2,
                                    per_device_batch_size=2, logging_steps=1, save_steps=2,
                                    bf16=False, resume=False, gradient_checkpointing=True)
        exp.optimizer = OptimizerConfig(learning_rate=1e-4)
        return exp

    log = make_exp().train()
    assert log["step"] == 2 and np.isfinite(log["loss"]) and np.isfinite(log["grad_norm"])
    ckpt = tmp_path / "out" / "checkpoint-2"
    exp = make_exp(model_name_or_path=str(ckpt))
    cfg, model, norms = exp.load_for_inference()
    assert norms is not None and len(norms["min"]) == 7
    server = OFTServer(exp, cfg, model, exp.tokenizer.build_tokenizer(), norms,
                       host="127.0.0.1", port=0)
    httpd = server.serve_background()
    try:
        chunk = _post(httpd.server_address[1], "stack the bowls", [_png((40, 90, 10))],
                      json.dumps([0.1] * 7))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert chunk.shape == (4, 7) and np.isfinite(chunk).all()
    lo, hi = np.asarray(norms["min"]), np.asarray(norms["max"])
    assert np.all(chunk >= lo - 1e-6) and np.all(chunk <= hi + 1e-6)


def test_replay_script_runs_an_oft_release(tmp_path):
    """script/replay_checkpoint_torch.py's OFT branch on a tiny release of the
    Diffusion head with proprio: the LIBERO twin's exp with the config.json
    dims, the release's weights in the serving dtypes, and the replayed chunk
    is the source model's on the same frame, state and noise."""
    from script import replay_checkpoint_torch as replay

    seeded = _exp("Diffusion", proprio=True, proprio_dim=8)
    cfg, source, _ = seeded.load_for_inference()
    dims = {"action_dim": 3, "chunk_size": 4, "action_model_type": "Diffusion"}
    chip_smoke.write_checkpoint(chip_smoke.reference_state_dict(source, cfg), str(tmp_path),
                                config=dims)
    exp = replay.build_exp("oft", str(tmp_path), device="cpu")
    assert (exp.model.action_dim, exp.model.chunk_size, exp.model.action_model_type,
            exp.model.proprio_dim) == (3, 4, "Diffusion", 8)
    exp.model = dataclasses.replace(exp.model, llm_preset="test", vit_preset="test",
                                    num_bins=64)
    exp.data = seeded.data
    got_cfg, model, norms, times = replay.load_converted(exp)
    assert norms is None and set(times) == {"load_s", "convert_s"}
    for (n, p), (_, q) in zip(model.named_parameters(), source.named_parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), n
    frame = replay.load_image(None)
    chunk, den = replay.replay_oft(exp, got_cfg, model, None, frame, "stack the bowls",
                                   state=[0.5] * 8)
    want, _ = replay.replay_oft(exp, got_cfg, source, None, frame, "stack the bowls",
                                state=[0.5] * 8)
    assert chunk.shape == (4, 3) and den is None
    np.testing.assert_array_equal(chunk, want)
