"""Int8 and w8a8 serving of the token-decoding policies (Discrete VLA and
MUVLA) against the JAX package, on the CPU.

* The served tree: one JAX init (the exp's ``model.build_params``) carried
  into the port by ``utils/bridge.py``, then each package's
  ``inference_quantize`` path (JAX ``prepare_inference_params``, the port's
  ``load_for_inference``): every served leaf bit for bit, the int8 ``q`` and
  the scales ``s`` among them, in "int8" and "w8a8" at min_size 0 and at the
  default (which none of the tiny models' weights reaches: they stay bf16).
* With both served trees' floating leaves cast to fp32 (the int8 ``q``
  kept; the tiny models' logits lie within bf16 rounding of each other, so
  bf16 orders of summation decide ties): the inference path's greedy tokens
  (Discrete VLA: ``generate`` and the actions
  ``discrete_vla_inference_action`` parses from them with a digit
  tokenizer; MUVLA: ``muvla_generate``) equal JAX's on three seeded inputs,
  and the prompt's logits agree within 1e-3.
* The port's decode engine over the quantized model (2 slots, one-shot and
  chunked admission) gives each request ``generate``'s tokens alone; at one
  case the JAX engine's too.
* chip_smoke 14e/14f's route counts (``quant_route_counts``, from the model,
  the engine's admissions and ticks and the ``generate`` calls) equal what
  the dispatch rule gives every quantized product the served requests make
  (``quant_routes_seen``, forward hooks), on the tiny models.

Mode "w8a8" sets ``W8A8_MIN_ROWS`` to 2048 in both packages (a process-wide
global, as in JAX); these tests then lower it to ``W8A8_TEST_ROWS`` in both,
so that the tiny prompts' prefills and admissions cross it, and restore it.
Tiny models: the 2-layer test LLM (tied embedding), the test ViT, MUVLA's
fuser of 32 and 6 history queries.
"""

import contextlib
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _engine import hold_admissions
from dexbotic_tpu.constants import IMAGE_TOKEN_INDEX
from dexbotic_tpu.exp import base_exp as jbase
from dexbotic_tpu.exp import decode_engine as jengine
from dexbotic_tpu.exp import discrete_vla_exp as jdexp
from dexbotic_tpu.exp import muvla_exp as jmexp
from dexbotic_tpu.models import discrete_vla as jdv
from dexbotic_tpu.models import generate as jgen
from dexbotic_tpu.models import muvla as jmu
from dexbotic_tpu.models import vlm as jvlm
from dexbotic_tpu.nn import transformer as jtr
from dexbotic_tpu.ops import quant_matmul as jqm
from dexbotic_tpu_torch.exp import base_exp as tbase
from dexbotic_tpu_torch.exp import discrete_vla_exp as tdexp
from dexbotic_tpu_torch.exp import muvla_exp as tmexp
from dexbotic_tpu_torch.exp import serve as tserve
from dexbotic_tpu_torch.exp.decode_engine import ContinuousBatchingEngine
from dexbotic_tpu_torch.models import discrete_vla as tdv
from dexbotic_tpu_torch.models import generate as tgen
from dexbotic_tpu_torch.models import muvla as tmu
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.nn import core as tcore
from dexbotic_tpu_torch.nn import transformer as ttr
from dexbotic_tpu_torch.ops import quant as tquant
from dexbotic_tpu_torch.ops import quant_matmul as tqm
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

torch.set_num_threads(2)
TOL = 1e-3
W8A8_TEST_ROWS = 16  # the prompts' prefills (>= 16 rows) take W8A8, the decode rows do not
NEW = 8
MUVLA_TINY = dict(llm_preset="test", vit_preset="test", obs_vit_preset="test", inter_dim=32,
                  num_history_queries=6, fuse_heads=4)
CASES = [(policy, mode, min_size) for policy in ("discrete", "muvla") for mode in ("int8", "w8a8")
         for min_size in (0, tquant.DEFAULT_MIN_SIZE)]


def _exps(policy: str, mode: str, min_size: int):
    """(JAX exp, port exp) of one policy at the tiny widths, serving ``mode``."""
    q = dict(inference_quantize=mode, inference_quantize_min_size=min_size)
    if policy == "discrete":
        kw = dict(llm_preset="test", vit_preset="test")
        return (jdexp.DiscreteVLAExp(model=jdexp.DiscreteVLAModelConfig(**kw),
                                     tokenizer=jbase.TokenizerConfig(model_max_length=96),
                                     data=jbase.DataConfig(image_processor="28"), **q),
                tdexp.DiscreteVLAExp(model=tdexp.DiscreteVLAModelConfig(**kw),
                                     tokenizer=tbase.TokenizerConfig(model_max_length=96),
                                     data=tbase.DataConfig(image_processor="28"), device="cpu",
                                     **q))
    return (jmexp.MUVLAExp(model=jmexp.MUVLAModelConfig(**MUVLA_TINY),
                           data=jbase.DataConfig(image_processor="28"), **q),
            tmexp.MUVLAExp(model=tmexp.MUVLAModelConfig(**MUVLA_TINY),
                           data=tbase.DataConfig(image_processor="28"), device="cpu", **q))


@contextlib.contextmanager
def _w8a8_rows():
    """Both packages' W8A8 global restored on the way out."""
    old = (jqm.W8A8_MIN_ROWS, tqm.W8A8_MIN_ROWS)
    try:
        yield
    finally:
        jqm.W8A8_MIN_ROWS, tqm.W8A8_MIN_ROWS = old


def _served(policy: str, mode: str, min_size: int, monkeypatch):
    """(JAX exp, port exp, JAX config, port config, JAX served tree, port
    served model): the JAX exp's own seeded init, served by
    ``prepare_inference_params``; the port's ``load_for_inference`` with the
    model it builds filled from that init.  Call inside :func:`_w8a8_rows`."""
    jx, tx = _exps(policy, mode, min_size)
    jcfg = jx.model.build_config()
    params = jax.device_get(jx.model.build_params(jcfg))
    jq = jax.device_get(jx.prepare_inference_params(params))
    mod, name = (tdexp, "build_discrete_vla") if policy == "discrete" else (tmexp, "build_muvla")
    build = getattr(mod, name)

    def from_jax(cfg, device, seed=0, prepare=None):
        model = build(cfg, device, seed=seed, prepare=prepare)
        load_jax_params(model, params)
        return model

    monkeypatch.setattr(mod, name, from_jax)
    tcfg, model, _ = tx.load_for_inference()
    if policy == "discrete":
        jcfg = dataclasses.replace(jcfg, max_new_tokens=NEW)
        tcfg = dataclasses.replace(tcfg, max_new_tokens=NEW)
    if mode == "w8a8":
        assert jqm.W8A8_MIN_ROWS == tqm.W8A8_MIN_ROWS == 2048
        jqm.W8A8_MIN_ROWS = tqm.W8A8_MIN_ROWS = W8A8_TEST_ROWS
    else:
        assert jqm.W8A8_MIN_ROWS is None and tqm.W8A8_MIN_ROWS is None
    return jx, tx, jcfg, tcfg, jq, model


def _bits(x) -> np.ndarray:
    """A leaf's bits: bf16 as uint16, everything else as it is."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _inputs(policy: str, seed: int) -> dict:
    """One seeded request: prompt ids with the image slots (>= W8A8_TEST_ROWS
    rows) and its images, as numpy."""
    rs = np.random.RandomState(seed)
    n_img = 4 if policy == "discrete" else 4 + 6  # the current view's tokens (+ 6 history queries)
    ids = rs.randint(3, 400, n_img + 14).astype(np.int32)
    ids[:n_img] = IMAGE_TOKEN_INDEX
    if policy == "discrete":
        return {"ids": ids[None], "images": rs.randn(1, 1, 28, 28, 3).astype(np.float32)}
    return {"ids": ids[None], "map": rs.randn(1, 28, 28, 3).astype(np.float32),
            "obs": rs.randn(1, 3, 28, 28, 3).astype(np.float32)}


def _jax_tokens(policy, jcfg, jq, inp):
    ids = jnp.asarray(inp["ids"])
    valid = jnp.ones_like(ids)
    if policy == "discrete":
        toks, _ = jgen.generate(jq["vlm"], jcfg.vlm, ids, valid, jnp.asarray(inp["images"]), NEW, 2)
    else:
        toks, _ = jmu.muvla_generate(jq, jcfg, ids, valid, jnp.asarray(inp["map"]),
                                     jnp.asarray(inp["obs"]), NEW, 2)
    return np.asarray(toks)


def _port_tokens(policy, tcfg, model, inp):
    ids = torch.from_numpy(inp["ids"])
    valid = torch.ones_like(ids)
    if policy == "discrete":
        toks, _ = tgen.generate(model.vlm, tcfg.vlm, ids, valid, torch.from_numpy(inp["images"]),
                                NEW, 2)
    else:
        toks, _ = tmu.muvla_generate(model, tcfg, ids, valid, torch.from_numpy(inp["map"]),
                                     torch.from_numpy(inp["obs"]), NEW, 2)
    return toks.numpy()


def _jax_prompt_logits(policy, jcfg, tree, inp):
    ids = jnp.asarray(inp["ids"])
    valid = jnp.ones_like(ids)
    if policy == "discrete":
        hidden, _ = jvlm.vlm_forward(tree["vlm"], jcfg.vlm, ids, valid,
                                     images=jnp.asarray(inp["images"]))
        return np.asarray(jtr.lm_logits(tree["vlm"]["llm"], jcfg.vlm.llm, hidden))
    fused = jmu.fuse_obs_with_history(tree, jcfg, jnp.asarray(inp["map"]), jnp.asarray(inp["obs"]))
    embeds = jvlm.splice_image_embeds({"llm": tree["llm"]}, jcfg.vlm, ids, fused)
    hidden, _ = jvlm.vlm_forward(tree, jcfg.vlm, ids, valid, inputs_embeds=embeds)
    return np.asarray(jtr.lm_logits(tree["llm"], jcfg.vlm.llm, hidden))


def _port_prompt_logits(policy, tcfg, model, inp):
    ids = torch.from_numpy(inp["ids"])
    valid = torch.ones_like(ids)
    if policy == "discrete":
        hidden = tvlm.vlm_forward(model.vlm, tcfg.vlm, ids, valid,
                                  images=torch.from_numpy(inp["images"]))
        return ttr.lm_logits(model.vlm.llm, tcfg.vlm.llm, hidden).numpy()
    fused = tmu.fuse_obs_with_history(model, tcfg, torch.from_numpy(inp["map"]),
                                      torch.from_numpy(inp["obs"]))
    embeds = tvlm.splice_image_embeds(model, tcfg.vlm, ids, fused)
    hidden = tvlm.vlm_forward(model, tcfg.vlm, ids, valid, inputs_embeds=embeds)
    return ttr.lm_logits(model.llm, tcfg.vlm.llm, hidden).numpy()


@pytest.mark.parametrize("policy,mode,min_size", CASES)
def test_quantized_serving_matches_jax(policy, mode, min_size, monkeypatch):
    """The served tree bit for bit, the greedy tokens (and Discrete VLA's
    actions) on three inputs exactly, the prompt's fp32 logits within 1e-3."""
    with _w8a8_rows():
        jx, tx, jcfg, tcfg, jq, model = _served(policy, mode, min_size, monkeypatch)
        params = dict(model.named_parameters())
        n_quant = 0
        for name, val, path in port_arrays(jq):
            got = params.pop(name).detach()
            np.testing.assert_array_equal(_bits(got), _bits(val), err_msg=name)
            n_quant += name.endswith(".q")
        assert not params, sorted(params)[:4]
        n_mods = sum(tquant.is_quantized(m) for m in model.modules())
        assert n_quant == n_mods
        assert (n_mods > 0) == (min_size == 0)
        if min_size == 0:
            emb = model.vlm.llm.embed if policy == "discrete" else model.llm.embed
            assert isinstance(emb, tcore.QuantEmbedding)  # the tied table, per-row scales

        # both served trees with every floating leaf in fp32 (q stays int8):
        # the tiny models' logits sit within bf16 rounding of each other
        j32 = jax.tree.map(lambda x: np.asarray(x, np.float32)
                           if np.asarray(x).dtype.name in ("bfloat16", "float32") else x, jq)
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.float()
        for seed in (1, 2, 3):
            inp = _inputs(policy, seed)
            want = _jax_tokens(policy, jcfg, j32, inp)
            np.testing.assert_array_equal(_port_tokens(policy, tcfg, model, inp), want)
        if policy == "discrete":  # the exp's inference function: the actions parsed from them
            ttok = chip_smoke.DigitDecode(tx.tokenizer.build_tokenizer())
            jtok = chip_smoke.DigitDecode(jx.tokenizer.build_tokenizer())
            inp = _inputs(policy, 1)
            got = tdv.discrete_vla_inference_action(
                model, tcfg, ttok, torch.from_numpy(inp["ids"]),
                torch.ones(inp["ids"].shape, dtype=torch.int32),
                torch.from_numpy(inp["images"]), 2)
            want = jdv.discrete_vla_inference_action(
                j32, jcfg, jtok, jnp.asarray(inp["ids"]), jnp.ones(inp["ids"].shape, jnp.int32),
                jnp.asarray(inp["images"]), eos_token_id=2)
            np.testing.assert_array_equal(got, want)
        inp = _inputs(policy, 4)
        want = _jax_prompt_logits(policy, jcfg, j32, inp)
        got = _port_prompt_logits(policy, tcfg, model, inp)
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _engine_requests(policy, tx, tcfg, model, n=3):
    """The server's inputs of n requests: the prompts' ids, and the images
    (Discrete VLA) or the spliced fp32 prompt embeds (MUVLA), as the
    servers hand them to the engine."""
    reqs = []
    for seed in range(n):
        inp = _inputs(policy, 10 + seed)
        if policy == "discrete":
            reqs.append((inp["ids"][0], dict(images=inp["images"][0])))
            continue
        ids = torch.from_numpy(inp["ids"])
        fused = tmu.fuse_obs_with_history(model, tcfg, torch.from_numpy(inp["map"]),
                                          torch.from_numpy(inp["obs"]))
        embeds = tvlm.splice_image_embeds(model, tcfg.vlm, ids, fused)
        reqs.append((inp["ids"][0], dict(embeds=embeds[0].float())))
    return reqs


def _serve(engine, reqs):
    """Every request submitted from its own thread, at once."""
    out = [None] * len(reqs)

    def run(i):
        ids, kw = reqs[i]
        out[i] = engine.submit(ids, timeout=300, **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


def _generate_alone(policy, tcfg, model, ids, kw, eos):
    ids_t = torch.from_numpy(ids)[None]
    valid = torch.ones_like(ids_t)
    vlm = model.vlm if policy == "discrete" else model
    if policy == "discrete":
        toks, _ = tgen.generate(vlm, tcfg.vlm, ids_t, valid, torch.from_numpy(kw["images"])[None],
                                NEW, eos)
    else:  # generate's route: the spliced embeds in the model's dtype
        toks, _ = tgen.generate(vlm, tcfg.vlm, ids_t, valid, None, NEW, eos,
                                inputs_embeds=kw["embeds"][None].to(torch.bfloat16))
    toks = toks[0].tolist()
    return toks[: toks.index(eos) + 1] if eos in toks else toks


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("policy,mode", [("discrete", "int8"), ("discrete", "w8a8"),
                                         ("muvla", "int8"), ("muvla", "w8a8")])
def test_engine_over_the_quantized_model_matches_generate(policy, mode, chunk, monkeypatch):
    """Three concurrent requests through a 2-slot engine over the quantized
    model (admitted once all three are queued; a slot reused), one-shot or
    chunked: each request's tokens equal its own ``generate`` alone; at one
    case also the JAX engine's over the JAX served tree."""
    with _w8a8_rows():
        jx, tx, jcfg, tcfg, jq, model = _served(policy, mode, 0, monkeypatch)
        vlm = model.vlm if policy == "discrete" else model
        reqs = _engine_requests(policy, tx, tcfg, model)
        eng = ContinuousBatchingEngine(vlm, tcfg.vlm, slots=2, max_prompt=64, max_new=NEW,
                                       eos_token_id=-1, steps_per_tick=2,
                                       prefill_chunk=chunk or None)
        hold_admissions(eng, len(reqs))
        try:
            got = _serve(eng, reqs)
            assert eng.batched_steps > 0
            assert {c for *_, c in eng.admit_log} == {bool(chunk)}
        finally:
            eng.close()
        assert got == [_generate_alone(policy, tcfg, model, ids, kw, -1) for ids, kw in reqs]
        if policy == "discrete" and mode == "int8" and not chunk:
            jeng = jengine.ContinuousBatchingEngine(jq["vlm"], jcfg.vlm, slots=2, max_prompt=64,
                                                    max_new=NEW, eos_token_id=-1,
                                                    temperature=0.0, steps_per_tick=2)
            try:
                assert _serve(jeng, reqs) == got
            finally:
                jeng.close()


class SilentTokenizer(chip_smoke.DigitDecode):
    """Decodes every text to one without digits: the retries always run."""

    def decode(self, ids):
        return "no action"


def _requests_at_once(server, reqs):
    """Every (fields, files) request through the server's get_response from
    its own thread, at once."""
    out = [None] * len(reqs)

    def run(i):
        out[i] = server.get_response(*reqs[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
@pytest.mark.parametrize("policy", ["discrete", "muvla"])
def test_chip_smoke_quant_route_counts_match_the_rule(policy, mode, monkeypatch):
    """chip_smoke 14e/14f on the tiny quantized models: three requests built
    as 14e and 14f build theirs (chip_smoke's frames and prompts) through
    the servers' engines (2 slots; Discrete VLA chunked, with retries that
    always run), and ``quant_route_counts`` of the model's passes (the
    engine's admissions and ticks, the generate calls, MUVLA's fuses)
    equal the routes the dispatch rule gives the calls the hooks saw, the
    rule read as on the card (``quant_route`` given "cuda" for every
    product).  On the CPU quant_linear takes the dequantize formulation
    where the card takes K4, and W8A8 as on the card."""
    real_route = chip_smoke.quant_route
    monkeypatch.setattr(chip_smoke, "quant_route",
                        lambda rows, K, N, device: real_route(rows, K, N, "cuda"))
    with _w8a8_rows():
        _, tx, _, tcfg, _, model = _served(policy, mode, 0, monkeypatch)
        tok = SilentTokenizer(tx.tokenizer.build_tokenizer())
        gens: list = []
        if policy == "discrete":
            cfg = dataclasses.replace(tcfg, max_retries=1)
            server = tserve.DiscreteVLAServer(tx, cfg, model, tok, host="127.0.0.1", port=0,
                                              continuous_batching=2, prefill_chunk=16)
            reqs = [({"text": chip_smoke.LIBERO_PROMPT}, [("f", chip_smoke._frame_png(200 + i))])
                    for i in range(3)]
            prompt = len(server._prepare(*reqs[0])[0])
        else:
            server = tserve.MUVLAServer(tx, tcfg, model, tok, max_new_tokens=NEW,
                                        continuous_batching=2)
            reqs = [({"text": chip_smoke.MUVLA_INSTRUCTIONS[i]},
                     [("f", chip_smoke._frame_png(300 + 4 * i + v)) for v in range(4)])
                    for i in range(3)]
            prompt = server._prepare(*reqs[0])[0].shape[1]
        eng = server.engine
        probe = chip_smoke.EngineProbe(eng, lambda ids, images, embeds: tuple(np.asarray(ids)))
        try:
            with (chip_smoke.generate_calls(tdv, gens),
                  chip_smoke.quant_routes_seen(model) as seen, chip_smoke.quant_calls() as calls):
                replies = _requests_at_once(server, reqs)
        finally:
            server.close()
        assert all(r is not None for r in replies)
        vlm = model.vlm if policy == "discrete" else model
        passes = chip_smoke.engine_passes(vlm, tcfg.vlm, eng, eng.admit_log, len(probe.ticks),
                                          prompt, 1 if policy == "discrete" else 0)
        if policy == "discrete":
            assert len(gens) == 2 * len(reqs) and {c[3] for c in gens} == {0.0, 1.0}
            for _, n_prompt, new, *_ in gens:
                passes += chip_smoke.generate_passes(vlm, tcfg.vlm, n_prompt, new, 1)
            assert {c for *_, c in eng.admit_log} == {True}
        else:
            assert not gens
            passes += chip_smoke.muvla_fuse_passes(model, tcfg, 3) * len(reqs)
        want = chip_smoke.quant_route_counts(passes)
        assert seen.routes() == want
        assert want["k4"] > 0 and want["dequant"] > 0 and (want["w8a8"] > 0) == (mode == "w8a8")
        assert dict(calls) == {"k4": 0, "dequant": want["dequant"] + want["k4"],
                               "w8a8": want["w8a8"]}
