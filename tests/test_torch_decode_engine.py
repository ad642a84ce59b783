"""The port's continuous-batching decode engine against the JAX package, on the CPU.

* ``mot_forward``'s per-row cache columns (``write_cols``): equal to the
  shared-cursor path where the columns coincide and to JAX's at different
  columns a row; a write past the cache's end is dropped, as XLA's scatter
  drops it, for a parked row (all of a chunk's columns past the end), a
  finished row (one token at column C) and a row that crosses the end.
* ``ContinuousBatchingEngine``'s greedy tokens equal the JAX engine's and
  the port's ``generate``: one-shot admission, chunked admission, a slot
  reused after a longer prompt, EOS early, ``max_new`` that differs between
  slots, and the pre-spliced embeds route; concurrent clients coalesce.
* A failed step fails the in-flight requests (their clients get the error)
  and the engine serves again; a dead loop fails later submits at once.

Tiny models: the 2-layer test LLM and the test ViT (4 image tokens).
Tolerance 1e-5 (fp32 caches) unless stated; tokens exact.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexbotic_tpu.constants import IMAGE_TOKEN_INDEX
from dexbotic_tpu.exp import decode_engine as jengine
from dexbotic_tpu.models import generate as jgen
from dexbotic_tpu.models import presets as jpresets
from dexbotic_tpu.models import vlm as jvlm
from dexbotic_tpu.nn import transformer as jtf
from dexbotic_tpu_torch.exp import decode_engine as tengine
from dexbotic_tpu_torch.models import generate as tgen
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.nn import transformer as ttf
from dexbotic_tpu_torch.utils.bridge import load_jax_params

from _engine import hold_admissions

torch.set_num_threads(2)
JCFG = jvlm.VLMConfig(llm=jpresets.LLM_TEST, vit=jpresets.VIT_TEST)
TCFG = tvlm.VLMConfig(llm=tpresets.LLM_TEST, vit=tpresets.VIT_TEST)
NT = TCFG.num_image_tokens


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def pair():
    params = jax.device_get(jvlm.init_vlm(jax.random.PRNGKey(0), JCFG))
    model = tvlm.VLM(TCFG)
    load_jax_params(model, params)
    return params, model.eval().requires_grad_(False)


def _prompt(rs, text_len):
    ids = rs.randint(1, 400, NT + text_len).astype(np.int32)
    ids[:NT] = IMAGE_TOKEN_INDEX
    return ids, rs.randn(1, 28, 28, 3).astype(np.float32)


def _generate(model, ids, img, T, eos=-1):
    toks, _ = tgen.generate(model, TCFG, _t(ids)[None], torch.ones(1, len(ids), dtype=torch.int32),
                            _t(img)[None], T, eos)
    return toks[0].tolist()


def _serve(eng, prompts, max_new=None, **kw):
    """Every prompt submitted from its own thread, at once."""
    out = [None] * len(prompts)

    def run(i):
        ids, img = prompts[i]
        out[i] = eng.submit(ids, images=img, max_new=None if max_new is None else max_new[i],
                            timeout=300, **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


# ---------------------------------------------------------------------------
# write_cols
# ---------------------------------------------------------------------------


def _prefilled(params, model, B, P, C, seed=1):
    """Both packages' fp32 caches of C columns after a P-token prefill."""
    cfg_j, cfg_t = jpresets.LLM_TEST, tpresets.LLM_TEST
    rs = np.random.RandomState(seed)
    x = rs.randn(B, P, cfg_t.hidden_size).astype(np.float32)
    valid = np.ones((B, P), np.int32)
    grp = np.cumsum(valid, 1).astype(np.int32)
    jc = jtf.init_kv_cache(cfg_j, B, C, dtype=jnp.float32)
    _, jc = jtf.mot_forward([jtf.Stream(cfg_j, params["llm"], jnp.asarray(x))], grp - 1, grp,
                            valid, cache=jc, update_cache=True)
    tc = ttf.init_kv_cache(cfg_t, B, C, dtype=torch.float32)
    _, tc = ttf.mot_forward([ttf.Stream(cfg_t, model.llm, _t(x))], _t(grp - 1), _t(grp),
                            _t(valid), cache=tc, update_cache=True)
    return jc, tc, rs


def _step_both(params, model, jc, tc, tok, pos, valid, cols):
    cfg_j, cfg_t = jpresets.LLM_TEST, tpresets.LLM_TEST
    jo, jc2 = jtf.mot_forward([jtf.Stream(cfg_j, params["llm"], jnp.asarray(tok))], pos, pos + 1,
                              valid, cache=jc, update_cache=True,
                              write_cols=None if cols is None else jnp.asarray(cols))
    to, tc2 = ttf.mot_forward([ttf.Stream(cfg_t, model.llm, _t(tok))], _t(pos), _t(pos + 1),
                              _t(valid), cache=tc, update_cache=True,
                              write_cols=None if cols is None else _t(cols))
    return jo[0], jc2, to[0], tc2


def test_write_cols_matches_cursor_path(pair):
    """One token a row at column P through write_cols equals the cursor
    path's write there and JAX's write_cols; ``length`` stays."""
    params, model = pair
    B, P = 2, 8
    jc, tc, rs = _prefilled(params, model, B, P, P + 2)
    tok = rs.randn(B, 1, 64).astype(np.float32)
    pos = np.full((B, 1), P, np.int32)
    v1 = np.ones((B, 1), np.int32)
    _, _, out_a, cache_a = _step_both(params, model, jc, {k: (v.clone() if torch.is_tensor(v)
                                                              else v) for k, v in tc.items()},
                                      tok, pos, v1, None)
    jo, jcb, out_b, cache_b = _step_both(params, model, jc, tc, tok, pos, v1,
                                         np.full((B,), P, np.int32))
    np.testing.assert_allclose(out_a.numpy(), out_b.numpy(), rtol=1e-5, atol=1e-5)
    for f in ("k", "v", "grp", "valid"):
        np.testing.assert_allclose(cache_a[f].numpy(), cache_b[f].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(cache_b[f].numpy(), np.asarray(jcb[f]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_b.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    assert cache_b["length"] == P and cache_a["length"] == P + 1


@pytest.mark.parametrize("case", ["rows_apart", "finished_row", "parked_rows", "crosses_end"])
def test_write_past_the_end_is_dropped(pair, case):
    """Per-row columns a row apart; a finished row's token at column C; a
    chunk whose parked rows sit at C; a row whose chunk crosses the end.
    Outputs and the whole cache equal JAX's (XLA drops the writes past the
    end); the dropped columns leave the cache as it was."""
    params, model = pair
    B, P, C = 3, 6, 10
    jc, tc, rs = _prefilled(params, model, B, P, C, seed=2)
    before = {f: tc[f].clone() for f in ("k", "v", "grp", "valid")}
    T = 1 if case in ("rows_apart", "finished_row") else 3
    cols = {"rows_apart": [6, 8, 7], "finished_row": [6, C, 9], "parked_rows": [C, 6, C],
            "crosses_end": [6, 8, C]}[case]
    tok = rs.randn(B, T, 64).astype(np.float32)
    pos = (np.asarray(cols)[:, None] + np.arange(T)).astype(np.int32)
    valid = np.ones((B, T), np.int32)
    jo, jc2, to, tc2 = _step_both(params, model, jc, tc, tok, pos, valid,
                                  np.asarray(cols, np.int32))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    for f in ("k", "v", "grp", "valid", "seg"):
        np.testing.assert_allclose(tc2[f].numpy(), np.asarray(jc2[f]), rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    for b, w in enumerate(cols):
        kept = slice(min(w, C), min(w + T, C))
        for f in ("k", "grp"):
            untouched = np.ones(C, bool)
            untouched[kept] = False
            np.testing.assert_array_equal(tc2[f][:, b, untouched].numpy() if f == "k"
                                          else tc2[f][b, untouched].numpy(),
                                          before[f][:, b, untouched].numpy() if f == "k"
                                          else before[f][b, untouched].numpy())


def test_vlm_forward_passes_write_cols(pair):
    """vlm_forward with a cache continues groups and positions per row from
    the row's valid count and writes at write_cols, as JAX's."""
    params, model = pair
    B, C = 2, 12
    rs = np.random.RandomState(3)
    ids = rs.randint(1, 400, (B, 4)).astype(np.int32)
    valid = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.int32)
    jc = jtf.init_kv_cache(JCFG.llm, B, C, dtype=jnp.float32)
    tc = ttf.init_kv_cache(TCFG.llm, B, C, dtype=torch.float32)
    cols = np.array([0, 5], np.int32)
    for _ in range(2):
        jh, jc = jvlm.vlm_forward(params, JCFG, jnp.asarray(ids), jnp.asarray(valid), cache=jc,
                                  update_cache=True, write_cols=jnp.asarray(cols))
        th, tc = tvlm.vlm_forward(model, TCFG, _t(ids), _t(valid), cache=tc, update_cache=True,
                                  write_cols=_t(cols))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
        cols = cols + 4
    for f in ("k", "grp", "valid"):
        np.testing.assert_allclose(tc[f].numpy(), np.asarray(jc[f]), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _jax_engine_tokens(params, prompts, T, **kw):
    eng = jengine.ContinuousBatchingEngine(params, JCFG, max_new=T, eos_token_id=-1,
                                           temperature=0.0, **kw)
    try:
        return _serve(eng, prompts)
    finally:
        eng.close()


@pytest.mark.parametrize("mode", ["one_shot", "chunked"])
def test_engine_matches_jax_engine_and_generate(pair, mode):
    """Three concurrent prompts through two slots (admitted once all three
    are queued; a slot reused), greedy: the port's tokens equal JAX's engine
    and the port's generate; ticks served two slots at once."""
    params, model = pair
    rs = np.random.RandomState(2 if mode == "one_shot" else 7)
    prompts = [_prompt(rs, t) for t in ((4, 6, 9) if mode == "one_shot" else (23, 4, 11))]
    T = 5
    kw = (dict(slots=2, max_prompt=64, steps_per_tick=2) if mode == "one_shot"
          else dict(slots=2, max_prompt=64, steps_per_tick=1, prefill_chunk=16))
    eng = tengine.ContinuousBatchingEngine(model, TCFG, max_new=T, eos_token_id=-1, **kw)
    hold_admissions(eng, len(prompts))
    try:
        got = _serve(eng, prompts)
        assert eng.batched_steps > 0
        chunked = {c for *_, c in eng.admit_log}
        assert chunked == ({False} if mode == "one_shot" else {True})
    finally:
        eng.close()
    want = [_generate(model, ids, img, T) for ids, img in prompts]
    assert got == want
    assert got == _jax_engine_tokens(params, prompts, T, **kw)


def test_engine_chunked_slot_reuse_clears_stale_occupancy(pair):
    """One slot, chunked: a longer prompt, then a shorter one in the same
    row; the stale columns of the first leak into nothing."""
    _, model = pair
    rs = np.random.RandomState(11)
    prompts = [_prompt(rs, 30), _prompt(rs, 6)]
    eng = tengine.ContinuousBatchingEngine(model, TCFG, slots=1, max_prompt=64, max_new=4,
                                           eos_token_id=-1, steps_per_tick=1, prefill_chunk=8)
    try:
        for ids, img in prompts:
            assert eng.submit(ids, images=img, timeout=300) == _generate(model, ids, img, 4)
    finally:
        eng.close()


def test_engine_eos_stops_early_and_max_new_per_request(pair):
    """The first greedy token as EOS ends a request after one token; two
    requests with max_new 2 and 7 in the slots at once get 2 and 7."""
    _, model = pair
    rs = np.random.RandomState(3)
    ids, img = _prompt(rs, 5)
    first = _generate(model, ids, img, 3)[0]
    eng = tengine.ContinuousBatchingEngine(model, TCFG, slots=2, max_prompt=64, max_new=8,
                                           eos_token_id=first, steps_per_tick=4)
    try:
        assert eng.submit(ids, images=img, timeout=300) == [first]
    finally:
        eng.close()
    prompts = [_prompt(rs, 4), _prompt(rs, 9)]
    eng = tengine.ContinuousBatchingEngine(model, TCFG, slots=2, max_prompt=64, max_new=8,
                                           eos_token_id=-1, steps_per_tick=3)
    try:
        got = _serve(eng, prompts, max_new=[2, 7])
    finally:
        eng.close()
    assert got == [_generate(model, *prompts[0], 2), _generate(model, *prompts[1], 7)]


def test_engine_embeds_route_matches_jax(pair):
    """Pre-spliced prompt embeds (the MUVLA server's route) through both
    engines, one-shot and chunked; equal to the port's generate on the
    same embeds."""
    params, model = pair
    rs = np.random.RandomState(5)
    prompts = [_prompt(rs, t) for t in (7, 19)]
    embeds = []
    for ids, img in prompts:
        feats = tvlm.encode_images(model, TCFG, _t(img)[None])
        embeds.append(tvlm.splice_image_embeds(model, TCFG, _t(ids)[None], feats)[0].detach())
    want = []
    for (ids, _), e in zip(prompts, embeds):
        toks, _ = tgen.generate(model, TCFG, _t(ids)[None], torch.ones(1, len(ids), dtype=torch.int32),
                                None, 4, -1, inputs_embeds=e[None])
        want.append(toks[0].tolist())
    for chunk in (None, 8):
        eng = tengine.ContinuousBatchingEngine(model, TCFG, slots=2, max_prompt=64, max_new=4,
                                               eos_token_id=-1, prefill_chunk=chunk)
        jeng = jengine.ContinuousBatchingEngine(params, JCFG, slots=2, max_prompt=64, max_new=4,
                                                eos_token_id=-1, prefill_chunk=chunk)
        try:
            got = [eng.submit(ids, embeds=e.numpy(), timeout=300)
                   for (ids, _), e in zip(prompts, embeds)]
            jgot = [jeng.submit(ids, embeds=e.numpy(), timeout=300)
                    for (ids, _), e in zip(prompts, embeds)]
        finally:
            eng.close()
            jeng.close()
        assert got == want == jgot


def test_engine_sampled_draws_from_its_generator(pair):
    """Temperature > 0: the engine's draws come from its torch.Generator
    (two engines seeded alike draw alike), within the vocabulary."""
    _, model = pair
    rs = np.random.RandomState(9)
    ids, img = _prompt(rs, 6)
    outs = []
    for _ in range(2):
        eng = tengine.ContinuousBatchingEngine(model, TCFG, slots=2, max_prompt=64, max_new=6,
                                               eos_token_id=-1, temperature=1.0,
                                               generator=torch.Generator().manual_seed(4))
        try:
            outs.append(eng.submit(ids, images=img, timeout=300))
        finally:
            eng.close()
    assert outs[0] == outs[1] and len(outs[0]) == 6 and all(0 <= t < 512 for t in outs[0])


def test_engine_failed_step_fails_requests_not_clients(pair):
    """A failing step errors the in-flight request (its client gets the
    error, no hang); the state is rebuilt and a healthy step serves again."""
    _, model = pair
    rs = np.random.RandomState(4)
    ids, img = _prompt(rs, 5)
    eng = tengine.ContinuousBatchingEngine(model, TCFG, slots=2, max_prompt=64, max_new=4,
                                           eos_token_id=-1, steps_per_tick=2)
    try:
        def bad_step(*a, **k):
            raise RuntimeError("injected step failure")

        eng._step_fn = bad_step
        with pytest.raises(RuntimeError, match="injected"):
            eng.submit(ids, images=img, timeout=60)
        eng._step_fn = eng._step
        assert eng._dead is None
        assert eng.submit(ids, images=img, timeout=300) == _generate(model, ids, img, 4)
    finally:
        eng.close()


def test_engine_dead_loop_fails_fast(pair):
    """The loop thread dying marks the engine dead: the request in flight
    and every later submit raise at once."""
    _, model = pair
    rs = np.random.RandomState(5)
    ids, img = _prompt(rs, 5)
    eng = tengine.ContinuousBatchingEngine(model, TCFG, slots=2, max_prompt=64, max_new=4,
                                           eos_token_id=-1, steps_per_tick=2)
    try:
        def bad_tick(*a, **k):
            raise RuntimeError("injected loop death")

        eng._decode_tick = bad_tick
        with pytest.raises(RuntimeError):
            eng.submit(ids, images=img, timeout=60)
        assert eng._dead is not None
        with pytest.raises(RuntimeError, match="dead"):
            eng.submit(ids, images=img, timeout=60)
    finally:
        eng.close()


def test_engine_refuses_a_prompt_past_max_prompt(pair):
    _, model = pair
    eng = tengine.ContinuousBatchingEngine(model, TCFG, slots=1, max_prompt=16, max_new=2)
    try:
        with pytest.raises(ValueError, match="max_prompt"):
            eng.submit(np.ones(17, np.int32), timeout=10)
    finally:
        eng.close()


def test_engine_under_thread_stress(pair):
    """Twelve clients (more than the cores given to the test) on a 3-slot
    engine, the interpreter switching threads every 10 us: every client gets
    its own prompt's tokens (a lost or crossed update would give another's),
    and every client thread ends."""
    import sys

    _, model = pair
    rs = np.random.RandomState(13)
    prompts = [_prompt(rs, t) for t in (3, 8, 5, 12, 4, 9, 6, 11, 7, 10, 2, 13)]
    want = [_generate(model, ids, img, 3) for ids, img in prompts]
    eng = tengine.ContinuousBatchingEngine(model, TCFG, slots=3, max_prompt=64, max_new=3,
                                           eos_token_id=-1, steps_per_tick=2)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = [None] * len(prompts)

        def run(i):
            out[i] = eng.submit(*prompts[i], timeout=300)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        eng.close()
    assert out == want and eng.batched_steps > 0
