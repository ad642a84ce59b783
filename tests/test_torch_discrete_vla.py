"""The port's Discrete VLA against the JAX package, on the CPU in fp32.

* ``parse_action_text`` on the JAX package's cases and a few more.
* ``discrete_vla_loss`` and every gradient against ``jax.value_and_grad``.
* ``discrete_vla_inference_action``, greedy, against JAX's: a tokenizer
  that decodes each token id as its number makes the action a function of
  the greedy tokens; the retry path by its count of ``generate`` calls and
  its zeros (texts that never parse, and one that parses at the third call).
* ``DiscreteVLAServer`` with and without the decode engine against the JAX
  server (text and actions), concurrent HTTP clients through the engine
  (their steps coalesce), a text that does not parse falling back to the
  sampled retries; the engine's ``max_prompt`` holds the full-width prompt
  (LLaMA-2-7B + CLIP-L/336: 576 image slots), above the JAX server's 512.
* ``DiscreteVLAExp.train()`` on a tiny suite: the metric keys, finite values.

Tiny models: the 2-layer test LLM and the test ViT (4 image tokens).
Tolerance 1e-3 (fp32) unless stated; tokens, texts and bins exact.
"""

import dataclasses
import io
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dexbotic_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from dexbotic_tpu.exp import base_exp as jbase
from dexbotic_tpu.exp import discrete_vla_exp as jexp
from dexbotic_tpu.exp import serve as jserve
from dexbotic_tpu.models import discrete_vla as jdv
from dexbotic_tpu_torch.exp import base_exp as tbase
from dexbotic_tpu_torch.exp import discrete_vla_exp as texp
from dexbotic_tpu_torch.exp import serve as tserve
from dexbotic_tpu_torch.exp.optim import OptimizerConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig
from dexbotic_tpu_torch.models import discrete_vla as tdv
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

from _engine import hold_admissions

torch.set_num_threads(2)
TOL = 1e-3
PROMPT = "pick up the cube"


def _exps(**model):
    kw = dict(llm_preset="test", vit_preset="test", **model)
    j = jexp.DiscreteVLAExp(model=jexp.DiscreteVLAModelConfig(**kw),
                            tokenizer=jbase.TokenizerConfig(model_max_length=96),
                            data=jbase.DataConfig(image_processor="28", aug_policy="identity"))
    t = texp.DiscreteVLAExp(model=texp.DiscreteVLAModelConfig(**kw),
                            tokenizer=tbase.TokenizerConfig(model_max_length=96),
                            data=tbase.DataConfig(image_processor="28", aug_policy="identity"),
                            device="cpu")
    return j, t


@pytest.fixture(scope="module")
def pair():
    """(JAX exp, port exp, JAX config, port config, JAX params, port model)
    with 8 new tokens and one retry, as the JAX server test builds them."""
    jx, tx = _exps()
    jcfg = dataclasses.replace(jx.model.build_config(), max_new_tokens=8, max_retries=1)
    tcfg = dataclasses.replace(tx.model.build_config(), max_new_tokens=8, max_retries=1)
    params = jax.device_get(jdv.init_discrete_vla(jax.random.PRNGKey(0), jcfg))
    model = tdv.build_discrete_vla(tcfg, "cpu", seed=3)
    load_jax_params(model, params)
    return jx, tx, jcfg, tcfg, params, model


class DigitTokenizer:
    """The exp's tokenizer, whose decode writes each token id as its number:
    a greedy decode then always parses, into the first ids as bins."""

    def __init__(self, tok):
        self._tok = tok

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def __call__(self, *args, **kw):
        return self._tok(*args, **kw)

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


class SilentTokenizer(DigitTokenizer):
    """Decodes to text without digits (a parse failure) until ``parse_at``."""

    def __init__(self, tok, parse_at=None):
        super().__init__(tok)
        self.calls, self.parse_at = 0, parse_at

    def decode(self, ids):
        self.calls += 1
        return super().decode(ids) if self.calls == self.parse_at else "no action"


@pytest.mark.parametrize("text,dim", [
    ("1 2 3 4 5 6 7", 7), ("a12b300c5 6 7 8 9 10", 7), ("1 2 3", 7), ("", 1), ("254 255 0", 3),
    ("x 128y", 1)])
def test_parse_action_text_matches_jax(text, dim):
    want = jdv.parse_action_text(text, dim, 255)
    got = tdv.parse_action_text(text, dim, 255)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


def _batch(seed=0, B=2, n_text=10):
    rs = np.random.RandomState(seed)
    nt = 4
    ids = rs.randint(1, 400, (B, nt + n_text)).astype(np.int32)
    ids[:, :nt] = IMAGE_TOKEN_INDEX
    mask = np.ones(ids.shape, np.int32)
    if B > 1:
        mask[1, -3:] = 0
    labels = np.where(mask == 1, ids, IGNORE_INDEX).astype(np.int32)
    labels[:, : nt + 4] = IGNORE_INDEX
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "images": rs.randn(B, 1, 28, 28, 3).astype(np.float32)}


def test_loss_and_grads_match_jax(pair):
    _, _, jcfg, tcfg, params, model = pair
    batch = _batch()
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jdv.discrete_vla_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    model.requires_grad_(True)
    try:
        loss, m = tdv.discrete_vla_loss(model, tcfg, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()})
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL, atol=TOL)
        assert set(m) == set(jm) == {"text_loss", "loss"}
        grads = dict(model.named_parameters())
        n = 0
        for name, val, _ in port_arrays(jgrads):
            got = grads[name].grad
            got = np.zeros_like(val) if got is None else got.numpy()
            np.testing.assert_allclose(got, val, rtol=TOL, atol=TOL, err_msg=name)
            n += 1
        assert n == len(grads)
    finally:
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)


def _inputs(seed):
    b = _batch(seed, B=1)
    return b["input_ids"], np.ones_like(b["input_ids"]), b["images"]


@pytest.mark.parametrize("seed", [1, 2])
def test_greedy_inference_action_matches_jax(pair, seed):
    jx, tx, jcfg, tcfg, params, model = pair
    ids, valid, imgs = _inputs(seed)
    jtok = DigitTokenizer(jx.tokenizer.build_tokenizer())
    ttok = DigitTokenizer(tx.tokenizer.build_tokenizer())
    want = jdv.discrete_vla_inference_action(params, jcfg, jtok, jnp.asarray(ids),
                                             jnp.asarray(valid), jnp.asarray(imgs), eos_token_id=2)
    stats = {}
    got = tdv.discrete_vla_inference_action(model, tcfg, ttok, torch.from_numpy(ids),
                                            torch.from_numpy(valid), torch.from_numpy(imgs), 2,
                                            stats=stats)
    np.testing.assert_array_equal(got, want)
    assert stats == {"generate_calls": 1, "parsed": True}


@pytest.mark.parametrize("parse_at,retries", [(None, 0), (None, 3), (3, 4)])
def test_retry_path_counts_and_zeros(pair, monkeypatch, parse_at, retries):
    """A text that never parses: 1 + max_retries generate calls (the retries
    sampled at temperature 1.0 from the generator), then zeros; one that
    parses at the third call stops there with a parsed action."""
    _, tx, _, tcfg, _, model = pair
    cfg = dataclasses.replace(tcfg, max_retries=retries)
    temps = []
    real = tdv.generate

    def counted(*a, temperature=0.0, **kw):
        temps.append(temperature)
        return real(*a, temperature=temperature, **kw)

    monkeypatch.setattr(tdv, "generate", counted)
    ids, valid, imgs = _inputs(4)
    stats = {}
    tok = SilentTokenizer(tx.tokenizer.build_tokenizer(), parse_at)
    got = tdv.discrete_vla_inference_action(model, cfg, tok, torch.from_numpy(ids),
                                            torch.from_numpy(valid), torch.from_numpy(imgs), 2,
                                            generator=torch.Generator().manual_seed(0),
                                            stats=stats)
    calls = 1 + retries if parse_at is None else parse_at
    assert temps == [0.0] + [1.0] * (calls - 1)
    assert stats == {"generate_calls": calls, "parsed": parse_at is not None}
    if parse_at is None:
        np.testing.assert_array_equal(got, np.zeros(cfg.action_dim))
    else:
        assert got.shape == (cfg.action_dim,) and (np.abs(got) <= 1).all()


def _png(color) -> bytes:
    buf = io.BytesIO()
    Image.new("RGB", (28, 28), color).save(buf, "PNG")
    return buf.getvalue()


def _post(port, text, png):
    boundary = "dvlatest"
    body = (f'--{boundary}\r\nContent-Disposition: form-data; name="text"\r\n\r\n{text}\r\n'
            f'--{boundary}\r\nContent-Disposition: form-data; name="image"; filename="f.png"\r\n'
            f'Content-Type: image/png\r\n\r\n').encode() + png + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/process_frame", data=body,
                                 headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


NORMS = {"min": [-1.0, -2.0, 0.0, 0.0, 0.0, 0.0, -0.5], "max": [1.0, 2.0, 1.0, 0.5, 3.0, 1.0, 0.5]}


def test_server_engine_and_fallback_match_jax(pair):
    """Both packages' servers, with and without the engine, on a digit
    tokenizer (the greedy text parses): equal texts and actions
    (denormalised by min/max); 4 concurrent HTTP clients through the port's
    engine (2 slots; admitted once all four are queued) coalesce and get the
    direct replies; a tokenizer whose
    text never parses takes the fused retries (zeros, denormalised)."""
    jx, tx, jcfg, tcfg, params, model = pair
    jtok = DigitTokenizer(jx.tokenizer.build_tokenizer())
    ttok = DigitTokenizer(tx.tokenizer.build_tokenizer())
    frames = [[("image", _png(c))] for c in ((40, 90, 160), (200, 10, 30), (0, 255, 70),
                                              (90, 90, 90))]
    jplain = jserve.DiscreteVLAServer(jx, jcfg, params, jtok, NORMS, port=0)
    jcb = jserve.DiscreteVLAServer(jx, jcfg, params, jtok, NORMS, port=0, continuous_batching=2)
    tplain = tserve.DiscreteVLAServer(tx, tcfg, model, ttok, NORMS, host="127.0.0.1", port=0)
    tcb = tserve.DiscreteVLAServer(tx, tcfg, model, ttok, NORMS, host="127.0.0.1", port=0,
                                   continuous_batching=2)
    assert tcb.concurrent and not tplain.concurrent and tcb.engine.P == 320
    httpd = tcb.serve_background()
    try:
        for f in frames[:2]:
            want_cb = jcb.get_response({"text": PROMPT}, f)
            want_plain = jplain.get_response({"text": PROMPT}, f)
            got_cb = tcb.get_response({"text": PROMPT}, f)
            got_plain = tplain.get_response({"text": PROMPT}, f)
            assert got_cb["text"] == want_cb["text"] and got_cb["text"]
            assert got_plain["text"] == want_plain["text"] == ""
            for got, want in ((got_cb, want_cb), (got_plain, want_plain)):
                np.testing.assert_allclose(got["actions"], want["actions"], rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(got_cb["actions"], got_plain["actions"], atol=1e-9)
        direct = [tcb.get_response({"text": PROMPT}, f) for f in frames]
        replies = [None] * len(frames)

        def run(i):
            replies[i] = _post(httpd.server_address[1], PROMPT, frames[i][0][1])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(frames))]
        steps = tcb.engine.batched_steps
        hold_admissions(tcb.engine, len(frames))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert replies == direct and tcb.engine.batched_steps > steps
        assert tcb.parsed == 2 + 4 + 4 and tcb.unparsed == 0 and tplain.parsed == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        tcb.close()
        jcb.engine.close()
    silent = tserve.DiscreteVLAServer(tx, tcfg, model, SilentTokenizer(ttok), NORMS,
                                      host="127.0.0.1", port=0, continuous_batching=2)
    try:
        out = silent.get_response({"text": PROMPT}, frames[0])
    finally:
        silent.close()
    lo, hi = np.asarray(NORMS["min"]), np.asarray(NORMS["max"])
    assert out["text"] == "no action" and silent.unparsed == 1
    np.testing.assert_allclose(out["actions"], lo + 0.5 * (hi - lo))


def test_full_width_prompt_fits_the_engine():
    """LLaMA-2-7B + CLIP-L/336 (576 image slots) with the byte-level
    tokenizer and the dexbotic template: a LIBERO instruction's prompt fits
    the server's default max_prompt (the JAX engine's 512 does not); only
    the tokenizer is built."""
    exp = texp.DiscreteVLAExp(device="cpu")
    cfg, tok = exp.model.build_config(), exp.tokenizer.build_tokenizer()
    empty = len(tserve._cogact_prompt_ids(exp, cfg, tok, "", assistant_stub=None))
    P = tserve.engine_max_prompt(empty)
    for text in ("pick up the moka pot",
                 "put the black bowl in the bottom drawer of the cabinet and close it"):
        ids = tserve._cogact_prompt_ids(exp, cfg, tok, text, assistant_stub=None)
        jids = jserve._cogact_prompt_ids(jexp.DiscreteVLAExp(), jexp.DiscreteVLAExp().model
                                         .build_config(), jexp.DiscreteVLAExp().tokenizer
                                         .build_tokenizer(), text, assistant_stub=None)
        assert ids == list(jids) and 512 < len(ids) <= P
        assert sum(i == IMAGE_TOKEN_INDEX for i in ids) == 576
    assert P == 896


def test_exp_train_on_a_tiny_suite(tmp_path, monkeypatch):
    """DiscreteVLAExp.train(): two steps on a 3-episode suite (answers of
    one 7-dof step as bin strings), the metric keys and finite values, a
    checkpoint (with its norm statistics) that load_for_inference reads back."""
    from dexbotic_tpu_torch.data import registry as tregistry

    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    os.makedirs(root)
    rng = np.random.RandomState(0)
    for e in range(3):
        lines = []
        for t in range(8):
            Image.new("RGB", (40, 32), (e * 50, t * 20, 90)).save(f"{root}/e{e}f{t}.png")
            lines.append(json.dumps({"images_1": {"type": "image", "url": f"e{e}f{t}.png"},
                                     "state": (np.sin(np.arange(7) + t * 0.4)
                                               + 0.01 * rng.randn(7)).tolist(),
                                     "prompt": PROMPT, "is_robot": True}))
        with open(f"{root}/e{e}.jsonl", "w") as f:
            f.write("\n".join(lines))
    tregistry.register_dataset({"suite": {"data_path_prefix": root, "annotations": root,
                                          "frequency": 1}},
                               prefix="dvla", meta_data={"non_delta_mask": [6],
                                                         "periodic_mask": None,
                                                         "periodic_range": None})

    def make(**kw):
        _, exp = _exps(**kw)
        exp.data = tbase.DataConfig(dataset_name="dvla_suite", image_processor="28")
        exp.tokenizer = tbase.TokenizerConfig(model_max_length=320)
        exp.trainer = TrainerConfig(output_dir=str(tmp_path / "out"), max_steps=2,
                                    per_device_batch_size=2, logging_steps=1, save_steps=2,
                                    bf16=False, resume=False, gradient_checkpointing=True)
        exp.optimizer = OptimizerConfig(learning_rate=1e-4)
        return exp

    log = make().train()
    assert log["step"] == 2 and set(log) == {"loss", "text_loss", "grad_norm", "step",
                                             "steps_per_sec", "data_wait_s"}
    assert all(np.isfinite(log[k]) for k in ("loss", "text_loss", "grad_norm"))
    assert log["loss"] > 0
    cfg, model, norms = make(model_name_or_path=str(tmp_path / "out" / "checkpoint-2")
                             ).load_for_inference()
    assert len(norms["min"]) == 7 and isinstance(model, tdv.DiscreteVLA)
