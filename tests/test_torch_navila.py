"""The port's NaVILA against the JAX package, on the CPU in fp32.

* ``mlp_downsample`` on an odd (3x3, zero-padded) and an even (4x4) token
  grid, and ``VLMConfig.num_image_tokens``' rule (SigLIP-so400m/384: 196).
* ``causal_lm_loss`` and ``soft_cross_entropy_gaussian`` (targets in and out
  of the digit set, ignored labels) and their logits' gradients.
* ``generate``, greedy, over right-padded rows with an EOS that one row
  draws midway (pads after it): tokens equal, log-probs within 2e-3 (both
  packages write the K/V into a bf16 cache; a value that lands beside a
  bf16 rounding boundary may round the other way); sampled at temperature
  0.9 from a torch.Generator, JAX's decode fed the port's tokens gives the
  same log-probs.
* ``pack_batch`` equal to JAX's array for array (a dropped sample too), and
  segment isolation: a packed row's hidden states equal each sample's alone.
* ``navila_packed_loss`` equal to ``navila_loss`` on the same samples and to
  JAX's packed loss, with the projector's and lm_head's gradients.
* ``DexNavilaDataset``'s history indices, length hints and samples;
  ``nav_question`` and ``NAV_PROMPT`` byte for byte.
* ``NaVILAInferenceSession.act`` over an episode against JAX's session;
  ``NaVILAServer``'s ``run_model`` / ``episode_first_frame`` contract and its
  BGR flip; ``NaVILAExp.train()`` packed on a tiny suite (its
  context-parallel loss is tests/test_torch_ring.py's).
* A fleet of sessions on one shared decode engine (one-shot and chunked
  admission) against JAX's sessions on a JAX engine: the same texts.

Tiny models: the 2-layer test LLM, a ViT of 3x3 patches (4 tokens a frame
after mlp_downsample).  Tolerance 1e-3 (fp32) unless stated; integer
outputs exact.
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
from dexbotic_tpu.data import dex_navila_dataset as jds
from dexbotic_tpu.data.registry import register_dataset
from dexbotic_tpu.exp import navila_exp as jexp
from dexbotic_tpu.models import generate as jgen
from dexbotic_tpu.models import losses as jlosses
from dexbotic_tpu.models import navila as jnav
from dexbotic_tpu.models import presets as jpresets
from dexbotic_tpu.models import vlm as jvlm
from dexbotic_tpu.nn import projector as jproj
from dexbotic_tpu.nn import vit as jvit
from dexbotic_tpu_torch.data import dex_navila_dataset as tds
from dexbotic_tpu_torch.data import registry as tregistry
from dexbotic_tpu_torch.exp import navila_exp as texp
from dexbotic_tpu_torch.exp import optim as toptim
from dexbotic_tpu_torch.exp import trainer as ttrainer
from dexbotic_tpu_torch.models import generate as tgen
from dexbotic_tpu_torch.models import losses as tlosses
from dexbotic_tpu_torch.models import navila as tnav
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.nn import projector as tproj
from dexbotic_tpu_torch.nn import vit as tvit
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

torch.set_num_threads(2)
TOL = 1e-3
VIT = dict(image_size=42, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, select_layer=None)
for _p, _v in ((jpresets, jvit), (tpresets, tvit)):  # the exps read presets by name
    _p.VIT_PRESETS["navila_test"] = _v.ViTConfig(**VIT)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, what="", tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _pair(**kw):
    return tuple(n.NaVILAConfig(vlm=v.VLMConfig(llm=p.LLM_TEST, vit=p.VIT_PRESETS["navila_test"],
                                                projector_type="mlp_downsample"), **kw)
                 for n, v, p in ((jnav, jvlm, jpresets), (tnav, tvlm, tpresets)))


def _params_and_model(seed=0, **kw):
    jcfg, tcfg = _pair(**kw)
    params = jax.device_get(jnav.init_navila(jax.random.PRNGKey(seed), jcfg))
    model = tnav.build_navila(tcfg, "cpu", seed=5)
    load_jax_params(model, params)
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("grid", [3, 4])
def test_mlp_downsample_matches_jax(grid):
    params = jax.device_get(jproj.init_projector(jax.random.PRNGKey(1), "mlp_downsample", 12, 20))
    proj = tproj.Projector("mlp_downsample", 12, 20)
    load_jax_params(proj, params)
    x = np.random.default_rng(grid).normal(size=(2, grid * grid, 12)).astype(np.float32)
    want = jproj.apply_projector(params, jnp.asarray(x), "mlp_downsample")
    got = tproj.apply_projector(proj, _t(x), "mlp_downsample")
    assert got.shape == (2, ((grid + 1) // 2) ** 2, 20)
    _close(got, want)
    # a 2x2 block's channels are its tokens in row order; the blocks come
    # column by column (the reference's transpose quirk): the second output
    # token is the block below the first
    s2d = tproj.downsample_2x2(_t(x)).numpy()
    xg = x.reshape(2, grid, grid, 12)
    np.testing.assert_array_equal(s2d[0, 0], np.concatenate([xg[0, 0, 0], xg[0, 0, 1],
                                                             xg[0, 1, 0], xg[0, 1, 1]]))
    np.testing.assert_array_equal(s2d[0, 1, :12], xg[0, 2, 0])


def test_patchify_drops_the_pixels_past_the_last_patch():
    """SigLIP-so400m/384 patches 27 x 14 of its 384 pixels a side: the port
    drops the rest, as the reference's stride-14 convolution (VALID) does,
    giving JAX's patches of the cropped image; JAX's reshape raises on the
    uncropped one."""
    x = np.random.default_rng(0).normal(size=(2, 44, 44, 3)).astype(np.float32)
    got = tvit.patchify(_t(x), 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jvit.patchify(jnp.asarray(x[:, :42, :42]), 14)))
    w = np.random.default_rng(1).normal(size=(5, 3, 14, 14)).astype(np.float32)
    conv = torch.nn.functional.conv2d(_t(x).permute(0, 3, 1, 2), _t(w), stride=14)
    flat = _t(w).permute(0, 2, 3, 1).reshape(5, -1)  # (row, col, channel) order
    _close(got @ flat.T, conv.flatten(2).transpose(1, 2))
    with pytest.raises(TypeError):
        jvit.patchify(jnp.asarray(x), 14)


def test_num_image_tokens_rule():
    for vit in ("siglip_so400m_384", "clip_vit_l_336", "navila_test"):
        for proj in ("mlp_downsample", "mlp2x_gelu"):
            want = jvlm.VLMConfig(llm=jpresets.LLM_TEST, vit=jpresets.VIT_PRESETS[vit],
                                  projector_type=proj).num_image_tokens
            got = tvlm.VLMConfig(llm=tpresets.LLM_TEST, vit=tpresets.VIT_PRESETS[vit],
                                 projector_type=proj).num_image_tokens
            assert got == want
    assert tvlm.VLMConfig(llm=tpresets.LLM_TEST, vit=tpresets.VIT_PRESETS["siglip_so400m_384"],
                          projector_type="mlp_downsample").num_image_tokens == 196


@pytest.mark.parametrize("soft", [False, True])
def test_losses_match_jax(soft):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 9, 40)).astype(np.float32) * 3
    digits = np.arange(20, 30, dtype=np.int32)
    labels = rng.integers(0, 40, (2, 9)).astype(np.int32)
    labels[0, 2:6] = [21, 29, 20, 25]  # digits, at the set's edges too
    labels[1, :3] = IGNORE_INDEX

    def jloss(lg):
        if soft:
            return jlosses.soft_cross_entropy_gaussian(lg, jnp.asarray(labels), jnp.asarray(digits),
                                                       std=1.5)
        return jlosses.causal_lm_loss(lg, jnp.asarray(labels))

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lt = _t(logits).requires_grad_(True)
    got = (tlosses.soft_cross_entropy_gaussian(lt, _t(labels), _t(digits), std=1.5) if soft
           else tlosses.causal_lm_loss(lt, _t(labels)))
    got.backward()
    _close(got, want)
    _close(lt.grad, jgrad)
    nll, mask = tlosses.token_nll(_t(logits), _t(labels), _t(digits) if soft else None)
    jnll, jmask = jlosses.token_nll(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(digits) if soft else None)
    _close(nll, jnll)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def _prompt_batch(jcfg, seed, lens, frames=2):
    """Right-padded prompts of ``lens`` valid tokens (frames' image slots first)."""
    rng = np.random.default_rng(seed)
    S = max(lens)
    nt = jcfg.vlm.num_image_tokens * frames
    ids = rng.integers(1, 400, (len(lens), S)).astype(np.int32)
    ids[:, :nt] = IMAGE_TOKEN_INDEX
    valid = (np.arange(S)[None] < np.asarray(lens)[:, None]).astype(np.int32)
    ids[valid == 0] = 0
    imgs = rng.normal(size=(len(lens), frames, 42, 42, 3)).astype(np.float32)
    return ids, valid, imgs


def test_generate_greedy_matches_jax():
    """Three right-padded prompts, 10 new tokens; the EOS is the token row 0
    draws at step 3 (found by a first run without one): row 0 then writes the
    pad id, and the rows after it are unaffected."""
    jcfg, tcfg, params, model = _params_and_model(seed=2)
    ids, valid, imgs = _prompt_batch(jcfg, 4, [17, 13, 15])

    def both(eos):
        jt, jl = jgen.generate(params["vlm"], jcfg.vlm, jnp.asarray(ids), jnp.asarray(valid),
                               jnp.asarray(imgs), max_new_tokens=10, eos_token_id=eos,
                               pad_token_id=7)
        tt, tl = tgen.generate(model.vlm, tcfg.vlm, _t(ids), _t(valid), _t(imgs),
                               max_new_tokens=10, eos_token_id=eos, pad_token_id=7)
        return np.asarray(jt), np.asarray(jl), tt.numpy(), tl

    jt, jl, tt, tl = both(-1)
    np.testing.assert_array_equal(tt, jt)
    _close(tl, jl, "logprobs", tol=2e-3)
    eos = int(jt[0, 3])
    jt, jl, tt, tl = both(eos)
    np.testing.assert_array_equal(tt, jt)
    _close(tl, jl, "logprobs", tol=2e-3)
    first = int(np.argmax(tt[0] == eos))
    assert first <= 3 and (tt[0, first + 1:] == 7).all()


def test_generate_sampled_logprobs_match_jax_on_the_same_tokens():
    """At temperature 0.9 the port draws from its torch.Generator (the same
    seed, the same tokens; threefry's draws cannot be reproduced): JAX's
    prefill into its bf16 cache and its decode steps, fed the port's tokens,
    give the same log-probs within 2e-3."""
    from dexbotic_tpu.nn import transformer as jtr

    jcfg, tcfg, params, model = _params_and_model(seed=6)
    ids, valid, imgs = _prompt_batch(jcfg, 9, [16, 13])
    runs = [tgen.generate(model.vlm, tcfg.vlm, _t(ids), _t(valid), _t(imgs), max_new_tokens=6,
                          eos_token_id=-1, temperature=0.9,
                          generator=torch.Generator().manual_seed(seed)) for seed in (3, 3, 4)]
    toks, logps = runs[0]
    assert torch.equal(toks, runs[1][0]) and not torch.equal(toks, runs[2][0])
    B, S = ids.shape
    cache = jtr.init_kv_cache(jcfg.vlm.llm, B, S + 6, dtype=jnp.bfloat16)
    hidden, cache = jvlm.vlm_forward(params["vlm"], jcfg.vlm, jnp.asarray(ids), jnp.asarray(valid),
                                     images=jnp.asarray(imgs), cache=cache, update_cache=True)
    n = valid.sum(1)
    prev = hidden[np.arange(B), n - 1]
    want = []
    for t in range(6):
        logits = jtr.lm_logits(params["vlm"]["llm"], jcfg.vlm.llm, prev).astype(jnp.float32)
        tok = jnp.asarray(toks[:, t].numpy())
        want.append(np.asarray(jax.nn.log_softmax(logits, -1))[np.arange(B), toks[:, t].numpy()])
        emb = jtr.embed_tokens(params["vlm"]["llm"], jcfg.vlm.llm, tok[:, None], dtype=prev.dtype)
        pos = jnp.asarray(n + t)[:, None]
        hidden, cache = jvlm.vlm_forward(params["vlm"], jcfg.vlm, tok[:, None],
                                         jnp.ones((B, 1), jnp.int32), inputs_embeds=emb,
                                         positions=pos, grp=pos + 1, cache=cache,
                                         update_cache=True)
        prev = hidden[:, 0]
    _close(logps, np.stack(want, 1), "logprobs of the drawn tokens", tol=2e-3)


def test_generate_write_cols_and_engine_raise():
    """write_cols (the decode engine's per-row columns) writes into a given
    cache only: without one it is refused, as JAX asserts; the exp's
    inference() raises; a context-parallel config builds (its loss and
    training run in tests/test_torch_ring.py)."""
    jcfg, tcfg, params, model = _params_and_model()
    ids, valid, _ = _prompt_batch(jcfg, 1, [6, 6], frames=0)
    with pytest.raises(ValueError, match="write_cols"):
        tvlm.vlm_forward(model.vlm, tcfg.vlm, _t(ids), _t(valid), write_cols=torch.zeros(2))
    assert texp.NaVILAModelConfig(context_parallel_seq=2).build_config() == \
        texp.NaVILAModelConfig().build_config()
    exp = texp.NaVILAExp(device="cpu")
    with pytest.raises(NotImplementedError, match="inference"):
        exp.inference()


def _unpacked(jcfg, seed, lens, frames=2):
    """K samples of the collator's layout: right-padded ids, labels on their
    answer (the last 5 tokens), frames."""
    ids, valid, imgs = _prompt_batch(jcfg, seed, lens, frames)
    labels = np.full(ids.shape, IGNORE_INDEX, np.int32)
    rng = np.random.default_rng(seed + 1)
    for b, n in enumerate(lens):
        labels[b, n - 5: n] = ids[b, n - 5: n]
        labels[b, n - 3] = 20 + rng.integers(0, 10)  # a digit target of the soft CE
        ids[b, n - 3] = labels[b, n - 3]
    return ids, labels, valid, imgs


@pytest.mark.parametrize("rows,max_len,dropped", [(2, 45, 0), (3, 30, 1), (1, 25, 4)])
def test_pack_batch_matches_jax(rows, max_len, dropped):
    """Both packages' arrays, equal; a sample that fits no row is dropped
    with a warning by both."""
    import warnings

    jcfg, _ = _pair()
    ids, labels, valid, _ = _unpacked(jcfg, 6, [14, 20, 13, 15, 21])
    out = []
    for mod in (tnav, jnav):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out.append(mod.pack_batch(ids, labels, valid, rows, max_len, pad_token_id=3))
        assert sum("dropped" in str(x.message) for x in w) == dropped
    got, want = out
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _packed(jcfg, lens, rows, max_len, seed=8):
    ids, labels, valid, imgs = _unpacked(jcfg, seed, lens)
    packed = tnav.pack_batch(ids, labels, valid, rows, max_len)
    packed["images"] = imgs
    return packed, {"input_ids": ids, "labels": labels, "attention_mask": valid, "images": imgs}


def test_segments_are_isolated():
    """Each sample's hidden states in a packed row of two equal its own,
    run alone at positions 0.."""
    jcfg, tcfg, params, model = _params_and_model(seed=3)
    lens = [18, 14]
    packed, unpacked = _packed(jcfg, lens, 1, 40)
    assert sorted(set(packed["segments"][0].tolist())) == [-1, 0, 1]
    tp = {k: _t(v) for k, v in packed.items()}
    with torch.no_grad():
        hidden = tnav.navila_forward_packed(model, tcfg, tp, tnav.packed_embeds(model, tcfg, tp))
        for b, n in enumerate(lens):
            alone = tvlm.vlm_forward(model.vlm, tcfg.vlm, _t(unpacked["input_ids"][b: b + 1]),
                                     _t(unpacked["attention_mask"][b: b + 1]),
                                     images=_t(unpacked["images"][b: b + 1]))
            cols = np.nonzero(packed["segments"][0] == b)[0]  # longest first: sample b, segment b
            assert len(cols) == n
            _close(hidden[0, cols], alone[0, :n], f"sample {b}")


@pytest.mark.parametrize("soft", [False, True])
def test_packed_loss_matches_unpacked_and_jax(soft):
    """The packed loss equals navila_loss on the same samples unpacked and
    JAX's packed loss; the projector's and lm_head's gradients equal JAX's."""
    jcfg, tcfg, params, model = _params_and_model(seed=4)
    packed, unpacked = _packed(jcfg, [16, 14, 19, 15], 2, 40)
    digits = np.arange(20, 30, dtype=np.int32)
    st = _t(digits) if soft else None
    model.requires_grad_(True)
    tl, metrics = tnav.navila_packed_loss(model, tcfg, {k: _t(v) for k, v in packed.items()}, st)
    tl.backward()
    assert set(metrics) == {"text_loss", "loss"}
    with torch.no_grad():
        un, _ = tnav.navila_loss(model, tcfg, {k: _t(v) for k, v in unpacked.items()}, st)
    _close(tl, un, "packed vs unpacked")

    def jloss(p):
        return jnav.navila_packed_loss(p, jcfg, {k: jnp.asarray(v) for k, v in packed.items()},
                                       soft_tokens=jnp.asarray(digits) if soft else None)[0]

    jl, jgrads = jax.value_and_grad(jloss)(params)
    _close(tl, jl, "port vs JAX")
    got = dict(model.named_parameters())
    n = 0
    for name, val, _ in port_arrays(jax.device_get(jgrads)):
        if name.startswith(("vlm.projector.", "vlm.llm.embed", "vlm.llm.norm")):
            _close(got[name].grad, val, name)
            n += 1
    assert n >= 6


def _write_nav_suite(root: str, prefix: str, lengths=(11, 4, 7)):
    """A navigation suite: episodes of 28x28 PNG frames with prompts and
    parse_nav_action-style answers of different lengths."""
    os.makedirs(root, exist_ok=True)
    answers = ["The next action is move forward 50 cm.", "The next action is turn left 30 degree.",
               "The next action is stop.", "The next action is turn right 15 degree."]
    for e, n in enumerate(lengths):
        lines = []
        for t in range(n):
            Image.new("RGB", (30, 26), (e * 70, t * 9, 40)).save(f"{root}/e{e}f{t}.png")
            lines.append(json.dumps({
                "images_1": {"type": "image", "url": f"e{e}f{t}.png"},
                "prompt": "walk to the kitchen" + " and stop at the door" * (t % 3),
                "answer": answers[(e + t) % 4]}))
        with open(f"{root}/e{e}.jsonl", "w") as f:
            f.write("\n".join(lines))
    for register in (register_dataset, tregistry.register_dataset):
        register({"suite": {"data_path_prefix": root, "annotations": root, "frequency": 1}},
                 prefix=prefix, meta_data={})
    return f"{prefix}_suite"


def _exps(dataset="", train=False, **model_kw):
    """(JAX exp, port exp) of the tiny NaVILA.  ``train`` takes the dexbotic
    chat template: tokenize_dexbotic (the training tokenization of both
    packages) asserts the TWO separator style, which llama_3 is not."""
    kw = dict(llm_preset="test", vit_preset="navila_test", **model_kw)
    out = []
    for mod in (jexp, texp):
        extra = {} if mod is jexp else {"device": "cpu"}
        if train:
            extra["tokenizer"] = mod.base_exp.TokenizerConfig(model_max_length=512)
        out.append(mod.NaVILAExp(
            model=mod.NaVILAModelConfig(**kw),
            data=mod.NaVILADataConfig(dataset_name=dataset, image_processor="42", num_images=8,
                                      data_keys=["input_ids", "labels", "image"]),
            **extra))
    return out


def test_dataset_matches_jax(tmp_path):
    name = _write_nav_suite(str(tmp_path / "nav"), "navds")
    jx, tx = _exps(name, train=True)
    datasets = []
    for exp in (jx, tx):
        tok = exp.tokenizer.build_tokenizer()
        datasets.append(exp.data.build_data(exp.build_tokenization(tok)))
    jd, td = datasets
    assert td.length_hints() == jd.length_hints() and len(td) == len(jd)
    for t in (0, 3, 7, 8, 30):
        assert td._history_indices(t) == jd._history_indices(t)
    for i in (0, 5, 13, len(td) - 1):
        a, b = jd[i], td[i]
        assert set(a) == set(b) == {"image", "input_ids", "labels"}
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
    assert isinstance(td, tds.DexNavilaDataset) and isinstance(jd, jds.DexNavilaDataset)


def test_nav_question_and_prompt_are_byte_equal():
    assert texp.NAV_PROMPT == jexp.NAV_PROMPT
    for instr, n in (("go to the red chair", 8), ('turn "left" now', 1), ("", 3)):
        assert texp.nav_question(instr, n) == jexp.nav_question(instr, n)
    for text in ("The next action is move forward 75 cm", "is turn left 20 degree", "stop",
                 "is turn right", "gibberish", "is move forward 40 cm"):
        assert tnav.parse_nav_action(text) == jnav.parse_nav_action(text)
    jb, tb = jnav.FrameHistoryBuffer(4), tnav.FrameHistoryBuffer(4)
    for i in range(7):
        f = np.full((2, 2, 3), i, np.uint8)
        np.testing.assert_array_equal(np.stack(tb.add(f)), np.stack(jb.add(f)))


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (30, 34, 3), dtype=np.uint8) for _ in range(n)]


def _session_pair(max_new_tokens=6):
    jx, tx = _exps()
    cfg_j = jx.model.build_config()
    params = jax.device_get(jnav.init_navila(jax.random.PRNGKey(9), cfg_j))
    cfg_t = tx.model.build_config()
    model = tnav.build_navila(cfg_t, "cpu")
    load_jax_params(model, params)
    tok_j, tok_t = jx.tokenizer.build_tokenizer(), tx.tokenizer.build_tokenizer()
    js = jexp.NaVILAInferenceSession(jx, cfg_j, params, tok_j, max_new_tokens=max_new_tokens)
    ts = texp.NaVILAInferenceSession(tx, cfg_t, model, tok_t, max_new_tokens=max_new_tokens)
    return jx, tx, js, ts, model


def test_session_act_matches_jax():
    """Three frames of an episode through both sessions (greedy): the EOS id
    from the llama_3 stop string, the same prompt ids and the same text."""
    jx, tx, js, ts, _ = _session_pair()
    assert ts.eos_token_id == js.eos_token_id and ts.eos_token_id != 0
    for i, frame in enumerate(_frames(3)):
        if i == 1:
            js.observe(frame)
            ts.observe(frame)
            continue
        want = js.act(frame, "find the sofa", jax.random.PRNGKey(0))
        got = ts.act(frame, "find the sofa")
        assert got == want
    assert len(ts.buffer.frames) == len(js.buffer.frames) == 3
    ids, _, imgs = ts.inputs(_frames(1, 5)[0], "x")
    assert imgs.shape == (1, 8, 42, 42, 3) and int((ids == IMAGE_TOKEN_INDEX).sum()) == 8 * 4


@pytest.mark.parametrize("chunk", [0, 64])
def test_sessions_on_a_shared_engine_match_jax(chunk):
    """Two sessions (two robots, their own histories) on one shared engine,
    their requests in flight together, against JAX's two sessions on a JAX
    engine of the same sizes: the same texts (the engine route stops at the
    EOS id and at 0, as JAX's); the port's engine served the two at once:
    a tick for both slots, or (chunked) a tick between an admission's chunks."""
    jx, tx, _, _, model = _session_pair()
    params = jax.device_get(jnav.init_navila(jax.random.PRNGKey(9), jx.model.build_config()))
    cfg_j, cfg_t = jx.model.build_config(), tx.model.build_config()
    tok_j, tok_t = jx.tokenizer.build_tokenizer(), tx.tokenizer.build_tokenizer()
    kw = dict(slots=2, max_new_tokens=6, max_prompt=640, prefill_chunk=chunk)
    jeng = jexp.NaVILAInferenceSession.make_shared_engine(cfg_j, params, **kw)
    teng = texp.NaVILAInferenceSession.make_shared_engine(cfg_t, model, **kw)
    frames = [_frames(3, 11), _frames(3, 12)]
    try:
        texts = {}
        for pkg, eng in (("jax", jeng), ("port", teng)):
            mod, cfg, m, tok, x = ((jexp, cfg_j, params, tok_j, jx) if pkg == "jax"
                                   else (texp, cfg_t, model, tok_t, tx))
            sessions = [mod.NaVILAInferenceSession(x, cfg, m, tok, engine=eng, max_new_tokens=6)
                        for _ in frames]
            out = [[], []]
            together = threading.Barrier(2)

            def robot(i, sessions=sessions, out=out, pkg=pkg, together=together):
                for f in frames[i]:
                    together.wait(timeout=60)
                    rng = jax.random.PRNGKey(0) if pkg == "jax" else None
                    out[i].append(sessions[i].act(f, f"find the sofa {i}", rng))

            threads = [threading.Thread(target=robot, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            texts[pkg] = out
        assert texts["port"] == texts["jax"] and all(len(o) == 3 for o in texts["port"])
        interleaved = any(t0 < t < t1 for t0, t1, *_ in teng.admit_log for t in teng.tick_times)
        assert teng.batched_steps > 0 or (chunk and interleaved)
        assert {c for *_, c in teng.admit_log} == {bool(chunk)}
    finally:
        jeng.close()
        teng.close()


def _post(port, fields, png):
    boundary = "navtestboundary"
    body = b""
    for k, v in fields.items():
        body += f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
    if png is not None:
        body += (f'--{boundary}\r\nContent-Disposition: form-data; name="image"; '
                 f'filename="f.png"\r\nContent-Type: image/png\r\n\r\n').encode() + png + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/process_frame", data=body,
                                 headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_server_contract():
    """run_model=False appends the frame (BGR) and answers []; a model
    request answers parse_nav_action of the session's text, equal to a direct
    session on the same history; episode_first_frame empties the history."""
    from dexbotic_tpu_torch.exp.serve import NaVILAServer, _decode_frames

    _, tx, _, direct, model = _session_pair()
    server = NaVILAServer(tx, tx.model.build_config(), model, tx.tokenizer.build_tokenizer(),
                          host="127.0.0.1", port=0, max_new_tokens=6)
    frames = _frames(3, 1)
    pngs = [_png(f) for f in frames]
    httpd = server.serve_background()
    port = httpd.server_address[1]
    try:
        assert _post(port, {"text": "go", "episode_first_frame": "True", "run_model": "False"},
                     pngs[0]) == []
        decoded, order = _decode_frames([pngs[0]])
        bgr = decoded[0] if order == "bgr" else decoded[0][..., ::-1]
        np.testing.assert_array_equal(server.session.buffer.frames[0], bgr)
        np.testing.assert_array_equal(server.session.buffer.frames[0], frames[0][..., ::-1])
        assert _post(port, {"text": "go", "run_model": "False"}, pngs[1]) == []
        reply = _post(port, {"text": "go to the door"}, pngs[2])
        for f in frames[:2]:
            direct.observe(f[..., ::-1])
        want = tnav.parse_nav_action(direct.act(frames[2][..., ::-1], "go to the door"))
        assert reply == want and all(a in (0, 1, 2, 3) for a in reply)
        assert len(server.session.buffer.frames) == 3
        assert _post(port, {"text": "go"}, None) == []
        _post(port, {"text": "go", "episode_first_frame": "true", "run_model": "False"}, pngs[1])
        assert len(server.session.buffer.frames) == 1
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_exp_train_packed(tmp_path, monkeypatch):
    """``NaVILAExp.train()``: three packed steps of 4 samples (258-315 tokens:
    the dexbotic template's system text is most of them) in 2 rows of 640
    tokens, soft CE on the digit ids; the packed batches hold 2 segments in
    a row; finite metrics and a checkpoint."""
    monkeypatch.chdir(tmp_path)
    name = _write_nav_suite(str(tmp_path / "nav"), "navtrain")
    _, tx = _exps(name, train=True, pack_max_len=640)
    tx.trainer = ttrainer.TrainerConfig(output_dir=str(tmp_path / "out"), max_steps=3,
                                        per_device_batch_size=2, logging_steps=1, save_steps=3,
                                        bf16=False, resume=False, gradient_checkpointing=True)
    tx.optimizer = toptim.OptimizerConfig(learning_rate=1e-4, freeze_llm=True)
    seen = []
    step = ttrainer.Trainer.train_step

    def recorded(self, batch):
        seen.append({k: np.asarray(v) for k, v in batch.items()})
        return step(self, batch)

    monkeypatch.setattr(ttrainer.Trainer, "train_step", recorded)
    log = tx.train()
    assert log["step"] == 3 and set(log) == {"loss", "text_loss", "grad_norm", "step",
                                             "steps_per_sec", "data_wait_s"}
    assert all(np.isfinite(log[k]) for k in ("loss", "text_loss", "grad_norm"))
    assert os.path.exists(tmp_path / "out" / "checkpoint-3" / "params.pt")
    for b in seen:
        assert b["input_ids"].shape == (2, 640) and b["images"].shape == (4, 8, 42, 42, 3)
        segs = [len(set(row[row >= 0].tolist())) for row in b["segments"]]
        assert sum(segs) == 4 and max(segs) >= 2
        starts = (b["positions"] == 0) & (b["attention_mask"] == 1)
        assert (b["labels"][starts] == IGNORE_INDEX).all()


def test_example_exp_matches_jax():
    """The port's example NaVILA exp holds the JAX example's values in every
    field the two share."""
    from dexbotic_tpu_torch.playground.example_navila_exp import MyNaVILAExp
    from playground.example_navila_exp import MyNaVILAExp as JExample

    j, t = JExample(), MyNaVILAExp()
    for part in ("model", "data", "action", "tokenizer", "optimizer", "trainer"):
        jd, td = dataclasses.asdict(getattr(j, part)), dataclasses.asdict(getattr(t, part))
        common = sorted(set(jd) & set(td))
        assert len(common) >= len(jd) // 2, (part, sorted(set(jd) - set(td)))
        assert {k: td[k] for k in common} == {k: jd[k] for k in common}, part
