"""The port's pi0 serving entry points on the CPU at a tiny pi0, pi0.5 and DM0.

A multipart POST to /process_frame (3 views and a state, 1 view with the
others masked, batch_size=2, micro-batched singles) must return what a
direct call of flow_vla_inference_action returns from the same generator
state, after the served state normalisation and output transforms (mean/std
for pi0, the quantiles for pi0.5 and DM0, whose tokenization and text bucket
differ too); those transforms and ServingStats must equal the JAX
FlowVLAServer's on one raw chunk (float64 on both sides, rtol 1e-12).
"""

import concurrent.futures
import dataclasses
import io
import json
import sys
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from dexbotic_tpu.exp import pi0_exp as jexp
from dexbotic_tpu.exp import serve as jserve
from dexbotic_tpu_torch.exp.pi0_exp import DM0Exp, FlowModelConfig, Pi0Exp, Pi05Exp
from dexbotic_tpu_torch.exp.serve import FlowVLAServer, ServingStats, _decode_frames
from dexbotic_tpu_torch.data.image_processing import preprocess_images_batch
from dexbotic_tpu_torch.models import presets
from dexbotic_tpu_torch.models.flow_vla import flow_vla_inference_action

torch.set_num_threads(2)

NORMS = {"action": {"mean": [0.1] * 7, "std": [2.0] * 7, "min": [-1.0] * 7, "max": [3.0] * 7},
         "state": {"mean": [0.5] * 8, "std": [0.25] * 8, "min": [-2.0] * 8, "max": [2.0] * 8}}


def _exp(cls=Pi0Exp, **model):
    base = cls()
    tiny = dict(llm_preset="test", vit_preset="test", expert_preset="test", action_dim=8,
                chunk_size=5, num_flow_steps=3, seed=5)
    return cls(model=FlowModelConfig(**{**dataclasses.asdict(base.model), **tiny, **model}),
               data=dataclasses.replace(base.data, image_processor="28"), device="cpu")


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


@pytest.fixture(scope="module")
def served():
    exp = _exp()
    cfg, model, _ = exp.load_for_inference()
    return exp, cfg, model, exp.tokenizer.build_tokenizer()


@pytest.fixture(scope="module", params=["pi05", "dm0"])
def served_variant(request):
    """A tiny pi0.5 (the adaRMS expert, its zero-initialised ``dense``
    projections redrawn so that the time condition counts) or DM0 (qk-norm
    in both streams, as the Qwen3 pair: tiny presets registered for the
    build), each exp's quantile statistics and tokenization."""
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "pi05":
            exp = _exp(Pi05Exp, expert_preset="test_adarms")
        else:
            mp.setitem(presets.LLM_PRESETS, "test_qk",
                       dataclasses.replace(presets.LLM_TEST, qk_norm=True))
            mp.setitem(presets.EXPERT_PRESETS, "test_qk",
                       dataclasses.replace(presets.EXPERT_TEST, qk_norm=True))
            exp = _exp(DM0Exp, llm_preset="test_qk", expert_preset="test_qk")
        cfg, model, _ = exp.load_for_inference()
    assert exp.action.use_quantiles and (cfg.adarms or cfg.llm.qk_norm and cfg.expert.qk_norm)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".dense." in name:
                p.normal_(0.0, 0.05, generator=gen)
    return exp, cfg, model, exp.tokenizer.build_tokenizer()


def _direct(exp, cfg, model, tok, prompt, groups, state_rows, norms, gen):
    """The request by hand: ids padded to the 64-token bucket, views
    preprocessed and masked, the state normalised, the chunk denormalised
    (NORMS by hand: mean/std, or the min/max quantiles with the padded dim's
    identity -1/1) and made absolute against the raw state, cut to the env's
    7 dims."""
    B, n = len(groups), exp.data.num_images
    quantiles = exp.action.use_quantiles
    ids = np.asarray(exp.build_tokenization(tok)(
        conversations=[{"from": "human", "value": prompt}])["input_ids"], np.int32)
    ids_b = np.zeros((B, -(-len(ids) // 64) * 64), np.int32)
    ids_b[:, : len(ids)] = ids
    proc = exp.data.build_image_processor()
    imgs = np.zeros((B, n, proc.size, proc.size, 3), np.float32)
    masks = np.zeros((B, n), np.int32)
    for b, g in enumerate(groups):
        frames, order = _decode_frames(g)
        imgs[b, : len(g)] = preprocess_images_batch(frames, proc, channel_order=order)
        masks[b, : len(g)] = 1
    stats = ServingStats(norms, use_quantiles=quantiles)
    st = np.stack(state_rows).astype(np.float32)
    raw = flow_vla_inference_action(
        model, cfg, torch.from_numpy(ids_b), torch.from_numpy((ids_b != 0).astype(np.int32)),
        torch.from_numpy(imgs), torch.from_numpy(masks),
        torch.from_numpy(stats.normalize("state", st)), generator=gen).float().numpy()
    out = []
    for b in range(B):
        a = raw[b].astype(np.float64)
        if norms is not None and quantiles:
            lo, hi = np.concatenate([np.full(7, -1.0), [-1.0]]), np.concatenate([np.full(7, 3.0), [1.0]])
            a = (a + 1.0) / 2.0 * (hi - lo + 1e-6) + lo
        elif norms is not None:
            a = a * np.concatenate([np.full(7, 2.0 + 1e-6), np.ones(1)]) + \
                np.concatenate([np.full(7, 0.1), np.zeros(1)])
        absolute = a + np.asarray(state_rows[b], np.float64)[None]
        absolute[:, 6] = a[:, 6]  # the gripper stays as predicted
        out.append(absolute[:, :7])
    return np.stack(out)


def _serve(served, norms=None, **kw):
    exp, cfg, model, tok = served
    server = FlowVLAServer(exp, cfg, model, tok, norms, host="127.0.0.1", port=0, **kw)
    return server, server.serve_background()


@pytest.mark.parametrize("n_views", [3, 1])
def test_process_frame_equals_direct_call(served, n_views):
    """3 views and a state; 1 view, the other two zero-filled and masked."""
    exp, cfg, model, tok = served
    pngs = [_png((10 + 60 * i, 200 - 50 * i, 30)) for i in range(n_views)]
    state = [0.3, -0.2, 0.1, 0.0, 0.5, -0.4, 1.0]
    server, httpd = _serve(served, NORMS)
    try:
        got = _post(httpd.server_address[1], "pick up the moka pot", pngs, json.dumps(state))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert got.shape == (cfg.chunk_size, 7)
    row = np.zeros(8, np.float32)
    row[:7] = state
    want = _direct(exp, cfg, model, tok, "pick up the moka pot", [pngs], [row], NORMS,
                   torch.Generator().manual_seed(exp.model.seed))[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_views", [3, 1])
def test_process_frame_equals_direct_call_pi05_dm0(served_variant, n_views):
    """pi0.5 and DM0 through /process_frame: their tokenization (DM0's 100
    ids of the step template, in the 128-token bucket), the quantile
    normalisation of the state and the quantile denormalisation of the
    chunk; 3 views and 1 view, the chunk equal to a direct call's."""
    exp, cfg, model, tok = served_variant
    pngs = [_png((10 + 60 * i, 200 - 50 * i, 30)) for i in range(n_views)]
    state = [0.3, -0.2, 0.1, 0.0, 0.5, -0.4, 1.0]
    server, httpd = _serve(served_variant, NORMS)
    try:
        got = _post(httpd.server_address[1], "pick up the moka pot", pngs, json.dumps(state))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert server.stats.use_quantiles and got.shape == (cfg.chunk_size, 7)
    row = np.zeros(8, np.float32)
    row[:7] = state
    want = _direct(exp, cfg, model, tok, "pick up the moka pot", [pngs], [row], NORMS,
                   torch.Generator().manual_seed(exp.model.seed))[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the quantiles moved the chunk: the mean/std reading of the same raw chunk differs
    mean_std = dataclasses.replace(exp, action=dataclasses.replace(exp.action, use_quantiles=False))
    other = _direct(mean_std, cfg, model, tok, "pick up the moka pot", [pngs], [row], NORMS,
                    torch.Generator().manual_seed(exp.model.seed))[0]
    assert np.abs(other - want).max() > 1e-2


def test_batch_size_2_equals_direct_call(served):
    exp, cfg, model, tok = served
    groups = [[_png((1, 2, 3)), _png((9, 9, 200))], [_png((200, 9, 9)), _png((5, 90, 5))]]
    server, httpd = _serve(served)
    try:
        got = _post(httpd.server_address[1], "stack the cups", [p for g in groups for p in g],
                    "0.1,0.2;-0.3,0.4", batch_size=2)
    finally:
        httpd.shutdown()
        httpd.server_close()
    rows = [np.array([0.1, 0.2, 0, 0, 0, 0, 0, 0], np.float32),
            np.array([-0.3, 0.4, 0, 0, 0, 0, 0, 0], np.float32)]
    want = _direct(exp, cfg, model, tok, "stack the cups", groups, rows, None,
                   torch.Generator().manual_seed(exp.model.seed))
    assert got.shape == (2, cfg.chunk_size, 7)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_micro_batched_requests(served):
    server, httpd = _serve(served, micro_batch=4, micro_batch_window_ms=200.0)
    port = httpd.server_address[1]
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=3) as ex:
            outs = list(ex.map(lambda i: _post(port, f"task {i}", [_png((40 * i, 90, 10))] * 3,
                                               f"[{i}, 1.0]"), range(3)))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert all(o.shape == (5, 7) and np.isfinite(o).all() for o in outs)
    assert server.batched_calls >= 1
    # each request kept its own state: the absolute chunks differ by it in dim 0
    assert len({round(float(o[0, 0]), 4) for o in outs}) == 3


@pytest.mark.parametrize("norms,quantiles", [(NORMS, False), (NORMS, True),
                                             ({"min": [-2.0] * 6, "max": [3.0] * 6}, True),
                                             (None, False)])
def test_output_transforms_match_jax_server(served, norms, quantiles):
    """ServingStats and _postprocess on one raw 32-wide chunk against the JAX
    FlowVLAServer's (its model is never called)."""
    exp, cfg, model, tok = served
    e = dataclasses.replace(exp, action=dataclasses.replace(exp.action, use_quantiles=quantiles))
    je = jexp.Pi0Exp()
    je.action.use_quantiles = quantiles
    jsrv = jserve.FlowVLAServer(je, None, None, None, norms, host="127.0.0.1", port=0)
    tsrv = FlowVLAServer(e, cfg, model, tok, norms, host="127.0.0.1", port=0)
    rng = np.random.default_rng(3)
    raw = rng.uniform(-1.5, 1.5, (50, 32))
    state = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(tsrv._postprocess(raw, state), jsrv._postprocess(raw, state),
                               rtol=1e-12, atol=0)
    x = rng.standard_normal((2, 8)).astype(np.float32)
    np.testing.assert_array_equal(tsrv.stats.normalize("state", x), jsrv.stats.normalize("state", x))
    np.testing.assert_allclose(tsrv.stats.denormalize("action", raw),
                               jsrv.stats.denormalize("action", raw), rtol=1e-12, atol=0)
    assert FlowVLAServer._parse_state("[1, 2.5]", 4).tolist() == \
        jserve.FlowVLAServer._parse_state("[1, 2.5]", 4).tolist() == [1.0, 2.5, 0.0, 0.0]


def test_task_inference_single_and_unported_training(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["pi0_exp", "--task", "inference_single"])
    e = _exp(Pi05Exp, expert_preset="test_adarms")
    actions = Pi05Exp.main(model=e.model, data=e.data, device="cpu")
    assert actions.shape == (5, 8) and np.isfinite(actions).all()
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(printed, actions)
    # training is ported: ``--task train`` reaches BaseExp.train, which every
    # flow exp inherits (tests/test_torch_pi0_train.py runs it end to end)
    from dexbotic_tpu_torch.exp.base_exp import BaseExp

    assert Pi0Exp.train is Pi05Exp.train is BaseExp.train
    monkeypatch.setattr(sys, "argv", ["pi0_exp", "--task", "train"])
    monkeypatch.setattr(BaseExp, "train", lambda self: ("trained", self.exp_name))
    assert Pi0Exp.main(model=e.model, data=e.data, device="cpu") == ("trained", "pi0")
    with pytest.raises(ValueError):
        dataclasses.replace(e, inference_quantize="int4").load_for_inference()
