"""The port's serving entry points on the CPU at a tiny CogACT.

A multipart POST to /process_frame must return exactly what a direct call of
cogact_inference_action returns from the same generator state; batched and
micro-batched requests and ``--task inference_single`` must run.
"""

import concurrent.futures
import io
import json
import sys
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
from dexbotic_tpu_torch.exp.serve import CogActServer, _cogact_images, _cogact_prompt_ids
from dexbotic_tpu_torch.models.cogact import cogact_inference_action

torch.set_num_threads(2)


def _exp():
    return CogActExp(
        model=CogActModelConfig(llm_preset="test", vit_preset="test", action_model_type="DiT-S",
                                chunk_size=4, seed=7),
        tokenizer=base_exp.TokenizerConfig(model_max_length=96),
        data=base_exp.DataConfig(image_processor="28"),
        device="cpu",
    )


def _png(color) -> bytes:
    buf = io.BytesIO()
    Image.new("RGB", (64, 48), color).save(buf, "PNG")
    return buf.getvalue()


def _post(port, prompt, pngs, batch_size=1):
    b = "XBX"
    body = (f"--{b}\r\nContent-Disposition: form-data; name=\"text\"\r\n\r\n{prompt}\r\n"
            f"--{b}\r\nContent-Disposition: form-data; name=\"batch_size\"\r\n\r\n"
            f"{batch_size}\r\n").encode()
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
    cfg, model, norms = exp.load_for_inference()
    return exp, cfg, model, exp.tokenizer.build_tokenizer(), norms


def _serve(served, **kw):
    exp, cfg, model, tok, norms = served
    server = CogActServer(exp, cfg, model, tok, norms, host="127.0.0.1", port=0, **kw)
    return server, server.serve_background()


def test_process_frame_equals_direct_call(served):
    exp, cfg, model, tok, _ = served
    server, httpd = _serve(served)
    try:
        got = _post(httpd.server_address[1], "pick up the moka pot", [_png((10, 200, 30))])
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert got.shape == (cfg.chunk_size, cfg.action_dim)
    # the same request by hand: ids padded to the server's 64-wide bucket
    ids = _cogact_prompt_ids(exp, cfg, tok, "pick up the moka pot")
    L = -(-len(ids) // 64) * 64
    ids_t = torch.zeros((1, L), dtype=torch.int32)
    ids_t[0, : len(ids)] = torch.tensor(ids)
    valid = (torch.arange(L) < len(ids)).int()[None]
    imgs = torch.from_numpy(_cogact_images([_png((10, 200, 30))],
                                           exp.data.build_image_processor()))[None]
    gen = torch.Generator().manual_seed(exp.model.seed)
    want = cogact_inference_action(model, cfg, ids_t, valid, imgs, generator=gen)[0].numpy()
    np.testing.assert_array_equal(got.astype(np.float32), want)


def test_batched_and_micro_batched_requests(served):
    server, httpd = _serve(served, micro_batch=4, micro_batch_window_ms=200.0)
    port = httpd.server_address[1]
    try:
        both = _post(port, "a;b", [_png((1, 2, 3)), _png((200, 9, 9))], batch_size=2)
        assert both.shape == (2, 4, 7) and np.isfinite(both).all()
        with concurrent.futures.ThreadPoolExecutor(max_workers=3) as ex:
            outs = list(ex.map(lambda i: _post(port, f"task {i}", [_png((40 * i, 90, 10))]),
                               range(3)))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert all(o.shape == (4, 7) and np.isfinite(o).all() for o in outs)
    assert server.batched_calls >= 1


def test_task_inference_single(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["cogact_exp", "--task", "inference_single"])
    e = _exp()
    actions = CogActExp.main(model=e.model, tokenizer=e.tokenizer, data=e.data, device="cpu")
    assert actions.shape == (4, 7) and np.isfinite(actions).all()
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(printed, actions)


def test_unported_options_raise(served):
    with pytest.raises(NotImplementedError):
        _serve(served, fuse_preprocess=True)
    e = _exp()
    e.inference_quantize = "int4"
    with pytest.raises(ValueError):
        e.load_for_inference()


def test_norm_stats_denormalise_served_chunks(served):
    """With norm stats the server maps [-1, 1] chunks to robot units (clipped)."""
    exp, cfg, model, tok, _ = served
    norms = {"min": [-2.0] * 6, "max": [3.0] * 6}  # 6 of 7 dims: the last passes through
    raw_srv = CogActServer(exp, cfg, model, tok, None, host="127.0.0.1", port=0)
    srv = CogActServer(exp, cfg, model, tok, norms, host="127.0.0.1", port=0)
    fields, files = {"text": "go"}, [("im", _png((5, 5, 5)))]
    raw = np.asarray(raw_srv.get_response(fields, files))
    got = np.asarray(srv.get_response(fields, files))
    want = -2.0 + (np.clip(raw[:, :6], -1, 1) + 1.0) * 0.5 * 5.0
    np.testing.assert_allclose(got[:, :6], want, rtol=1e-6)
    np.testing.assert_array_equal(got[:, 6], raw[:, 6])
