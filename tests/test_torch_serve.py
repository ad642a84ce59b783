"""The port's serving entry points on the CPU at a tiny CogACT.

A multipart POST to /process_frame must return exactly what a direct call of
cogact_inference_action returns from the same generator state; batched and
micro-batched requests and ``--task inference_single`` must run.  On-device
preprocessing (``fuse_preprocess``, ops/image_ops.py) against the JAX
functions and the host path; the robot client against the JAX client.
Request dumps (``save_image_dir``) against JAX's files on every route: the
sequential and concurrent ones, the micro-batch worker's batched and retry
ones; a dump that cannot be written is the request's error.
"""

import concurrent.futures
import io
import json
import sys
import urllib.error
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


def _post_status(port, prompt, pngs, batch_size=1):
    """(HTTP status, the JSON body) of one multipart request."""
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
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(port, prompt, pngs, batch_size=1):
    status, body = _post_status(port, prompt, pngs, batch_size)
    assert status == 200, body
    return np.asarray(body)


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


def test_close_stops_the_micro_batch_worker():
    """close() ends a micro-batched server's worker thread once the queued
    requests are served, and with it the worker's hold on the server and
    its model."""
    import gc
    import weakref

    from dexbotic_tpu_torch.exp.serve import ActionServer

    class Echo(ActionServer):
        def __init__(self):
            super().__init__(micro_batch=2, micro_batch_window_ms=1.0)
            self.model = torch.nn.Linear(2, 2)

        def get_response(self, fields, files):
            return fields["x"]

    server = Echo()
    assert server._submit_single({"x": 1}, []) == 1
    thread, model = server._mb_thread, weakref.ref(server.model)
    server.close()
    thread.join(timeout=10)
    assert not thread.is_alive()
    del server
    gc.collect()
    assert model() is None


def test_task_inference_single(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["cogact_exp", "--task", "inference_single"])
    e = _exp()
    actions = CogActExp.main(model=e.model, tokenizer=e.tokenizer, data=e.data, device="cpu")
    assert actions.shape == (4, 7) and np.isfinite(actions).all()
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(printed, actions)


def test_unported_options_raise(served):
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


# ---------------------------------------------------------------------------
# Request dumps (ActionServer.save_image_dir)
# ---------------------------------------------------------------------------


def _dumped(path) -> dict:
    return {f.name: f.read_bytes() for f in sorted(path.iterdir())}


@pytest.mark.parametrize("case", ["one-frame", "three-frames", "no-frames"])
def test_maybe_dump_writes_the_jax_files(case, tmp_path):
    """The port's ``_maybe_dump`` and JAX's write the same files, byte for
    byte, for the same fields, payloads and results, numbered alike."""
    from dexbotic_tpu.exp.serve import ActionServer as JaxServer
    from dexbotic_tpu_torch.exp.serve import ActionServer

    frames = {"one-frame": [("image", _png((1, 2, 3)))],
              "three-frames": [("a", _png((9, 9, 9))), ("b", b"not a png\x00\xff"),
                               ("c", _frame_png((30, 50), 1))],
              "no-frames": []}[case]
    requests = [({"text": "pick up the cube", "batch_size": "1"}, frames,
                 [[0.125, -1.5], [2.0, 1e-7]]),
                ({"text": "go", "states": "[[0.1, 0.2]]"}, frames[::-1],
                 {"text": "<a>", "actions": [[1, 2]]})]
    for cls, name in ((JaxServer, "jax"), (ActionServer, "port")):
        server = cls(host="127.0.0.1", port=0, save_image_dir=str(tmp_path / name / "dump"))
        for fields, files, result in requests:
            server._maybe_dump(fields, files, result)
    port, jax_files = _dumped(tmp_path / "port" / "dump"), _dumped(tmp_path / "jax" / "dump")
    assert port == jax_files
    assert len(port) == 2 * (len(frames) + 1)
    assert json.loads(port["resp_000001.json"]) == {"fields": requests[1][0],
                                                    "result": requests[1][2]}
    if frames:
        assert port[f"frame_000000_{len(frames) - 1}.png"] == frames[-1][1]


def _stub_server(base, route: str, dump_dir):
    """A server of ``base`` answering a request with its text and payload
    sizes, raising on the text 'bad'; its micro-batches are served by a stub
    ``get_batched_response`` that fails the whole batch on one bad request."""

    class Stub(base):
        concurrent = route == "concurrent"

        def get_response(self, fields, files):
            if fields["text"] == "bad":
                raise ValueError("bad request")
            return {"echo": fields["text"], "sizes": [len(p) for _, p in files]}

        def get_batched_response(self, requests):
            self.stub_batches = getattr(self, "stub_batches", 0) + 1
            return [self.get_response(f, fl) for f, fl in requests]

    micro = route.startswith("micro-batched")
    server = Stub(host="127.0.0.1", port=0, micro_batch=3 if micro else 0,
                  micro_batch_window_ms=5000.0)
    server.save_image_dir = dump_dir  # the subclasses take it as an attribute, as in JAX
    return server


def _serve_stub(base, route, dump_dir, requests):
    """Post ``requests`` [(text, pngs)] to a stub server (concurrently on the
    micro-batched routes); returns ({text: (status, body)}, server)."""
    server = _stub_server(base, route, dump_dir)
    httpd = server.serve_background()
    port = httpd.server_address[1]
    try:
        if route.startswith("micro-batched"):
            with concurrent.futures.ThreadPoolExecutor(max_workers=len(requests)) as ex:
                outs = list(ex.map(lambda r: _post_status(port, *r), requests))
        else:
            outs = [_post_status(port, *r) for r in requests]
    finally:
        httpd.shutdown()
        httpd.server_close()
        if hasattr(server, "close"):  # the port's server stops its micro-batch worker
            server.close()
    return {text: out for (text, _), out in zip(requests, outs)}, server


@pytest.mark.parametrize("route", ["sequential", "concurrent", "micro-batched",
                                   "micro-batched-retry"])
def test_every_route_dumps_each_answered_request(route, tmp_path):
    """The sequential and concurrent routes and the micro-batch worker's
    batched and one-by-one retry routes dump each answered request once (its
    payloads as posted, its result as answered) and a failed one not at all,
    in both packages alike."""
    from dexbotic_tpu.exp.serve import ActionServer as JaxServer
    from dexbotic_tpu_torch.exp.serve import ActionServer

    pngs = {"a": [_png((1, 2, 3))], "b": [_png((9, 90, 9)), _frame_png((30, 50), 2)],
            "c": [_png((200, 9, 9))], "bad": [_png((5, 5, 5))]}
    texts = ["a", "b", "c"] if route == "micro-batched" else ["a", "bad", "b"]
    requests = [(t, pngs[t]) for t in texts]
    dumps = {}
    for base, name in ((JaxServer, "jax"), (ActionServer, "port")):
        dump_dir = tmp_path / name
        answers, server = _serve_stub(base, route, str(dump_dir), requests)
        if route.startswith("micro-batched"):
            assert server.batched_calls == 1 and server.stub_batches == 1
        by_text = {}
        for resp in sorted(dump_dir.glob("resp_*.json")):
            i = resp.name[len("resp_"):-len(".json")]
            dumped = json.loads(resp.read_text())
            frames = [f.read_bytes() for f in sorted(dump_dir.glob(f"frame_{i}_*.png"))]
            text = dumped["fields"]["text"]
            assert text not in by_text, f"{name}: {text} dumped twice"
            by_text[text] = (dumped, frames)
        good = [t for t in texts if t != "bad"]
        assert sorted(by_text) == sorted(good), name
        for t in good:
            status, body = answers[t]
            dumped, frames = by_text[t]
            assert status == 200 and dumped["result"] == body, (name, t)
            assert frames == pngs[t], (name, t)
        if "bad" in texts:
            assert answers["bad"][0] == 500
        dumps[name] = {t: (d["result"], f) for t, (d, f) in by_text.items()}
        if route in ("sequential", "concurrent"):  # answered in order: numbered alike
            dumps[name + " files"] = _dumped(dump_dir)
    assert dumps["port"] == dumps["jax"]
    if route in ("sequential", "concurrent"):
        assert dumps["port files"] == dumps["jax files"]


@pytest.mark.parametrize("route", ["sequential", "concurrent", "micro-batched"])
def test_a_failed_dump_is_the_requests_error(route, tmp_path):
    """A dump that cannot be written fails its request with a 500 in both
    packages (in the micro-batch worker after the one-by-one retry): it is
    never passed over."""
    from dexbotic_tpu.exp.serve import ActionServer as JaxServer
    from dexbotic_tpu_torch.exp.serve import ActionServer

    blocker = tmp_path / "a-file"
    blocker.write_text("")
    requests = [(t, [_png((i, 0, 0))]) for i, t in enumerate(["a", "b", "c"])]
    for base in (JaxServer, ActionServer):
        answers, _ = _serve_stub(base, route, str(blocker / "dump"), requests)
        assert sorted(status for status, _ in answers.values()) == [500] * 3


# ---------------------------------------------------------------------------
# On-device preprocessing (ops/image_ops.py, CogActServer(fuse_preprocess=True))
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("out_n,in_n", [(28, 64), (28, 48), (336, 640), (40, 20), (28, 28)])
@pytest.mark.parametrize("resample", ["bicubic", "bilinear"])
def test_resize_matrix_matches_jax(out_n, in_n, resample):
    from dexbotic_tpu.ops.image_ops import resize_matrix as jax_resize_matrix
    from dexbotic_tpu_torch.ops.image_ops import resize_matrix

    np.testing.assert_array_equal(resize_matrix(out_n, in_n, resample),
                                  jax_resize_matrix(out_n, in_n, resample))


def _clip8_reference(frames, in_hw, size, resample, pad, fill):
    """(pixels, tie-affected mask) of the two clip8 passes in float64: a
    pixel is tie-affected where a pass's exact value lies within 1e-4 of a
    .5 rounding tie, in its own vertical pass or in a horizontal value that
    feeds it; there fp32 sums in another order may round the other way."""
    from dexbotic_tpu_torch.ops.image_ops import resize_matrix

    x = frames.astype(np.float64)
    H, W = in_hw
    if pad and H != W:
        side = max(H, W)
        canvas = np.broadcast_to(np.asarray(fill, np.float64), (len(x), side, side, 3)).copy()
        top, left = (side - H) // 2, (side - W) // 2
        canvas[:, top:top + H, left:left + W] = x
        x = canvas
    tx = resize_matrix(size, x.shape[2], resample)
    ty = resize_matrix(size, x.shape[1], resample)

    def tie(v):
        return np.abs(v - np.floor(v) - 0.5) < 1e-4

    h = np.einsum("jx,byxc->byjc", tx, x)
    h_tie = tie(h)
    h = np.clip(np.round(h), 0, 255)
    v = np.einsum("iy,byxc->bixc", ty, h)
    affected = tie(v) | (np.einsum("iy,byxc->bixc", (ty != 0).astype(np.float64),
                                   h_tie.astype(np.float64)) > 0)
    return np.clip(np.round(v), 0, 255), affected


@pytest.mark.parametrize("in_hw,pad", [((48, 64), True), ((64, 40), True), ((40, 40), True),
                                       ((48, 64), False)])
@pytest.mark.parametrize("resample", ["bicubic", "bilinear"])
def test_device_preprocess_matches_jax(in_hw, pad, resample):
    """Square and non-square frames, with and without the pad: after each
    clip8 pass the port's pixels and JAX's equal the exact (float64) ones,
    but where an exact value is a .5 rounding tie, which fp32 sums in
    another order may break either way (one quantum); the normalisation is
    the same ops, so equal pixels give equal values."""
    import jax.numpy as jnp

    from dexbotic_tpu.ops.image_ops import make_device_preprocess as jax_prep
    from dexbotic_tpu_torch.ops.image_ops import make_device_preprocess

    frames = np.random.default_rng(5).integers(0, 256, (2, *in_hw, 3), dtype=np.uint8)
    fill = (122, 116, 104)
    raw = dict(resample=resample, pad_to_square=pad, fill=fill, rescale=1.0)
    want_px = np.asarray(jax_prep(in_hw, 28, **raw)(jnp.asarray(frames)))
    got_px = make_device_preprocess(in_hw, 28, device="cpu", **raw)(torch.from_numpy(frames))
    got_px = got_px.numpy()
    exact, affected = _clip8_reference(frames, in_hw, 28, resample, pad, fill)
    assert got_px.shape == want_px.shape == exact.shape == (2, 28, 28, 3)
    assert affected.mean() < 0.25  # bilinear 40 -> 28: ~20 % on or below a tie, others <= 2.4 %
    for px in (got_px, want_px):
        np.testing.assert_array_equal(px[~affected], exact[~affected])
        assert np.abs(px - exact).max() <= 1.0
    kw = dict(resample=resample, mean=(0.48145466, 0.4578275, 0.40821073),
              std=(0.26862954, 0.26130258, 0.27577711), pad_to_square=pad, fill=fill)
    want = np.asarray(jax_prep(in_hw, 28, **kw)(jnp.asarray(frames)))
    got = make_device_preprocess(in_hw, 28, device="cpu", **kw)(torch.from_numpy(frames)).numpy()
    same = got_px == want_px
    np.testing.assert_array_equal(got[same], want[same])


def _frame_png(hw, seed) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
        buf, "PNG")
    return buf.getvalue()


def test_fused_preprocess_matches_host_path(served):
    """Raw uint8 upload + the device's flip, pad, resize and normalisation
    give the host path's chunk (the JAX test's 2e-2), the pixels within
    float noise of each other; one cached plan per camera geometry."""
    exp, cfg, model, tok, norms = served
    host = CogActServer(exp, cfg, model, tok, norms, host="127.0.0.1", port=0)
    fused = CogActServer(exp, cfg, model, tok, norms, host="127.0.0.1", port=0,
                         fuse_preprocess=True)
    fields = {"text": "pick up the cube"}
    for seed in range(2):
        frames = [("image", _frame_png((48, 64), seed))]
        a_host = np.asarray(host.get_response(fields, frames))
        a_fused = np.asarray(fused.get_response(fields, frames))
        assert a_fused.shape == a_host.shape == (cfg.chunk_size, cfg.action_dim)
        np.testing.assert_allclose(a_fused, a_host, atol=2e-2)
    assert (fused.fused_calls, fused.host_calls, host.fused_calls, host.host_calls) == (2, 0, 0, 2)
    assert len(fused._device_prep) == 1
    from dexbotic_tpu_torch.exp.serve import _decode_frames

    pngs = [_frame_png((48, 64), 7), _frame_png((48, 64), 8)]
    frames, order = _decode_frames(pngs)
    dev = fused.device_images(frames, order, 2)[0].numpy()
    hst = _cogact_images(pngs, exp.data.build_image_processor())
    proc = exp.data.build_image_processor()
    quanta = np.abs(dev - hst) * np.asarray(proc.std) / proc.rescale
    assert dev.shape == hst.shape and quanta.max() <= 2.0
    assert len(fused._device_prep) == 2  # a second geometry: two views a row


def test_fused_preprocess_mixed_shapes_take_the_host_route(served):
    """A batch_size=2 request whose frames differ in shape is served by the
    host path, as in the JAX server, and counted there; the HTTP route
    serves fused requests too."""
    server, httpd = _serve(served, fuse_preprocess=True)
    port = httpd.server_address[1]
    try:
        mixed = _post(port, "a;b", [_png((1, 2, 3)), _frame_png((30, 50), 1)], batch_size=2)
        same = _post(port, "a;b", [_png((1, 2, 3)), _png((200, 9, 9))], batch_size=2)
        one = _post(port, "go", [_png((9, 9, 9))])
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert mixed.shape == same.shape == (2, 4, 7) and one.shape == (4, 7)
    assert np.isfinite(mixed).all() and np.isfinite(same).all()
    assert (server.fused_calls, server.host_calls) == (2, 1)
    assert len(server._device_prep) == 1  # both fused requests: 48x64 frames, one view


# ---------------------------------------------------------------------------
# The robot client
# ---------------------------------------------------------------------------


def test_dex_client_matches_the_jax_client(served):
    """The port's DexClient and the JAX one against one port server: the same
    requests (a refill every ``execute_steps`` actions), the same actions
    from the same generator state, the same delta -> absolute with +-pi
    wrapping of the angle dims."""
    pytest.importorskip("requests")
    from dexbotic_tpu.client import DexClient as JaxClient
    from dexbotic_tpu_torch.client import DexClient

    exp, cfg, model, tok, norms = served
    server, httpd = _serve(served)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/process_frame"
    frame = np.random.default_rng(3).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    state = np.array([0.1, -0.2, 0.3, 3.1, -3.1, 0.5, 1.0], np.float64)
    runs = []
    try:
        for cls in (DexClient, JaxClient):
            server.generator.manual_seed(exp.model.seed)
            calls = server.host_calls
            client = cls(url=url, execute_steps=3, delta_action=True)
            acts = [client.act(frame, "pick up the cube", state=state) for _ in range(7)]
            runs.append((np.stack(acts), server.host_calls - calls, len(client.queue)))
            client.reset()
            assert not client.queue
    finally:
        httpd.shutdown()
        httpd.server_close()
    (port_acts, port_calls, port_left), (jax_acts, jax_calls, jax_left) = runs
    assert port_calls == jax_calls == 3 and port_left == jax_left == 2
    np.testing.assert_array_equal(port_acts, jax_acts)
    assert port_acts.shape == (7, cfg.action_dim)
    assert np.all(np.abs(port_acts[:, 3:6]) <= np.pi)
    delta = np.array([0.0, 0.0, 0.0, 0.2, -0.3, 7.0, 0.1])
    for d in (delta, -delta):
        np.testing.assert_allclose(DexClient(delta_action=True)._integrate(d, state),
                                   JaxClient(delta_action=True)._integrate(d, state))
