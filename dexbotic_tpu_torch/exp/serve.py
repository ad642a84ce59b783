"""HTTP action server: POST /process_frame -> JSON action chunk.

Port of the serving paths of dexbotic_tpu/exp/serve.py: CogACT, OFT,
MemVLA, NaVILA and the flow VLAs (pi0/pi0.5/DM0) answer a multipart form
with a 'text' prompt, image file parts and optional 'batch_size' and
'states' fields with a JSON [chunk_size x action_dim] list (a list of those
for batch_size > 1); the text policies, Discrete VLA and MUVLA, answer
{"text": ..., ...}.  Stdlib http.server; host-side image preprocessing, or
for CogACT and OFT on the device (``fuse_preprocess``); optional
micro-batching of concurrent single-frame requests, or, for the text
policies, the continuous-batching decode engine (``exp/decode_engine.py``).
The device call draws its noise from one ``torch.Generator`` seeded from the
config and advanced by every request.
"""

from __future__ import annotations

import io
import json
import os
import queue
import re
import threading
import time
import traceback
from typing import Optional
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
from PIL import Image

from dexbotic_tpu_torch.data.image_processing import preprocess_images_batch, to_numpy_image
from dexbotic_tpu_torch.tokenization import conversation as conversation_lib
from dexbotic_tpu_torch.tokenization.tokenize import tokenizer_image_token


def _disposition_param(header: str, key: str):
    """name/filename out of a Content-Disposition line (quoted or bare)."""
    m = re.search(rf'{key}="((?:[^"\\]|\\.)*)"', header) or re.search(
        rf"{key}=([^;\r\n]+)", header)
    return m.group(1).replace('\\"', '"') if m else None


def parse_multipart(headers: dict, body: bytes):
    """Parse a multipart/form-data body -> (fields: dict, files: list of (name, bytes))."""
    ctype = headers.get("Content-Type", headers.get("content-type", ""))
    if not ctype.startswith("multipart/form-data"):
        try:
            return json.loads(body.decode() or "{}"), []
        except json.JSONDecodeError:
            return {}, []
    m = re.search(r'boundary="?([^";,]+)"?', ctype)
    if not m:
        return {}, []
    delim = b"--" + m.group(1).encode()
    fields, files = {}, []
    pos = body.find(delim)
    while pos != -1:
        pos += len(delim)
        if body.startswith(b"--", pos):
            break
        if body.startswith(b"\r\n", pos):
            pos += 2
        elif body.startswith(b"\n", pos):
            pos += 1
        nxt = body.find(delim, pos)
        part = body[pos: (nxt if nxt != -1 else len(body))]
        pos = nxt
        sep, off = part.find(b"\r\n\r\n"), 4
        if sep == -1:
            sep, off = part.find(b"\n\n"), 2
        if sep == -1:
            continue
        head = part[:sep].decode("utf-8", "replace")
        payload = part[sep + off:]
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        elif payload.endswith(b"\n"):
            payload = payload[:-1]
        name = _disposition_param(head, "name")
        filename = _disposition_param(head, "filename")
        if filename:
            files.append((name, payload))
        else:
            fields[name] = payload.decode()
    return fields, files


class ServingStats:
    """Serving-side state normalisation and action denormalisation, as the
    JAX ``ServingStats``: ``use_quantiles`` picks (x - min) / (max - min +
    1e-6) * 2 - 1 over (x - mean) / (std + 1e-6); the denormalisation pads
    the statistics to the data width with identity values and does not clip."""

    def __init__(self, mapping, use_quantiles: bool):
        self.mapping = mapping if isinstance(mapping, dict) else {}
        self.use_quantiles = use_quantiles

    def has(self, key: str) -> bool:
        return isinstance(self.mapping.get(key), dict)

    def _st(self, key, names, width=None):
        st = [np.asarray(self.mapping[key][n], np.float64).reshape(-1) for n in names]
        if width is not None:  # identity padding to the data width
            fill = {"min": -1.0, "max": 1.0, "mean": 0.0, "std": 1.0}
            st = [np.concatenate([v, np.full(width - v.shape[-1], fill[n])])
                  if v.shape[-1] < width else v for n, v in zip(names, st)]
        return st

    def normalize(self, key: str, x: np.ndarray) -> np.ndarray:
        if not self.has(key):
            return x
        if self.use_quantiles:
            lo, hi = self._st(key, ("min", "max"))
            return ((x - lo) / (hi - lo + 1e-6) * 2.0 - 1.0).astype(np.float32)
        mean, std = self._st(key, ("mean", "std"))
        return ((x - mean) / (std + 1e-6)).astype(np.float32)

    def denormalize(self, key: str, x: np.ndarray) -> np.ndarray:
        if not self.has(key):
            return x
        if self.use_quantiles:
            lo, hi = self._st(key, ("min", "max"), width=x.shape[-1])
            return (x + 1.0) / 2.0 * (hi - lo + 1e-6) + lo
        mean, std = self._st(key, ("mean", "std"), width=x.shape[-1])
        return x * (std + 1e-6) + mean


def _cogact_prompt_ids(exp, cfg, tokenizer, prompt: str, assistant_stub=" ") -> list:
    """Raw request text -> token ids with the image placeholders expanded."""
    template = exp.action.prompt_template
    text = template.format(prompt=prompt) if "{prompt}" in template else prompt
    if "<image>" not in text:
        text = "<image>\n" + text
    conv = conversation_lib.conv_templates[exp.tokenizer.chat_template].copy()
    conv.append_message(conv.roles[0], text)
    conv.append_message(conv.roles[1], assistant_stub)
    return tokenizer_image_token(conv.get_prompt(), tokenizer,
                                 num_image_tokens=cfg.vlm.num_image_tokens)


MAX_TEXT_TOKENS = 64  # a request's own text the engine-backed servers make room for


def engine_max_prompt(empty_prompt_ids: int) -> int:
    """The decode engine's prompt capacity for a served policy: the 64-token
    bucket of the prompt built around an empty request text (the template and
    the image slots) plus MAX_TEXT_TOKENS of the request's own text."""
    return -(-(empty_prompt_ids + MAX_TEXT_TOKENS) // 64) * 64


def _decode_frames(payloads) -> tuple[list, str]:
    """Raw multipart payloads / arrays / PIL images -> (uint8 HWC arrays, channel order)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    out, orders = [], []
    for p in payloads:
        if isinstance(p, (np.ndarray, Image.Image)):
            out.append(to_numpy_image(p))
            orders.append("rgb")
            continue
        img = cv2.imdecode(np.frombuffer(p, np.uint8), cv2.IMREAD_COLOR) if cv2 else None
        if img is not None:
            out.append(img)
            orders.append("bgr")
        else:
            out.append(to_numpy_image(Image.open(io.BytesIO(p))))
            orders.append("rgb")
    if len(set(orders)) > 1:  # mixed sources: normalise to RGB up front
        return [a[:, :, ::-1] if o == "bgr" else a for a, o in zip(out, orders)], "rgb"
    return out, orders[0] if orders else "rgb"


def _cogact_images(payloads, proc) -> np.ndarray:
    """Decode -> pad-to-square + processor, batched over all frames."""
    fill = tuple(int(x * 255) for x in proc.mean)
    frames, order = _decode_frames(payloads)
    return preprocess_images_batch(frames, proc, pad_fill=fill, channel_order=order)


def prepare_cogact_inputs(exp, cfg, tokenizer, images, prompt: str, device):
    """Images + raw task prompt -> (input_ids, valid, images) tensors, batch of 1."""
    ids = _cogact_prompt_ids(exp, cfg, tokenizer, prompt)
    input_ids = torch.tensor([ids], dtype=torch.int32, device=device)
    valid = torch.ones_like(input_ids)
    imgs = torch.from_numpy(_cogact_images(images, exp.data.build_image_processor()))
    return input_ids, valid, imgs[None].to(device)


class ActionServer:
    """Generic one-model action server; a subclass provides get_response().

    ``save_image_dir``, when set, receives each answered request's frames as
    ``frame_{i:06d}_{j}.png`` (the payload bytes as posted) and its fields and
    result as ``resp_{i:06d}.json``, numbered in the order the requests are
    answered (the reference's debug episode dumps); a failed request dumps
    nothing.  The subclasses do not take it: set ``server.save_image_dir``.

    micro_batch > 1 coalesces concurrent single-frame requests that arrive
    within ``micro_batch_window_ms`` of each other into one padded device
    call; every client still gets its own chunk.  A server that synchronises
    itself (``concurrent``: the continuous-batching decode engine) serves
    requests without the global lock."""

    concurrent = False
    engine = None  # a continuous-batching decode engine the server owns, closed by close()

    def __init__(self, host: str = "0.0.0.0", port: int = 7891,
                 save_image_dir: Optional[str] = None, micro_batch: int = 0,
                 micro_batch_window_ms: float = 5.0, micro_batch_timeout_s: float = 900.0):
        self.host, self.port = host, port
        self.save_image_dir = save_image_dir
        self._dump_idx = 0
        self._lock = threading.Lock()  # model state (the generator, _dump_idx) is mutable
        self.micro_batch = int(micro_batch)
        self.micro_batch_window_ms = float(micro_batch_window_ms)
        self.micro_batch_timeout_s = float(micro_batch_timeout_s)
        self.batched_calls = 0  # coalesced device calls
        self._mb_queue = self._mb_thread = None
        if self.micro_batch > 1:
            self._mb_queue = queue.Queue()
            self._mb_thread = threading.Thread(target=self._micro_batch_worker, daemon=True)
            self._mb_thread.start()

    def close(self) -> None:
        """Stop the micro-batch worker once the requests queued before it are
        served (the worker holds the server, and so its model, until then),
        and the server's decode engine."""
        if self._mb_queue is not None:
            self._mb_queue.put(None)
        if self.engine is not None:
            self.engine.close()

    def get_response(self, fields: dict, files: list):
        raise NotImplementedError

    def get_batched_response(self, requests: list) -> list:
        """Serve coalesced single requests [(fields, files), ...]; sequential by default."""
        return [self.get_response(f, fl) for f, fl in requests]

    def _micro_batch_worker(self):
        window = self.micro_batch_window_ms / 1e3
        closing = False
        while not closing:
            first = self._mb_queue.get()
            if first is None:  # close()
                return
            batch = [first]
            deadline = time.monotonic() + window
            while len(batch) < self.micro_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._mb_queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:  # close(): serve this batch, then stop
                    closing = True
                    break
                batch.append(item)
            with self._lock:
                try:
                    if len(batch) > 1:
                        self.batched_calls += 1
                    results = self.get_batched_response([(b["fields"], b["files"]) for b in batch])
                    for b, r in zip(batch, results):
                        self._maybe_dump(b["fields"], b["files"], r)
                        b["result"] = r
                except Exception as e:  # noqa: BLE001 (reported to the waiting clients)
                    if len(batch) == 1:
                        batch[0]["error"] = e
                    else:  # retry one by one so only a malformed request errors
                        for b in batch:
                            try:
                                r = self.get_response(b["fields"], b["files"])
                                self._maybe_dump(b["fields"], b["files"], r)
                                b["result"] = r
                            except Exception as e_one:  # noqa: BLE001
                                b["error"] = e_one
            for b in batch:
                b["event"].set()

    def _submit_single(self, fields, files):
        box = {"fields": fields, "files": files, "event": threading.Event()}
        self._mb_queue.put(box)
        if not box["event"].wait(timeout=self.micro_batch_timeout_s):
            raise TimeoutError(f"micro-batch worker exceeded {self.micro_batch_timeout_s}s")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _maybe_dump(self, fields, files, result):
        """Write one answered request to ``save_image_dir``; the caller holds the lock."""
        if not self.save_image_dir:
            return
        os.makedirs(self.save_image_dir, exist_ok=True)
        i = self._dump_idx
        self._dump_idx += 1
        for j, (_, payload) in enumerate(files):
            with open(f"{self.save_image_dir}/frame_{i:06d}_{j}.png", "wb") as f:
                f.write(payload)
        with open(f"{self.save_image_dir}/resp_{i:06d}.json", "w") as f:
            json.dump({"fields": fields, "result": result}, f)

    def make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                if self.path.rstrip("/") != "/process_frame":
                    self.send_error(404)
                    return
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                t0 = time.monotonic()
                try:
                    fields, files = parse_multipart(dict(self.headers), body)
                    single = int(fields.get("batch_size", 1)) == 1
                    if server_self._mb_queue is not None and single:
                        result = server_self._submit_single(fields, files)
                    elif server_self.concurrent:
                        # the server synchronises itself (the continuous-batching
                        # decode engine): requests must reach it together for
                        # their decode steps to coalesce
                        result = server_self.get_response(fields, files)
                        with server_self._lock:
                            server_self._maybe_dump(fields, files, result)
                    else:
                        with server_self._lock:
                            result = server_self.get_response(fields, files)
                            server_self._maybe_dump(fields, files, result)
                    payload = json.dumps(result).encode()
                    self.send_response(200)
                except Exception as e:  # noqa: BLE001 (the client gets the error)
                    traceback.print_exc()
                    payload = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("X-Inference-Time", f"{time.monotonic() - t0:.4f}")
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):
                pass

        return Handler

    def run(self):
        httpd = ThreadingHTTPServer((self.host, self.port), self.make_handler())
        print(f"action server listening on {self.host}:{self.port}")
        httpd.serve_forever()

    def serve_background(self) -> ThreadingHTTPServer:
        """Serve from a daemon thread; the caller ends it with shutdown() and
        server_close(), then this server's close()."""
        httpd = ThreadingHTTPServer((self.host, self.port), self.make_handler())
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd


class CogActServer(ActionServer):
    """CogACT serving.  ``fuse_preprocess=True`` moves pad-to-square, the
    PIL-parity resize and the normalisation onto the device
    (``ops/image_ops.py``: two products a frame): the host decodes the frame
    bytes and uploads raw uint8, the device flips BGR, resizes and runs the
    policy.  A request whose frames differ in shape takes the host path, as
    in the JAX server.  ``fused_calls`` and ``host_calls`` count the device
    calls each route served."""

    def __init__(self, exp, cfg, model, tokenizer, norms, host="0.0.0.0", port=7891,
                 micro_batch: int = 0, micro_batch_window_ms: float = 5.0,
                 fuse_preprocess: bool = False):
        super().__init__(host, port, micro_batch=micro_batch,
                         micro_batch_window_ms=micro_batch_window_ms)
        self.exp, self.cfg, self.tokenizer, self.norms = exp, cfg, tokenizer, norms
        self.device = torch.device(exp.device)
        self.infer = exp.make_infer_fn(cfg, model)
        self.generator = torch.Generator(device=self.device).manual_seed(exp.model.seed)
        self._prompt_cache: dict = {}
        self.fuse_preprocess = fuse_preprocess
        self._device_prep: dict = {}  # (in_hw, order, per) -> uint8 frames -> images
        self.fused_calls = self.host_calls = 0

    def device_images(self, frames: list, order: str, per: int) -> torch.Tensor:
        """Decoded uint8 frames of one shape -> [B, per, size, size, 3] fp32
        images, preprocessed on the device by the plan of this geometry."""
        key = (tuple(frames[0].shape[:2]), order, per)
        fn = self._device_prep.get(key)
        if fn is None:
            from dexbotic_tpu_torch.ops.image_ops import make_device_preprocess

            proc = self.exp.data.build_image_processor()
            prep = make_device_preprocess(
                key[0], proc.size, resample=proc.resample, mean=proc.mean, std=proc.std,
                rescale=proc.rescale, pad_to_square=True,
                fill=tuple(int(x * 255) for x in proc.mean), device=self.device)

            def fn(raw: torch.Tensor) -> torch.Tensor:
                imgs = prep(raw.flip(-1) if order == "bgr" else raw)
                return imgs.reshape(-1, per, *imgs.shape[1:])

            fn = self._device_prep[key] = fn
        return fn(torch.from_numpy(np.stack(frames)).to(self.device))

    def _prompt_ids(self, prompt: str) -> list:
        ids = self._prompt_cache.get(prompt)
        if ids is None:
            ids = _cogact_prompt_ids(self.exp, self.cfg, self.tokenizer, prompt)
            if len(self._prompt_cache) < 1024:
                self._prompt_cache[prompt] = ids
        return ids

    def _denorm(self, out: np.ndarray) -> np.ndarray:
        if self.norms is None:
            return out
        lo = np.asarray(self.norms["min"], np.float64)
        hi = np.asarray(self.norms["max"], np.float64)
        a = np.clip(out[..., : len(lo)], -1.0, 1.0)
        return np.concatenate([lo + (a + 1.0) * 0.5 * (hi - lo), out[..., len(lo):]], axis=-1)

    def _states(self, raws: list, B: int):
        """The rows' states from the requests' raw fields: CogACT reads none."""
        return None

    def _device_call(self, ids, valid, imgs, states):
        return self.infer(ids, valid, imgs, self.generator)

    def _infer_rows(self, prompts, payload_groups, pad_to=None, states=None) -> np.ndarray:
        """One batched device call over B rows (prompt + view group, and a
        state row where the policy reads one).

        ``pad_to`` pads the batch by repeating row 0; padded rows are sliced
        off.  Token length is padded to a multiple of 64."""
        B = len(prompts)
        Bp = max(pad_to or B, B)
        if Bp > B:
            prompts = list(prompts) + [prompts[0]] * (Bp - B)
            payload_groups = list(payload_groups) + [payload_groups[0]] * (Bp - B)
            if states is not None:
                states = np.concatenate([states, np.repeat(states[:1], Bp - B, axis=0)])
        per = len(payload_groups[0])
        if any(len(g) != per for g in payload_groups):
            raise ValueError("ragged view groups")
        rows = [self._prompt_ids(p) for p in prompts]
        L = -(-max(len(r) for r in rows) // 64) * 64
        ids = np.zeros((Bp, L), np.int32)
        valid = np.zeros((Bp, L), np.int32)
        for b, r in enumerate(rows):
            ids[b, : len(r)] = r
            valid[b, : len(r)] = 1
        payloads = [p for g in payload_groups for p in g]
        imgs = None
        if self.fuse_preprocess:
            frames, order = _decode_frames(payloads)
            if len({f.shape for f in frames}) == 1:
                imgs = self.device_images(frames, order, per)
                self.fused_calls += 1
        if imgs is None:  # the host path, and mixed frame shapes under fuse_preprocess
            flat = _cogact_images(payloads, self.exp.data.build_image_processor())
            imgs = torch.from_numpy(flat.reshape(Bp, per, *flat.shape[1:])).to(self.device)
            self.host_calls += 1
        out = self._device_call(torch.from_numpy(ids).to(self.device),
                                torch.from_numpy(valid).to(self.device), imgs, states)
        return self._denorm(out.float().cpu().numpy())[:B]

    def get_response(self, fields, files):
        """With 'batch_size'=B the images are B view groups in order and 'text'
        may carry B semicolon-separated prompts (one prompt serves all rows)."""
        prompt = fields.get("text", "")
        B = int(fields.get("batch_size", 1))
        prompts = prompt.split(";") if ";" in prompt else [prompt] * B
        payloads = [payload for _, payload in files]
        if len(prompts) != B or len(payloads) % B:
            raise ValueError(f"{len(prompts)} prompts and {len(payloads)} images "
                             f"for batch_size {B}")
        per = len(payloads) // B
        raw = (fields.get("states") or "").split(";")
        out = self._infer_rows(prompts, [payloads[i * per: (i + 1) * per] for i in range(B)],
                               states=self._states([raw[b] if b < len(raw) else None
                                                    for b in range(B)], B))
        return out[0].tolist() if B == 1 else out.tolist()

    def get_batched_response(self, requests):
        """Coalesced single requests -> one padded device call per view count."""
        results = [None] * len(requests)
        by_per: dict = {}
        for i, (fields, files) in enumerate(requests):
            by_per.setdefault(len(files), []).append((i, fields, [p for _, p in files]))
        for items in by_per.values():
            out = self._infer_rows([f.get("text", "") for _, f, _ in items],
                                   [g for _, _, g in items],
                                   pad_to=self.micro_batch if len(items) > 1 else None,
                                   states=self._states([f.get("states") for _, f, _ in items],
                                                       len(items)))
            for k, (i, _, _) in enumerate(items):
                results[i] = out[k].tolist()
        return results


class OFTServer(CogActServer):
    """OFT serving: the CogACT request contract (64-token prompt buckets,
    micro-batches padded with their first row, ``fuse_preprocess``) plus an
    optional 'states' form field, a JSON proprio vector for each row (B
    semicolon-separated vectors with 'batch_size'=B), zero-filled or cut to
    the config's proprio_dim; a policy without proprio reads none."""

    def _states(self, raws: list, B: int) -> np.ndarray | None:
        if not self.cfg.use_proprio:
            return None
        dim = self.cfg.proprio_dim
        s = np.zeros((B, dim), np.float32)
        for b, raw in enumerate(raws[:B]):
            if raw:
                vals = np.asarray(json.loads(raw), np.float32).reshape(-1)
                s[b, : min(len(vals), dim)] = vals[:dim]
        return s

    def _device_call(self, ids, valid, imgs, states):
        if states is not None:
            states = torch.from_numpy(states).to(self.device)
        return self.infer(ids, valid, imgs, states, self.generator)


class MemVLAServer(ActionServer):
    """Stateful MemVLA serving: the CogACT request contract plus a required
    'episode_first_frame' field, 'True' or 'False'; 'True' empties the
    memory bank and restarts the frame counter.  The bank is state across
    requests, so requests are served one at a time (the base class's lock)
    and never micro-batched.  The prompt takes CogACT's 64-token bucket; the
    noise comes from the server's ``torch.Generator``."""

    def __init__(self, exp, cfg, model, tokenizer, norms, host="0.0.0.0", port=7891):
        super().__init__(host, port)
        from dexbotic_tpu_torch.exp.memvla_exp import MemVLAInferenceSession

        self.exp, self.cfg, self.tokenizer, self.norms = exp, cfg, tokenizer, norms
        self.device = torch.device(exp.device)
        self.session = MemVLAInferenceSession(exp, cfg, model, batch_size=1)
        self.generator = torch.Generator(device=self.device).manual_seed(exp.model.seed)
        self._prompt_cache: dict = {}

    _prompt_ids = CogActServer._prompt_ids
    _denorm = CogActServer._denorm

    def get_response(self, fields, files):
        first = fields.get("episode_first_frame")
        if first not in ("True", "False"):
            raise ValueError(f"episode_first_frame must be 'True' or 'False', got {first!r}")
        if first == "True":
            self.session.reset()
        row = self._prompt_ids(fields.get("text", ""))
        L = -(-len(row) // 64) * 64
        ids = torch.zeros((1, L), dtype=torch.int32)
        ids[0, : len(row)] = torch.tensor(row, dtype=torch.int32)
        valid = (torch.arange(L) < len(row)).int()[None]
        imgs = _cogact_images([p for _, p in files], self.exp.data.build_image_processor())
        out = self.session.step(ids.to(self.device), valid.to(self.device),
                                torch.from_numpy(imgs)[None].to(self.device), self.generator)
        return self._denorm(out.float().cpu().numpy())[0].tolist()


class NaVILAServer(ActionServer):
    """Navigation serving: one camera frame a request and the fields 'text'
    (the instruction), 'episode_first_frame' (resets the frame history) and
    'run_model' ('False' only appends the frame to the history and returns
    []); the reply is ``parse_nav_action``'s list of action ints (0 stop, 1
    forward, 2 left, 3 right, repeated by magnitude).  A decoded RGB frame
    is flipped to BGR before preprocessing, as the reference server does.
    The history is state across requests, so requests are served one at a
    time (the base class's lock).  NaVILAExp has no ``inference()``: build
    this server by hand, as in the JAX package."""

    def __init__(self, exp, cfg, model, tokenizer, host="0.0.0.0", port=7891,
                 max_new_tokens: int = 32, engine=None):
        super().__init__(host, port)
        from dexbotic_tpu_torch.exp.navila_exp import NaVILAInferenceSession

        self.exp, self.cfg, self.tokenizer = exp, cfg, tokenizer
        self.session = NaVILAInferenceSession(exp, cfg, model, tokenizer, engine=engine,
                                              max_new_tokens=max_new_tokens)
        self.generator = torch.Generator(device=exp.device).manual_seed(0)

    @staticmethod
    def _parse_bool(value, default=False) -> bool:
        if value is None:
            return default
        return str(value).strip().lower() in ("1", "true", "t", "yes", "y", "on")

    def frame(self, files) -> Optional[np.ndarray]:
        """The request's first frame in BGR, or None."""
        payloads = [p for _, p in files]
        if not payloads:
            return None
        frames, order = _decode_frames(payloads[:1])
        return frames[0] if order == "bgr" else frames[0][..., ::-1]

    def get_response(self, fields, files):
        from dexbotic_tpu_torch.models.navila import parse_nav_action

        if self._parse_bool(fields.get("episode_first_frame")):
            self.session.reset()
        run_model = self._parse_bool(fields.get("run_model"), default=True)
        frame = self.frame(files)
        if not run_model:
            if frame is not None:
                self.session.observe(frame)
            return []
        if frame is None:
            return []
        return parse_nav_action(self.session.act(frame, fields.get("text", ""), self.generator))


class FlowVLAServer(ActionServer):
    """pi0/pi0.5/DM0 serving: multi-view posts with states, 'batch_size'
    requests and micro-batched single requests (the JAX ``FlowVLAServer``).

    Each row is a prompt, a group of views (views past ``num_images`` are
    dropped, missing ones zero-filled and masked) and a state; the state is
    normalised with the served statistics, and the chunk is denormalised,
    passed through the exp's output transforms against the raw state
    (``AbsoluteAction``) and cut to the environment's action dims."""

    def __init__(self, exp, cfg, model, tokenizer, norms, host="0.0.0.0", port=7891,
                 micro_batch: int = 0, micro_batch_window_ms: float = 5.0):
        super().__init__(host, port, micro_batch=micro_batch,
                         micro_batch_window_ms=micro_batch_window_ms)
        self.exp, self.cfg, self.tokenizer, self.norms = exp, cfg, tokenizer, norms
        # pi0 normalises by mean/std, pi0.5 and DM0 by quantiles
        self.stats = ServingStats(norms, use_quantiles=getattr(exp.action, "use_quantiles", True))
        self.device = torch.device(exp.device)
        self.infer = exp.make_infer_fn(cfg, model)
        self.generator = torch.Generator(device=self.device).manual_seed(exp.model.seed)
        self.num_images = exp.data.num_images
        self._prompt_cache: dict = {}

    def _prompt_ids(self, prompt: str) -> np.ndarray:
        ids = self._prompt_cache.get(prompt)
        if ids is None:
            out = self.exp.build_tokenization(self.tokenizer)(
                conversations=[{"from": "human", "value": prompt}])
            ids = np.asarray(out["input_ids"], np.int32)
            if len(self._prompt_cache) < 1024:
                self._prompt_cache[prompt] = ids
        return ids

    @staticmethod
    def _parse_state(row: str | None, dim: int) -> np.ndarray:
        """One state row (a JSON array or comma-separated floats) -> zero-padded [dim]."""
        s = np.zeros((dim,), np.float32)
        if row:
            try:
                vals = np.asarray(json.loads(row), np.float32).reshape(-1)
            except (json.JSONDecodeError, ValueError):
                vals = np.asarray([float(x) for x in row.split(",")], np.float32)
            s[: len(vals)] = vals[:dim]
        return s

    def _infer_rows(self, prompts, payload_groups, state_rows, pad_to=None) -> list:
        """One batched device call over B rows; ``pad_to`` pads the batch by
        repeating row 0 (padded rows are dropped).  Token length is padded to
        a multiple of 64."""
        B = len(prompts)
        Bp = max(pad_to or B, B)
        if Bp > B:
            prompts = list(prompts) + [prompts[0]] * (Bp - B)
            payload_groups = list(payload_groups) + [payload_groups[0]] * (Bp - B)
            state_rows = list(state_rows) + [state_rows[0]] * (Bp - B)
        per = len(payload_groups[0])
        if any(len(g) != per for g in payload_groups):
            raise ValueError("ragged view groups")
        rows = [self._prompt_ids(p) for p in prompts]
        L = -(-max(len(r) for r in rows) // 64) * 64
        ids = np.zeros((Bp, L), np.int32)
        for b, r in enumerate(rows):
            ids[b, : len(r)] = r
        proc = self.exp.data.build_image_processor()
        images = np.zeros((Bp, self.num_images, proc.size, proc.size, 3), np.float32)
        masks = np.zeros((Bp, self.num_images), np.int32)
        keep = min(per, self.num_images)
        frames, order = _decode_frames([p for g in payload_groups for p in g])
        flat = preprocess_images_batch(frames, proc, channel_order=order)
        for b in range(Bp):
            images[b, :keep] = flat[b * per: b * per + keep]
            masks[b, :keep] = 1
        states = self.stats.normalize("state", np.stack(state_rows))
        dev = self.device
        ids_t = torch.from_numpy(ids).to(dev)
        raw = self.infer(ids_t, (ids_t != 0).to(torch.int32), torch.from_numpy(images).to(dev),
                         torch.from_numpy(masks).to(dev), torch.from_numpy(states).to(dev),
                         self.generator)
        raw = raw.float().cpu().numpy()
        return [self._postprocess(raw[b], state_rows[b]) for b in range(B)]

    def get_response(self, fields, files):
        """With 'batch_size'=B the images are B groups of views in order and
        'states' carries B semicolon-separated vectors."""
        prompt = fields.get("text", "")
        B = int(fields.get("batch_size", 1))
        payloads = [p for _, p in files]
        if len(payloads) % B:
            raise ValueError(f"{len(payloads)} images not divisible by batch_size {B}")
        per = len(payloads) // B
        groups = [payloads[i * per: (i + 1) * per] for i in range(B)]
        state_strs = (fields.get("states") or "").split(";")
        state_rows = [self._parse_state(state_strs[b] if b < len(state_strs) else None,
                                        self.cfg.action_dim) for b in range(B)]
        results = self._infer_rows([prompt] * B, groups, state_rows)
        return results[0] if B == 1 else results

    def get_batched_response(self, requests):
        """Coalesced single requests -> one padded device call per view count;
        each request keeps its own prompt and state."""
        results = [None] * len(requests)
        by_per: dict = {}
        for i, (fields, files) in enumerate(requests):
            payloads = [p for _, p in files]
            by_per.setdefault(len(payloads), []).append((i, fields, payloads))
        for items in by_per.values():
            state_rows = [self._parse_state((f.get("states") or "").split(";")[0],
                                            self.cfg.action_dim) for _, f, _ in items]
            out = self._infer_rows([f.get("text", "") for _, f, _ in items],
                                   [g for _, _, g in items], state_rows,
                                   pad_to=self.micro_batch if len(items) > 1 else None)
            for k, (i, _, _) in enumerate(items):
                results[i] = out[k]
        return results

    def _postprocess(self, out, state_row) -> list:
        """Denormalise the chunk, turn deltas absolute against the raw request
        state with the exp's output transforms, then cut to the env's dims."""
        out = np.asarray(out, np.float64)
        if self.stats.has("action"):
            out = self.stats.denormalize("action", out)
        elif self.norms is not None and "min" in self.norms:  # flat {min, max} (CogACT format)
            lo = np.asarray(self.norms["min"], np.float64)
            hi = np.asarray(self.norms["max"], np.float64)
            d = min(out.shape[-1], len(lo))
            a = np.clip(out[:, :d], -1, 1)
            out = np.concatenate([lo[:d] + (a + 1) * 0.5 * (hi[:d] - lo[:d]), out[:, d:]], axis=-1)
        icfg = getattr(self.exp, "inference_cfg", None)
        if icfg is not None:
            pipe, meta = icfg.build_output_transforms({})
            if pipe.transforms:
                data = {"action": out, "state": np.asarray(state_row, np.float64),
                        "meta_data": meta}
                out = np.asarray(pipe(data)["action"])
            out = out[:, : getattr(icfg, "action_dim_out", out.shape[-1])]
        return out.tolist()


class DiscreteVLAServer(ActionServer):
    """Text-action serving for Discrete VLA (digit strings): a request's
    image(s) and 'text' give the prompt (the CogACT prompt with an empty
    assistant turn); the reply is {"text", "actions"}, the actions
    denormalised by the served {min, max} statistics.

    ``continuous_batching`` > 0 decodes greedily through the slot engine
    (``exp/decode_engine.py``) so that concurrent robot clients share
    decode steps (the handler takes no global lock: ``concurrent``); a text
    that does not parse falls back to ``discrete_vla_inference_action``'s
    sampled retries, as the reply's actions ("text" keeps the engine's
    text).  Without the engine every request takes that function, and
    "text" is "".  The engine's prompt capacity ``max_prompt`` defaults to
    :func:`engine_max_prompt` of the model's prompt (the JAX server keeps
    the engine's 512, below a full-width prompt).  The sampled retries draw
    from the server's generator, one request's at a time.  ``parsed`` and
    ``unparsed`` count the requests whose action came from a parsed text and
    those that answered zeros."""

    def __init__(self, exp, cfg, model, tokenizer, norms=None, host="0.0.0.0", port=7891,
                 continuous_batching: int = 0, prefill_chunk: int = 0,
                 max_prompt: Optional[int] = None):
        super().__init__(host, port)
        self.exp, self.cfg, self.model, self.tokenizer, self.norms = exp, cfg, model, tokenizer, norms
        self.device = torch.device(exp.device)
        self.eos = getattr(tokenizer, "eos_token_id", 0) or 0
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self._rng_lock = threading.Lock()
        self.parsed = self.unparsed = 0
        if continuous_batching > 0:
            from dexbotic_tpu_torch.exp.decode_engine import ContinuousBatchingEngine

            self.concurrent = True
            if max_prompt is None:
                max_prompt = engine_max_prompt(len(_cogact_prompt_ids(
                    exp, cfg, tokenizer, "", assistant_stub=None)))
            self.engine = ContinuousBatchingEngine(
                model.vlm, cfg.vlm, slots=continuous_batching, max_prompt=max_prompt,
                max_new=cfg.max_new_tokens, eos_token_id=self.eos,
                prefill_chunk=prefill_chunk or None)

    def _prepare(self, fields, files):
        frames, order = _decode_frames([p for _, p in files])
        imgs = preprocess_images_batch(frames, self.exp.data.build_image_processor(),
                                       channel_order=order)
        # an autoregressive text policy: the assistant turn stays empty
        ids = _cogact_prompt_ids(self.exp, self.cfg, self.tokenizer, fields.get("text", ""),
                                 assistant_stub=None)
        return np.asarray(ids, np.int32), imgs

    def get_response(self, fields, files):
        from dexbotic_tpu_torch.models.discrete_vla import parse_action_text

        ids, imgs = self._prepare(fields, files)
        text = ""
        if self.engine is not None:
            toks = self.engine.submit(ids, images=imgs)
            if self.eos in toks:
                toks = toks[: toks.index(self.eos)]
            text = self.tokenizer.decode(toks)
            action = parse_action_text(text, self.cfg.action_dim, self.cfg.vocab_bins)
            if action is None:  # sampled retries through generate
                action = self._fused_decode(ids, imgs)
            else:
                with self._rng_lock:
                    self.parsed += 1
        else:
            action = self._fused_decode(ids, imgs)
        if self.norms is not None:
            lo = np.asarray(self.norms["min"], np.float64)
            hi = np.asarray(self.norms["max"], np.float64)
            action = lo + (np.clip(action[: len(lo)], -1, 1) + 1.0) * 0.5 * (hi - lo)
        return {"text": text, "actions": np.asarray(action).tolist()}

    def _fused_decode(self, ids, imgs) -> np.ndarray:
        from dexbotic_tpu_torch.models.discrete_vla import discrete_vla_inference_action

        input_ids = torch.from_numpy(ids)[None].to(self.device)
        stats: dict = {}
        # one decode at a time on the server's generator: the eager decode is
        # host-bound under the interpreter lock, where concurrent decodes only
        # contend (the JAX server, whose calls are asynchronous device
        # programs, holds its lock only to split the key)
        with self._rng_lock:
            action = discrete_vla_inference_action(
                self.model, self.cfg, self.tokenizer, input_ids, torch.ones_like(input_ids),
                torch.from_numpy(imgs)[None].to(self.device), self.eos,
                generator=self.generator, stats=stats)
            if stats["parsed"]:
                self.parsed += 1
            else:
                self.unparsed += 1
        return action


class MUVLAServer(ActionServer):
    """Map-understanding VLA serving: the first posted image is the MAP
    view, the rest the observation views (the current one, then the
    history); the reply is {"text": the generated action text}, cut at the
    EOS id, the template's sep2 stop string removed, stripped.

    ``continuous_batching`` > 0 serves the decode through the slot engine's
    embeds route: the towers, the history QFormer and the fuser run on the
    request's thread, and the spliced prompt (in fp32, as the JAX server
    hands it over) joins the engine, so concurrent requests share decode
    steps (``concurrent``).  ``max_prompt`` defaults to
    :func:`engine_max_prompt` of the prompt with four observation views (the
    JAX server keeps the engine's 512).  Without the engine a request is one
    ``muvla_generate`` call drawing from the server's generator, one at a
    time."""

    def __init__(self, exp, cfg, model, tokenizer, host="0.0.0.0", port=7891,
                 max_new_tokens: int = 32, continuous_batching: int = 0,
                 prefill_chunk: int = 0, max_prompt: Optional[int] = None):
        super().__init__(host, port)
        self.exp, self.cfg, self.model, self.tokenizer = exp, cfg, model, tokenizer
        self.device = torch.device(exp.device)
        self.max_new_tokens = max_new_tokens
        self.eos = getattr(tokenizer, "eos_token_id", 0) or 0
        self.gen = exp.make_generate_fn(cfg, model, max_new_tokens=max_new_tokens,
                                        eos_token_id=self.eos)
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self._rng_lock = threading.Lock()
        if continuous_batching > 0:
            from dexbotic_tpu_torch.exp.decode_engine import ContinuousBatchingEngine

            self.concurrent = True
            if max_prompt is None:
                max_prompt = engine_max_prompt(len(self.prompt_ids("", 4)))
            self.engine = ContinuousBatchingEngine(
                model, cfg.vlm, slots=continuous_batching, max_prompt=max_prompt,
                max_new=max_new_tokens, eos_token_id=self.eos,
                prefill_chunk=prefill_chunk or None)

    def prompt_ids(self, prompt: str, n_obs_views: int) -> list:
        """The served prompt: the chat template around '<image>' + the text,
        no newline, an empty assistant turn; the tag expands to the fused
        tokens of ``n_obs_views`` observation views."""
        conv = conversation_lib.conv_templates[self.exp.tokenizer.chat_template].copy()
        conv.append_message(conv.roles[0], "<image>" + prompt)
        conv.append_message(conv.roles[1], None)
        return tokenizer_image_token(conv.get_prompt(), self.tokenizer,
                                     num_image_tokens=self.cfg.num_fused_tokens(n_obs_views))

    def _prepare(self, fields, files):
        payloads = [p for _, p in files]
        if len(payloads) < 2:
            raise ValueError("MUVLA needs a map view and at least one observation view")
        proc = self.exp.data.build_image_processor()
        map_f, map_o = _decode_frames(payloads[:1])
        obs_f, obs_o = _decode_frames(payloads[1:])
        map_img = torch.from_numpy(preprocess_images_batch(map_f, proc, channel_order=map_o))
        obs = torch.from_numpy(preprocess_images_batch(obs_f, proc, channel_order=obs_o))[None]
        ids = torch.tensor([self.prompt_ids(fields.get("text", ""), obs.shape[1])],
                           dtype=torch.int32)
        return ids.to(self.device), map_img.to(self.device), obs.to(self.device)

    def _decode_tokens(self, toks: list) -> dict:
        if self.eos in toks:
            toks = toks[: toks.index(self.eos)]
        text = self.tokenizer.decode(toks)
        sep2 = getattr(conversation_lib.conv_templates[self.exp.tokenizer.chat_template],
                       "sep2", None)
        if sep2:
            text = text.replace(sep2, "")
        return {"text": text.strip()}

    @torch.no_grad()
    def get_response(self, fields, files):
        from dexbotic_tpu_torch.models.muvla import fuse_obs_with_history
        from dexbotic_tpu_torch.models.vlm import splice_image_embeds

        input_ids, map_img, obs = self._prepare(fields, files)
        if self.engine is not None:
            tokens = fuse_obs_with_history(self.model, self.cfg, map_img, obs)
            embeds = splice_image_embeds(self.model, self.cfg.vlm, input_ids, tokens)
            toks = self.engine.submit(input_ids[0].cpu().numpy(), embeds=embeds[0].float(),
                                      max_new=self.max_new_tokens)
            return self._decode_tokens(toks)
        with self._rng_lock:  # one decode at a time, as DiscreteVLAServer's retries
            tokens = self.gen(input_ids, torch.ones_like(input_ids), map_img, obs, self.generator)
        return self._decode_tokens([int(t) for t in tokens[0].tolist()])
