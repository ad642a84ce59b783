"""Robot-side HTTP client with an action-chunk queue.

Port of dexbotic_tpu/client.py, with the same protocol and behaviour: POST
a frame (multipart field ``image``, file ``frame.png``), the instruction
(``text``) and optionally the state (``states``, comma-separated) to
/process_frame, queue the first ``execute_steps`` actions of the returned
chunk, pop one action per ``act()`` and query again when the queue runs dry;
optionally turn delta actions absolute against the state, wrapping the
angle dimensions into [-pi, pi].  Requests go through ``urllib.request``.
"""

from __future__ import annotations

import io
import json
import urllib.request
import uuid
from collections import deque

import numpy as np


def encode_multipart(fields: dict, files: list) -> tuple[bytes, str]:
    """(body, content type) of a multipart/form-data request: ``fields``
    {name: text}, ``files`` [(name, filename, bytes, content type)]."""
    boundary = uuid.uuid4().hex
    parts = []
    for name, value in fields.items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"\r\n\r\n"
                     f"{value}\r\n".encode())
    for name, filename, payload, ctype in files:
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; "
                     f"filename=\"{filename}\"\r\nContent-Type: {ctype}\r\n\r\n".encode()
                     + payload + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


class DexClient:
    def __init__(
        self,
        url: str = "http://localhost:7891/process_frame",
        execute_steps: int = 8,
        delta_action: bool = False,
        angle_indices: tuple = (3, 4, 5),
    ):
        self.url = url
        self.execute_steps = execute_steps
        self.delta_action = delta_action
        self.angle_indices = list(angle_indices)
        self.queue: deque = deque()

    def reset(self):
        self.queue.clear()

    def _post(self, image, instruction: str, state=None) -> np.ndarray:
        if isinstance(image, np.ndarray):
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(image).save(buf, format="PNG")
            payload = buf.getvalue()
        else:
            payload = image
        fields = {"text": instruction}
        if state is not None:
            fields["states"] = ",".join(str(float(x)) for x in np.asarray(state).ravel())
        body, ctype = encode_multipart(fields, [("image", "frame.png", payload, "image/png")])
        req = urllib.request.Request(self.url, data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=60) as resp:  # raises on >= 400
            return np.asarray(json.loads(resp.read()), dtype=np.float64)

    def act(self, image, instruction: str, state=None) -> np.ndarray:
        """Return the next action; refills the queue from the server when empty."""
        if not self.queue:
            chunk = self._post(image, instruction, state)
            for a in chunk[: self.execute_steps]:
                self.queue.append(np.asarray(a))
        action = self.queue.popleft()
        if self.delta_action and state is not None:
            action = self._integrate(action, np.asarray(state, np.float64))
        return action

    def _integrate(self, delta: np.ndarray, state: np.ndarray) -> np.ndarray:
        out = delta.copy()
        d = min(len(delta), len(state))
        out[:d] = state[:d] + delta[:d]
        for i in self.angle_indices:
            if i < len(out):
                while out[i] > np.pi:
                    out[i] -= 2 * np.pi
                while out[i] < -np.pi:
                    out[i] += 2 * np.pi
        return out
