"""Robot clients in a process of their own, so that their Python does not
share the server's interpreter lock.

The parent spawns :func:`main` and talks to it over a pipe: ``("warmup",
port, rounds)`` sends the mix's shapes through the server, ``("window",
port, start, seconds)`` runs the fleet, ``("stop",)`` ends the process.
Each robot is a thread that replans as soon as its chunk returns, so it
never has two requests out.  Every request is timed at the client, from
its send to its full reply, and carries a ``vb_id`` form field; the
reply's chunk goes back to the parent for the correctness check.
"""

from __future__ import annotations

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np

BOUNDARY = "vlabenchclient"
LATE_S = 60.0  # how long a request in flight at the window's close is waited for

WORDS = ("pick up the black bowl", "place it on the plate", "open the top drawer of the cabinet",
         "put the cream cheese in the bowl", "turn on the stove", "push the plate to the front",
         "put the wine bottle on top of the cabinet", "close the microwave",
         "stack the red block on the blue block", "move the ketchup next to the basket",
         "and", "then", "carefully", "slowly", "on the left", "on the right")


def frame_png(rng: np.random.Generator, height: int, width: int) -> bytes:
    """One seeded camera frame as PNG bytes (uniform noise pixels)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (height, width, 3), dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def instruction(rng: np.random.Generator, length: int) -> str:
    """A LIBERO-like instruction of exactly ``length`` characters."""
    text = ""
    while len(text) < length:
        text += WORDS[rng.integers(len(WORDS))] + " "
    text = text[:length]
    return text[:-1] + "." if text.endswith(" ") else text


def make_requests(traffic: dict, seed: int):
    """(frames, instructions, per-client orders) of a mix: ``frames`` seeded
    PNGs and one instruction per length of the mix's fixed lengths, every
    seed the same multiset of lengths in another order."""
    rng = np.random.default_rng(seed)
    frames = [frame_png(rng, traffic["frame_height"], traffic["frame_width"])
              for _ in range(traffic["frames"])]
    lengths = list(range(traffic["instruction_chars"][0], traffic["instruction_chars"][1] + 1,
                         traffic["instruction_step"]))
    texts = [instruction(rng, n) for n in rng.permutation(lengths)]
    orders = [rng.permutation(len(frames) * len(texts)) for _ in range(traffic["clients"])]
    return frames, texts, orders


def body(fields: dict, png: bytes) -> bytes:
    out = "".join(f"--{BOUNDARY}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n{v}\r\n"
                  for k, v in fields.items()).encode()
    out += (f"--{BOUNDARY}\r\nContent-Disposition: form-data; name=\"image\"; filename=\"f.png\"\r\n"
            f"Content-Type: image/png\r\n\r\n").encode() + png + f"\r\n--{BOUNDARY}--\r\n".encode()
    return out


def post(port: int, payload: bytes, timeout: float) -> tuple[int, object]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/process_frame", data=payload,
                                 headers={"Content-Type": f"multipart/form-data; boundary={BOUNDARY}"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None
    except (urllib.error.URLError, OSError, ValueError) as e:
        return 0, repr(e)


def request(c: int, k: int, frames, texts, orders) -> tuple[int, str, int, int]:
    """(vb_id, text, frame index, text index) of client c's k-th request."""
    j = int(orders[c][k % len(orders[c])])
    f, t = j % len(frames), j // len(frames)
    return c * 1_000_000 + k, texts[t], f, t


def warmup(port: int, traffic: dict, frames, texts, rounds: int) -> list:
    """Every client at once, ``rounds`` times (the full micro-batch), then
    one request alone with the shortest and the longest instruction each
    (a batch of one); returns the statuses."""
    statuses = []
    n = traffic["clients"]
    shortest = min(range(len(texts)), key=lambda t: len(texts[t]))
    longest = max(range(len(texts)), key=lambda t: len(texts[t]))

    def one(i, t, f):
        s, _ = post(port, body({"text": texts[t], "vb_id": 900_000_000 + i}, frames[f]), 900.0)
        statuses.append(s)

    for r in range(rounds):
        threads = [threading.Thread(target=one, args=(r * n + c, (r + c) % len(texts), c % len(frames)))
                   for c in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    for i, t in enumerate((shortest, longest) * 2):
        one(10_000 + i, t, i % len(frames))
    return statuses


def window(port: int, traffic: dict, frames, texts, orders, start: float, seconds: float) -> list:
    """The fleet from ``start`` (monotonic) for ``seconds``: each robot sends
    its next request as soon as its chunk returns.  Records [vb_id, client,
    text index, frame index, t_send, t_done, status, chunk] of each request
    sent in the window."""
    end = start + seconds
    records = []
    lock = threading.Lock()

    def client(c):
        k = 0
        now = time.monotonic()
        if now < start:
            time.sleep(start - now)
        while time.monotonic() < end:
            vid, text, f, t = request(c, k, frames, texts, orders)
            payload = body({"text": text, "vb_id": vid}, frames[f])
            t0 = time.monotonic()
            status, reply = post(port, payload, end - t0 + LATE_S)
            t1 = time.monotonic()
            with lock:
                records.append([vid, c, t, f, t0, t1, status, reply])
            k += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(traffic["clients"])]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return records


def main(conn, traffic: dict, seed: int) -> None:
    frames, texts, orders = make_requests(traffic, seed)
    conn.send(("ready",))
    while True:
        msg = conn.recv()
        if msg[0] == "warmup":
            conn.send(("warm", warmup(msg[1], traffic, frames, texts, msg[2])))
        elif msg[0] == "window":
            conn.send(("records", window(msg[1], traffic, frames, texts, orders, msg[2], msg[3])))
        else:
            conn.close()
            return
