"""Closed-loop serving: N robot clients against one action server over HTTP.

The mix file gives the clients, the server's micro-batch and window, the
frames and the instruction lengths.  Set-up builds the program from the
seed (the configuration's system adapter), starts the server on a free
localhost port, and sends the mix's shapes through it while the client
process stands ready.  The window runs the closed loop for ``--seconds``;
requests in flight at its close are waited for.  Then the program is freed
and a sample of the answered requests, drawn from the seed and holding the
longest instruction, is recomputed by the plain reference from the raw
request and the same noise.
"""

from __future__ import annotations

import gc
import math
import multiprocessing as mp
import time

import numpy as np

from vlabench import clients, core
from vlabench.reference import plain
from vlabench.trace import Spans, Window


class ServeRun:
    """What the metric readers of a serving cell read."""

    def __init__(self, cell, config, traffic, seconds, window, records, calls, spans, trace,
                 system):
        self.cell, self.config, self.traffic, self.seconds = cell, config, traffic, seconds
        self.window = window  # (start, end) monotonic
        self.records = records
        self.calls = calls
        self.spans = spans
        self.trace = trace
        self.system = system

    def sent(self) -> list:
        """Requests sent within the window."""
        return [r for r in self.records if self.window[0] <= r[4] < self.window[1]]

    def ok(self, r) -> bool:
        head = self.config["action_head"]
        return (r[6] == 200 and isinstance(r[7], list) and len(r[7]) == head["chunk_size"]
                and all(isinstance(a, list) and len(a) == head["action_dim"] for a in r[7]))

    def latencies_ms(self) -> list:
        """Send-to-reply of every request sent in the window; a failure ranks above all."""
        return [(r[5] - r[4]) * 1e3 if self.ok(r) else math.inf for r in self.sent()]

    def answered_in_window(self) -> list:
        return [r for r in self.records if self.ok(r) and r[5] <= self.window[1]]


def end_to_end(run: ServeRun) -> dict:
    return {"chunks_per_s": {"value": len(run.answered_in_window()) / run.seconds, "unit": "chunks/s"}}


def sample_requests(run: ServeRun, seed: int, n: int, texts: list) -> list:
    """``n`` answered requests drawn from the seed, the longest instruction among them."""
    done = [r for r in run.sent() if run.ok(r)]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(texts[r[2]]), r[0]))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def check(run: ServeRun, ref, config: dict, weight_seed: int, sample_seed: int, traffic_seed: int,
          norms: dict, device: str) -> tuple[list, dict]:
    """Recompute the sampled requests with the plain reference; returns the
    checks and the readings behind them."""
    import torch

    plain.no_tf32()
    frames, texts, _ = clients.make_requests(run.traffic, traffic_seed)
    picked = sample_requests(run, sample_seed, run.traffic["check_requests"], texts)
    by_id = {}
    for call in run.calls:
        for row, vid in enumerate(call["ids"] or ()):
            by_id[vid] = (call, row)
    W = ref.load_weights(config, weight_seed, device)
    head = config["action_head"]
    span = np.asarray(norms["max"]) - np.asarray(norms["min"])
    gaps, z_gaps, unmatched = [], [], 0
    for r in picked:
        if r[0] not in by_id:
            unmatched += 1
            continue
        call, row = by_id[r[0]]
        g = torch.Generator(device=device)
        g.set_state(call["state"])
        noise = torch.randn((call["padded"], head["chunk_size"], head["action_dim"]), generator=g,
                            dtype=torch.float32, device=device)[row]
        want, z = ref.served_chunk(W, config, texts[r[2]], frames[r[3]], noise, norms)
        got = np.asarray(r[7], np.float64)
        gaps.append(float((np.abs(got - want)[:, : len(span)] / span).max()))
        z_got = call["z"][row].float()
        z_gaps.append(float(torch.linalg.vector_norm(z_got - z) / torch.linalg.vector_norm(z)))
    del W
    gc.collect()
    lim = config["correctness"]
    checks = [core.Check("chunk_gap", max(gaps) if gaps else math.inf, lim["chunk_gap"]),
              core.Check("feature_gap", max(z_gaps) if z_gaps else math.inf, lim["feature_gap"]),
              core.Check("failed_requests", float(len(run.sent()) - len([r for r in run.sent() if run.ok(r)])), 0.0),
              core.Check("unmatched_requests", float(unmatched), 0.0)]
    return checks, {"chunk_gaps": gaps, "feature_gaps": z_gaps, "checked": len(gaps)}


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        quantize: str = "") -> dict:
    """One run of a serving cell; returns what ``vlabench.run`` prints."""
    import torch

    config, traffic = cell.config, cell.traffic
    system = core.load_system(cell)
    ref = core.load_reference(cell)
    weight_seed = core.derive_seed(seed, "weights")
    traffic_seed = core.derive_seed(seed, "traffic")

    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=clients.main, args=(child, traffic, traffic_seed), daemon=True)
    proc.start()
    httpd = server = recorder = None
    try:
        exp, cfg, model = system.build(config, weight_seed, core.derive_seed(seed, "server"),
                                       device, quantize)
        norms = system.norm_stats(config, core.derive_seed(seed, "norms"))
        server = system.make_server(exp, cfg, model, norms, traffic)
        spans = Spans(trace)
        recorder = system.Recorder(server, spans)
        httpd = server.serve_background()
        port = httpd.server_address[1]
        if parent.recv()[0] != "ready":
            raise RuntimeError("client process did not start")
        parent.send(("warmup", port, traffic["warmup_rounds"]))
        _, statuses = parent.recv()
        if any(s != 200 for s in statuses):
            raise RuntimeError(f"warm-up requests failed: {statuses}")
        undo = system.install_kernel_spans(spans) if trace else None
        traced = Window(spans)
        core.sync()
        start = time.monotonic() + 0.05
        setup_s = start - t_start
        if trace:
            traced.start()
            while time.monotonic() < start:
                time.sleep(0.001)
        parent.send(("window", port, start, seconds))
        if trace:  # the traced window closes with the measured one
            time.sleep(max(0.0, start + seconds - time.monotonic()))
            traced.stop()
        _, records = parent.recv()
        device_trace = None
        if trace:
            device_trace = traced.reduce()
            undo()
        window = (start, start + seconds)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        run_data = ServeRun(cell.name, config, traffic, seconds, window, records, recorder.calls,
                            spans, device_trace, system)
    finally:
        if recorder is not None:
            recorder.close()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if server is not None:
            server.close()
        if proc.is_alive():
            parent.send(("stop",))
        proc.join(timeout=30)
        if proc.is_alive():
            proc.terminate()
            proc.join()
    del exp, cfg, model, server, recorder, httpd
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks, readings = check(run_data, ref, config, weight_seed, core.derive_seed(seed, "sample"),
                             traffic_seed, norms, device)
    sent = run_data.sent()
    failed = len([r for r in sent if not run_data.ok(r)])
    return {"run": run_data, "setup_s": setup_s, "peak": peak, "checks": checks,
            "notes": readings, "attempted": len(sent), "failed": failed,
            "end_to_end": end_to_end(run_data)}
