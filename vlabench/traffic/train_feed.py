"""Training feed: the recipe's optimizer steps on seeded LIBERO-like samples.

The mix file gives the samples (count, views, frame size, instruction
lengths), the loader's workers, the steps that set-up drives and the
reference follows, and the steps a traced run profiles.  Set-up builds the
program from the seed (the configuration's system adapter: the trainer and
its feed), then drives the first steps through the trainer's own loop and
feed, reading the first gradient from the optimizer's moments after step 1
and each leaf's change after the last of them; those steps also warm up
every shape.  The window then runs the same trainer for ``--seconds``: it
spans from the first step's start to the end of the last step that
completed.  Then the program is freed and the plain reference follows the
first steps from the raw samples.
"""

from __future__ import annotations

import gc
import json
import math
import random
import shutil
import statistics
import time

import numpy as np

from vlabench import clients, core
from vlabench.reference import plain
from vlabench.trace import Spans, Window


def make_sample(config: dict, traffic: dict, seed: int, index: int):
    """Sample ``index`` of the seed: (uint8 views [n, h, w, 3], instruction,
    actions [chunk, dim] in [-1, 1], state [dim]); every seed has the same
    sizes."""
    rng = np.random.default_rng([seed, index])
    fl = config["flow"]
    frames = rng.integers(0, 256, (config["views"], traffic["frame_height"], traffic["frame_width"], 3),
                          dtype=np.uint8)
    lo, hi = traffic["instruction_chars"]
    text = clients.instruction(rng, int(rng.integers(lo, hi + 1)))
    actions = rng.uniform(-1.0, 1.0, (fl["chunk_size"], fl["action_dim"])).astype(np.float32)
    state = rng.uniform(-1.0, 1.0, fl["action_dim"]).astype(np.float32)
    return frames, text, actions, state


def loader_order(count: int, seed: int) -> list:
    """The samples in the order the loader's first epoch takes them: the
    documented rule of ``data_iterator`` and ``DataLoader`` (one
    ``random.Random(seed)`` shuffle of the indices)."""
    order = list(range(count))
    random.Random(seed).shuffle(order)
    return order


class Feed:
    """The device batches, handed to the trainer's loop one phase at a
    time: a phase ends after ``steps`` batches or once ``until`` (monotonic)
    has passed, without closing the loader.  ``marks`` holds the time of
    each request for a batch, which is the end of the step before it;
    ``on_mark(i)`` is called at the phase's i-th mark."""

    def __init__(self, batches):
        self.batches = batches
        self.left = self.until = None
        self.marks: list = []
        self.on_mark = None

    def phase(self, steps=None, until=None, on_mark=None):
        self.left, self.until, self.on_mark, self.marks = steps, until, on_mark, []
        return self

    def __iter__(self):
        return self

    def __next__(self):
        now = time.monotonic()
        self.marks.append(now)
        if self.on_mark is not None:
            self.on_mark(len(self.marks) - 1)
        if (self.left is not None and self.left <= 0) or (self.until is not None and now >= self.until):
            raise StopIteration
        if self.left is not None:
            self.left -= 1
        return next(self.batches)


class TrainRun:
    """What the metric readers of a training cell read."""

    def __init__(self, config, traffic, system, window, steps, data_waits, spans, trace,
                 text_valid, traced_steps):
        self.config, self.traffic, self.system = config, traffic, system
        self.window = window  # (start, end) monotonic
        self.steps = steps  # (t0, t1, metrics) of each step in the window
        self.data_waits = data_waits  # the trainer's data_wait_s of each window step
        self.spans = spans
        self.trace = trace
        self.text_valid = text_valid
        self.traced_steps = traced_steps  # whole steps inside the traced window
        tc = config["train"]
        self.batch = tc["per_device_batch_size"] * tc["gradient_accumulation_steps"]


def gaps(program: dict, reference: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf; (gap, leaf)."""
    names = [n for n in reference if keep is None or keep(n)]
    median = statistics.median(reference[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        p = program.get(n, 0.0)
        g = abs(p - reference[n]) / max(reference[n], median, 1e-30)
        if not math.isfinite(g):
            return math.inf, n
        if g > worst:
            worst, at = g, n
    return worst, at


def compare(config: dict, got: dict, want: dict) -> tuple[list, dict]:
    """The checks of the first steps: each step's loss, the first gradient's
    norms and the change's norms by leaf; a leaf whose reference gradient
    is under a thousandth of the median leaf's moves by round-off alone and
    is left out of the change."""
    lim = config["correctness"]
    losses = [abs(p - r) / abs(r) for p, r in zip(got["losses"], want["losses"])]
    loss_gap = max(losses) if len(losses) == len(want["losses"]) else math.inf
    grad_gap, grad_at = gaps(got["grad_norms"], want["grad_norms"])
    g = want["grad_norms"]
    floor = 1e-3 * statistics.median(g.values())
    change_gap, change_at = gaps(got["change_norms"], want["change_norms"], lambda n: g[n] >= floor)
    checks = [core.Check("loss_gap", loss_gap, lim["loss_gap"]),
              core.Check("grad_norm_gap", grad_gap, lim["grad_norm_gap"]),
              core.Check("change_norm_gap", change_gap, lim["change_norm_gap"])]
    notes = {"losses": got["losses"], "reference_losses": want["losses"], "loss_gaps": losses,
             "grad_worst_leaf": grad_at, "change_worst_leaf": change_at,
             "change_leaves_left_out": sorted(n for n in g if g[n] < floor)}
    return checks, notes


def reference_steps(config: dict, traffic: dict, weight_seed: int, data_seed: int, train_seed: int,
                    steps: int, ref, device, rows=None) -> dict:
    tc = config["train"]
    batch = tc["per_device_batch_size"] * tc["gradient_accumulation_steps"]
    order = loader_order(traffic["samples"], train_seed)
    samples = [[make_sample(config, traffic, data_seed, order[s * batch + r])[:3] for r in range(batch)]
               for s in range(steps)]
    W = ref.load_weights(config, weight_seed, device)
    try:
        return ref.train(W, config, samples, train_seed, block=traffic["reference_rows"], rows=rows)
    finally:
        del W


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    """One run of a training cell; returns what ``vlabench.run`` prints."""
    import torch

    config, traffic = cell.config, cell.traffic
    system = core.load_system(cell)
    ref = core.load_reference(cell)
    weight_seed = core.derive_seed(seed, "weights")
    data_seed = core.derive_seed(seed, "data")
    train_seed = core.derive_seed(seed, "train")
    checked = traffic["checked_steps"]
    out_dir = core.scratch_dir("train")
    try:
        exp, trainer, tokenizer = system.build(config, weight_seed, train_seed, str(out_dir), device)
        samples = system.Samples(exp, tokenizer,
                                 lambda i: make_sample(config, traffic, data_seed, i), traffic["samples"])
        feed = Feed(system.make_loader(exp, tokenizer, trainer, samples, traffic["workers"]))
        steps = []
        step_fn = trainer.train_step
        spans = Spans(trace)

        def train_step(batch):
            t0 = time.monotonic()
            with spans.span("step"):
                out = step_fn(batch)
            steps.append((t0, time.monotonic(), out))
            return out

        trainer.train_step = train_step
        # the first steps, through the window's own call and feed
        start_params = {n: p.detach().clone() for n, p in trainer.params.items()}
        trainer.train(feed.phase(steps=1))
        b1 = exp.optimizer.adam_beta1
        grad_norms = {n: float(torch.linalg.vector_norm(m)) / (1 - b1)
                      for n, m in trainer.optimizer.mu.items()}
        trainer.train(feed.phase(steps=checked - 1))
        change_norms = {n: float(torch.linalg.vector_norm(p.detach().float() - start_params[n].float()))
                        for n, p in trainer.params.items()}
        got = {"losses": [s[2]["loss"] for s in steps[:checked]], "grad_norms": grad_norms,
               "change_norms": change_norms}
        del start_params
        core.sync()
        setup_s = time.monotonic() - t_start

        undo = system.install_spans(trainer, spans) if trace else None
        traced = Window(spans)
        first_traced = traffic["trace_after_steps"]
        last_traced = first_traced + traffic["trace_steps"]

        def on_mark(i):
            if trace and i == first_traced:
                traced.start()
            elif trace and i == last_traced:
                traced.stop()

        first = len(steps)
        trainer.train(feed.phase(until=time.monotonic() + seconds, on_mark=on_mark))
        window = (feed.marks[0], feed.marks[-1])
        device_trace = None
        if trace:
            traced.stop()  # where the window closed before the traced steps did
            device_trace = traced.reduce()
        if undo is not None:
            undo()
            undo = None  # its closure holds the trainer, which has to be freed before the reference
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        feed.batches.close()
        trainer.close()
        logged = {}
        with open(out_dir / "metrics.jsonl") as f:
            for line in f:
                entry = json.loads(line)
                logged[entry["step"]] = entry
        window_steps = steps[first:]
        waits = [logged[k]["data_wait_s"] for k in range(first + 1, first + len(window_steps) + 1)
                 if k in logged]
        text_valid = int(samples.tok([{"from": "human", "value": "x"}])["token_mask"].sum())
        traced = max(0, min(last_traced, len(feed.marks) - 1) - first_traced) if trace else 0
        run_data = TrainRun(config, traffic, system, window, window_steps, waits, spans, device_trace,
                            text_valid, traced)
        del exp, trainer, feed, samples, step_fn
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    plain.no_tf32()
    want = reference_steps(config, traffic, weight_seed, data_seed, train_seed, checked, ref, device)
    checks, notes = compare(config, got, want)
    samples_done = len(run_data.steps) * run_data.batch
    rate = samples_done / (window[1] - window[0]) if len(run_data.steps) else 0.0
    return {"run": run_data, "setup_s": setup_s, "peak": peak, "checks": checks, "notes": notes,
            "attempted": len(run_data.steps), "failed": 0,
            "end_to_end": {"train_samples_per_s": {"value": rate, "unit": "samples/s"}}}


def control(cell, seed: int, device: str) -> dict:
    """The readings that set the checks' upper ends, with no program run:
    the reference put in the program's place in fp8 (the control), and
    with half of each micro-batch left out, the mean taken over the rest
    (a fault), each compared with the fp32 reference."""
    config, traffic = cell.config, cell.traffic
    ref = core.load_reference(cell)
    seeds = [core.derive_seed(seed, t) for t in ("weights", "data", "train")]
    steps = traffic["checked_steps"]
    plain.no_tf32()
    want = reference_steps(config, traffic, *seeds, steps, ref, device)
    out = {}
    for name, rows, quant in (("fp8", None, "fp8"),
                              ("half_batch", config["train"]["per_device_batch_size"] // 2, None)):
        plain.QUANT = quant
        try:
            got = reference_steps(config, traffic, *seeds, steps, ref, device, rows=rows)
        finally:
            plain.QUANT = None
        checks, notes = compare(config, got, want)
        out[name] = {"checks": {c.name: c.value for c in checks}, "notes": notes}
    return out
