"""The readers the per-layer metrics share: each takes what a run recorded
(its spans, counters and the reduced device trace) and returns the number,
or None where the run holds nothing to read."""

from __future__ import annotations

from vlabench import yardstick


def visible_pairs(masks, cache: dict) -> int:
    """Visible (query, key) pairs of one call summed over its batch rows:
    key j is seen by query i when kv_grp[j] <= q_grp[i] and kv_valid[j]."""
    q_grp, kv_grp, kv_valid = masks
    key = tuple((t.data_ptr(), t._version, tuple(t.shape)) for t in masks)
    if key not in cache:
        seen = (kv_grp[:, None, :] <= q_grp[:, :, None]) & (kv_valid[:, None, :] != 0)
        cache[key] = int(seen.sum().item())
    return cache[key]


def attention_work(span: dict, cache: dict, backward: bool = False) -> tuple[float, float]:
    """(operations, bytes) of a recorded attention call (``k1`` or ``k3`` span)."""
    (B, Sq, Hq, D), (_, Skv, Hkv, _) = span["shapes"]
    pairs = visible_pairs(span["masks"], cache) * Hq
    fn = yardstick.attention_bwd if backward else yardstick.attention_fwd
    return fn(B, Sq, Skv, Hq, Hkv, D, pairs, span["elem"])


def roofline_share(run, name: str, work) -> float | None:
    """100 x the least time of the profiled ``name`` spans' work over the
    device time of the kernels launched inside them; None without either."""
    if run.trace is None:
        return None
    spans = run.spans.of(name, profiled_only=True)
    device_s = run.trace.device_s(name)
    if not spans or device_s <= 0:
        return None
    least = sum(yardstick.bound_s(*work(s))[0] for s in spans)
    return 100.0 * least / device_s


def bound_by(spans: list, work) -> str:
    """Which of operations or bytes bounds most of the spans' least time."""
    by = {"operations": 0.0, "bytes": 0.0}
    for s in spans:
        t, which = yardstick.bound_s(*work(s))
        by[which] += t
    return max(by, key=by.get)


def bounds(run) -> dict:
    """Which of operations or bytes bounds each kernel span's roofline
    (printed beside the shares)."""
    cache = {}
    works = {"k1": lambda s: attention_work(s, cache), "k2": lambda s: (s["ops"], s["bytes"]),
             "k3": lambda s: attention_work(s, cache, backward=True)}
    return {f"{name}_bound_by": bound_by(spans, work) for name, work in works.items()
            if (spans := run.spans.of(name, profiled_only=True))}


def in_window(run, name: str) -> list:
    return [s for s in run.spans.of(name) if run.window[0] <= s["t0"] < run.window[1]]


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def host_ms(run):
    spans = {vid: s for s in run.spans.of("policy") for vid in s["requests"]}
    gaps = [((r[5] - r[4]) - (spans[r[0]]["t1"] - spans[r[0]]["t0"])) * 1e3
            for r in run.sent() if run.ok(r) and r[0] in spans]
    return sum(gaps) / len(gaps) if gaps else None


def batch_rows(run):
    calls = in_window(run, "policy")
    return sum(len(s["requests"]) for s in calls) / len(calls) if calls else None


def policy_ms(run):
    calls = in_window(run, "policy")
    return 1e3 * sum(s["t1"] - s["t0"] for s in calls) / len(calls) if calls else None


def k1_roofline(run):
    cache = {}
    return roofline_share(run, "k1", lambda s: attention_work(s, cache))


def k2_roofline(run):
    return roofline_share(run, "k2", lambda s: (s["ops"], s["bytes"]))


def idle_share(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def serve_mfu(run):
    """Model FLOPs of the chunks whose policy call ran inside the traced
    window over the traced window's seconds times the bf16 peak."""
    if run.trace is None:
        return None
    flops = 0.0
    for s in run.spans.of("policy", profiled_only=True):
        for n in s.get("tokens", ())[: len(s["requests"])]:
            flops += run.system.chunk_flops(run.config, n)
    if flops <= 0:
        return None
    return 100.0 * flops / (run.trace.window_s * yardstick.PEAK_BF16_FLOPS)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def data_wait_ms(run):
    return 1e3 * sum(run.data_waits) / len(run.data_waits) if run.data_waits else None


def optim_ms(run):
    calls = in_window(run, "optim")
    return 1e3 * sum(s["t1"] - s["t0"] for s in calls) / len(calls) if calls else None


def k3_roofline(run):
    cache = {}
    return roofline_share(run, "k3", lambda s: attention_work(s, cache, backward=True))


def train_mfu(run):
    """Model FLOPs of the samples of the steps inside the traced window over
    the traced window's seconds times the bf16 peak."""
    if run.trace is None or not run.traced_steps:
        return None
    flops = run.traced_steps * run.batch * run.system.sample_flops(run.config, run.text_valid)
    return 100.0 * flops / (run.trace.window_s * yardstick.PEAK_BF16_FLOPS)
