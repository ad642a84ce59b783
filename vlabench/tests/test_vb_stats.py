"""The tail and the rates over synthetic runs that hold failures and a stall."""

import math
import statistics

import pytest

from vlabench import core
from vlabench.tests.vb_tiny import REPO


def test_percentile_ranks_failures_last():
    xs = [float(i) for i in range(1, 101)]
    assert core.percentile(xs, 95) == pytest.approx(95.05)
    assert math.isinf(core.percentile(xs[:-10] + [math.inf] * 10, 95))
    assert core.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert core.spread(xs) == pytest.approx((q3 - q1) / med)


def serve_run(records, seconds=10.0):
    kind = core.load_part(REPO, "traffic", "serve_closed_loop")
    config = core.load_json(REPO / "vlabench/configs/cogact-qwen2-7b.json")
    traffic = core.load_json(REPO / "vlabench/traffic/fleet8.json")
    return kind, kind.ServeRun("fleet8", config, traffic, seconds, (0.0, seconds), records, [], None,
                               None, None)


def record(i, sent, done, ok=True):
    chunk = [[0.0] * 7 for _ in range(16)] if ok else None
    return [i, 0, 0, 0, sent, done, 200 if ok else 500, chunk]


def test_serving_rates_and_tail_with_failures_and_a_stall():
    # 18 answered in 0.5 s, one stalled 4 s, one failed, one sent after the window
    recs = [record(i, 0.5 * i, 0.5 * i + 0.5) for i in range(18)]
    recs.append(record(18, 9.0, 13.0))
    recs.append(record(19, 9.5, 9.6, ok=False))
    recs.append(record(20, 10.5, 10.7))
    kind, run = serve_run(recs)
    e2e = kind.end_to_end(run)
    assert e2e["chunks_per_s"]["value"] == pytest.approx(18 / 10.0)  # the stalled one came late
    assert len(run.sent()) == 20
    # 20 latencies: 18 of 500 ms, one of 4000 ms, one failure ranked above all
    lat = sorted(run.latencies_ms())
    assert math.isinf(lat[-1]) and lat[-2] == pytest.approx(4000.0)
    # the 95th percentile of 20 lies between the stall and the failure: a miss
    assert math.isinf(core.percentile(run.latencies_ms(), 95))
    assert core.percentile(run.latencies_ms(), 90) == pytest.approx(500.0 + 0.1 * 3500.0)


def test_training_rate_over_whole_steps():
    kind = core.load_part(REPO, "traffic", "train_feed")
    feed = kind.Feed(iter(range(100)))
    clock = iter([0.0, 6.0, 12.5, 31.0, 40.0])
    kind.time.monotonic, real = (lambda: next(clock)), kind.time.monotonic
    try:
        got = list(feed.phase(until=30.0))
    finally:
        kind.time.monotonic = real
    # marks at 0, 6, 12.5 and 31: three whole steps, the window from 0 to 31
    assert got == [0, 1, 2] and feed.marks == [0.0, 6.0, 12.5, 31.0]


def test_fleet_tail_reader_reads_no_miss():
    reader = core.load_metric(REPO, "chunk_latency_p95_ms.fleet")
    recs = [record(i, 0.5 * i, 0.5 * i + 0.5) for i in range(18)] + [record(18, 9.0, 13.0)]
    kind, run = serve_run(recs)
    assert reader.read(run) == pytest.approx(core.percentile([500.0] * 18 + [4000.0], 95))
    kind, run = serve_run(recs + [record(19, 9.5, 9.6, ok=False)])
    assert reader.read(run) is None  # the failure lies in the top 5 %
