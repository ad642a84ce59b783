"""Spans and the device trace of a traced run (``--trace 1``).

The benchmark wraps the calls into the program's layers at run time (never
the program's files): each wrapper records a host span with what it knows
of the call (its shapes, the requests it served).  The profiler runs over
the traced window, which a ``vb:window`` annotation on the thread that
opens it marks; that annotation also ties the host's monotonic clock to the
profiler's.  After the window the profiler's raw events are reduced here:

* a device kernel belongs to the innermost span that holds its launch (the
  CUDA runtime or driver call, linked to the kernel by its correlation id),
  on whatever thread it ran, so a span's device time is every kernel
  launched inside it, whatever kernels implement it;
* busy time is the union of the kernel intervals within the window;
* the idle gaps are named by the innermost span active on the host at the
  gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


class Spans:
    """Host spans, kept in memory; a no-op recorder when off."""

    def __init__(self, on: bool):
        self.on = on
        self.items: list = []
        self.profiling = False
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        if not self.on:
            yield attrs
            return
        t0 = time.monotonic()
        try:
            yield attrs
        finally:
            t1 = time.monotonic()
            with self._lock:
                self.items.append({"name": name, "t0": t0, "t1": t1, "profiled": self.profiling,
                                   **attrs})

    def of(self, name: str, profiled_only: bool = False) -> list:
        return [s for s in self.items if s["name"] == name and (s["profiled"] or not profiled_only)]


@dataclass
class DeviceTrace:
    """The reduced profiler window: kernel intervals (ns), their owning
    annotation, and the host annotations."""

    window: tuple  # (start_ns, end_ns) of the traced window
    kernels: list = field(default_factory=list)  # (start, end, name, annotation or None)
    annotations: list = field(default_factory=list)  # (start, end, name, thread)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def clipped(self):
        w0, w1 = self.window
        for s, e, name, ann in self.kernels:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                yield s, e, name, ann

    def busy_intervals(self) -> list:
        out = []
        for s, e, _, _ in sorted(self.clipped()):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_s(self, annotation: str) -> float:
        """Seconds of the kernels launched inside ``vb:<annotation>`` spans."""
        key = f"vb:{annotation}"
        return sum(e - s for s, e, _, ann in self.kernels if ann == key) / 1e9

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(int)
        for s, e, name, _ in self.clipped():
            by[name] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle seconds within the window, summed by what the host was doing."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        by = defaultdict(int)
        anns = sorted(a for a in self.annotations if a[2] != "vb:window")
        starts = [a[0] for a in anns]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            best = innermost(anns, starts, (s + e) // 2)
            name = best[2] if best else "outside the spans (HTTP, batcher, data wait, other host work)"
            by[name] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def innermost(anns: list, starts: list, t: int, reach: int = 20000):
    """The latest-starting annotation of ``anns`` (sorted by start) that
    holds time ``t``, or None; nested spans make it the innermost."""
    i = bisect.bisect_right(starts, t) - 1
    stop = max(-1, i - reach)
    while i > stop:
        if anns[i][1] >= t:
            return anns[i]
        i -= 1
    return None


class Window:
    """The profiler over the traced window: ``start`` and ``stop`` on one
    thread, after the device's queued work; ``reduce`` gives the
    DeviceTrace with the spans recorded meanwhile."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = self.marker = None
        self.anchor = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        from vlabench.core import sync

        sync()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.marker = record_function("vb:window")
        self.anchor = time.monotonic()
        self.marker.__enter__()
        self.spans.profiling = True

    def stop(self) -> None:
        from vlabench.core import sync

        if self.marker is None:
            return
        sync()
        self.spans.profiling = False
        self.marker.__exit__(None, None, None)
        self.marker = None
        self.prof.__exit__(None, None, None)

    def reduce(self) -> "DeviceTrace":
        trace = reduce_profile(self.prof, self.spans.items, self.anchor)
        self.prof = None
        return trace


def reduce_profile(prof, spans: list, anchor: float) -> DeviceTrace:
    """A finished ``torch.profiler.profile`` whose ``vb:window`` annotation
    opened at monotonic ``anchor`` -> DeviceTrace, each kernel owned by the
    innermost of the profiled ``spans`` that holds its launch."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    launches, device, window = {}, [], None
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name == "vb:window":
                window = (ev.start_ns(), ev.end_ns())
            elif name.startswith("cu") and ev.correlation_id():
                launches[ev.correlation_id()] = ev.start_ns()
        elif not name.startswith("vb:") and not ev.is_user_annotation():
            device.append(ev)
    if window is None:
        raise RuntimeError("the profiler recorded no vb:window annotation")
    offset = window[0] - anchor * 1e9
    anns = sorted((int(s["t0"] * 1e9 + offset), int(s["t1"] * 1e9 + offset), f"vb:{s['name']}", 0)
                  for s in spans if s["profiled"])
    starts = [a[0] for a in anns]
    kernels = []
    for ev in device:
        owner = None
        launch = launches.get(ev.correlation_id())
        if launch is not None:
            best = innermost(anns, starts, launch)
            owner = best[2] if best else None
        kernels.append((ev.start_ns(), ev.end_ns(), ev.name(), owner))
    return DeviceTrace(window, kernels, anns)
