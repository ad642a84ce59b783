"""95th percentile of the send-to-reply latency at the client over every
request sent in the window, ms.  Above capacity a robot's wait is set by
how the micro-batcher splits the fleet into batches.  A failed request
ranks above every answer; where it reaches the 95th percentile there is no
finite number to read (the run is then not correct either)."""

import math

from vlabench import core


def read(run):
    lat = run.latencies_ms()
    p95 = core.percentile(lat, 95) if lat else math.inf
    return p95 if math.isfinite(p95) else None
