"""Cross-check of the traced device time: K1's time per call as the traced
run reads it (the kernels launched inside the decoder's attention calls of
the profiled window) against CUDA events around queued calls at the same
shapes, in the same process after the window.  The benchmark's own runs
never run this.

    python3 vlabench/k1_check.py --workload <cell> --seed <n> --seconds <s> [--calls 50]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vlabench import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--calls", type=int, default=50)
    args = p.parse_args(argv)
    root = core.repo_root()
    core.set_cache_dirs(root)
    import torch

    from vlabench import run

    cell = core.load_cell(args.workload, root)
    res = run.run_cell(cell, args.seed, args.seconds, True, "cuda", time.monotonic())
    trace, spans = res["run"].trace, res["run"].spans.of("k1", profiled_only=True)
    by_shape = Counter(s["shapes"] for s in spans)
    per_span = {}
    for s in spans:
        per_span.setdefault(s["shapes"], []).append(s)
    traced_total = trace.device_s("k1")
    from dexbotic_tpu_torch.ops.attention import attention

    out = {"traced_k1_s": traced_total, "spans": len(spans), "shapes": []}
    events_total = 0.0
    for shape, n in by_shape.most_common():
        (B, Sq, Hq, D), (_, Skv, Hkv, _) = shape
        q_grp, kv_grp, kv_valid = per_span[shape][0]["masks"]
        g = torch.Generator(device="cuda").manual_seed(0)
        dtype = torch.bfloat16 if per_span[shape][0]["elem"] == 2 else torch.float32
        q = torch.randn(B, Sq, Hq, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, Skv, Hkv, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, Skv, Hkv, D, generator=g, device="cuda").to(dtype)
        for _ in range(5):
            attention(q, k, v, q_grp, kv_grp, kv_valid)
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(args.calls):
            attention(q, k, v, q_grp, kv_grp, kv_valid)
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / args.calls
        events_total += ms / 1e3 * n
        out["shapes"].append({"shape": shape, "calls_in_window": n, "events_ms_per_call": ms})
    out["events_k1_s"] = events_total
    out["traced_over_events"] = traced_total / events_total if events_total else None
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
