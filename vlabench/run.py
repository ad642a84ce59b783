"""Run one cell once and print its result as the last line of standard output.

    python3 vlabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` the same window runs under the profiler with the benchmark's
spans, and the metrics are the cell's per-layer metrics, each read by
``vlabench/metrics/<name>.py``.  The run exits non-zero and prints no
result when no CUDA device is there (or fewer than the cell asks for), when
the program is missing, or when a process of the run holds JAX or the JAX
package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()  # set-up is counted from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout is the import root
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vlabench import core  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(cell: core.Cell, run_data) -> dict:
    """The cell's per-layer metrics that find something to read."""
    out = {}
    for m in cell.per_layer:
        value = core.load_metric(cell.root, m["name"]).read(run_data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: core.Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float = T_START, **kw) -> dict:
    """Run the cell's traffic kind; returns its result with the metrics the
    contract asks for under ``metrics``, and the device record."""
    result = core.load_kind(cell).run(cell, seed, seconds, trace, device, t_start, **kw)
    run_data = result["run"]
    if trace:
        metrics = per_layer(cell, run_data)
    else:
        names = {m["name"] for m in cell.end_to_end}
        metrics = {k: v for k, v in result["end_to_end"].items() if k in names}
        metrics["setup_s"] = {"value": result["setup_s"], "unit": "s"}
    result["metrics"] = metrics
    return result


def main(argv=None) -> int:
    args = parse(argv)
    root = core.repo_root()
    core.set_cache_dirs(root)
    if not (root / core.PROGRAM).is_dir():
        print(f"the program ({core.PROGRAM}) is not in {root}", file=sys.stderr)
        return 3
    cell = core.load_cell(args.workload, root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = core.forbidden_loaded()
    if bad:
        print(f"the run holds forbidden modules: {bad}", file=sys.stderr)
        return 4
    device = core.device_info(cell.chips, result["peak"])
    breakdown = None
    trace = getattr(result["run"], "trace", None)
    if args.trace and trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        breakdown = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    if args.trace:
        from vlabench import readers

        result["notes"].update(readers.bounds(result["run"]))
    for name, value in result.get("notes", {}).items():
        print(f"note {name}: {value}", file=sys.stderr)
    correct = all(c.ok for c in result["checks"])
    core.emit(correct, result["attempted"], result["failed"], result["metrics"], device,
              result["checks"], breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
