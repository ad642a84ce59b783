"""The readings of a cell's control and faults on the chip, which set the
upper ends of its correctness limits (``PERF.md`` gives them).  The
benchmark's own runs never run this.

    python3 vlabench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

A serving cell runs the program with its int8 path switched on (the
precision below the bf16 it serves in), one whole run a seed, and with
``--fault`` a fault planted where the answers are produced instead; a
training cell puts the plain reference in the program's place in fp8, and
with half of each micro-batch left out.  Each reading goes to standard
output as one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vlabench import core  # noqa: E402


FAULTS = {
    "shift": "every answer shifted by 0.5 (a quarter of the normalised range)",
    "rolled": "each row of a batch answered with its neighbour's chunk",
    "no_guidance": "the action head sampled without classifier-free guidance (scale 1)",
    "step_dropped": "the guided DDIM run with one step fewer",
}


@contextlib.contextmanager
def planted(fault):
    """The served policy's answers altered where they are produced: the
    chunk the policy call returns (``shift``, ``rolled``), or the action
    head's sampler, K2 and its plain loop alike (``no_guidance``,
    ``step_dropped``)."""
    if fault is None:
        yield
        return
    from dexbotic_tpu_torch.exp import cogact_exp
    from dexbotic_tpu_torch.models import cogact as cogact_mod

    if fault in ("shift", "rolled"):
        mod, names = cogact_exp, ("cogact_inference_action",)
    else:
        mod, names = cogact_mod, ("fused_dit_sample", "dit_sample_ref")
    real = {n: getattr(mod, n) for n in names}

    def wrap(fn):
        def broken(*args, **kw):
            if fault == "no_guidance":
                kw["cfg_scale"] = 1.0
            elif fault == "step_dropped":
                kw["steps"] -= 1
            out = fn(*args, **kw)
            if fault == "shift":
                return out + 0.5
            return out.roll(1, dims=0) if fault == "rolled" else out

        return broken

    for n, fn in real.items():
        setattr(mod, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(mod, n, fn)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--fault", choices=tuple(FAULTS), default=None,
                   help="a served model's fault: " + "; ".join(f"{k}: {v}" for k, v in FAULTS.items()))
    args = p.parse_args(argv)
    root = core.repo_root()
    core.set_cache_dirs(root)
    cell = core.load_cell(args.workload, root)
    kind = core.load_kind(cell)
    for seed in args.seeds:
        if hasattr(kind, "control"):
            out = kind.control(cell, seed, "cuda")
        else:
            from vlabench import run

            name = args.fault or "int8"
            with planted(args.fault):
                res = run.run_cell(cell, seed, args.seconds, False, "cuda", time.monotonic(),
                                   quantize="" if args.fault else "int8")
            out = {name: {"checks": {c.name: c.value for c in res["checks"]}, "notes": res["notes"]}}
        print(json.dumps({"workload": cell.name, "seed": seed, "readings": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
