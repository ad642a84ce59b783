"""What every cell shares: finding a cell's files by name, seeds, statistics,
the import guard and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its configuration
is the JSON file the entry of ``configs`` names; its traffic mix is
``vlabench/traffic/<traffic>.json``, whose ``kind`` names the generator
``vlabench/traffic/<kind>.py``; the configuration's ``system`` names the
adapter ``vlabench/systems/<system>.py`` that builds the program, and its
``reference`` the plain model ``vlabench/reference/<reference>.py``; each
per-layer metric is ``vlabench/metrics/<name>.py``.  A later change adds a
cell, a mix, a kind or a metric by adding files and entries only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
from dataclasses import dataclass, field
from pathlib import Path

# the top-level module names no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dexbotic_tpu")
PROGRAM = "dexbotic_tpu_torch"

HERE = Path(__file__).resolve().parent


def repo_root() -> Path:
    """The checkout: the directory that holds ``BENCHMARK.json`` and ``vlabench/``."""
    return HERE.parent


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot) is
    one of FORBIDDEN_MODULES, compared whole: ``dexbotic_tpu_torch`` is not
    ``dexbotic_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN_MODULES})


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed of its own for each use of the run's ``--seed``."""
    import numpy as np

    words = [int(seed) & (2 ** 64 - 1)] + [sum(ord(c) << (8 * (i % 7)) for i, c in enumerate(str(t)))
                                           for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


# ---------------------------------------------------------------------------
# Finding a cell's files
# ---------------------------------------------------------------------------


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names, loaded."""

    root: Path
    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)  # metric entries this cell reports
    per_layer: list = field(default_factory=list)

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path | None = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, its configuration,
    its traffic mix and the metrics it reports."""
    root = Path(root or repo_root())
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(root / "vlabench" / "traffic" / f"{entry['traffic']}.json")
    return Cell(root, name, entry, config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def _load_module(path: Path, qualname: str):
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(qualname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_part(root: Path, folder: str, name: str):
    """``<root>/vlabench/<folder>/<name>.py`` as a module (a name may hold dots)."""
    return _load_module(Path(root) / "vlabench" / folder / f"{name}.py",
                        f"vlabench_{folder}_{name.replace('.', '_').replace('-', '_')}")


def load_kind(cell: Cell):
    return load_part(cell.root, "traffic", cell.traffic["kind"])


def load_system(cell: Cell):
    return load_part(cell.root, "systems", cell.config["system"])


def load_reference(cell: Cell):
    return load_part(cell.root, "reference", cell.config["reference"])


def load_metric(root: Path, name: str):
    return load_part(root, "metrics", name)


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between closest
    ranks, as numpy's default; ``inf`` entries (failed requests) rank above
    every finite one."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if lo == hi or xs[lo] == xs[hi]:
        return float(xs[lo])
    if math.isinf(xs[hi]):
        return math.inf
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------


@dataclass
class Check:
    """One number the correctness comparison reads, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def sync() -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def device_info(count: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def emit(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
         checks: list, breakdown: dict | None = None) -> str:
    """Print the checks on standard error, then the result as the last line
    of standard output: the contract's keys, then ``checks`` last."""
    for c in checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr)
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    line = json.dumps(out)
    sys.stderr.flush()
    print(line, flush=True)
    return line


def scratch_dir(tag: str) -> Path:
    """A directory of this run under TMPDIR (never a fixed /tmp path)."""
    import tempfile

    return Path(tempfile.mkdtemp(prefix=f"vlabench-{tag}-"))


def set_cache_dirs(root: Path) -> None:
    """Keep every build and kernel cache of the program inside the checkout,
    at fixed paths, so that only a cell's first run there builds."""
    cache = Path(root) / ".vlabench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv_compute")
    # a library that loads JAX or Flax by itself is kept from doing so
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
