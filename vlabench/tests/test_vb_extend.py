"""A later change adds a cell and a metric as new files only: a toy traffic
kind, its mix, a configuration and a per-layer metric dropped into a copy
of the benchmark are found by name and run, and no file that was there is
edited."""

import hashlib
import json

from vlabench import run
from vlabench.tests.vb_tiny import checkout

TOY_KIND = '''
"""A toy traffic kind: counts to the mix's number."""


class ToyRun:
    def __init__(self, n):
        self.n = n


def run(cell, seed, seconds, trace, device, t_start):
    n = cell.traffic["count"] + cell.config["extra"]
    return {"run": ToyRun(n), "setup_s": 0.5, "peak": 0, "checks": [], "notes": {},
            "attempted": n, "failed": 0,
            "end_to_end": {"toy_rate": {"value": float(n) / seconds, "unit": "1/s"}}}
'''

TOY_METRIC = '''
"""The toy run's count."""


def read(run):
    return float(run.n)
'''


def digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in (root / "vlabench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_are_files_only(tmp_path):
    root = checkout(tmp_path)
    before = digests(root)
    (root / "vlabench/traffic/toy_kind.py").write_text(TOY_KIND)
    (root / "vlabench/traffic/toy.json").write_text(json.dumps({"kind": "toy_kind", "count": 40}))
    (root / "vlabench/configs/toy.json").write_text(json.dumps({"name": "toy", "extra": 2}))
    (root / "vlabench/metrics/toy_count.toy.py").write_text(TOY_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "test", "file": "vlabench/configs/toy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "toy.toy", "config": "toy", "traffic": "toy", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "toy_rate", "unit": "1/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["toy.toy"]})
    bench["per_layer"].append({"name": "toy_count.toy", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "toy", "moves": "toy_rate",
                               "workloads": ["toy.toy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = run.core.load_cell("toy.toy", root)
    e2e = run.run_cell(cell, 7, 2.0, False, "cpu", 0.0)["metrics"]
    assert e2e == {"toy_rate": {"value": 21.0, "unit": "1/s"}, "setup_s": {"value": 0.5, "unit": "s"}}
    layer = run.run_cell(cell, 7, 2.0, True, "cpu", 0.0)["metrics"]
    assert layer == {"toy_count.toy": {"value": 42.0, "unit": "1"}}
    after = digests(root)
    assert {p: d for p, d in after.items() if p in before} == before
