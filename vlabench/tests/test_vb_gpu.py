"""The controls at the cells' own sizes, on the card: each comes out not
correct by at least one of its cell's limits.  Skips without a CUDA device.

    python -m pytest vlabench/tests/test_vb_gpu.py -q -m gpu
"""

import json
import subprocess
import sys

import pytest

from vlabench.tests.vb_tiny import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_full_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vlabench import core

    c = core.load_cell(cell, REPO)
    limits = c.config["correctness"]
    out = subprocess.run([sys.executable, "vlabench/control.py", "--workload", cell, "--seeds",
                          str(2 ** 31 + 41)], cwd=REPO, capture_output=True, text=True, check=True)
    readings = json.loads(out.stdout.strip().splitlines()[-1])["readings"]
    for name, r in readings.items():
        assert any(v > limits[k] for k, v in r["checks"].items() if k in limits), (name, r["checks"])
