"""Nothing the benchmark loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``dexbotic_tpu`` (compared whole: ``dexbotic_tpu_torch`` is the
port), and the plain references load nothing of the port either."""

import json
import subprocess
import sys

from vlabench.tests.vb_tiny import REPO, checkout

LOAD_ALL = """
import json, sys
from vlabench import core, run, clients, readers, trace, yardstick, weights, control, k1_check
root = core.repo_root()
for folder in ("traffic", "systems", "reference", "metrics"):
    for path in sorted((root / "vlabench" / folder).glob("*.py")):
        core.load_part(root, folder, path.stem)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFS = """
import json, sys
import vlabench.reference.plain, vlabench.reference.cogact, vlabench.reference.dm0
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

TINY_RUN = """
import json, sys
from pathlib import Path
from vlabench import core, run
cell = core.load_cell(sys.argv[1], Path(sys.argv[2]))
res = run.run_cell(cell, 2 ** 31 + 11, 2.0, False, "cpu", 0.0)
print(json.dumps({"bad": core.forbidden_loaded(), "program": "dexbotic_tpu_torch" in sys.modules}))
"""


def top_level(code, *args, cwd=REPO):
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=cwd, capture_output=True, text=True,
                         check=True, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    mods = set(top_level(LOAD_ALL))
    assert not mods & {"jax", "jaxlib", "flax", "dexbotic_tpu"}


def test_references_load_nothing_of_the_program():
    mods = set(top_level(REFS))
    assert not mods & {"jax", "jaxlib", "flax", "dexbotic_tpu", "dexbotic_tpu_torch"}


def test_the_guard_compares_whole_names():
    from vlabench import core

    assert core.forbidden_loaded(["dexbotic_tpu_torch.exp", "numpy"]) == []
    assert core.forbidden_loaded(["dexbotic_tpu.models", "jaxlib.xla", "flax"]) == [
        "dexbotic_tpu.models", "flax", "jaxlib.xla"]


def test_a_run_of_the_program_loads_no_jax(tmp_path):
    root = checkout(tmp_path)
    for cell in ("dm0-tiny.train-tiny", "cogact-tiny.tiny2"):
        got = top_level(TINY_RUN, cell, str(root), cwd=root)
        assert got == {"bad": [], "program": True}


def test_no_device_no_result(tmp_path):
    cmd = [sys.executable, "vlabench/run.py", "--workload", "cogact-qwen2-7b.fleet8", "--seed",
           str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(REPO / "vlabench"), str(bare / "vlabench")], check=True)
    out = subprocess.run(cmd, cwd=bare, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
