"""Tiny checkouts for the CPU tests: the benchmark's files copied to a
temporary directory, the program linked beside them, and ``BENCHMARK.json``
given tiny cells whose configuration and mix files sit in ``tests/data``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"

SERVE = "cogact-tiny.tiny2"
TRAIN = "dm0-tiny.train-tiny"


def checkout(tmp: Path) -> Path:
    """A checkout at ``tmp`` holding the benchmark's files, the program (linked)
    and the tiny cells, each reporting the metrics of the full cell it stands
    for."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "vlabench", root / "vlabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "dexbotic_tpu_torch").symlink_to(REPO / "dexbotic_tpu_torch")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    shutil.copy(DATA / "cogact-tiny.json", root / "vlabench/configs/cogact-tiny.json")
    shutil.copy(DATA / "tiny2.json", root / "vlabench/traffic/tiny2.json")
    shutil.copy(DATA / "dm0-tiny.json", root / "vlabench/configs/dm0-tiny.json")
    shutil.copy(DATA / "train-tiny.json", root / "vlabench/traffic/train-tiny.json")
    bench["configs"] += [
        {"name": "cogact-tiny", "source": "test", "file": "vlabench/configs/cogact-tiny.json",
         "reduced": [], "why": "test"},
        {"name": "dm0-tiny", "source": "test", "file": "vlabench/configs/dm0-tiny.json",
         "reduced": [], "why": "test"}]
    bench["workloads"] += [
        {"name": SERVE, "config": "cogact-tiny", "traffic": "tiny2", "chips": 1, "why": "test"},
        {"name": TRAIN, "config": "dm0-tiny", "traffic": "train-tiny", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells = m.get("workloads")
        if cells is None:
            continue
        if "cogact-qwen2-7b.fleet8" in cells:
            cells.append(SERVE)
        if "dm0.libero-train" in cells:
            cells.append(TRAIN)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def limits_of(name: str) -> dict:
    """The correctness limits of the full configuration ``name``."""
    return json.loads((REPO / "vlabench/configs" / f"{name}.json").read_text())["correctness"]
