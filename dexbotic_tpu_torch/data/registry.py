"""Dataset registry: string-keyed suites with per-dataset meta_data.

Same contract as the reference (/root/reference/dexbotic/data/data_source/
register.py): CONVERSATION_DATA maps '{prefix}_{name}' -> {data_path_prefix,
annotations, frequency, meta_data}.  Suites point at local Dexdata roots; set
DEXBOTIC_DATA_ROOT to relocate.
"""

from __future__ import annotations

import os

CONVERSATION_DATA: dict[str, dict] = {}


def register_dataset(dataset: dict, prefix: str = "", meta_data: dict | None = None):
    if prefix:
        dataset = {f"{prefix}_{k}": v for k, v in dataset.items()}
    if meta_data is not None:
        for v in dataset.values():
            v.setdefault("meta_data", meta_data)
    CONVERSATION_DATA.update(dataset)


def _root() -> str:
    return os.environ.get("DEXBOTIC_DATA_ROOT", "./data")


def _suite(name: str, subsets: list[str], video_dir: str = "video") -> dict:
    return {
        sub: {
            "data_path_prefix": os.path.join(_root(), name, f"{name}_{sub}", video_dir),
            "annotations": os.path.join(_root(), name, f"{name}_{sub}"),
            "frequency": 1,
        }
        for sub in subsets
    }


# LIBERO (libero_official.py) — gripper is non-delta dim 6.
register_dataset(
    _suite("libero", ["goal", "10", "spatial", "object", "pi0_all", "oft_all"]),
    prefix="libero",
    meta_data={"non_delta_mask": [6], "periodic_mask": None, "periodic_range": None},
)

# CALVIN (calvin_official.py) — euler angles periodic with range 2*pi.
register_dataset(
    _suite("calvin", ["abc", "abcd", "d"]),
    prefix="calvin",
    meta_data={
        "non_delta_mask": [6],
        "periodic_mask": [3, 4, 5],
        "periodic_range": 6.283185307179586,
    },
)

# ManiSkill2 / SimplerEnv / RoboTwin2 (maniskill2|simpler|robotwin2_official.py)
register_dataset(
    _suite("maniskill2", ["all"]),
    prefix="maniskill2",
    meta_data={"non_delta_mask": [6], "periodic_mask": None, "periodic_range": None},
)
# per-task maniskill names as the reference registers them
# (maniskill2_official.py:5-40: PickCube/StackCube/PickSingleYCB/
# PickSingleEGAD/PickClutterYCB under prefix 'maniskill')
register_dataset(
    _suite(
        "maniskill",
        ["pickcube", "stackcube", "picksingleycb", "picksingleegad", "pickclutterycb"],
    ),
    prefix="maniskill",
    meta_data={"non_delta_mask": [6], "periodic_mask": None, "periodic_range": None},
)
register_dataset(
    _suite("simpler", ["bridge", "fractal", "all"]),
    prefix="simpler",
    meta_data={"non_delta_mask": [6], "periodic_mask": None, "periodic_range": None},
)
register_dataset(
    _suite("robotwin2", ["all"]),
    prefix="robotwin2",
    meta_data={"non_delta_mask": [6, 13], "periodic_mask": None, "periodic_range": None},
)
register_dataset(
    _suite("navila", ["r2r", "rxr"], video_dir="videos"),
    prefix="navila",
    meta_data={"non_delta_mask": None, "periodic_mask": None, "periodic_range": None},
)
