"""Dexdata dataset: one .jsonl per episode + index_cache.json.

Format and behavior pinned to /root/reference/dexbotic/data/dataset/
dex_dataset.py: registry lookup by '+'-joined names with frequency
resampling, deterministic seed-42 episode shuffle, index-cache build/check,
frame-level global index, per-item pipeline (action transforms -> image
preprocess -> tokenize), random-retry on errors (opt-out for memory
training, dex_mem_dataset.py:15-22).

Outputs are numpy dicts (no torch); batching/padding happens in the
collator so device shapes stay static.
"""

from __future__ import annotations

import copy
import json
import math
import os
import random
import warnings
from typing import Callable, Optional

import numpy as np

from dexbotic_tpu_torch.data.io import smart_exists, smart_glob, smart_join, smart_open
from dexbotic_tpu_torch.data.registry import CONVERSATION_DATA


def load_jsonl(file_path: str, parse: bool = False):
    with smart_open(file_path, "r") as f:
        lines = [l for l in f.readlines() if l.strip()]
    return [json.loads(l) for l in lines] if parse else lines


class DexDataset:
    default_keys = ["input_ids", "labels", "action", "image"]

    def __init__(
        self,
        dataset_name: str,
        tokenization_func: Callable,
        action_process_func=None,
        image_process_func=None,
        depth_process_func=None,
        num_images: int = 1,
        data_keys: Optional[list[str]] = None,
        images_keys: Optional[list[str]] = None,
        depths_keys: Optional[list[str]] = None,
        load_depth: bool = False,
        retry_on_error: bool = True,
        with_indexes: bool = False,  # DexMemDataset behavior
    ):
        self._build_dataset_from_name(dataset_name)
        self.num_images = num_images
        self.data_keys = data_keys or self.default_keys
        self.images_keys = images_keys
        self.depths_keys = depths_keys
        self.load_depth = load_depth
        self.retry_on_error = retry_on_error
        self.with_indexes = with_indexes

        self.action_process_func = action_process_func
        self.tokenization_func = tokenization_func
        if not isinstance(image_process_func, list):
            image_process_func = [image_process_func] * num_images
        assert len(image_process_func) == num_images
        self.image_process_func = image_process_func
        self.depth_process_func = depth_process_func

    # -- index ------------------------------------------------------------

    def _build_dataset_from_name(self, dataset_names: str):
        self.datasets_info = [CONVERSATION_DATA[n] for n in dataset_names.split("+")]
        self._build_dataset_index()

    def _build_dataset_index(self):
        total = 0
        global_index = []
        file_name_map: dict[str, int] = {}
        dataset_map: dict[str, dict] = {}
        file_id = dataset_id = 0
        for info in self.datasets_info:
            data_path = info["annotations"]
            prefix = info.get("data_path_prefix", "")
            frequency = info["frequency"]
            meta = info.get("meta_data", {})
            if data_path not in dataset_map:
                dataset_map[data_path] = {
                    "id": dataset_id,
                    "meta_data": meta,
                    "data_path_prefix": prefix,
                }
                dataset_id += 1
            ds_idx = dataset_map[data_path]["id"]

            data_index = list(self._get_index_cache(data_path)["data"].items())
            data_index = self._deterministic_shuffle(data_index)

            sampled = []
            f = frequency
            while f > 0:
                if f >= 1:
                    sampled.extend(copy.deepcopy(data_index))
                else:
                    sampled.extend(copy.deepcopy(data_index[: math.ceil(len(data_index) * f)]))
                f -= 1

            for jsonl_file, num_samples in sampled:
                if jsonl_file not in file_name_map:
                    file_name_map[jsonl_file] = file_id
                    file_id += 1
                fi = file_name_map[jsonl_file]
                for frame in range(num_samples):
                    global_index.append((ds_idx, fi, frame))
            total += sum(n for _, n in sampled)

        self.global_index = global_index
        self.file_name_map = {v: k for k, v in file_name_map.items()}
        self.dataset_map = {
            v["id"]: {
                "data_path": k,
                "meta_data": v["meta_data"],
                "data_path_prefix": v["data_path_prefix"],
            }
            for k, v in dataset_map.items()
        }
        self.total_samples = total

    @staticmethod
    def _deterministic_shuffle(data_index):
        data_index.sort(key=lambda x: x[0])
        random.Random(42).shuffle(data_index)
        return data_index

    def _get_index_cache(self, data_path):
        cache_file = smart_join(data_path, "index_cache.json")
        if smart_exists(cache_file):
            with smart_open(cache_file) as f:
                cache = json.load(f)
            if self._check_index_cache(data_path, cache):
                return cache
        return self._build_index_cache(data_path)

    @staticmethod
    def _glob_jsonl(data_path):
        return smart_glob(smart_join(data_path, "**", "*.jsonl"), recursive=True)

    def _build_index_cache(self, data_path):
        files = self._glob_jsonl(data_path)
        cache = {
            "meta_data": {"total_samples": 0, "total_jsonl_files": len(files)},
            "data": {},
        }
        for f in files:
            n = len(load_jsonl(f))
            cache["data"][f] = n
            cache["meta_data"]["total_samples"] += n
        try:
            with smart_open(smart_join(data_path, "index_cache.json"), "w") as f:
                json.dump(cache, f, indent=2)
        except OSError:
            warnings.warn(f"could not write index cache in {data_path}")
        return cache

    def _check_index_cache(self, data_path, cache):
        return len(self._glob_jsonl(data_path)) == cache["meta_data"]["total_jsonl_files"]

    # -- items ------------------------------------------------------------

    def __len__(self):
        return self.total_samples

    def unsafe_getitem(self, idx) -> dict:
        ds_idx, file_idx, frame_idx = self.global_index[idx]
        jsonl_file = self.file_name_map[file_idx]
        info = self.dataset_map[ds_idx]
        episode = load_jsonl(jsonl_file, parse=True)

        shift = getattr(self.action_process_func, "predict_length", 0)
        if frame_idx >= len(episode) - shift:
            if not self.retry_on_error:
                raise IndexError(
                    f"frame {frame_idx} out of range for {jsonl_file} (mem mode)"
                )
            frame_idx = random.randint(0, len(episode) - shift - 1)

        meta = dict(info["meta_data"])
        meta.update(
            frame_indices=[frame_idx],
            jsonl_file=jsonl_file,
            dataset=info["data_path"],
            num_images=self.num_images,
            images_keys=self.images_keys,
            depths_keys=self.depths_keys,
            load_depth=self.load_depth,
            data_path_prefix=info["data_path_prefix"],
        )

        data = self.action_process_func(episode, meta_data=meta)
        if isinstance(data, list):
            data = data[frame_idx]
        data["meta_data"] = meta
        out: dict = {}

        rgb = data.pop("rgb_data", [])
        if len(rgb) < self.num_images:
            rgb = rgb + [None] * (self.num_images - len(rgb))
        pixels = [fn(img) for fn, img in zip(self.image_process_func, rgb)]
        out["image"] = pixels[0] if len(pixels) == 1 else np.stack(pixels, axis=0)

        if self.load_depth and self.depth_process_func is not None:
            depth = data.pop("depth_data", [])
            if len(depth) < self.num_images:
                depth = depth + [None] * (self.num_images - len(depth))
            dv = [self.depth_process_func(d) for d in depth]
            out["depth"] = dv[0] if len(dv) == 1 else np.stack(dv, axis=0)

        if "conversations" not in data:
            data["conversations"] = [
                {"from": "human", "value": data.pop("prompt", "")},
                {"from": "gpt", "value": data.pop("answer", "")},
            ]
        tok = self.tokenization_func(conversations=data["conversations"], has_image=True)
        out["input_ids"] = tok["input_ids"]
        out["labels"] = tok["labels"]

        for k in self.data_keys:
            if k not in out:
                assert k in data, f"{k} missing from {jsonl_file}"
                out[k] = data[k]
        if self.with_indexes:
            out["indexes"] = np.array([ds_idx, file_idx, frame_idx])
        return out

    def __getitem__(self, idx) -> dict:
        if not self.retry_on_error:
            return self.unsafe_getitem(idx)
        try:
            return self.unsafe_getitem(idx)
        except Exception:
            return self.unsafe_getitem(random.randint(0, len(self) - 1))
