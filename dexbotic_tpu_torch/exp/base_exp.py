"""Experiment layer (port of dexbotic_tpu/exp/base_exp.py).

Layered dataclass configs that users subclass and override, and
``python -m <exp module> --task {train,inference,inference_single,
compute_norm_stats}`` dispatch (``train`` by default).  The data pipeline,
tokenization and norm statistics are the port's copies of the JAX package's
(``data/``, ``tokenization/``).  Serving may quantize the weights to int8
(``inference_quantize``).  Training fetches its batches in line, or with
``num_workers > 0`` through ``data/loader.py``'s workers (``worker_mode``
'thread' or 'process') and a device prefetch.  ``train()`` joins a process
group when one is configured (``parallel/multihost``: torchrun's or the
DEXBOTIC_* variables) and feeds each data rank its contiguous rows of every
global batch (``per_device_batch_size`` x data ranks x accumulation rows).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from dexbotic_tpu_torch.data import normalize
from dexbotic_tpu_torch.data import transforms as T
from dexbotic_tpu_torch.data.collator import Collator
from dexbotic_tpu_torch.data.dexdata import DexDataset
from dexbotic_tpu_torch.data.loader import DataLoader, device_prefetch
from dexbotic_tpu_torch.data.image_processing import (
    DummyRGBProcessor,
    ImageProcessorConfig,
    PixelAug,
    PreprocessRGB,
)
from dexbotic_tpu_torch.data.multimodal import LoadMultiModal
from dexbotic_tpu_torch.data.transforms import DEFAULT_PROMPT_TEMPLATE
from dexbotic_tpu_torch.tokenization.tokenize import DummyTokenization, LLMTokenization, SimpleTokenizer
from dexbotic_tpu_torch.exp.optim import OptimizerConfig
from dexbotic_tpu_torch.exp.trainer import Trainer, TrainerConfig, load_checkpoint_params
from dexbotic_tpu_torch.nn.core import cast_matrices_
from dexbotic_tpu_torch.ops import quant_matmul
from dexbotic_tpu_torch.ops.quant import quantize_model_
from dexbotic_tpu_torch.parallel import multihost
from dexbotic_tpu_torch.utils.convert import is_release_checkpoint, load_release_checkpoint

NORM_STATS_POLL_S = 2.0  # how often a non-primary process looks for the primary's norm stats


@dataclass
class Config:
    pass


@dataclass
class TokenizerConfig(Config):
    tokenizer_path: Optional[str] = None  # local HF tokenizer dir, else SimpleTokenizer
    model_max_length: int = 2048
    chat_template: str = "dexbotic"

    def build_tokenizer(self):
        if self.tokenizer_path:
            sp_path = self.tokenizer_path
            if os.path.isdir(sp_path):
                cand = os.path.join(sp_path, "tokenizer.model")
                has_hf = any(os.path.exists(os.path.join(sp_path, f))
                             for f in ("tokenizer.json", "tokenizer_config.json"))
                sp_path = cand if (os.path.exists(cand) and not has_hf) else None
            elif not sp_path.endswith(".model"):
                sp_path = None
            if sp_path:
                from dexbotic_tpu_torch.tokenization.spm import SpmTokenizer

                return SpmTokenizer(sp_path, model_max_length=self.model_max_length)
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(self.tokenizer_path, use_fast=True)
            tok.model_max_length = self.model_max_length
            if tok.pad_token_id is None:
                tok.pad_token = tok.eos_token
            return tok
        tok = SimpleTokenizer(model_max_length=self.model_max_length)
        # register the chat template's <|...|> markers as single special tokens
        import re

        from dexbotic_tpu_torch.tokenization import conversation as conversation_lib

        conv = conversation_lib.conv_templates.get(self.chat_template)
        if conv is not None:
            marks: set = set()
            for s in (conv.system, conv.sep, getattr(conv, "sep2", None) or "", *conv.roles):
                marks.update(re.findall(r"<\|[^|>]+\|>", s or ""))
            if marks:
                tok.add_special_tokens(sorted(marks))
        return tok


@dataclass
class ActionConfig(Config):
    statistic_mapping: Optional[str] = None  # path to norm_stats.json
    replace_with_default_answer: str = " "
    trajectory_length: int = 16
    delta: bool = True
    trajectory_padding_mode: str = "zero"
    padding_action: bool = False
    vocab_size: int = 255
    string_format: str = " {value}"
    prompt_template: Union[str, Callable] = DEFAULT_PROMPT_TEMPLATE
    load_multimodal_masks: bool = False

    def _read_norm_stats(self, path):
        if not (path and os.path.exists(path)):
            raise FileNotFoundError(f"norm stats not found: {path}")
        with open(path) as f:
            return T.ToNumpy()(json.load(f)["norm_stats"])

    def build_action_process_func(self) -> T.Pipeline:
        stats = self._read_norm_stats(self.statistic_mapping)
        return T.Pipeline([
            T.ToDict(),
            T.ToNumpy(),
            T.AddAction(predict_length=1),
            T.DeltaAction(enable=self.delta),
            T.AddTrajectory(trajectory_length=self.trajectory_length,
                            padding_mode=self.trajectory_padding_mode,
                            padding_action=self.padding_action),
            T.ActionNormAnd2String(statistic_mapping=stats, vocab_size=self.vocab_size,
                                   string_format=self.string_format),
            LoadMultiModal(return_masks=self.load_multimodal_masks),
            T.AddPromptTemplate(prompt_template=self.prompt_template),
            T.ReplaceAnswer(default_answer=self.replace_with_default_answer),
            T.ToList(),
        ])


@dataclass
class ComputeNormActionConfig(ActionConfig):
    norm_method: str = "default"  # 'default' (q01/q99) | 'minmax'
    norm_save_path: str = field(default_factory=lambda: os.path.join(
        "norm_assets", time.strftime("%m%d-%H%M") + "-default"))
    max_batches: int = 500
    batch_size: int = 128

    def build_action_process_func(self) -> T.Pipeline:
        return T.Pipeline([T.ToDict(), T.ToNumpy(), T.AddAction(predict_length=1),
                           T.DeltaAction(enable=self.delta), T.ToList()])

    def compute_norm_stats(self, dataset_name: str) -> str:
        """Stream samples through RunningStats; write the merged q01/q99
        envelope norm_stats.json; returns its path."""
        fn = self.build_action_process_func()
        norm_files = {}
        for name in dataset_name.split("+"):
            if name.startswith("general"):
                continue
            ds = DexDataset(dataset_name=name, tokenization_func=DummyTokenization(),
                            action_process_func=fn, image_process_func=DummyRGBProcessor(),
                            data_keys=["action"])
            stats = normalize.RunningStats()
            n = min(len(ds), self.max_batches * self.batch_size)
            buf = []
            for i in random.Random(0).sample(range(len(ds)), n):
                buf.append(np.asarray(ds[i]["action"], np.float64).reshape(-1))
                if len(buf) == self.batch_size:
                    stats.update(np.stack(buf))
                    buf = []
            if buf:
                stats.update(np.stack(buf))
            save_dir = os.path.join(self.norm_save_path, name)
            normalize.save(save_dir, {"action": stats.get_statistics()})
            norm_files[name] = os.path.join(save_dir, "norm_stats.json")

        lo_list, hi_list = [], []
        for f in norm_files.values():
            with open(f) as fh:
                st = json.load(fh)["norm_stats"]["action"]
            lo, hi = ("q01", "q99") if self.norm_method == "default" else ("min", "max")
            lo_list.append(st[lo])
            hi_list.append(st[hi])
        merged = {"default": {"min": np.array(lo_list).min(0).tolist(),
                              "max": np.array(hi_list).max(0).tolist()}}
        out = os.path.join(self.norm_save_path, "norm_stats.json")
        os.makedirs(self.norm_save_path, exist_ok=True)
        with open(out, "w") as fh:
            json.dump({"norm_stats": merged}, fh, indent=2)
        return out


@dataclass
class DataConfig(Config):
    dataset_name: Optional[str] = None
    num_images: int = 1
    aug_policy: Union[str, list, None] = "identity"
    image_aspect_ratio: Optional[str] = "pad"
    image_pad_mode: str = "mean"
    image_processor: str = "siglip_224"  # key into _PROCESSORS or size int
    data_keys: list = field(default_factory=lambda: ["input_ids", "labels", "action", "image"])
    images_keys: Optional[list] = None
    shuffle: bool = True  # the order is seeded by TrainerConfig.seed, as in JAX
    # host decode (data/loader.py): 0 fetches in line; > 0 runs that many
    # workers, 'thread' or 'process' (forked), and prefetches onto the device
    num_workers: int = 0
    worker_mode: str = "thread"

    _PROCESSORS = {
        "clip_336": ImageProcessorConfig.clip_336(),
        "siglip_384": ImageProcessorConfig.siglip(384),
        "siglip_224": ImageProcessorConfig.siglip(224),
    }

    def build_image_processor(self) -> ImageProcessorConfig:
        if isinstance(self.image_processor, ImageProcessorConfig):
            return self.image_processor
        if isinstance(self.image_processor, str) and self.image_processor in self._PROCESSORS:
            return self._PROCESSORS[self.image_processor]
        return ImageProcessorConfig(size=int(self.image_processor))

    def build_data(self, tokenization_func, action_process_func) -> DexDataset:
        proc = self.build_image_processor()
        policies = (self.aug_policy if isinstance(self.aug_policy, list)
                    else [self.aug_policy] * self.num_images)
        img_fns = [PreprocessRGB(proc, image_aspect_ratio=self.image_aspect_ratio,
                                 augmentations=PixelAug(p) if p else None,
                                 image_pad_mode=self.image_pad_mode) for p in policies]
        return DexDataset(dataset_name=self.dataset_name, tokenization_func=tokenization_func,
                          action_process_func=action_process_func, image_process_func=img_fns,
                          num_images=self.num_images, data_keys=self.data_keys,
                          images_keys=self.images_keys)


@torch.no_grad()
def fill_weights_(model: nn.Module, path: Optional[str], convert_fn: Callable, cfg) -> nn.Module:
    """Fill a built model from ``path``, if set: a released checkpoint is
    converted by ``convert_fn`` (the model then holds its load and convert
    seconds in ``checkpoint_times``), a port ``checkpoint-{step}`` directory
    is copied in by parameter name."""
    if path and is_release_checkpoint(path):
        model.checkpoint_times = load_release_checkpoint(model, path, convert_fn, cfg)
    elif path:
        saved = load_checkpoint_params(path)
        params = dict(model.named_parameters())
        missing = sorted(set(params) - set(saved))
        if missing:
            raise KeyError(f"{path} lacks parameters {missing[:5]}")
        for name, p in params.items():
            p.copy_(saved[name].to(p.dtype))
    return model


def data_iterator(dataset, collator, batch_size: int, seed: int = 42, epochs: int = 10 ** 6,
                  shuffle: bool = True, process_id: int = 0, process_count: int = 1):
    """Epoch iterator yielding collated numpy batches, each epoch in a fresh
    seeded order (``shuffle``) or in the dataset's order.  ``batch_size`` is
    the global batch; with ``process_count`` > 1 each process collates its
    own contiguous slice of every global batch (the same order everywhere,
    disjoint rows)."""
    if batch_size % process_count:
        raise ValueError(f"batch_size {batch_size} not divisible by {process_count} processes")
    n = len(dataset)
    rng = random.Random(seed)
    local = batch_size // process_count
    lo, hi = process_id * local, (process_id + 1) * local
    for _ in range(epochs):
        order = list(range(n))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, n - batch_size + 1, batch_size):
            yield collator([dataset[j] for j in order[i + lo: i + hi]])


@dataclass
class BaseExp:
    """Compose the config blocks; subclass + override per policy."""

    exp_name: str = "base_exp"
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    tokenizer: TokenizerConfig = field(default_factory=TokenizerConfig)
    action: ActionConfig = field(default_factory=ActionConfig)
    data: DataConfig = field(default_factory=DataConfig)
    # "" = bf16 serving; "int8" = weight-only int8 (ops/quant.py), K4 at few
    # rows; "w8a8" = also int8 activations for matmuls of >= 2048 rows
    inference_quantize: str = ""
    inference_quantize_min_size: int = 1 << 16  # skip weights smaller than this
    # >1 coalesces concurrent single-frame requests into one device call
    serve_micro_batch: int = 0
    device: str = "cuda"

    def prepare_inference_params(self, model: nn.Module) -> nn.Module:
        """Serving dtype policy: fp32 tensors with ndim >= 2 -> bf16, 1-D stay fp32.

        Applied to the module while it is laid out on the meta device, before
        its weights are materialised (quantization needs the values: see
        :meth:`quantize_inference_model`)."""
        if self.inference_quantize not in ("", "int8", "w8a8"):
            raise ValueError(f"unknown inference_quantize={self.inference_quantize!r}")
        return cast_matrices_(model, torch.bfloat16)

    def quantize_inference_model(self, model: nn.Module) -> nn.Module:
        """Optional weight-only int8 quantization of the materialised serving
        model, in place (``ops/quant.quantize_model_``); "w8a8" additionally
        turns on int8 activations for matmuls of >= 2048 rows, as JAX does."""
        if self.inference_quantize:
            quantize_model_(model, min_size=self.inference_quantize_min_size)
            if self.inference_quantize == "w8a8":
                quant_matmul.W8A8_MIN_ROWS = 2048
        return model

    def load_for_inference(self):
        """(config, model in the serving dtype on ``device``, norm stats or None).

        With ``inference_quantize`` the model is quantized once its weights
        hold their values (initialised, then filled from the checkpoint)."""
        cfg = self.model.build_config()
        model = self.model.build_params(cfg, self.device, prepare=self.prepare_inference_params)
        self.quantize_inference_model(model)
        return cfg, model, self.served_norm_stats()

    def served_norm_stats(self):
        """The checkpoint's ``norm_stats.json`` statistics ({min, max}) or None."""
        path = os.path.join(self.model.model_name_or_path or "", "norm_stats.json")
        if not (self.model.model_name_or_path and os.path.exists(path)):
            return None
        with open(path) as f:
            return json.load(f)["norm_stats"]["default"]

    # ---- hooks each policy exp implements --------------------------------

    def build_model(self, tokenizer):  # -> (config, model, loss_fn)
        raise NotImplementedError

    def build_tokenization(self, tokenizer):
        return LLMTokenization(tokenizer, chat_template=self.tokenizer.chat_template,
                               num_image_tokens=self.num_image_tokens())

    def num_image_tokens(self) -> int:
        return 1

    # ---- norm stats ------------------------------------------------------

    def _auto_compute_norm_stats(self, poll_timeout_s: float = 1800.0) -> None:
        """Compute (or reuse the cached) norm stats keyed by the dataset name's
        md5.  Across processes the primary alone computes and writes them;
        the others poll for the finished file, up to ``poll_timeout_s``."""
        if self.action.statistic_mapping and os.path.exists(self.action.statistic_mapping):
            return
        key = hashlib.md5(self.data.dataset_name.encode()).hexdigest()[:16]
        cache_dir = os.path.join("norm_assets", f"auto-{key}")
        out = os.path.join(cache_dir, "norm_stats.json")
        if not os.path.exists(out):
            if multihost.is_primary():
                ComputeNormActionConfig(delta=self.action.delta, norm_save_path=cache_dir
                                        ).compute_norm_stats(self.data.dataset_name)
            else:
                t0 = time.time()
                while not os.path.exists(out):
                    if time.time() - t0 > poll_timeout_s:
                        raise TimeoutError(f"norm stats {out} not produced by the primary")
                    time.sleep(NORM_STATS_POLL_S)
        self.action.statistic_mapping = out

    # ---- tasks -----------------------------------------------------------

    def train(self) -> dict:
        multihost.maybe_initialize(device=self.device)  # a no-op unless a launch configures one
        self._auto_compute_norm_stats()
        tokenizer = self.tokenizer.build_tokenizer()
        _, model, loss_fn = self.build_model(tokenizer)
        dataset = self.data.build_data(self.build_tokenization(tokenizer),
                                       self.action.build_action_process_func())
        collator = Collator(pad_token_id=tokenizer.pad_token_id,
                            max_length=self.tokenizer.model_max_length)
        with open(self.action.statistic_mapping) as f:
            norm_stats_json = f.read()
        trainer = Trainer(loss_fn, model, self.trainer, self.optimizer,
                          norm_stats_json=norm_stats_json)
        # per-step global batch = micro-batch x data ranks x accumulation
        batch_size = (self.trainer.per_device_batch_size * trainer.data_size
                      * self.trainer.gradient_accumulation_steps)
        shard = dict(process_id=trainer.data_rank, process_count=trainer.data_size)
        if self.data.num_workers > 0:
            batches = device_prefetch(iter(DataLoader(
                dataset, collator, batch_size, shuffle=self.data.shuffle,
                num_workers=self.data.num_workers, worker_mode=self.data.worker_mode,
                seed=self.trainer.seed, **shard)), trainer.device)
        else:
            batches = data_iterator(dataset, collator, batch_size, seed=self.trainer.seed,
                                    shuffle=self.data.shuffle, **shard)
        try:
            return trainer.train(batches)
        finally:
            batches.close()  # a process-mode loader stops its workers
            trainer.close()

    def compute_norm_stats(self) -> str:
        return ComputeNormActionConfig(delta=self.action.delta).compute_norm_stats(
            self.data.dataset_name)

    def inference(self):
        raise NotImplementedError("policy exp must implement inference()")

    def inference_single(self):
        raise NotImplementedError("policy exp must implement inference_single()")

    @classmethod
    def main(cls, **overrides):
        parser = argparse.ArgumentParser()
        parser.add_argument("--task", default="train",
                            choices=["train", "inference", "inference_single",
                                     "compute_norm_stats"])
        args, _ = parser.parse_known_args()
        exp = cls(**overrides)
        return getattr(exp, args.task)()
