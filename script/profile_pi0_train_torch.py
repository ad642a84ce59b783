"""Where one pi0 training step spends its time on an NVIDIA GPU.

    python script/profile_pi0_train_torch.py [--out DIR]

Builds pi0 at full width and depth (``Pi0Exp``'s defaults: SigLIP so400m/224
+ Gemma-2B + the Gemma-300M expert, seeded random weights, bf16 matrices
and fp32 activations as the Trainer casts them) and runs optimizer steps of
the LIBERO pi0 recipe (micro-batch 4 x accumulation 4, remat, no freeze) on
one synthetic global batch: 3 views of 224x224, 22 real of 48 text tokens, a
state and a 50 x 32 action chunk per row.  After one warm-up step it prints
the CUDA-synchronised wall time of a step (median of 2), then one step under
``torch.profiler``: the device's busy time (the union of the kernels'
intervals), the idle share of the step, and the device time by kind of
kernel (K1, K3, the class map they share, GEMMs, elementwise and reductions,
the rest), then the kernels that take the most device time.  One JSON line
at the end; with ``--out`` it is also written to
``DIR/profile_pi0_train.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dexbotic_tpu_torch.exp.pi0_exp import Pi0Exp  # noqa: E402
from dexbotic_tpu_torch.exp.trainer import Trainer, TrainerConfig  # noqa: E402
from script.profile_pi0_torch import card_line, trace  # noqa: E402

MICRO, ACCUM = 4, 4  # the recipe's per_device_batch_size and gradient_accumulation_steps
# (label, substrings of the kernel names), first match wins
KINDS = [("K1 flash_fwd", ("flash_fwd_kernel",)),
         ("K3 flash_bwd", ("dkv_kernel", "dkv256_kernel", "dkv_sum_kernel", "dq_kernel",
                           "dq256_kernel", "pre_kernel")),
         ("class map of K1/K3", ("tile_class_kernel",)),
         ("GEMMs", ("gemm", "xmma", "cutlass", "cublas", "Kernel2", "splitK")),
         ("elementwise and reductions", ("elementwise", "reduce", "Reduce", "softmax", "norm",
                                         "copy", "cat", "index", "scatter", "gather", "fill"))]


def kind_of(name: str) -> str:
    return next((label for label, keys in KINDS if any(k in name for k in keys)), "other")


def synthetic_batch(cfg, rows: int, seed: int = 0) -> dict:
    """A collated global batch of the recipe's shapes, numpy as the Collator gives."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((rows, 48), np.int64)
    ids[:, :22] = rng.integers(1, 256, (rows, 22))
    return {"input_ids": ids, "attention_mask": ids != 0,
            "images": rng.uniform(-1, 1, (rows, 3, 224, 224, 3)).astype(np.float32),
            "image_masks": np.ones((rows, 3), bool),
            "states": rng.standard_normal((rows, cfg.action_dim)).astype(np.float32),
            "actions": rng.standard_normal((rows, cfg.chunk_size, cfg.action_dim)).astype(np.float32)}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_pi0_train: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="a directory for the JSON result")
    args = ap.parse_args()
    card = card_line()
    print(card, flush=True)
    exp = Pi0Exp(trainer=TrainerConfig(output_dir="unused", max_steps=10, per_device_batch_size=MICRO,
                                       gradient_accumulation_steps=ACCUM,
                                       gradient_checkpointing=True, bf16=True),
                 device="cuda")
    cfg, model, loss_fn = exp.build_model(None)
    trainer = Trainer(loss_fn, model, exp.trainer, exp.optimizer)
    batch = synthetic_batch(cfg, MICRO * ACCUM)

    def step():
        trainer.train_step(batch)
        torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    step()
    walls = []
    for _ in range(2):
        t = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = statistics.median(walls)
    busy, n, by_name = trace(step)
    kinds: dict = {}
    for name, ms in by_name.items():
        kinds[kind_of(name)] = kinds.get(kind_of(name), 0.0) + ms
    res = {"card": card, "micro_batch": MICRO, "accumulation": ACCUM, "step_wall_ms": wall,
           "samples_per_s": MICRO * ACCUM / wall * 1e3, "busy_ms": busy,
           "idle_share": 1 - busy / wall, "kernels": n,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "device_ms_by_kind": kinds}
    print(f"step wall {wall:.1f} ms ({res['samples_per_s']:.3f} samples/s), device busy "
          f"{busy:.1f} ms (idle {1 - busy / wall:.1%}), {n} kernels, peak "
          f"{res['peak_gib']:.2f} GiB", flush=True)
    total = sum(kinds.values())
    for label, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {label}: {ms:.1f} ms ({ms / total:.1%} of kernel time)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    res["top_kernels_ms"] = {k[:120]: v for k, v in top}
    for k, v in top:
        print(f"  {v:9.3f} ms  {k[:110]}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_pi0_train.json"), "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
