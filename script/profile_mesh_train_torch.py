"""What the mesh path adds to a CogACT-7B training step on one NVIDIA GPU.

    python script/profile_mesh_train_torch.py [--out DIR]

Builds CogACT-7B on the LIBERO recipe as chip_smoke's phase 7 does
(LLaMA-2-7B + CLIP-L/336 + DiT-B, seeded random weights, bf16 matrices,
``freeze_llm`` and ``freeze_mm_vision``, micro-batch 8 x accumulation 2,
remat) and runs optimizer steps on one synthetic global batch of the
recipe's rows (1304 valid of 2048 tokens, one 336x336 frame) twice: on the
one-device path, then on the mesh path (``parallel/``: a process group of
one over NCCL, a 1 x 1 mesh, where the FSDP rule replicates every leaf),
one model at a time.  For each: the
CUDA-synchronised wall time of a step (median of 2 after a warm-up), the
peak memory, then one step under ``torch.profiler``: the device's busy
time, the idle share, and the device time by kind of kernel (K1, K3,
GEMMs, NCCL, FSDP2's copies, elementwise, the rest) and the kernels that
take the most.  One JSON line at the end; with ``--out`` it is also written
to ``DIR/profile_mesh_train.json``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import socket
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dexbotic_tpu_torch.constants import IMAGE_TOKEN_INDEX  # noqa: E402
from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig  # noqa: E402
from dexbotic_tpu_torch.exp.optim import OptimizerConfig  # noqa: E402
from dexbotic_tpu_torch.exp.trainer import Trainer, TrainerConfig  # noqa: E402
from dexbotic_tpu_torch.parallel import multihost  # noqa: E402
from script.profile_pi0_torch import card_line, trace  # noqa: E402

MICRO, ACCUM, SEQ, VALID = 8, 2, 2048, 1304  # the recipe's rows (phase 7's samples)
# (label, substrings of the kernel names), first match wins
KINDS = [("K1 flash_fwd", ("flash_fwd_kernel",)),
         ("K3 flash_bwd", ("dkv_kernel", "dkv256_kernel", "dkv_sum_kernel", "dq_kernel",
                           "dq256_kernel", "pre_kernel")),
         ("class map of K1/K3", ("tile_class_kernel",)),
         ("NCCL", ("nccl",)),
         ("FSDP2 copies (gather out, reduce-scatter in)", ("split_with_sizes", "chunk_cat",
                                                          "foreach_copy", "all_gather_copy")),
         ("GEMMs", ("gemm", "xmma", "cutlass", "cublas", "Kernel2", "splitK")),
         ("elementwise and reductions", ("elementwise", "reduce", "Reduce", "softmax", "norm",
                                         "copy", "cat", "index", "scatter", "gather", "fill"))]


def kind_of(name: str) -> str:
    return next((label for label, keys in KINDS if any(k in name for k in keys)), "other")


def make_exp() -> CogActExp:
    return CogActExp(
        model=CogActModelConfig(),
        trainer=TrainerConfig(output_dir="unused", max_steps=10, per_device_batch_size=MICRO,
                              gradient_accumulation_steps=ACCUM, bf16=True,
                              gradient_checkpointing=True, resume=False),
        optimizer=OptimizerConfig(learning_rate=2e-5, freeze_llm=True, freeze_mm_vision=True),
        device="cuda")


def synthetic_batch(cfg, rows: int, seed: int = 0) -> dict:
    """A collated global batch of the recipe's shapes, numpy as the Collator gives."""
    rng = np.random.default_rng(seed)
    nt = cfg.vlm.num_image_tokens
    ids = np.zeros((rows, SEQ), np.int64)
    ids[:, 0] = 1
    ids[:, 1: 1 + nt] = IMAGE_TOKEN_INDEX
    ids[:, 1 + nt: VALID] = rng.integers(3, cfg.vlm.llm.vocab_size, (rows, VALID - 1 - nt))
    size = cfg.vlm.vit.image_size
    return {"input_ids": ids, "attention_mask": ids != 0,
            "images": rng.uniform(-1, 1, (rows, 1, size, size, 3)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (rows, cfg.chunk_size, cfg.action_dim))
            .astype(np.float32)}


def measure(label: str) -> dict:
    """Steps of one path; a process group of one is up for 'mesh'."""
    exp = make_exp()
    cfg, model, loss_fn = exp.build_model(exp.tokenizer.build_tokenizer())
    trainer = Trainer(loss_fn, model, exp.trainer, exp.optimizer)
    if (trainer.mesh is not None) != (label == "mesh"):
        raise RuntimeError(f"{label}: the Trainer took the other path")
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
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    busy, n, by_name = trace(step)
    kinds: dict = {}
    for name, ms in by_name.items():
        kinds[kind_of(name)] = kinds.get(kind_of(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    res = {"step_wall_ms": wall, "walls_ms": walls, "peak_gib": peak, "busy_ms": busy,
           "idle_share": 1 - busy / wall, "kernels": n, "device_ms_by_kind": kinds,
           "top_kernels_ms": {k[:120]: v for k, v in top}}
    print(f"{label}: step wall {wall:.1f} ms, device busy {busy:.1f} ms (idle "
          f"{1 - busy / wall:.1%}), {n} kernels, peak {peak:.2f} GiB", flush=True)
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {kind}: {ms:.1f} ms")
    for k, v in top:
        print(f"  {v:9.3f} ms  {k[:110]}")
    del trainer, model, loss_fn
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_mesh_train: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="a directory for the JSON result")
    args = ap.parse_args()
    card = card_line()
    print(card, flush=True)
    res = {"card": card, "micro_batch": MICRO, "accumulation": ACCUM, "rows": f"{VALID} of {SEQ}",
           "plain": measure("plain")}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    multihost.maybe_initialize(f"localhost:{port}", 1, 0)
    try:
        res["mesh"] = measure("mesh")
    finally:
        multihost.shutdown()
    res["mesh_minus_plain_ms"] = res["mesh"]["step_wall_ms"] - res["plain"]["step_wall_ms"]
    print(f"the mesh path adds {res['mesh_minus_plain_ms']:.1f} ms a step", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_mesh_train.json"), "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
