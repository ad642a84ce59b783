"""chip_smoke phase 10a's GRPO micro-step taken apart, at given decoder
depths, on an H100: which part of the step puts the kernel path's metrics
further from the fp32 witness than 10a's rule allows.

    python script/witness_rl_step_torch.py [--layers 2 4] [--out DIR]

At each depth, chip_smoke's seeded actor (``rl_exp``: the LIBERO
SimpleVLA-RL twin, fp32 weights) and its rollout batch of 8 mock envs
(``rl_rollout_batch``) go through one micro-step (``rl_micro_step``: the
metrics, the gradients' global norm, the watched groups' gradients) on
these paths:

* ``fp32_witness``: the plain attention in fp32;
* ``plain``: K1's and K3's plain versions on q, k, v rounded to bf16
  (``decoder_plain_on_bf16``);
* ``kernel_policy_loss``: K1 and K3, through ``rl_policy_loss`` as the
  paths above;
* ``kernel_updater``: K1 and K3 through ``GRPOUpdater.grads`` (remat on),
  the path 10a holds, its norm from ``GRPOUpdater.apply`` as 10a reads it;
* ``bf16_matrices``: a bf16 copy made by ``nn/core.cast_matrices_`` (10a's
  margin: the Trainer's rule, which keeps a stacked layer's norm scales and
  biases fp32);
* ``bf16_served``: a bf16 copy made by ``nn/core.cast_served_`` (JAX's
  rule on its tree, which casts them too).

Each path's distance from the witness (loss abs, entropy and grad_norm rel,
1 - the worst watched gradient cosine), then 10a's rule (``hold_step``)
with each kernel path against each bf16 copy.  K1 and K3 alone: every K3
launch of the ``kernel_updater`` step is held against the plain versions
on its own inputs, K1's saved output against ``flash_attention_ref`` on the
same q, k, v and K3's dq, dk, dv against ``flash_attention_bwd_ref`` on the
same q, k, v, output, LSE and dO: per launch the largest error over the
largest |plain| value of each tensor.  Prints one JSON line last; ``--out
DIR`` also writes it to ``DIR/witness_rl_step.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

SCALARS = {"loss": "abs", "entropy": "rel", "grad_norm": "rel"}


@contextlib.contextmanager
def kernels_alone(rows: list):
    """Each K3 launch while inside, with K1's output it was given, held
    against their plain versions on the same inputs (a row a launch)."""
    from dexbotic_tpu_torch.ops import attention as attn

    launch = attn._flash_bwd_cuda

    def rel(a, b) -> float:
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def held(q, k, v, q_grp, kv_grp, kv_valid, out, lse, g, scale, q_seg, kv_seg):
        dq, dk, dv = launch(q, k, v, q_grp, kv_grp, kv_valid, out, lse, g, scale, q_seg, kv_seg)
        with torch.no_grad():
            o_ref, _ = attn.flash_attention_ref(q, k, v, q_grp, kv_grp, kv_valid, scale, q_seg,
                                                kv_seg)
            rq, rk, rv = attn.flash_attention_bwd_ref(q, k, v, q_grp, kv_grp, kv_valid, out, lse,
                                                      g, scale, q_seg, kv_seg)
            rows.append({"shape": list(q.shape), "k1_out": rel(out, o_ref), "k3_dq": rel(dq, rq),
                         "k3_dk": rel(dk, rk), "k3_dv": rel(dv, rv)})
        return dq, dk, dv

    attn._flash_bwd_cuda = held
    try:
        yield rows
    finally:
        attn._flash_bwd_cuda = launch


def distance(path: tuple, ref: tuple) -> dict:
    """A path's (metrics, gradients) from the witness's, as hold_step reads them."""
    (w, g), (w32, g32) = path, ref
    out = {}
    for k, how in SCALARS.items():
        d = abs(w[k] - w32[k])
        out[f"{k}_{how}"] = d if how == "abs" else d / abs(w32[k])
    out["grad_1_minus_cosine"] = 1 - min(cs._cosine(g[k], g32[k]) for k in g32)
    return out


def at_depth(layers: int) -> dict:
    from dexbotic_tpu_torch.exp.rl.rl_trainer import GRPOUpdater
    from dexbotic_tpu_torch.nn.core import cast_matrices_, cast_served_

    cs.free_memory()
    exp = cs.rl_exp(layers)
    cfg = exp.model.build_config()
    model = exp.model.build_params(cfg, "cuda")
    mb = cs.rl_rollout_batch(exp, cfg, model, exp.tokenizer.build_tokenizer())
    watched, plain = cs.rl_watched(cfg), cs.plain_config(cfg)
    paths = {"fp32_witness": cs.rl_micro_step(model, plain, exp, mb, watched)}
    with cs.decoder_plain_on_bf16():
        paths["plain"] = cs.rl_micro_step(model, plain, exp, mb, watched)
    paths["kernel_policy_loss"] = cs.rl_micro_step(model, cfg, exp, mb, watched)
    for name, cast in (("bf16_matrices", cast_matrices_), ("bf16_served", cast_served_)):
        bf = cs.rl_bf16_copy(model, plain, cast)
        paths[name] = cs.rl_micro_step(bf, plain, exp, mb, watched)
        del bf
        cs.free_memory()
    updater = GRPOUpdater(cfg, exp.grpo, model, learning_rate=exp.rl_learning_rate,
                          temperature=exp.rollout.temperature)
    with kernels_alone([]) as alone:
        metrics, grads = updater.grads(model, mb)
    wk = {k: float(v) for k, v in metrics.items()}
    gk = cs.rl_watched_grads(grads.items(), watched)
    wk["grad_norm"] = float(updater.apply(model, grads))
    paths["kernel_updater"] = (wk, gk)
    ref = paths["fp32_witness"]
    rules = {}
    for kernel in ("kernel_updater", "kernel_policy_loss"):
        for bf in ("bf16_matrices", "bf16_served"):
            checks: list = []
            _, bounds = cs.hold_step(f"{layers} layers, {kernel} with {bf}",
                                     {"kernel": paths[kernel], "plain": paths["plain"],
                                      "bf16_matrices": paths[bf]}, ref, SCALARS, checks)
            rules[f"{kernel} with {bf}"] = {"holds": all(ok for ok, _ in checks),
                                            "bounds": bounds,
                                            "failed": [m for ok, m in checks if not ok]}
    out = {"layers": layers,
           "metrics": {p: {k: w[k] for k in ("loss", "pg_loss", "entropy", "grad_norm")}
                       for p, (w, _) in paths.items()},
           "vs_fp32": {p: distance(v, ref) for p, v in paths.items() if p != "fp32_witness"},
           "rule": rules,
           "kernels_alone": alone,
           "kernels_alone_max": {k: max(r[k] for r in alone) for k in
                                 ("k1_out", "k3_dq", "k3_dk", "k3_dv")} if alone else None}
    del model, updater, grads, mb, paths
    cs.free_memory()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("witness_rl_step_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    result = {"card": cs.card_line(), "depths": [at_depth(n) for n in args.layers]}
    line = json.dumps(result, default=float)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "witness_rl_step.json"), "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
