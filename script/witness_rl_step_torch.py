"""chip_smoke phase 10a's GRPO micro-step taken apart, at given decoder
depths, on an H100: each path's distance from the fp32 witness under two
rules for the old log-probs, and 10a's rule under each.

    python script/witness_rl_step_torch.py [--layers 2 4] [--out DIR]

At each depth, chip_smoke's seeded actor (``rl_exp``: the LIBERO
SimpleVLA-RL twin, fp32 weights) and its rollout batch of 8 mock envs
(``rl_rollout_batch``, drawn on the kernel path) go through one micro-step
(``rl_micro_step``: the metrics, the gradients' global norm, the watched
groups' gradients) on these paths:

* ``fp32_witness``: the plain attention in fp32;
* ``plain``: K1's and K3's plain versions on q, k, v rounded to bf16
  (``decoder_plain_on_bf16``);
* ``kernel_policy_loss``: K1 and K3, through ``rl_policy_loss`` as the
  paths above;
* ``kernel_updater``: K1 and K3 through ``GRPOUpdater.grads`` (remat on),
  the path 10a holds (no update is applied);
* ``bf16``: a copy under the Trainer's bf16 rule (``trainer_rule_copy``,
  ``nn/core.cast_like_jax_``), 10a's margin.

The old log-probs are either the rollout's (``rollout``: the kernel path's,
so its ratio is exactly 1 and every other path's pg_loss is its log-prob gap
from the kernel path) or each path's own (``own``: recomputed on the path by
``rl_own_old_logp``, 10a's rule).  Each path's distance from the witness
(loss abs, entropy and grad_norm rel, 1 - the worst watched gradient
cosine), then 10a's rule (``hold_step``) with each kernel path, under each
rule.  K1 and K3 alone: every K3 launch of the ``kernel_updater`` step (own
log-probs) is held against the plain versions on its own inputs, K1's saved
output against ``flash_attention_ref`` on the same q, k, v and K3's dq, dk,
dv against ``flash_attention_bwd_ref`` on the same q, k, v, output, LSE and
dO: per launch the largest error over the largest |plain| value of each
tensor.  Prints one JSON line last; ``--out DIR`` also writes it to
``DIR/witness_rl_step.json``.
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
    from dexbotic_tpu_torch.exp.optim import global_norm
    from dexbotic_tpu_torch.exp.rl.rl_trainer import GRPOUpdater
    from dexbotic_tpu_torch.models.oft import build_oft

    cs.free_memory()
    exp = cs.rl_exp(layers)
    cfg = exp.model.build_config()
    model = exp.model.build_params(cfg, "cuda")
    mb = cs.rl_rollout_batch(exp, cfg, model, exp.tokenizer.build_tokenizer())
    watched, plain = cs.rl_watched(cfg), cs.plain_config(cfg)
    bf, reading = cs.trainer_rule_copy(build_oft, plain, model, f"{layers} layers' bf16 copy")
    updater = GRPOUpdater(cfg, exp.grpo, model, learning_rate=exp.rl_learning_rate,
                          temperature=exp.rollout.temperature)
    out = {"layers": layers, "bf16_rule": reading, "old_logp_gap": {}}
    alone: list = []
    for old in ("rollout", "own"):
        def step(m, c, label, updater_path=False):
            b = mb
            if old == "own":
                b, out["old_logp_gap"][label] = cs.rl_own_old_logp(m, c, exp, mb)
            if not updater_path:
                return cs.rl_micro_step(m, c, exp, b, watched)
            m.requires_grad_(True)
            with kernels_alone(alone) if old == "own" else contextlib.nullcontext():
                metrics, grads = updater.grads(m, b)
            wk = {k: float(v) for k, v in metrics.items()}
            wk["grad_norm"] = float(global_norm([g for g in grads.values() if g is not None]))
            gk = cs.rl_watched_grads(grads.items(), watched)
            for p in m.parameters():
                p.grad = None
            m.requires_grad_(False)
            return wk, gk

        paths = {"fp32_witness": step(model, plain, "fp32_witness")}
        with cs.decoder_plain_on_bf16():
            paths["plain"] = step(model, plain, "plain")
        paths["kernel_policy_loss"] = step(model, cfg, "kernel_policy_loss")
        paths["bf16"] = step(bf, plain, "bf16")
        paths["kernel_updater"] = step(model, cfg, "kernel_updater", updater_path=True)
        ref = paths["fp32_witness"]
        rules = {}
        for kernel in ("kernel_updater", "kernel_policy_loss"):
            checks: list = []
            _, bounds = cs.hold_step(f"{layers} layers, {old} old log-probs, {kernel}",
                                     {"kernel": paths[kernel], "plain": paths["plain"],
                                      "bf16": paths["bf16"]}, ref, SCALARS, checks)
            rules[kernel] = {"holds": all(ok for ok, _ in checks), "bounds": bounds,
                             "failed": [m for ok, m in checks if not ok]}
        out[old] = {"metrics": {p: {k: w[k] for k in ("loss", "pg_loss", "entropy", "grad_norm")}
                                for p, (w, _) in paths.items()},
                    "vs_fp32": {p: distance(v, ref) for p, v in paths.items()
                                if p != "fp32_witness"},
                    "rule": rules}
        del paths, ref
    out["kernels_alone"] = alone
    out["kernels_alone_max"] = {k: max(r[k] for r in alone) for k in
                                ("k1_out", "k3_dq", "k3_dk", "k3_dv")} if alone else None
    del model, bf, updater, mb
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
