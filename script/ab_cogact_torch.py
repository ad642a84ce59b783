"""Two checkouts of the port on one card: CogACT-7B's served call and its training step.

    python script/ab_cogact_torch.py ab --baseline DIR [--order old,new,new,old] [--out DIR]
    python script/ab_cogact_torch.py one --root DIR
    python script/ab_cogact_torch.py inproc --baseline DIR [--rounds 3] [--out DIR]

``one`` imports ``dexbotic_tpu_torch`` from ``--root`` (a directory that
holds the package, e.g. ``git archive <commit> dexbotic_tpu_torch`` unpacked
into a gitignored ``_scratch/``), builds CogACT-7B at full width with seeded
random bf16 weights on the card and times:

* the served device call: ``cogact_inference_action`` on one 480x640 frame
  and "pick up the moka pot" (811 tokens in the 832-token bucket), B=1,
  CUDA-synchronised wall clock, median of 20 calls after 3;
* the training step: ``CogActExp.train()`` on chip_smoke.py's synthetic
  Dexdata suite and LIBERO recipe (frozen LLM, micro-batch 8, accumulation
  2, rows of 2048 tokens), the median step time of steps 2-5.

It prints one JSON line.  The helpers (frame, suite, recipe) are this
checkout's chip_smoke.py, whichever package is measured.  ``ab`` runs
``one`` in a process of its own for each entry of ``--order`` ("old": the
baseline, "new": the checkout this script is in), prints each result and the
mean of each side, and writes ``ab_cogact.json`` under ``--out``.

``inproc`` isolates the decoder's forward: in one process, on one model and
this checkout's kernels, it swaps ``models/vlm.transformer_forward`` between
the baseline's ``nn/transformer.py`` (loaded from its file) and this
checkout's, in the order old, new, new, old per round, for the served call
(medians of 10) and a training micro-batch's forward + backward (8 rows of
2048 tokens, remat, frozen LLM; medians of 3); it also counts the CUDA
kernels and their device time in one served call of each (``torch.profiler``)
and writes ``ab_cogact_inproc.json`` under ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_STEPS = 5


def _helpers():
    """This checkout's chip_smoke.py, loaded by path (a baseline checkout may hold its own)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wall_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def serve_call(cs):
    """(the served device call as a function, the model): CogACT-7B on one frame."""
    import torch

    from dexbotic_tpu_torch.exp import base_exp
    from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
    from dexbotic_tpu_torch.exp.serve import _cogact_images, _cogact_prompt_ids
    from dexbotic_tpu_torch.models.cogact import cogact_inference_action

    exp = CogActExp(model=CogActModelConfig(), data=base_exp.DataConfig(image_processor="clip_336"),
                    device="cuda")
    cfg, model, _ = exp.load_for_inference()
    cs.redraw_final_(model.action_head, torch.Generator(device="cuda").manual_seed(3))
    row = _cogact_prompt_ids(exp, cfg, exp.tokenizer.build_tokenizer(), cs.PROMPT)
    L = -(-len(row) // 64) * 64
    ids = torch.zeros((1, L), dtype=torch.int32, device="cuda")
    valid = torch.zeros_like(ids)
    ids[0, : len(row)] = torch.tensor(row, device="cuda")
    valid[0, : len(row)] = 1
    imgs = torch.from_numpy(_cogact_images([cs._frame_png()], exp.data.build_image_processor()))
    imgs = imgs[None].cuda()
    noise = torch.randn((1, cfg.chunk_size, cfg.action_dim),
                        generator=torch.Generator(device="cuda").manual_seed(4), device="cuda")

    @torch.no_grad()
    def call():
        return cogact_inference_action(model, cfg, ids, valid, imgs, noise=noise)

    return call, model


def serve_call_ms(cs) -> float:
    import torch

    call, model = serve_call(cs)
    ms = _wall_ms(call)
    del call, model
    gc.collect()
    torch.cuda.empty_cache()
    return ms


def train_step_s(cs) -> float:
    with tempfile.TemporaryDirectory() as tmp, cs.working_dir(tmp):
        dataset = cs.write_suite(os.path.join(tmp, "suite"))
        cs.train_exp(dataset, "out", 8, 2, TRAIN_STEPS).train()
        with open(os.path.join("out", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    if len(rows) != TRAIN_STEPS:
        raise RuntimeError(f"train() logged {len(rows)} of {TRAIN_STEPS} steps")
    return statistics.median(1 / r["steps_per_sec"] for r in rows[1:])


def one(root: str) -> dict:
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import dexbotic_tpu_torch

    where = os.path.dirname(os.path.realpath(dexbotic_tpu_torch.__file__))
    if not where.startswith(os.path.realpath(root) + os.sep):
        raise RuntimeError(f"dexbotic_tpu_torch came from {where}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _helpers()
    return {"root": root, "card": cs.card_line(), "serve_call_ms": serve_call_ms(cs),
            "train_step_s": train_step_s(cs)}


def _kernels(fn) -> tuple[int, float]:
    """(CUDA kernels, their summed device ms) of one call of ``fn``."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "Memcpy" not in e.name]
    return len(spans), sum(spans) / 1e3


def inproc(baseline: str, rounds: int, out: str | None) -> int:
    import torch

    sys.path.insert(0, REPO)
    from dexbotic_tpu_torch.data.collator import Collator
    from dexbotic_tpu_torch.exp.trainer import Trainer
    from dexbotic_tpu_torch.models import vlm
    from dexbotic_tpu_torch.models.cogact import cogact_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _helpers()
    path = os.path.join(os.path.abspath(baseline), "dexbotic_tpu_torch", "nn", "transformer.py")
    spec = importlib.util.spec_from_file_location("baseline_transformer", path)
    old_mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = old_mod  # its dataclasses look their module up there
    spec.loader.exec_module(old_mod)
    impls = {"old": old_mod.transformer_forward, "new": vlm.transformer_forward}
    order = ["old", "new", "new", "old"] * rounds
    res = {"card": cs.card_line(), "baseline": path, "order": order}

    def swapped(fn, label):
        def run():
            vlm.transformer_forward = impls[label]
            return fn()
        return run

    call, model = serve_call(cs)
    serve = {lab: [] for lab in impls}
    for label in order:
        serve[label].append(_wall_ms(swapped(call, label), reps=10, warmup=2))
    res["serve_call_ms"] = serve
    res["serve_kernels"] = {lab: _kernels(swapped(call, lab)) for lab in impls}
    del call, model
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp, cs.working_dir(tmp):
        dataset = cs.write_suite(os.path.join(tmp, "suite"))
        exp = cs.train_exp(dataset, "out", 8, 1, 1)
        exp._auto_compute_norm_stats()
        tok = exp.tokenizer.build_tokenizer()
        cfg, model, _ = exp.build_model(tok)
        ds = exp.data.build_data(exp.build_tokenization(tok), exp.action.build_action_process_func())
        batch = Collator(pad_token_id=tok.pad_token_id,
                         max_length=exp.tokenizer.model_max_length)([ds[i] for i in range(8)])
    g = torch.Generator(device="cuda").manual_seed(9)
    rows = cfg.repeated_diffusion_steps * 8
    t = torch.randint(0, cfg.diffusion_steps, (rows,), generator=g, device="cuda")
    noise = torch.randn((rows, cfg.chunk_size, cfg.action_dim), generator=g, device="cuda")

    def loss_fn(m, b, gen):
        return cogact_loss(m, cfg, b, gen, remat=True, diffusion_t=t, diffusion_noise=noise)

    trainer = Trainer(loss_fn, model, exp.trainer, exp.optimizer)
    train = {lab: [] for lab in impls}
    for label in order:
        step = swapped(lambda: trainer.accumulate_grads(batch), label)
        train[label].append(_wall_ms(step, reps=3, warmup=1))
    res["train_microbatch_ms"] = train
    for key in ("serve_call_ms", "train_microbatch_ms"):
        side = {lab: statistics.median(v) for lab, v in res[key].items()}
        res[key + "_median"] = {**side, "new_over_old": side["new"] / side["old"]}
        print(f"{key}: old {side['old']:.3f} new {side['new']:.3f} new/old "
              f"{side['new'] / side['old']:.4f}  (all: {res[key]})")
    print(f"serve kernels (count, device ms): {res['serve_kernels']}")
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "ab_cogact_inproc.json"), "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


def ab(baseline: str, order: list, out: str | None) -> int:
    roots = {"old": os.path.abspath(baseline), "new": REPO}
    runs = []
    for label in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "one", "--root", roots[label]],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            print(f"ab: the {label} run failed (exit {proc.returncode})", file=sys.stderr)
            return 1
        res = {"label": label, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(f"{label}: served call {res['serve_call_ms']:.3f} ms, training step "
              f"{res['train_step_s']:.4f} s  ({res['card']})", flush=True)
        runs.append(res)
    summary = {}
    for key in ("serve_call_ms", "train_step_s"):
        side = {lab: statistics.mean(r[key] for r in runs if r["label"] == lab) for lab in roots}
        summary[key] = {**side, "new_over_old": side["new"] / side["old"]}
        print(f"{key}: old {side['old']:.4f}, new {side['new']:.4f}, new/old "
              f"{side['new'] / side['old']:.4f}")
    result = {"order": order, "runs": runs, "summary": summary}
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "ab_cogact.json"), "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_ab = sub.add_parser("ab")
    p_ab.add_argument("--baseline", required=True)
    p_ab.add_argument("--order", default="old,new,new,old")
    p_ab.add_argument("--out")
    p_one = sub.add_parser("one")
    p_one.add_argument("--root", required=True)
    p_in = sub.add_parser("inproc")
    p_in.add_argument("--baseline", required=True)
    p_in.add_argument("--rounds", type=int, default=3)
    p_in.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_cogact: no CUDA device", file=sys.stderr)
        return 2
    if args.cmd == "ab":
        return ab(args.baseline, args.order.split(","), args.out)
    if args.cmd == "inproc":
        return inproc(args.baseline, args.rounds, args.out)
    print(json.dumps(one(args.root)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
