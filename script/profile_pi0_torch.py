"""Where one pi0 device call spends its time on an NVIDIA GPU.

    python script/profile_pi0_torch.py [--out DIR]

Builds pi0 at full width (``Pi0Exp``'s defaults: SigLIP so400m/224 + Gemma-2B
+ the Gemma-300M expert, seeded random bf16 weights, fp32 activations) on
the card and runs one
request's device call (3 views, the served 64-token text bucket, a state,
seeded noise) as the server does.  For each part (ViT + projector with the
text embedding, the prefix prefill, the Euler steps; ``part_calls`` and
``PARTS``, which chip_smoke.py's phase 5c uses too) it prints the
CUDA-synchronised wall time, the device's busy time inside it (the union of
the kernels' intervals in a ``torch.profiler`` trace), the idle share, the
number of kernels and the host time per kernel, then the kernels that take
the most device time over the whole call.  One JSON line at the end; with
``--out`` it is also written to ``DIR/profile_pi0.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dexbotic_tpu_torch.exp.pi0_exp import Pi0Exp  # noqa: E402
from dexbotic_tpu_torch.models import flow_vla as fv  # noqa: E402
from dexbotic_tpu_torch.nn.transformer import mot_forward  # noqa: E402


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def wall_ms(fn, reps: int = 5) -> float:
    """Median CUDA-synchronised wall time of ``fn`` over ``reps`` calls after one."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def part_calls(model, cfg, ids, text_mask, imgs, masks, states, noise) -> dict:
    """The nested calls of one device call: the prefix embedding (ViT +
    projector + text), the prefix prefill (which embeds first) and the whole
    call; :data:`PARTS` turns readings of them into parts."""
    def prefix():
        return fv.embed_prefix(model, cfg, imgs, masks, ids, text_mask)

    def prefill():
        tokens, pmask, par = prefix()
        _, grp, pos = fv._positions_and_grp(pmask, par)
        return mot_forward(fv._streams(model, cfg, tokens, None, None), pos, grp, pmask,
                           update_cache=True)

    def call():
        return fv.flow_vla_inference_action(model, cfg, ids, text_mask, imgs, masks, states,
                                            noise=noise)

    return {"prefix": prefix, "prefill": prefill, "call": call}


# each part: (the call that ends with it, the call it follows, or None)
PARTS = {"vit_projector": ("prefix", None), "prefill": ("prefill", "prefix"),
         "euler_steps": ("call", "prefill"), "device_call": ("call", None)}


def split_parts(measured: dict) -> dict:
    """{part: readings} from {call: a tuple of additive readings}."""
    out = {}
    for part, (whole, less) in PARTS.items():
        vals = measured[whole]
        out[part] = vals if less is None else tuple(a - b for a, b in zip(vals, measured[less]))
    return out


def trace(fn):
    """(busy ms, kernel count, {kernel name: device ms}) of one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "Memcpy" not in e.name:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    if not spans:
        raise RuntimeError("the profiler saw no kernel")
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy / 1e3, len(spans), by_name


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_pi0: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="a directory for the JSON result")
    args = ap.parse_args()
    card = card_line()
    print(card, flush=True)
    exp = Pi0Exp(device="cuda")
    cfg, model, _ = exp.load_for_inference()
    tok = exp.build_tokenization(exp.tokenizer.build_tokenizer())
    row = tok(conversations=[{"from": "human", "value": "pick up the moka pot"}])["input_ids"]
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.zeros((1, 64), dtype=torch.int32, device="cuda")
    ids[0, : len(row)] = torch.as_tensor(row, dtype=torch.int32)
    text_mask = (ids != 0).to(torch.int32)
    size = exp.data.build_image_processor().size
    imgs = torch.rand((1, 3, size, size, 3), generator=g, device="cuda") * 2 - 1
    masks = torch.ones((1, 3), dtype=torch.int32, device="cuda")
    states = torch.randn((1, cfg.action_dim), generator=g, device="cuda")
    noise = torch.randn((1, cfg.chunk_size, cfg.action_dim), generator=g, device="cuda")
    calls = part_calls(model, cfg, ids, text_mask, imgs, masks, states, noise)
    res = {"card": card, "params_b": sum(p.numel() for p in model.parameters()) / 1e9}
    measured, names = {}, {}
    for name, fn in calls.items():
        busy, n, names[name] = trace(fn)
        measured[name] = (wall_ms(fn), busy, n)
    for part, (w, busy, n) in split_parts(measured).items():
        res[part] = {"wall_ms": w, "busy_ms": busy, "idle_share": 1 - busy / w, "kernels": n,
                     "host_us_per_kernel": w / n * 1e3}
        print(f"{part}: wall {w:.2f} ms, device busy {busy:.2f} ms (idle {1 - busy / w:.1%}), "
              f"{n} kernels, {w / n * 1e3:.1f} us of wall a kernel", flush=True)
    top = sorted(names["call"].items(), key=lambda kv: -kv[1])[:12]
    res["top_kernels_ms"] = {k[:120]: v for k, v in top}
    for k, v in top:
        print(f"  {v:8.3f} ms  {k[:110]}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_pi0.json"), "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
