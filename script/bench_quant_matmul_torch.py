"""K4 (the int8-weight matmul) of dexbotic_tpu_torch on an H100: its plans
against each other, and against the build of an earlier tree's kernel.

    python script/bench_quant_matmul_torch.py plans
    python script/bench_quant_matmul_torch.py ab --baseline DIR

Shapes: every case of chip_smoke phase 4c (``K4_CASES``: the served DiT
products, LLaMA-7B's widths at 1, 16 and 64 rows, and an int8 request's
prefill products: CLIP-L/336 at 577 rows, the projector at 576, LLaMA-2-7B
at 832 and 1664), with bf16 and fp32 activations.  Times: median of 20
calls, CUDA events around the Python call, the L2 flushed before each.

``plans``: K4 under every plan of the tile and the split (rows a block from
the kernel's instances, splits 1, 2, 3, 4, 8, 16 where they leave at least
4 k steps each): its time a call and its kernels' own device time
(torch.profiler), beside the plan that ``ops/quant_matmul.plan`` picks (its
L2-warm time too, and the wrapper's host time a call), the
dequantize formulation that ``quant_linear`` runs where K4 is not
dispatched, and one matmul on the dequantized weight (the library call).
``ab``: DIR holds an earlier tree's ``dexbotic_tpu_torch/csrc`` whose
``quant_matmul.cu`` is the mma.sync kernel of M <= 64 rows (its split rule
is copied here as ``old_splits``); both builds load into this process and
each call is timed in the order old, new, new, old at every case it takes.
Each mode prints one JSON line; ``--out DIR`` also writes it to
``DIR/bench_quant_matmul_<mode>.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import K4_CASES  # noqa: E402
from dexbotic_tpu_torch.kernels import build  # noqa: E402
from dexbotic_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from dexbotic_tpu_torch.ops.quant import quantize_weight  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURES = {"dbx_quant_matmul": [_I] + [_P] * 5 + [_I] * 4 + [_P]}
SPLITS = (1, 2, 3, 4, 8, 16)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


class Timer:
    def __init__(self):
        self.scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 20, flush: bool = True) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            if flush:
                self.scratch.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def device_ms(fn, reps: int = 10, sessions: int = 3) -> float:
    """K4's kernels' own device time per call (torch.profiler).  A session
    can come back with no kernel record (3 of 656 did on an H100): it is run
    again, up to ``sessions`` times, and then raises, so that no empty
    reading is taken for the fastest plan."""
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if any(k in e.key for k in ("qm_kernel", "reduce_kernel", "split_kernel")))
        if total > 0:
            return total / reps / 1e3
    raise RuntimeError(f"the profiler saw no K4 kernel in {sessions} sessions")


def host_us(fn, reps: int = 200) -> float:
    """Host time of one call of the wrapper: calls issued back to back
    behind a long device job, so that the device never waits for them."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))  # ~1 s of device time queued ahead
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


def inputs(M: int, K: int, N: int, dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, s = quantize_weight((torch.randn(N, K, generator=g, device="cuda") * 0.02).bfloat16())
    x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
    return x, q, s[:, 0].to(dtype)


def max_err(out, x, q, s) -> float:
    ref = qm.quant_matmul_ref(x.double(), q, s.double())
    return (out.double() - ref).abs().max().item()


def all_plans(M: int, K: int, N: int) -> list:
    steps = K // qm._K_STEP
    if M <= qm._FEW_ROWS[-1]:  # the few-row tile, and the smallest prefill tile
        rows = [next(r for r in qm._FEW_ROWS if r >= M), qm._MANY_ROWS[0]]
    else:
        rows = list(qm._MANY_ROWS)
    out = []
    for r in rows:
        ch = 64 if r in qm._FEW_ROWS else 128
        for sp in SPLITS:
            if sp == 1 or steps // sp >= qm._MIN_K_STEPS:
                out.append(qm.Plan(r, ch, sp, (-(-M // r), -(-N // ch), sp)))
    return out


def plans(args) -> dict:
    timer, rows = Timer(), []
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, M, K, N) in enumerate(K4_CASES):
            x, q, s = inputs(M, K, N, dtype, i)
            w = q.to(dtype) * s[:, None]
            picked = qm.plan(M, K, N)
            row = {"case": f"{name} M={M} K={K} N={N} {str(dtype)[6:]}",
                   "picked": [picked.rows, picked.splits],
                   "plain_ms": timer(lambda: qm.quant_matmul_ref(x, q, s)),
                   "library_ms": timer(lambda: torch.matmul(x, w.t())), "plans": {}}
            for p in dict.fromkeys([picked] + all_plans(M, K, N)):
                out = qm._launch(x, q, s, p)
                torch.cuda.synchronize()
                err = max_err(out, x, q, s)
                ms = timer(lambda p=p: qm._launch(x, q, s, p))
                dev = device_ms(lambda p=p: qm._launch(x, q, s, p))
                row["plans"][f"{p.rows}x{p.splits}"] = {"ms": ms, "device_ms": dev, "err": err}
            best = min(row["plans"].items(), key=lambda kv: kv[1]["device_ms"])
            row["best"] = best[0]
            row["picked_ms"] = row["plans"][f"{picked.rows}x{picked.splits}"]["ms"]
            row["picked_warm_ms"] = timer(lambda: qm.quant_matmul(x, q, s), flush=False)
            row["picked_device_ms"] = device_ms(lambda: qm.quant_matmul(x, q, s))
            row["host_us"] = host_us(lambda: qm.quant_matmul(x, q, s))
            print(f"  {row['case']}: picked {picked.rows}x{picked.splits} {row['picked_ms']:.4f} ms "
                  f"(L2 warm {row['picked_warm_ms']:.4f}, alone {row['picked_device_ms']:.4f}, "
                  f"host {row['host_us']:.1f} us a call), best alone {best[0]} "
                  f"{best[1]['device_ms']:.4f} ms; "
                  f"dequantize formulation {row['plain_ms']:.4f}, library "
                  f"{row['library_ms']:.4f}", flush=True)
            rows.append(row)
            del x, q, s, w
    return {"cases": rows}


def old_splits(N: int, K: int) -> int:
    """The earlier kernel's split rule (its ops/quant_matmul.py:k_splits)."""
    want = -(-(132 * 16) // -(-N // 8))
    return max(1, min(want, K // 64 // 4))


def ab(args) -> dict:
    src = os.path.join(args.baseline, "quant_matmul.cu")
    out_dir = os.path.join(build.BUILD_DIR, "baseline")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libk4_baseline.so")
    build.build_library([src], so)
    old = build.bind(so, OLD_SIGNATURES)
    timer, rows = Timer(), []

    def old_call(x, q, s):
        M, K = x.shape
        N = q.shape[0]
        sp = old_splits(N, K)
        out = torch.empty(M, N, dtype=x.dtype, device="cuda")
        part = torch.empty(sp, M, N, device="cuda") if sp > 1 else None
        code = old.dbx_quant_matmul(int(x.dtype == torch.bfloat16), x.data_ptr(), q.data_ptr(),
                                    s.data_ptr(), out.data_ptr(),
                                    None if part is None else part.data_ptr(), M, N, K, sp,
                                    torch.cuda.current_stream().cuda_stream)
        build.check(code, "baseline dbx_quant_matmul")
        return out

    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, M, K, N) in enumerate(K4_CASES):
            if M > 64:
                continue
            x, q, s = inputs(M, K, N, dtype, i)
            errs = (max_err(old_call(x, q, s), x, q, s), max_err(qm.quant_matmul(x, q, s), x, q, s))
            t = [timer(lambda: old_call(x, q, s)), timer(lambda: qm.quant_matmul(x, q, s)),
                 timer(lambda: qm.quant_matmul(x, q, s)), timer(lambda: old_call(x, q, s))]
            row = {"case": f"{name} M={M} K={K} N={N} {str(dtype)[6:]}",
                   "old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]],
                   "old_err": errs[0], "new_err": errs[1]}
            print(f"  {row['case']}: old {t[0]:.4f}/{t[3]:.4f} ms, new {t[1]:.4f}/{t[2]:.4f} ms",
                  flush=True)
            rows.append(row)
    return {"cases": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_quant_matmul: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["plans", "ab"])
    ap.add_argument("--baseline", help="an earlier tree's dexbotic_tpu_torch/csrc (ab)")
    ap.add_argument("--out", help="a directory for the JSON result")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    result = {"card": card, "mode": args.mode, **(plans if args.mode == "plans" else ab)(args)}
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"bench_quant_matmul_{args.mode}.json"), "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
