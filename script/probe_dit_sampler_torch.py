"""K2 (the fused DiT sampler) of dexbotic_tpu_torch on an H100: a per-phase
probe of its cooperative kernel, and an A/B against an earlier tree's build.

    python script/probe_dit_sampler_torch.py probe [--baseline DIR]
    python script/probe_dit_sampler_torch.py ab --baseline DIR
    python script/probe_dit_sampler_torch.py plans

The head is chip_smoke's DiT-B (seeded bf16 weights, the final layer
redrawn), sampled by DDIM-10 with CFG 1.5.

``probe``: the kernel runs with its probe buffer (``Params::probe``): every
block stamps ``%globaltimer`` at the start and the end of every (step,
layer, phase) and, in a product phase, counts the cycles it waited for its
stages (weights and activations) and the cycles of the rest of the product
(of which its partial stores and thread 0's requests at its start; zero
for the parent's kernel).
Printed per phase kind, as medians over the steps and layers: the phase's
time on the slowest block and on the median block, the barrier after it
(from the last block's end of the phase to the first block's start of the
next), and for products the median block's stage wait and product, at B=1,
2 and 8 (rows 2, 4 and 16 with CFG), each where the kernel serves it, with
bf16 block weights (and int8 at B=1).  With ``--baseline DIR`` the kernel
of DIR's ``dit_sampler.cu`` (the parent tree's mma.sync design, rows <= 4)
is probed instead, after the same stamps are put into a copy of it as text
edits (``probe_edits``).

``ab``: DIR's kernel as it is and this tree's, at B=1 and B=2 with bf16 and
int8 block weights, each call timed in the order old, new, new, old (median
of 20 calls, CUDA events around the Python call), then each kernel's own
device time a call (torch.profiler) and the wrapper's host time a call
(calls queued behind a long device job); at B=8, which the old kernel does
not serve, this tree's kernel against the plain sampler loop.  DIR comes
from ``git archive <commit> dexbotic_tpu_torch/csrc`` unpacked into a
gitignored directory.

``plans``: this tree's kernel under its planned k chunks and under others
(halved, doubled, one a product) at B=1 and B=8, bf16 and int8 blocks, by
device time, each plan timed twice, in the order of the list and back.

Each mode prints one JSON line last; ``--out DIR`` also writes it to
``DIR/probe_dit_sampler_<mode>.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import _dit_head, device_ms, plain_int8  # noqa: E402
from dexbotic_tpu_torch.kernels import build  # noqa: E402
from dexbotic_tpu_torch.nn.core import weight_dtype  # noqa: E402
from dexbotic_tpu_torch.ops import dit_fused  # noqa: E402
from dexbotic_tpu_torch.ops.diffusion import DiffusionSchedule  # noqa: E402
from dexbotic_tpu_torch.ops.quant import quantize_model_  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the parent tree's entry point, and the same with the probe pointer before the stream
OLD_SIGNATURE = [_I, _I] + [_P] * 29 + [_I] * 10 + [_F, _I, _P]
PROBED_SIGNATURE = OLD_SIGNATURE[:-1] + [_P, _P]
LAYER_PHASES = ("qkv", "bias_qkv", "attn", "o", "res_ln_o", "fc0", "bias_gelu", "fc1",
                "res_ln_fc1")
PRODUCTS = ("qkv", "o", "fc0", "fc1")
KIND_ORDER = ("embed", "ln0", *LAYER_PHASES, "final")
CASES = ((1, "bf16"), (2, "bf16"), (8, "bf16"), (1, "int8"))  # (B, block weights)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def probe_edits(src: str) -> str:
    """The parent's dit_sampler.cu with the probe of this tree's kernel: the
    header stamps of each block, a record at every grid.sync of the step loop
    (phase start and end, stage-wait and product cycles), nothing else."""
    def sub(old: str, new: str, text: str, count: int = 1) -> str:
        if text.count(old) != count:
            raise RuntimeError(f"dit_sampler.cu no longer holds {old!r} {count} time(s)")
        return text.replace(old, new)

    src = sub("  int sampler;  // 0 ddim, 1 dpm\n};\n",
              "  int sampler;  // 0 ddim, 1 dpm\n  unsigned long long* probe;\n};\n\n"
              "__device__ __forceinline__ unsigned long long gtimer() {\n"
              "  unsigned long long t;\n"
              "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
              "  return t;\n}\n"
              "struct Probe { unsigned long long t0; long long wait, prod; };\n", src)
    src = sub("const Product<T, Q>& cur, T* stage) {\n",
              "const Product<T, Q>& cur, T* stage, Probe& pb) {\n"
              "  const long long c_in = clock64();\n  long long waited = 0;\n", src)
    src = sub("    cp_async_wait<0>();\n    __syncthreads();\n    const T* Ws",
              "    const long long cw = clock64();\n    cp_async_wait<0>();\n    __syncthreads();\n"
              "    waited += clock64() - cw;\n    const T* Ws", src)
    src = sub("      stage_acts(p, A, cur, item + 2, As);\n      cp_async_commit();\n    }\n  }\n}\n",
              "      stage_acts(p, A, cur, item + 2, As);\n      cp_async_commit();\n    }\n  }\n"
              "  pb.wait += waited;\n  pb.prod += clock64() - c_in - waited;\n}\n", src)
    src = sub("  cg::grid_group grid = cg::this_grid();\n",
              "  cg::grid_group grid = cg::this_grid();\n"
              "  unsigned long long* const hdr = p.probe ? p.probe + 4 * blockIdx.x : nullptr;\n"
              "  if (hdr && threadIdx.x == 0) { hdr[0] = clock64(); hdr[1] = gtimer(); }\n"
              "  Probe pb{0, 0, 0};\n  const int slots = 3 + 9 * p.depth;\n  int ph = 0;\n"
              "  auto sync = [&](int step) {\n"
              "    if (hdr && threadIdx.x == 0) {\n"
              "      unsigned long long* r = p.probe + 4 * gridDim.x +\n"
              "          (size_t(step * slots + ph) * gridDim.x + blockIdx.x) * 6;\n"
              "      r[0] = pb.t0; r[1] = gtimer(); r[2] = pb.wait; r[3] = pb.prod;\n"
              "      r[4] = 0; r[5] = 0;\n    }\n"
              "    ++ph;\n    grid.sync();\n"
              "    if (hdr && threadIdx.x == 0) pb = Probe{gtimer(), 0, 0};\n  };\n", src)
    head, loop = src.split("  for (int step = 0; step < p.N; ++step) {\n", 1)
    loop, tail = loop.split("\ntemplate <typename T, bool Q>\ncudaError_t launch", 1)
    loop = loop.replace("grid.sync();", "sync(step);")
    loop = re.sub(r"gemm_phase<T, Q>\((.*?), stage\);", r"gemm_phase<T, Q>(\1, stage, pb);", loop)
    loop = sub("    final_phase<T>(p, step, sm);\n    sync(step);\n  }\n}\n",
               "    final_phase<T>(p, step, sm);\n    sync(step);\n  }\n"
               "  if (hdr && threadIdx.x == 0) { hdr[2] = clock64(); hdr[3] = gtimer(); }\n}\n", loop)
    src = (head + "  for (int step = 0; step < p.N; ++step) {\n"
           "    ph = 0;\n    if (hdr && threadIdx.x == 0) pb = Probe{gtimer(), 0, 0};\n"
           + loop + "\ntemplate <typename T, bool Q>\ncudaError_t launch" + tail)
    src = sub("float cfg_scale, int sampler, void* stream) {\n",
              "float cfg_scale, int sampler, void* probe, void* stream) {\n", src)
    src = sub("  p.N = N; p.RP = RP;", "  p.probe = static_cast<unsigned long long*>(probe);\n"
              "  p.N = N; p.RP = RP;", src)
    return src


def build_old(csrc: str, probed: bool):
    """DIR's dit_sampler.cu (with the probe's edits when ``probed``), built
    alone into its own library."""
    with open(os.path.join(csrc, "dit_sampler.cu")) as f:
        src = f.read()
    out_dir = os.path.join(build.BUILD_DIR, "k2_baseline")
    os.makedirs(out_dir, exist_ok=True)
    name = "probed" if probed else "plain"
    path = os.path.join(out_dir, f"dit_sampler_{name}.cu")
    with open(path, "w") as f:
        f.write(probe_edits(src) if probed else src)
    so = os.path.join(out_dir, f"libk2_{name}.so")
    build.build_library([path], so)
    sig = PROBED_SIGNATURE if probed else OLD_SIGNATURE
    return build.bind(so, {"dbx_dit_sample": sig})


_OLD_STACKS: dict = {}


def old_call(lib, head, cfg, z, noise, sched, steps, cfg_scale, sampler, probe=None):
    """The parent tree's K2 wrapper: dense block weights stacked [depth, in,
    out] (cached per head, as that wrapper cached them), 16-row padding."""
    cdtype = weight_dtype(head.x_embed)
    B, T, A = noise.shape
    H, M = cfg.hidden_size, cfg.mlp_dim
    rows = (2 if cfg_scale > 1.0 else 1) * B
    RP = -(-rows * (T + 1) // 16) * 16
    if RP > 80:
        raise ValueError(f"the parent's K2 does not serve {rows} rows")
    p = dict(dit_fused.prepare(head, cfg, z, sched, steps, cfg_scale, sampler))
    int8 = p["wqkv"].dtype == torch.int8
    if not int8:
        if id(head) not in _OLD_STACKS:
            lins = {"qkv": [b.attn.qkv for b in head.blocks], "o": [b.attn.o for b in head.blocks],
                    "fc0": [b.mlp.fc0 for b in head.blocks], "fc1": [b.mlp.fc1 for b in head.blocks]}
            _OLD_STACKS[id(head)] = {
                "w" + n: torch.stack([dit_fused._dense_weight(lin).t() for lin in ls]).contiguous()
                for n, ls in lins.items()}
        p.update(_OLD_STACKS[id(head)])
    dev = noise.device
    x0 = noise.float().contiguous()
    out = torch.empty_like(x0)
    h = torch.zeros((RP, H), dtype=cdtype, device=dev)
    hn, attn = torch.zeros_like(h), torch.zeros_like(h)
    qkv = torch.zeros((RP, 3 * H), dtype=cdtype, device=dev)
    m = torch.zeros((RP, M), dtype=cdtype, device=dev)
    x, xp = torch.empty_like(x0), torch.empty_like(x0)
    part = torch.empty(max(3 * H * H, H * M) // 128 * RP, dtype=torch.float32, device=dev)

    def scales(name):
        return p["s" + name].data_ptr() if int8 else None

    extra = [] if probe is None else [probe.data_ptr()]
    code = lib.dbx_dit_sample(
        int(cdtype == torch.bfloat16), int(int8), p["coef"].data_ptr(), p["cond"].data_ptr(),
        x0.data_ptr(), p["pos"].data_ptr(), p["xw"].data_ptr(), p["xb"].data_ptr(),
        p["fw"].data_ptr(), p["fb"].data_ptr(), p["wqkv"].data_ptr(), scales("qkv"),
        p["bqkv"].data_ptr(), p["wo"].data_ptr(), scales("o"), p["bo"].data_ptr(),
        p["wfc0"].data_ptr(), scales("fc0"), p["bfc0"].data_ptr(), p["wfc1"].data_ptr(),
        scales("fc1"), p["bfc1"].data_ptr(), out.data_ptr(), h.data_ptr(),
        hn.data_ptr(), qkv.data_ptr(), attn.data_ptr(), m.data_ptr(), x.data_ptr(),
        xp.data_ptr(), part.data_ptr(), B, T, A, H, cfg.num_heads, M, cfg.depth, steps, RP,
        int(cfg_scale > 1.0), float(cfg_scale), int(sampler == "dpm"), *extra,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "parent dbx_dit_sample")
    return out


def heads():
    """{"bf16": chip_smoke's DiT-B head, "int8": the same quantized} and its cfg."""
    cfg, head, _, _ = _dit_head(2)
    _, head_q, _, _ = _dit_head(2)
    quantize_model_(head_q)
    return cfg, {"bf16": head, "int8": head_q}


def inputs(cfg, B: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(B, 1, cfg.token_size, generator=g, device="cuda")
    noise = torch.randn(B, cfg.chunk_size, cfg.in_channels, generator=g, device="cuda")
    return z, noise


def slot_kind(slot: int, depth: int) -> str:
    if slot == 0:
        return "embed"
    if slot == 1:
        return "ln0"
    if slot == 2 + 9 * depth:
        return "final"
    return LAYER_PHASES[(slot - 2) % 9]


def summarize(buf: torch.Tensor, G: int, steps: int, depth: int) -> dict:
    """Per phase kind (us, medians over its steps and layers): the phase on
    the slowest block, on the median block, the barrier after it; products
    also the median block's stage wait and product.  Plus the layer's time
    (first block's start of one qkv phase to the next) and the whole run."""
    slots = 3 + 9 * depth
    b = buf.cpu().to(torch.float64)
    hdr = b[:4 * G].view(G, 4)
    rate = ((hdr[:, 2] - hdr[:, 0]) / (hdr[:, 3] - hdr[:, 1])).median().item()  # cycles / ns
    rec = b[4 * G:].view(steps, slots, G, dit_fused.PROBE_WORDS)
    start, end = rec[..., 0], rec[..., 1]
    dur = (end - start) / 1e3
    kinds: dict = {}
    for s in range(steps):
        for k in range(slots):
            nxt = (s, k + 1) if k + 1 < slots else (s + 1, 0)
            row = kinds.setdefault(slot_kind(k, depth), {"slowest": [], "median": [], "barrier": [],
                                                         "wait": [], "product": [], "store": [],
                                                         "issue": []})
            row["slowest"].append(dur[s, k].max().item())
            row["median"].append(dur[s, k].median().item())
            if nxt[0] < steps:
                row["barrier"].append((start[nxt].min() - end[s, k].max()).item() / 1e3)
            row["wait"].append(rec[s, k, :, 2].median().item() / rate / 1e3)
            for i, key in ((3, "product"), (4, "store"), (5, "issue")):
                row[key].append(rec[s, k, :, i].median().item() / rate / 1e3)
    table = {}
    for kind in KIND_ORDER:
        r = kinds[kind]
        table[kind] = {"slowest_us": statistics.median(r["slowest"]),
                       "median_us": statistics.median(r["median"]),
                       "barrier_us": statistics.median(r["barrier"]) if r["barrier"] else None}
        if kind in PRODUCTS:
            table[kind]["wait_us"] = statistics.median(r["wait"])
            for key in ("product", "store", "issue"):
                table[kind][f"{key}_us"] = statistics.median(r[key])
    first = start.min(dim=2).values  # [steps, slots]
    layer = [(first[s, 2 + 9 * (j + 1)] - first[s, 2 + 9 * j]).item() / 1e3
             for s in range(steps) for j in range(depth - 1)]
    total = (end.max() - start.min()).item() / 1e3
    return {"phases": table, "layer_us": statistics.median(layer) if layer else None,
            "run_us": total, "sm_cycles_per_ns": rate}


def print_table(label: str, s: dict) -> None:
    print(f"  {label}: a layer {s['layer_us']:.2f} us, the run {s['run_us']:.1f} us "
          f"(SM clock {s['sm_cycles_per_ns']:.3f} GHz)", flush=True)
    print("    phase        slowest  median  barrier   wait  product (store  issue)  (us)")
    for kind, r in s["phases"].items():
        bar = f"{r['barrier_us']:8.2f}" if r["barrier_us"] is not None else "       -"
        extra = (f" {r['wait_us']:6.2f} {r['product_us']:8.2f} ({r['store_us']:5.2f} "
                 f"{r['issue_us']:5.2f})" if "wait_us" in r else "")
        print(f"    {kind:<12} {r['slowest_us']:7.2f} {r['median_us']:7.2f} {bar}{extra}")


def probe(args) -> dict:
    cfg, hs = heads()
    sched, steps = DiffusionSchedule.create(100), 10
    G = torch.cuda.get_device_properties(0).multi_processor_count
    lib = build_old(args.baseline, probed=True) if args.baseline else None
    out = {}
    for B, weights in CASES:
        head = hs[weights]
        rows = 2 * B
        z, noise = inputs(cfg, B, B)
        buf = torch.zeros(dit_fused.probe_words(G, steps, cfg.depth), dtype=torch.int64,
                          device="cuda")
        kw = dict(steps=steps, cfg_scale=1.5, sampler="ddim")
        label = f"B={B} ({rows} rows) {weights}"
        try:
            if lib is not None:
                call = lambda: old_call(lib, head, cfg, z, noise, sched, **kw, probe=buf)  # noqa: E731
            else:
                if not dit_fused.k2_serves(rows, cfg.chunk_size, cfg.in_channels, cfg.hidden_size,
                                           cfg.mlp_dim, cfg.num_heads):
                    raise ValueError("outside k2_serves")
                call = lambda: dit_fused._launch(head, cfg, z, noise, sched, **kw, probe=buf)  # noqa: E731
            for _ in range(3):  # warm-up, then the probed run is the last
                call()
            torch.cuda.synchronize()
        except ValueError as e:
            print(f"  {label}: not served ({e})", flush=True)
            continue
        s = summarize(buf, G, steps, cfg.depth)
        if lib is None:
            s["plan"] = dit_fused.plan(rows, cfg.chunk_size, cfg.hidden_size, cfg.mlp_dim,
                                       G).describe(cfg.hidden_size, cfg.mlp_dim)
        print_table(label, s)
        out[label] = s
    return {"kernel": "baseline " + args.baseline if args.baseline else "this tree", "cases": out}


def host_us(fn, reps: int = 50) -> float:
    """Host time of one call: calls issued back to back behind a long device
    job, so that the device never waits for them."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))  # ~1 s of device time queued ahead
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


def ab(args) -> dict:
    from dexbotic_tpu_torch.ops.dit_fused import dit_sample_ref, fused_dit_sample

    cfg, hs = heads()
    lib = build_old(args.baseline, probed=False)
    sched = DiffusionSchedule.create(100)
    kw = dict(steps=10, cfg_scale=1.5, sampler="ddim")
    rows = []

    def timed(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    for B, weights in ((1, "bf16"), (2, "bf16"), (1, "int8"), (2, "int8")):
        head = hs[weights]
        z, noise = inputs(cfg, B, B)
        old = lambda: old_call(lib, head, cfg, z, noise, sched, **kw)  # noqa: E731
        new = lambda: fused_dit_sample(head, cfg, z, noise, sched, **kw)  # noqa: E731
        diff = (old() - new()).abs().max().item()
        t = [timed(old), timed(new), timed(new), timed(old)]
        dev = [device_ms(old, ("dit_sample_kernel",)), device_ms(new, ("dit_sample_kernel",))]
        host = [host_us(old), host_us(new)]
        row = {"case": f"B={B} {weights}", "old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]],
               "old_device_ms": dev[0], "new_device_ms": dev[1], "old_host_us": host[0],
               "new_host_us": host[1], "max_abs_diff": diff}
        print(f"  {row['case']}: old {t[0]:.4f}/{t[3]:.4f} ms (alone {dev[0]:.4f}, host "
              f"{host[0]:.0f} us), new {t[1]:.4f}/{t[2]:.4f} ms (alone {dev[1]:.4f}, host "
              f"{host[1]:.0f} us); outputs differ by {diff:.3g}", flush=True)
        rows.append(row)
    for weights in ("bf16", "int8"):
        head = hs[weights]
        z, noise = inputs(cfg, 8, 8)
        new = lambda: fused_dit_sample(head, cfg, z, noise, sched, **kw)  # noqa: E731
        with plain_int8():
            plain_ms = timed(lambda: dit_sample_ref(head, cfg, z, noise, sched, **kw), reps=5)
        ms, dev, host = timed(new), device_ms(new, ("dit_sample_kernel",)), host_us(new)
        row = {"case": f"B=8 {weights}", "new_ms": ms, "new_device_ms": dev, "new_host_us": host,
               "plain_ms": plain_ms}
        print(f"  {row['case']}: new {ms:.4f} ms (alone {dev:.4f}, host {host:.0f} us), plain loop "
              f"{plain_ms:.4f} ms", flush=True)
        rows.append(row)
    return {"cases": rows}


def plans(args) -> dict:
    """K2 under its planned k chunks and under other chunks (halved,
    doubled, one a product) at B=1 and B=8,
    bf16 and int8 blocks: each plan's device time a call (torch.profiler)
    and its partial bytes a layer, in the order of the list and back."""
    import dataclasses

    cfg, hs = heads()
    sched = DiffusionSchedule.create(100)
    G = torch.cuda.get_device_properties(0).multi_processor_count
    kw = dict(steps=10, cfg_scale=1.5, sampler="ddim")
    ks = [K // 64 for _, _, K in dit_fused.products(cfg.hidden_size, cfg.mlp_dim)]
    rows_out = []
    for B in (1, 8):
        for weights in ("bf16", "int8"):
            head = hs[weights]
            z, noise = inputs(cfg, B, B)
            pl = dit_fused.plan(2 * B, cfg.chunk_size, cfg.hidden_size, cfg.mlp_dim, G)
            cands = {"planned": pl.chunks,
                     "half": tuple(max(1, c // 2) for c in pl.chunks),
                     "double": tuple(min(k, 2 * c) for c, k in zip(pl.chunks, ks)),
                     "one": (1, 1, 1, 1)}
            cands = {k: v for i, (k, v) in enumerate(cands.items())
                     if v not in list(cands.values())[:i]}
            order = list(cands) + list(reversed(cands))
            times: dict = {}
            for name in order:
                p_ = dataclasses.replace(pl, chunks=cands[name])
                def call(p_=p_):
                    return dit_fused._launch(head, cfg, z, noise, sched, **kw, k2_plan=p_)

                times.setdefault(name, []).append(device_ms(call, ("dit_sample_kernel",)))
            for name, ch in cands.items():
                p_ = dataclasses.replace(pl, chunks=ch)
                row = {"case": f"B={B} {weights}", "plan": name, "chunks": list(ch),
                       "device_ms": times[name],
                       "partial_mb": sum(p_.partial_bytes(cfg.hidden_size, cfg.mlp_dim).values()) / 1e6}
                print(f"  {row['case']} {name} {ch}: {times[name][0]:.4f}/{times[name][1]:.4f} ms "
                      f"alone, partials {row['partial_mb']:.2f} MB a layer", flush=True)
                rows_out.append(row)
    return {"cases": rows_out}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_dit_sampler: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["probe", "ab", "plans"])
    ap.add_argument("--baseline", help="an earlier tree's dexbotic_tpu_torch/csrc")
    ap.add_argument("--out", help="a directory for the JSON result")
    args = ap.parse_args()
    if args.mode == "ab" and not args.baseline:
        ap.error("ab needs --baseline")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    result = {"card": card, "mode": args.mode,
              **{"probe": probe, "ab": ab, "plans": plans}[args.mode](args)}
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"probe_dit_sampler_{args.mode}.json"), "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
