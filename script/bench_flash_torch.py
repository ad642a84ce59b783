"""K1 and K3 of dexbotic_tpu_torch on an H100: an A/B against the build of
an earlier tree's sources (the mma.sync kernels before the wgmma redesign),
K1's block-shape rule, the sweep behind K3's lo parts, and K3's head_dim-256
design against the parent's.

    python script/bench_flash_torch.py ab --baseline DIR
    python script/bench_flash_torch.py rows
    python script/bench_flash_torch.py sweep --draws 100
    python script/bench_flash_torch.py d256 --baseline DIR

``ab``: DIR holds an earlier tree's ``dexbotic_tpu_torch/csrc`` whose
``dbx_flash_fwd``/``dbx_flash_bwd`` take the signatures of the mma.sync
kernels (q pre-scaled, delta and a contiguous dO made by torch in the
wrapper, which ``old_bwd`` repeats).  Both builds load into this process and
each call is timed in the order old, new, new, old (median of 20 calls, CUDA
events around the Python call), then the new kernels' own device time per
call from ``torch.profiler`` (``self_device_time_total``).  ``rows``: K1 with
64-row and 128-row blocks at every shape of the main path.  ``sweep``: K3
built with each choice of lo parts (``-DK3_LO_PARTS``), every gradient's
error against the plain version in fp32 over seeded draws, as a ratio to
chip_smoke's bound (2 x the plain bf16 version's error + 1e-3).  Shapes:
chip_smoke's training case (B=8, S=2048, 32 heads of 128, 1304 live tokens)
and serving's (S=832, 773 live) at B=1, at batch_size=2 and for an 8-frame
request; ``rows`` adds serving at B=4, training's micro-batch of 2 and pi0's
head_dim-256 calls (8 query heads on 1 kv head: the prefix, 816 tokens in
``inference_single`` and 832 served, and the 51-token suffix against it, at
B=1 and batch_size=2).  ``d256``: K3 at pi0's and pi0.5's training calls
(the LIBERO recipes' micro-batch, B=4, 867 and 978 tokens, 8 query heads on
1 kv head of 256), this tree's build against the parent's (DIR: the parent
tree's ``dexbotic_tpu_torch/csrc``, its entry point behind ``ParentK3``, at
dK and dV in separate one-warpgroup blocks): each build's spills and
registers, whether the head_dim-64/128 instances' SASS is the parent's, the
gradients against the plain version in fp32 (as a ratio to chip_smoke's
bound), two calls bitwise equal, which gradients equal the parent's bit for
bit, the time a call in the order parent, new,
new, parent, the kernels' own device time in all and by kernel (pre, tile
classes, dK/dV, the partials' sum, dq), and this tree's dK/dV device time
at every split count (the data behind ``ops/attention.py:bwd_splits``).
Before the head_dim-256 redesign ``d256`` built the old design's
alternatives as text edits of a copy of the source (dK and dV in one
block's two warpgroups, each recomputing S^T; 128-row dq tiles): the
redesign replaced the first, the second spilled, and both went with their
edits.  Each mode prints one JSON
line; ``--out DIR`` also writes it to ``DIR/bench_flash_<mode>.json``.
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
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dexbotic_tpu_torch.kernels import build  # noqa: E402
from dexbotic_tpu_torch.ops import attention as A  # noqa: E402

TRAIN = (8, 2048, 32, 32, 128, 2048 - 1304)  # B, S, Hq, Hkv, D, right padding
SERVE = (1, 832, 32, 32, 128, 59)
SERVE_B2 = (2, 832, 32, 32, 128, 59)  # batch_size=2
SERVE_B4 = (4, 832, 32, 32, 128, 59)  # between the two: where the block rule turns
SERVE_B8 = (8, 832, 32, 32, 128, 59)  # an 8-frame request
TRAIN_B2 = (2, 2048, 32, 32, 128, 2048 - 1304)  # chip_smoke 7a's micro-batch
PI0 = [("pi0_prefix", 1, 816, 816), ("pi0_prefix_served", 1, 832, 832),
       ("pi0_suffix", 1, 51, 867), ("pi0_suffix_served", 1, 51, 883),
       ("pi0_prefix_b2", 2, 832, 832), ("pi0_suffix_b2", 2, 51, 883)]  # label, B, Sq, Skv
K1_KERNELS = ("flash_fwd_kernel", "tile_class_kernel")
K3_KERNELS = ("pre_kernel", "tile_class_kernel", "dkv_kernel", "dkv256_kernel", "dkv_sum_kernel",
              "dq_kernel", "dq256_kernel")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_SIGNATURES = {"dbx_flash_fwd": [_P] * 10 + [_I] * 6 + [_F, _P],
                  "dbx_flash_bwd": [_P] * 14 + [_I] * 6 + [_F, _P]}


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def inputs(case, seed: int):
    B, S, Hq, Hkv, D, pad = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g, device="cuda").bfloat16()
                     for H in (Hq, Hkv, Hkv, Hq))
    valid = torch.ones(B, S, dtype=torch.int32, device="cuda")
    valid[:, S - pad:] = 0
    grp = torch.cumsum(valid, 1, dtype=torch.int32)
    return q, k, v, dout, (grp.clone(), grp, valid)


def pi0_inputs(B: int, Sq: int, Skv: int, seed: int):
    """A pi0 call at head_dim 256: the bidirectional prefix (Sq = Skv) with
    the text's last 26 of 48 tokens padding, or the suffix (state token group
    1, actions group 2) against the cached prefix."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Sq, 8, 256, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(B, Skv, 1, 256, generator=g, device="cuda").bfloat16() for _ in range(2))
    P = Skv if Sq == Skv else Skv - Sq
    valid = torch.ones(B, Skv, dtype=torch.int32, device="cuda")
    valid[:, 768 + 22: P] = 0
    kv_grp = torch.zeros(B, Skv, dtype=torch.int32, device="cuda")
    if Sq < Skv:
        kv_grp[:, P:] = 2
        kv_grp[:, P] = 1
    return q, k, v, (kv_grp[:, Skv - Sq:].contiguous(), kv_grp, valid)


def pi0_train_inputs(B: int, seed: int):
    """pi0's training call: 3 views x 256 image tokens and the text padded
    to 48 (the last 26 padding), bidirectional, then the state token (group
    1) and 50 action tokens (group 2); q, k, v, dO and the int vectors."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    S, prefix = 867, 816
    q, dout = (torch.randn(B, S, 8, 256, generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, 1, 256, generator=g, device="cuda").bfloat16() for _ in range(2))
    valid = torch.ones(B, S, dtype=torch.int32, device="cuda")
    valid[:, 768 + 22: prefix] = 0
    grp = torch.zeros(B, S, dtype=torch.int32, device="cuda")
    grp[:, prefix] = 1
    grp[:, prefix + 1:] = 2
    return q, k, v, dout, (grp.clone(), grp, valid)


def median_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 50) -> float:
    """Host time of one call: the wrapper and the launches, without waiting
    for the device (the queue stays far from full at these sizes)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def device_parts(fn, names, reps: int = 10) -> dict:
    """Each named kernel's own device time per call, from the profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        for n in names:
            if n in e.key:
                t = getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                parts[n] = parts.get(n, 0.0) + t / reps / 1e3
    return parts


def device_ms(fn, names, reps: int = 10, breakdown: bool = True) -> float:
    """The named kernels' own device time per call, from the profiler."""
    parts = device_parts(fn, names, reps)
    if breakdown:
        print(f"  device ms per call by kernel: {parts}", flush=True)
    return sum(parts.values())


def build_variant(csrc: str, name: str, flags=(), signatures=None) -> ctypes.CDLL:
    """K1 and K3 from ``csrc`` into their own library under the build directory."""
    out = os.path.join(build.BUILD_DIR, name)
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"lib{name}.so")
    build.build_library([os.path.join(csrc, f) for f in ("flash_fwd.cu", "flash_bwd.cu")], so,
                        list(flags))
    sig = signatures or {n: build._SIGNATURES[n]
                         for n in ("dbx_flash_fwd", "dbx_flash_bwd", "dbx_flash_tile_classes")}
    return build.bind(so, sig)


def _ptrs(ints):
    return [t.data_ptr() for t in ints] + [None, None]


def old_fwd(lib, q, k, v, ints):
    """The earlier tree's K1 wrapper (the mma.sync kernels)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    ints = [t.to(torch.int32).contiguous() for t in ints]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    code = lib.dbx_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), *_ptrs(ints),
                             out.data_ptr(), lse.data_ptr(), B, Sq, Skv, Hq, Hkv, D, D ** -0.5,
                             torch.cuda.current_stream().cuda_stream)
    build.check(code, "old dbx_flash_fwd")
    return out, lse


def old_bwd(lib, q, k, v, ints, out, lse, g):
    """The earlier tree's K3 wrapper (the mma.sync kernels): q~, a contiguous dO and delta by torch."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    scale = D ** -0.5
    qs = (q.float() * scale).to(torch.bfloat16).contiguous()
    do = g.to(torch.bfloat16).contiguous()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    k, v, lse = k.contiguous(), v.contiguous(), lse.float().contiguous()
    ints = [t.to(torch.int32).contiguous() for t in ints]
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v)
    code = lib.dbx_flash_bwd(qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                             lse.data_ptr(), delta.data_ptr(), *_ptrs(ints), dq.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, Hq, Hkv, D, scale,
                             torch.cuda.current_stream().cuda_stream)
    build.check(code, "old dbx_flash_bwd")
    return dq, dk, dv


def _max_diff(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def ab(args) -> dict:
    old = build_variant(args.baseline, "baseline", signatures=OLD_SIGNATURES)
    res = {}
    for label, case in (("train", TRAIN), ("serve", SERVE)):
        q, k, v, dout, ints = inputs(case, 1)
        f_old = lambda: old_fwd(old, q, k, v, ints)  # noqa: E731
        f_new = lambda: A.flash_attention_fwd(q, k, v, *ints)  # noqa: E731
        out, lse = f_new()
        row = {"k1_diff_to_old": _max_diff(f_old()[:1], (out,)),
               "k1_ms_old_new_new_old": [median_ms(f) for f in (f_old, f_new, f_new, f_old)],
               "k1_device_ms": device_ms(f_new, K1_KERNELS),
               "k1_device_ms_old": device_ms(f_old, K1_KERNELS),
               "k1_host_ms_new_old": [host_ms(f_new), host_ms(f_old)]}
        if label == "train":
            b_old = lambda: old_bwd(old, q, k, v, ints, out, lse, dout)  # noqa: E731
            b_new = lambda: A.flash_attention_bwd(q, k, v, *ints, out, lse, dout)  # noqa: E731
            row["k3_diff_to_old"] = _max_diff(b_old(), b_new())
            row["k3_ms_old_new_new_old"] = [median_ms(f) for f in (b_old, b_new, b_new, b_old)]
            row["k3_device_ms"] = device_ms(b_new, K3_KERNELS)
            row["k3_device_ms_old"] = device_ms(b_old, ("dkv_kernel", "dq_kernel"))
            row["k3_host_ms_new_old"] = [host_ms(b_new), host_ms(b_old)]
        res[label] = row
        print(label, json.dumps(row), flush=True)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return res


def rows(args) -> dict:
    res = {}
    sms = A._sm_count(torch.cuda.current_device())
    for label, case in (("train", TRAIN), ("train_b2", TRAIN_B2), ("serve", SERVE),
                        ("serve_b2", SERVE_B2), ("serve_b4", SERVE_B4), ("serve_b8", SERVE_B8)):
        q, k, v, _, ints = inputs(case, 2)
        B, S, Hq = case[0], case[1], case[2]
        f = {r: (lambda r=r: A._flash_cuda(q, k, v, *ints, case[4] ** -0.5, None, None, rows=r))
             for r in (64, 128)}
        ms = [median_ms(f[r]) for r in (64, 128, 128, 64)]
        res[label] = {"blocks_64": -(-S // 64) * Hq * B, "blocks_128": -(-S // 128) * Hq * B,
                      "sms": sms, "ms_64_128_128_64": ms, "picked": A.fwd_rows(B, S, Hq, sms),
                      "device_ms_64": device_ms(f[64], K1_KERNELS),
                      "device_ms_128": device_ms(f[128], K1_KERNELS)}
        print(label, json.dumps(res[label]), flush=True)
        del q, k, v, ints
    for label, B, Sq, Skv in PI0:
        q, k, v, ints = pi0_inputs(B, Sq, Skv, 3)
        f = {r: (lambda r=r: A._flash_cuda(q, k, v, *ints, 256 ** -0.5, None, None, rows=r))
             for r in (64, 128)}
        ms = [median_ms(f[r]) for r in (64, 128, 128, 64)]
        res[label] = {"blocks_64": -(-Sq // 64) * 8 * B, "blocks_128": -(-Sq // 128) * 8 * B,
                      "sms": sms, "ms_64_128_128_64": ms, "picked": A.fwd_rows(B, Sq, 8, sms, 256),
                      "device_ms_64": device_ms(f[64], K1_KERNELS),
                      "device_ms_128": device_ms(f[128], K1_KERNELS),
                      "host_ms_64": host_ms(f[64])}
        print(label, json.dumps(res[label]), flush=True)
        del q, k, v, ints
    return res


SWEEP_VARIANTS = {7: "all lo parts", 6: "dK and dQ lo (the build's default)", 5: "no dK lo",
                  3: "no dQ lo", 2: "dK lo only", 0: "none"}


def sweep(args) -> dict:
    libs = {}
    for lo in SWEEP_VARIANTS:  # build sequentially: each build runs two nvcc at once
        libs[lo] = build_variant(build.SRC_DIR, f"lo{lo}", [f"-DK3_LO_PARTS={lo}"])
    worst = {lo: [0.0, 0.0, 0.0] for lo in libs}
    over = {lo: 0 for lo in libs}
    scale = TRAIN[4] ** -0.5
    for d in range(args.draws):
        q, k, v, dout, ints = inputs(TRAIN, 1000 + d)
        out, lse = A.flash_attention_fwd(q, k, v, *ints)
        with torch.no_grad():
            ref = A.flash_attention_bwd_ref(q.float(), k.float(), v.float(), *ints, out.float(),
                                            lse, dout.float())
            plain = A.flash_attention_bwd_ref(q, k, v, *ints, out, lse, dout)
            bounds = [2 * (p.float() - r).abs().max().item() + 1e-3 for p, r in zip(plain, ref)]
            del plain
            for lo, lib in libs.items():
                with mock.patch.object(build, "load", return_value=lib):  # this build's K3
                    got = A._flash_bwd_cuda(q, k, v, *ints, out, lse, dout, scale, None, None)
                ratios = [(a.float() - r).abs().max().item() / b for a, r, b in zip(got, ref, bounds)]
                worst[lo] = [max(x, y) for x, y in zip(worst[lo], ratios)]
                over[lo] += max(ratios) > 1.0
        del q, k, v, dout, out, lse, ref
        torch.cuda.empty_cache()
        if d % 10 == 9:
            print(f"draw {d + 1}: worst err/bound (dq, dk, dv) {worst}", flush=True)
    return {"draws": args.draws, "variants": {f"{lo} ({SWEEP_VARIANTS[lo]})":
                                              {"worst_dq_dk_dv": worst[lo], "draws_over": over[lo]}
                                              for lo in libs}}


class ParentK3:
    """An earlier tree's library behind this tree's ``dbx_flash_bwd``
    signature: the entry point before the head_dim-256 split took no
    ``part`` (the 18th argument) and no ``splits`` (after D), both dropped."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def dbx_flash_bwd(self, *a):
        return self.lib.dbx_flash_bwd(*a[:17], *a[18:24], *a[25:])


PARENT_BWD = {"dbx_flash_bwd": [_P] * 17 + [_I] * 6 + [_F] + [ctypes.c_longlong] * 3 + [_P]}
# pi0's and pi0.5's training calls (the LIBERO recipes' micro-batch of 4):
# label, text slots, valid text, suffix (pi0: the state token, then 50 actions)
D256_SHAPES = [("pi0_train", 48, 22, 51), ("pi05_train", 200, 200, 10)]


def d256_inputs(B: int, text: int, n_valid: int, suffix: int, seed: int):
    """A flow VLA's training call at head_dim 256, 8 query heads on 1 kv
    head: 3 views x 256 image tokens and ``text`` slots (the first
    ``n_valid`` valid), bidirectional, then the suffix (pi0: the state token
    in group 1 and the actions in group 2; pi0.5: the actions in group 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    prefix = 768 + text
    S = prefix + suffix
    q, dout = (torch.randn(B, S, 8, 256, generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, 1, 256, generator=g, device="cuda").bfloat16() for _ in range(2))
    valid = torch.ones(B, S, dtype=torch.int32, device="cuda")
    valid[:, 768 + n_valid: prefix] = 0
    grp = torch.zeros(B, S, dtype=torch.int32, device="cuda")
    grp[:, prefix:] = 1
    if suffix == 51:
        grp[:, prefix + 1:] = 2
    return q, k, v, dout, (grp.clone(), grp, valid)


def build_spills(name: str, pattern: str) -> dict:
    """Registers and spill bytes of each kernel whose mangled name matches
    ``pattern`` in a build's nvcc output (``-Xptxas -v``)."""
    with open(os.path.join(build.BUILD_DIR, name, "build.log")) as f:
        log = f.read()
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(pattern, m.group(1))
            entry = None
            if k:
                args = re.findall(r"Li(\d+)E", m.group(1))
                entry = k.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif entry and "spill stores" in line:
            out[entry] = {"spill_bytes": sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))}
        elif entry and "Used" in line and "registers" in line:
            out[entry]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            entry = None
    return out


def sass_by_instance(so: str) -> dict:
    """``cuobjdump -sass`` of a library, per K3 kernel at head dims 64 and
    128 (keyed by name, D, warpgroups, stages), the instructions with their
    addresses and encodings dropped."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool if os.path.exists(tool) else "cuobjdump", "-sass", so],
                          capture_output=True, text=True, check=True).stdout
    out, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*?(dkv_kernel|dq_kernel)I((?:Li\d+E)+)E", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2))[:3]
            key = f"{m.group(1)}<{', '.join(args)}>" if args[0] in ("64", "128") else None
            if key:
                out[key] = []
        elif "Function :" in line:
            key = None
        elif key:
            ins = re.sub(r"/\*[0-9a-fx]+\*/", "", line).split(";")[0].strip()
            if ins:
                out[key].append(ins)
    return out


def d256(args) -> dict:
    """K3 at head_dim 256: this tree's design against the parent's (built
    from ``--baseline DIR``, its ``csrc``) at pi0's and pi0.5's training
    calls, then this tree's dK/dV time at every split count."""
    from concurrent.futures import ThreadPoolExecutor

    if not args.baseline:
        raise SystemExit("d256 needs --baseline DIR (the parent tree's dexbotic_tpu_torch/csrc)")
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source and build
        new, old = pool.map(lambda a: build_variant(*a), [
            (build.SRC_DIR, "d256_new"), (args.baseline, "d256_parent", (), {
                **{n: build._SIGNATURES[n] for n in ("dbx_flash_fwd", "dbx_flash_tile_classes")},
                **PARENT_BWD})])
    libs = {"parent": ParentK3(old), "new": new}
    kernels = r"(dkv_kernel|dkv256_kernel|dkv_sum_kernel|dq_kernel|dq256_kernel)"
    res = {"spills": {label: build_spills(f"d256_{label}", kernels) for label in libs}}
    sass = {label: sass_by_instance(lib._name if label == "new" else lib.lib._name)
            for label, lib in libs.items()}
    res["d64_d128_sass_equal"] = {k: sass["new"].get(k) == v for k, v in sass["parent"].items()}
    print("spills", json.dumps(res["spills"]), "sass equal", res["d64_d128_sass_equal"], flush=True)
    scale = 256 ** -0.5
    sms = A._sm_count(torch.cuda.current_device())
    for label, text, n_valid, suffix in D256_SHAPES:
        q, k, v, dout, ints = d256_inputs(4, text, n_valid, suffix, 5)
        out, lse = A.flash_attention_fwd(q, k, v, *ints)
        with torch.no_grad():
            ref = A.flash_attention_bwd_ref(q.float(), k.float(), v.float(), *ints, out.float(),
                                            lse, dout.float())
            plain = A.flash_attention_bwd_ref(q, k, v, *ints, out, lse, dout)
            bounds = [2 * (p.float() - r).abs().max().item() + 1e-3 for p, r in zip(plain, ref)]
        del plain

        def call(which, splits=None):
            with mock.patch.object(build, "load", return_value=libs[which]):  # this build's K3
                return A._flash_bwd_cuda(q, k, v, *ints, out, lse, dout, scale, None, None,
                                         splits=1 if which == "parent" else splits)

        row = {"B_S_Hq_Hkv_D": [4, q.shape[1], 8, 1, 256],
               "splits_rule": A.bwd_splits(4, q.shape[1], q.shape[1], 8, 1, sms)}
        for which in libs:
            got = call(which)
            row[which] = {
                "err_over_bound_dq_dk_dv": [(a.float() - r).abs().max().item() / b
                                            for a, r, b in zip(got, ref, bounds)],
                "deterministic": all(torch.equal(a, b) for a, b in zip(got, call(which))),
                "ms": []}
            parts = device_parts(lambda w=which: call(w), K3_KERNELS)
            row[which]["device_ms"] = sum(parts.values())
            row[which]["device_ms_by_kernel"] = parts  # pre, classes, dK/dV, the sum, dq
        for which in ("parent", "new", "new", "parent"):
            row[which]["ms"].append(median_ms(lambda w=which: call(w)))
        parent = call("parent")  # (dq, dk, dv) bit for bit: at the rule's split count and at 1
        row["equal_to_parent_dq_dk_dv"] = {
            str(G): [torch.equal(a, b) for a, b in zip(call("new", G), parent)]
            for G in (row["splits_rule"], 1)}
        row["splits_device_ms"] = {  # this tree's dK/dV and its sum at each split count
            G: device_ms(lambda G=G: call("new", G), ("dkv256_kernel", "dkv_sum_kernel"),
                         breakdown=False) for G in range(1, A.BWD_MAX_SPLITS + 1)}
        res[label] = row
        print(label, json.dumps(row), flush=True)
        del q, k, v, dout, out, lse, ref
        torch.cuda.empty_cache()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("ab", "rows", "sweep", "d256"))
    ap.add_argument("--baseline", help="an earlier tree's dexbotic_tpu_torch/csrc (ab)")
    ap.add_argument("--draws", type=int, default=100)
    ap.add_argument("--out", help="a directory for the JSON result")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    modes = {"ab": ab, "rows": rows, "sweep": sweep, "d256": d256}
    res = {"card": card, "mode": args.mode, **modes[args.mode](args)}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"bench_flash_{args.mode}.json"), "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
