"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

``nvcc`` compiles every ``.cu`` file of ``dexbotic_tpu_torch/csrc`` to an
object, one process per source, all started together, and links the objects
into one shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds rather than minutes).  The library's name
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded from ``dexbotic_tpu_torch/_build/``.  Nothing here
runs at import time: the first kernel launch builds.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C signatures of the entry points (see the .cu files).
_SIGNATURES = {
    # q, k, v, q_grp, kv_grp, kv_valid, q_seg, kv_seg, o, lse, cls,
    # B, Sq, Skv, Hq, Hkv, D, scale, rows, stream
    "dbx_flash_fwd": [_P] * 11 + [_I] * 6 + [_F, _I, _P],
    # q_grp, kv_grp, kv_valid, q_seg, kv_seg, cls, B, Sq, Skv, stream
    "dbx_flash_tile_classes": [_P] * 6 + [_I] * 3 + [_P],
    # bf16?, int8?, coef, cond, x0, pos, xw, xb, fw, fb, wqkv, sqkv, bqkv, wo, so,
    # bo, w0, s0, b0, w1, s1, b1, out, h, hn, qkv, attn, m, x, xp, part,
    # B, T, A, H, heads, M, depth, N, RP, cfg_pair, cfg_scale, sampler, bn, nt,
    # the k chunks of qkv, o, fc0, fc1, probe, stream
    "dbx_dit_sample": [_I, _I] + [_P] * 29 + [_I] * 10 + [_F, _I] + [_I] * 6 + [_P, _P],
    # q, k, v, out, dout, lse, q_grp, kv_grp, kv_valid, q_seg, kv_seg, dq, dk,
    # dv, q~ (scratch), delta (scratch), cls (scratch), part (scratch), B, Sq,
    # Skv, Hq, Hkv, D, splits, scale, dout's element strides (b, s, h), stream
    "dbx_flash_bwd": [_P] * 18 + [_I] * 7 + [_F] + [_L] * 3 + [_P],
    # bf16?, x, q, s, out, part (fp32 partials), xs (bf16 parts of fp32 x),
    # M, N, K, rows (x rows a block), splits, stream
    "dbx_quant_matmul": [_I] + [_P] * 6 + [_I] * 5 + [_P],
}


class _Library:
    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.build_seconds = None  # wall time of the build in this process
        self.build_log = ""
        self.path = None  # the loaded library

    def _sources(self) -> list[str]:
        return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                      + glob.glob(os.path.join(SRC_DIR, "*.cuh")))

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
        for path in self._sources():
            h.update(os.path.basename(path).encode())
            with open(path, "rb") as f:
                h.update(f.read())
        return h.hexdigest()[:16]

    def _nvcc(self) -> str:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(cuda_home, "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else shutil.which("nvcc")
        if nvcc is None:
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
        return nvcc

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self) -> ctypes.CDLL:
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libdexbotic_kernels_{self._digest()}.so")
        if not os.path.exists(so):
            t0 = time.perf_counter()
            self.build_log = build_library([s for s in self._sources() if s.endswith(".cu")], so)
            self.build_seconds = time.perf_counter() - t0
        self.path = so
        return bind(so)


def build_library(sources: list[str], so: str, extra_flags=()) -> str:
    """nvcc each source to an object (all started together), link them into
    ``so``; returns nvcc's output (``-Xptxas -v``), also written to
    ``build.log`` beside ``so``.  Raises if a step fails."""
    out_dir = os.path.dirname(so)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, f"{os.path.basename(s)}.{tag}.o") for s in sources]
    nvcc = LIBRARY._nvcc()
    flags = [*NVCC_FLAGS, *extra_flags]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", o, s], text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for s, o in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [s for s, p in zip(sources, procs) if p.returncode != 0]
    if not failed:
        r = subprocess.run([nvcc, *LINK_FLAGS, "-o", f"{so}.{tag}", *objs],
                           capture_output=True, text=True)
        logs.append(r.stdout + r.stderr)
        if r.returncode != 0:
            failed = ["link"]
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    log = "\n".join(logs)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    os.replace(f"{so}.{tag}", so)
    return log


def bind(so: str, signatures: dict | None = None) -> ctypes.CDLL:
    """Load ``so`` and set the C signatures of its entry points."""
    lib = ctypes.CDLL(so)
    for name, argtypes in (signatures or _SIGNATURES).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


LIBRARY = _Library()


def load() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` at first use."""
    return LIBRARY.get()


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
