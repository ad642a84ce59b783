"""The port imports torch and never jax, and builds nothing when imported."""

import os
import pkgutil
import re
import subprocess
import sys

import dexbotic_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(dexbotic_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG], "dexbotic_tpu_torch."))


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises ImportError
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_no_jax_in_the_sources():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pat.search(fh.read()), f


def test_kernel_modules_import_without_nvcc_or_gpu():
    from dexbotic_tpu_torch.kernels import build
    from dexbotic_tpu_torch.ops import attention, dit_fused  # noqa: F401

    assert build.LIBRARY._lib is None  # nothing was built or loaded by importing
    assert sorted(os.listdir(os.path.join(PKG, "csrc"))) == ["dit_sampler.cu", "flash_bwd.cu",
                                                             "flash_fwd.cu"]
