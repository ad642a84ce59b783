"""The port imports torch, never jax nor the JAX package, and builds nothing when imported."""

import os
import pkgutil
import re
import subprocess
import sys

import dexbotic_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(dexbotic_tpu_torch.__file__)


def _modules():
    """The port's modules (its playground recipes included) and the port's
    scripts (``script/*_torch.py``)."""
    scripts = sorted("script." + f[:-3] for f in os.listdir(os.path.join(REPO, "script"))
                     if f.endswith("_torch.py"))
    return sorted(m.name for m in pkgutil.walk_packages([PKG], "dexbotic_tpu_torch.")) + scripts


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises ImportError
        "sys.modules['dexbotic_tpu'] = None\n"  # and so does any import of the JAX package
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert sys.modules['jax'] is None and sys.modules['dexbotic_tpu'] is None\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_no_jax_in_the_sources():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    for path in _sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def _sources():
    for root, _, files in os.walk(PKG):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")
    script = os.path.join(REPO, "script")
    yield from (os.path.join(script, f) for f in sorted(os.listdir(script))
                if f.endswith("_torch.py"))


def test_new_entry_points_are_covered():
    """The LIBERO recipe twins, the OFT, hybrid, loader, RL (sim envs, the RL
    dataset, GRPO, the SimpleVLA-RL exp), MemVLA, decode engine, Discrete
    VLA, MUVLA and PE-ViT modules, the example recipes and the replay script
    are among the modules imported with JAX blocked and scanned above."""
    names = _modules()
    for recipe in ("cogact", "pi0", "pi05", "dm0", "oft", "oft_discrete", "simplevla_rl",
                   "memvla"):
        assert f"dexbotic_tpu_torch.playground.benchmarks.libero.libero_{recipe}" in names
    for module in ("models.oft", "exp.oft_exp", "exp.hybrid_cogact_exp", "data.loader",
                   "sim_envs.base", "sim_envs.factory", "sim_envs.libero_env",
                   "data.dex_rl_dataset", "exp.rl.grpo", "exp.rl.rl_trainer",
                   "exp.simplevla_rl_exp", "models.memvla", "exp.memvla_exp",
                   "exp.decode_engine", "models.discrete_vla", "exp.discrete_vla_exp",
                   "models.muvla", "exp.muvla_exp", "nn.pe_vit",
                   "playground.example_muvla_exp", "playground.example_navila_exp"):
        assert f"dexbotic_tpu_torch.{module}" in names
    assert "script.replay_checkpoint_torch" in names
    assert os.path.join(REPO, "script", "replay_checkpoint_torch.py") in set(_sources())


def test_playground_twins_are_covered():
    """The twins of the JAX package's entry files (the CALVIN, ManiSkill2,
    RoboTwin2.0 and SimplerEnv recipes, the examples, the success-rate
    harness, the SO-101 example and bridge) are among the modules imported
    with JAX blocked and scanned above."""
    names = _modules()
    twins = ["benchmarks.calvin.calvin_cogact", "benchmarks.calvin.calvin_oft",
             "benchmarks.maniskill2.maniskill2_cogact", "benchmarks.maniskill2.maniskill2_oft",
             "benchmarks.maniskill2.maniskill2_pi0", "benchmarks.robotwin2.robotwin2_cogact",
             "benchmarks.simpler.simpler_cogact", "benchmarks.simpler.simpler_memvla",
             "benchmarks.simpler.simpler_oft", "eval_server", "example_exp",
             "example_memvla_exp", "so101_inference_example", "so101.bridge_server"]
    for twin in twins:
        assert f"dexbotic_tpu_torch.playground.{twin}" in names, twin


def test_parallel_layer_is_covered():
    """The parallel layer (launch contract, mesh, FSDP2 and tensor parallelism)
    is among the modules imported with JAX blocked and scanned above, and
    imports no distributed machinery it does not need when imported."""
    names = _modules()
    for module in ("parallel", "parallel.multihost", "parallel.mesh"):
        assert f"dexbotic_tpu_torch.{module}" in names, module
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['dexbotic_tpu'] = None\n"
            "import dexbotic_tpu_torch.parallel.mesh, dexbotic_tpu_torch.parallel.multihost\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_no_jax_package_in_the_sources():
    """No line of the port or of chip_smoke.py imports dexbotic_tpu (the port's
    own dexbotic_tpu_torch is fine)."""
    pat = re.compile(r"^\s*(import dexbotic_tpu|from dexbotic_tpu)(\.|\s|$)", re.M)
    for path in _sources():
        with open(path) as fh:
            found = pat.findall(fh.read())
        assert not found, (path, found)


def test_kernel_modules_import_without_nvcc_or_gpu():
    from dexbotic_tpu_torch.kernels import build
    from dexbotic_tpu_torch.ops import attention, dit_fused, quant_matmul  # noqa: F401

    assert build.LIBRARY._lib is None  # nothing was built or loaded by importing
    csrc = os.path.join(PKG, "csrc")
    assert sorted(os.listdir(csrc)) == ["dit_sampler.cu", "flash_bwd.cu", "flash_fwd.cu",
                                        "hopper.cuh", "host", "quant_matmul.cu"]
    # host code (g++, built into _build/ by data/fast_image.py), outside the kernels' hash
    assert os.listdir(os.path.join(csrc, "host")) == ["fast_image.cpp"]
    assert all(os.path.dirname(p) == csrc for p in build.LIBRARY._sources())


def test_memvla_training_and_navila_modules_are_covered():
    """MemVLA training's schedules and NaVILA's modules (the model, generate,
    the losses, the dataset, the exp, the example recipe) are among the
    modules imported with JAX blocked and scanned above."""
    names = _modules()
    for module in ("exp.mem_trainer", "models.navila", "models.generate", "models.losses",
                   "data.dex_navila_dataset", "exp.navila_exp", "nn.projector",
                   "playground.example_navila_exp"):
        assert f"dexbotic_tpu_torch.{module}" in names
