"""K4's function at the row counts the port now gives it, against the JAX
package, and the pure-Python parts of K4: its planner and the split of fp32
activations into bf16 parts.

The port's quant_linear (on the CPU: the plain version, the dequantize
formulation K4 replaces) against JAX's quant_linear with interpret=True,
which runs the Pallas kernel at any M, and against JAX's dequantize
formulation.  M from 1 to 300 (past JAX's TPU guard of 64), K = 128/256, a
ragged N = 200, inputs from numpy seeds.  Tolerances: fp32 2e-5 (the JAX
kernel test's); bf16 one bf16 ulp of the output (2^-7 |ref|): the two sides
round the product once or twice (the kernel rounds acc * s once; the
dequantize formulation rounds x @ q and then the scaling).
"""

import importlib.util
import os

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch
from torch import nn

from dexbotic_tpu.ops import quant as jquant
from dexbotic_tpu.ops import quant_matmul as jqm
from dexbotic_tpu_torch.nn import core as tcore
from dexbotic_tpu_torch.ops import quant_matmul as tqm
from dexbotic_tpu_torch.utils.bridge import load_jax_params

torch.set_num_threads(2)


def _chip_smoke_cases():
    """chip_smoke.py phase 4c's (layer, M, K, N) cases."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.K4_CASES


K4_CASES = _chip_smoke_cases()


def _quant_module(jp, N: int, K: int):
    m = nn.Module()
    m.lin = tcore.QuantLinear(torch.zeros(N, K, dtype=torch.int8), torch.zeros(N), None)
    load_jax_params(m, {"lin": jp})
    return m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K", [(1, 128), (64, 256), (65, 128), (130, 256), (300, 128)])
def test_quant_linear_matches_jax_at_k4_rows(M, K, dtype):
    rng = np.random.default_rng(M * 1000 + K)
    N = 200
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jp = jax.device_get({"w": jquant.quantize_weight(jnp.asarray(w), pad_cols=True)})
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    xj = jnp.asarray(x).astype(jdt)
    refs = {"pallas kernel": jqm.quant_linear(jp, xj, interpret=True),
            "dequantize formulation": jqm.quant_linear(jp, xj)}
    m = _quant_module(jp, N, K)
    xt = torch.from_numpy(x).to(tdt)
    n0 = tqm.quant_matmul.launches
    with torch.no_grad():
        got = m.lin(xt)
        plain = tqm.quant_matmul_ref(xt, m.lin.q, m.lin.s.to(tdt))
    assert tqm.quant_matmul.launches == n0 and got.dtype == tdt and got.shape == (M, N)
    assert torch.equal(got, plain)  # a CPU tensor takes the plain version
    got = got.float().numpy()
    for name, ref in refs.items():
        ref = np.asarray(ref.astype(jnp.float32))
        assert ref.shape == (M, N), name
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0, err_msg=name)
        else:
            assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6), name


@pytest.mark.parametrize("name,M,K,N", K4_CASES, ids=[f"{c[0]} M={c[1]}" for c in K4_CASES])
def test_quant_matmul_plan_at_every_chip_smoke_shape(name, M, K, N):
    """The planner's tile, split and grid for every shape chip_smoke times:
    the grid covers M and N with no empty tile, the splits cut K's steps
    into non-empty ranges as the kernel cuts them, the tiles are instances."""
    p = tqm.plan(M, K, N)
    steps = K // tqm._K_STEP
    assert p.rows % 8 == 0 and 8 <= p.rows <= 256 and p.rows in tqm._FEW_ROWS + tqm._MANY_ROWS
    assert p.channels == (64 if p.rows in tqm._FEW_ROWS else 128)
    rt, ct, sp = p.grid
    assert (rt - 1) * p.rows < M <= rt * p.rows and (ct - 1) * p.channels < N <= ct * p.channels
    assert sp == p.splits and 1 <= sp <= steps
    assert sp == 1 or steps // sp >= tqm._MIN_K_STEPS
    cuts = [i * steps // sp for i in range(sp + 1)]  # csrc/quant_matmul.cu:qm_kernel's kb0
    assert cuts[0] == 0 and cuts[-1] == steps and all(a < b for a, b in zip(cuts, cuts[1:]))
    if M <= tqm._FEW_ROWS[-1]:
        assert rt == 1  # one tile covers every row of the weight stream


def test_split_bf16x3_reconstructs_fp32():
    """hi + mid + lo: each part a bf16 value (hi the bf16 rounding of x, each
    later part that of what the parts before it left), summing to x within
    2^-24 |x|, across twelve decades."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32)
    xt = torch.from_numpy(x)
    parts = tqm.split_bf16x3_ref(xt)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, 4096)
    assert torch.equal(parts[0], xt.to(torch.bfloat16))
    assert torch.equal(parts[1], (xt - parts[0].float()).to(torch.bfloat16))
    recon = parts.double().sum(0).numpy()
    assert np.all(np.abs(recon - x.astype(np.float64)) <= 2.0 ** -24 * np.abs(x))
