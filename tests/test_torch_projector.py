"""The port's ``linear{N}x`` projector against the JAX package, on the CPU in fp32.

``nn/projector.py`` builds the type as JAX's ``init_projector`` does (a
bias-free ``fc`` of ``mm_hidden * N -> hidden``) and applies it as
``apply_projector`` (``fc`` on features of that width), on the JAX test's
shapes (tests/test_vit_projector.py); a released ``linear4x`` projector goes
through ``utils/convert.convert_projector`` into the port's module.  The
JAX package's VLM hands a projector features of width ``mm_hidden``, so
neither package concatenates features for it.  Tolerance 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from dexbotic_tpu.nn import projector as jproj
from dexbotic_tpu.utils import convert as jconvert
from dexbotic_tpu_torch.nn import projector as tproj
from dexbotic_tpu_torch.utils import convert as tconvert
from dexbotic_tpu_torch.utils.bridge import load_jax_params

TOL = 1e-5


@pytest.mark.parametrize("ptype,mult", [("linear2x", 2), ("linear4x", 4)])
def test_linear_nx_projector_matches_jax(ptype, mult):
    mm_h, h = 24, 40
    params = jax.device_get(jproj.init_projector(jax.random.PRNGKey(0), ptype, mm_h, h))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 8, mm_h * mult)))
    want = np.asarray(jproj.apply_projector(params, x, ptype))
    proj = tproj.Projector(ptype, mm_h, h)
    assert dict((n, tuple(p.shape)) for n, p in proj.named_parameters()) == {
        "fc.weight": (h, mm_h * mult)}  # bias-free, as JAX's
    load_jax_params(proj, params)
    got = tproj.apply_projector(proj, torch.from_numpy(x), ptype)
    assert got.shape == (2, 8, h)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)


def test_converted_linear4x_projector_serves_in_the_port():
    """A released linear4x projector (a bare bias-free nn.Linear): both
    packages' converters give the same tree, which fills the port's module,
    whose output is the JAX projector's on that tree."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((40, 96)).astype(np.float32)
    sd = {"mm_projector.weight": w}
    jtree = jax.device_get(jconvert.convert_projector(sd, "linear4x"))
    ttree = tconvert.convert_projector({"mm_projector.weight": torch.from_numpy(w)}, "linear4x")
    proj = tproj.Projector("linear4x", 24, 40)
    load_jax_params(proj, ttree)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    got = tproj.apply_projector(proj, torch.from_numpy(x), "linear4x").detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jproj.apply_projector(jtree, x, "linear4x")),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, x @ w.T, rtol=TOL, atol=TOL)


def test_unknown_projector_type_is_refused():
    with pytest.raises(ValueError, match="unknown projector type"):
        tproj.Projector("linear0y", 24, 40)
    with pytest.raises(ValueError, match="Unknown projector type"):
        jproj.init_projector(jax.random.PRNGKey(0), "linear0y", 24, 40)
