"""dexbotic_tpu_torch: the PyTorch/CUDA port of dexbotic_tpu.

Mirrors the JAX package's layout (``nn/``, ``ops/``, ``models/``, ``exp/``)
so each module's counterpart has the same relative path.  The JAX package
stays the reference; this package imports ``torch`` and never ``jax``.
Kernels written by hand for Hopper live in ``csrc/`` and are built at first
use by ``kernels/build.py``.
"""

from dexbotic_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX  # noqa: F401
