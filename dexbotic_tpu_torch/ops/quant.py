"""Weight-only int8 quantization for serving (port of dexbotic_tpu/ops/quant.py).

A quantized linear weight is an int8 ``q`` [out, in] and a per-output-channel
scale ``s`` [out] in the weight's own dtype, with ``w ~= q * s``: the port's
``[out, in]`` layout of the JAX ``{"q": [in, out], "s": [1, out]}``.  An
embedding quantizes per row: ``q`` [V, D], ``s`` [V, 1].  ``nn/core.py``
holds the modules (:class:`~dexbotic_tpu_torch.nn.core.QuantLinear`,
:class:`~dexbotic_tpu_torch.nn.core.QuantEmbedding`);
:func:`quantize_model_` swaps them in after a bf16 model is materialised.

The JAX package pads ``q``'s out-dim for the TPU kernel's tiling when asked
(``pad_cols``); the port stores no padded columns: the Hopper kernel masks its
ragged edge (``csrc/quant_matmul.cu``).
"""

from __future__ import annotations

import torch
from torch import nn

from dexbotic_tpu_torch.utils.bridge import STACKED

# Quantize only weights at least this large (JAX: per stacked leaf, see
# quantize_model_); small heads and projections stay exact.
DEFAULT_MIN_SIZE = 1 << 16

# a "w" whose parent key holds one of these is a norm scale, never a matmul operand
_NORM_NAME_MARKERS = ("ln", "norm")


@torch.no_grad()
def quantize_weight(w: torch.Tensor, dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with max-abs scales over ``dim``.

    ``dim=-1`` reduces over a Linear weight's input axis (per output channel)
    and over an embedding's feature axis (per row).  As in JAX: the scale is
    max|w| / 127 in fp32, floored at 1e-12; ``q = clip(round(w / s))`` with the
    fp32 scale, rounding half to even; the scale is stored in ``w``'s dtype.
    Returns (q int8, s with ``dim`` kept as size 1)."""
    s = w.abs().amax(dim=dim, keepdim=True).float() / 127.0
    s = s.clamp_min(1e-12)
    q = torch.round(w.float() / s).clamp_(-127, 127).to(torch.int8)
    return q, s.to(w.dtype)


def dequantize_weight(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q * s in fp32, returned in the scale's dtype ([out] scales broadcast per row)."""
    if s.ndim == 1:
        s = s[:, None]
    return (q.float() * s.float()).to(s.dtype)


def is_quantized(module: nn.Module) -> bool:
    from dexbotic_tpu_torch.nn.core import QuantEmbedding, QuantLinear

    return isinstance(module, (QuantLinear, QuantEmbedding))


def quantized_bytes(model: nn.Module) -> int:
    """Bytes of a (possibly partly quantized) model's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def jax_stack(model: nn.Module, name: str) -> nn.Module | None:
    """The list the JAX tree stacks on a leading axis with the module or
    parameter ``name``: the first ``layers``/``blocks`` ModuleList on its
    path, unless the JAX tree holds it as a Python list (``jax_stacked =
    False``); else None."""
    parts = name.split(".")
    for i, part in enumerate(parts[:-1]):
        if part in STACKED and parts[i + 1].isdigit():
            stack = model.get_submodule(".".join(parts[: i + 1]))
            return stack if getattr(stack, "jax_stacked", True) else None
    return None


def _stack_depth(model: nn.Module, name: str) -> int:
    """Layers stacked with the module ``name`` in the JAX tree (1 where none)."""
    stack = jax_stack(model, name)
    return 1 if stack is None else len(stack)


def _is_norm_name(name: str) -> bool:
    n = name.lower()
    return any(m in n for m in _NORM_NAME_MARKERS)


@torch.no_grad()
def quantize_model_(model: nn.Module, min_size: int = DEFAULT_MIN_SIZE,
                    quantize_embed: bool = True) -> nn.Module:
    """Swap every eligible ``core.Linear`` (and ``nn.Embedding``) of ``model``
    for its int8 counterpart, in place, one module at a time, so that peak
    memory stays near the unquantized model plus one layer.

    Eligibility is the JAX ``quantize_params`` rule on the JAX tree: a
    floating weight of at least ``min_size`` elements, where a layer of a
    stacked ``layers``/``blocks`` list counts the whole stack's elements
    ([L, in, out]); a weight whose module name holds "ln" or "norm" is skipped.
    Biases, norms, positional embeddings and other 1-D or non-matrix
    parameters stay as they are."""
    from dexbotic_tpu_torch.nn.core import Linear, QuantEmbedding, QuantLinear

    for name in [n for n, _ in model.named_modules() if n]:
        mod = model.get_submodule(name)
        parent_name, _, attr = name.rpartition(".")
        if isinstance(mod, Linear):
            if _is_norm_name(attr):
                continue
            make = QuantLinear.from_linear
        elif isinstance(mod, nn.Embedding) and quantize_embed:
            make = QuantEmbedding.from_embedding
        else:
            continue
        w = mod.weight
        if not w.is_floating_point() or w.numel() * _stack_depth(model, name) < min_size:
            continue
        setattr(model.get_submodule(parent_name) if parent_name else model, attr, make(mod))
        del mod, w  # the float weight's last references: freed before the next layer
    return model
