"""Carry JAX parameter trees into the port's modules.

The JAX package stores nested dicts of arrays with ``[in, out]`` linear
weights and layer stacks on a leading axis (``layers`` in the decoder and
the ViT, ``blocks`` in the DiT).  The port's modules use the same names, so a
JAX path maps onto a parameter name by three rules: a stacked subtree is
unstacked into ``<name>.<i>``; a leaf ``w`` becomes ``weight`` (transposed
when 2-D: ``nn.Linear`` is ``[out, in]``), ``b`` becomes ``bias`` and
``embedding`` becomes ``weight``; any other leaf keeps its name.  A tied
embedding has no ``lm_head`` on either side.

An int8-quantized weight (``ops/quant.py``: ``{"q": [..., in, Np], "s":
[..., 1, N]}`` under ``w``, ``{"q": [V, D], "s": [V, 1]}`` under
``embedding``) fills the ``q`` and ``s`` of a ``QuantLinear`` /
``QuantEmbedding``: a linear's ``q`` is transposed to [N, in] with the
zero-padded columns the TPU kernel's tiling added dropped, its ``s`` becomes
[N]; an embedding's pair keeps its layout.

Leaves may be numpy arrays (a JAX tree) or torch tensors (a converted
checkpoint, ``utils/convert.py``, on any device and in the file's dtype).
A converted tree's stacked leaves are lists of the per-layer tensors, not
stacks.  A torch leaf is transposed as a view and copied straight into its
parameter, so a converted tree is never copied again.  A Python list of layer
dicts (OFT's MLPResNet ``blocks``, MemVLA's ``retrieval`` blocks) is no
stack: its items map onto ``<name>.<i>`` as they are.  MemVLA's tree needs
no rule of its own: the bank's roles, gates and timestep embedders and the
DiT's ``xattn`` (a stacked subtree of ``blocks``) follow these.  Nor do the
MoE layers (``nn/moe.py``): the router's [L, H, E] stack unstacks into
``layers.<i>.mlp.router.weight`` ([E, H], transposed like any 2-D ``w``),
and an expert stack [L, E, in, out] into ``layers.<i>.mlp.gate.weight`` [E,
in, out], the JAX layout, kept (a 3-D ``w`` is not transposed).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch import nn

STACKED = ("layers", "blocks")
_RENAME = {"w": "weight", "b": "bias", "embedding": "weight"}


def _leaf(x):
    """A leaf as numpy, or as it is where it is a tensor or a list of the
    per-layer tensors of a stack."""
    if isinstance(x, torch.Tensor) or (isinstance(x, list) and isinstance(x[0], torch.Tensor)):
        return x
    return np.asarray(x)


def _flatten(tree, prefix=()) -> Iterator[tuple[tuple, np.ndarray]]:
    if isinstance(tree, dict) and set(tree) == {"q", "s"} and prefix[-1:] == ("w",):
        # quantized linear: drop the padded columns, which only q carries
        s = _leaf(tree["s"])
        yield prefix + ("q",), _leaf(tree["q"])[..., : s.shape[-1]]
        yield prefix + ("s",), s
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)) and tree and isinstance(tree[0], dict):
        for i, v in enumerate(tree):  # a Python list of layers (OFT's MLPResNet blocks)
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield prefix, _leaf(tree)


def _port_leaves(path: tuple, arr: np.ndarray) -> Iterator[tuple[str, np.ndarray]]:
    """(port parameter name, value in the port's layout) for one JAX leaf."""
    stacked = [i for i, k in enumerate(path)
               if k in STACKED and not (i + 1 < len(path) and path[i + 1].isdigit())]
    if stacked:
        p = stacked[0]
        entries = [(path[: p + 1] + (str(i),) + path[p + 1:], arr[i]) for i in range(len(arr))]
    else:
        entries = [(path, arr)]
    for parts, val in entries:
        leaf = parts[-1]
        if len(parts) > 1 and parts[-2] in ("w", "embedding") and leaf in ("q", "s"):
            if parts[-2] == "w":  # [in, N] -> [N, in]; [1, N] -> [N]
                val = val.T if leaf == "q" else val.reshape(-1)
            yield ".".join(parts[:-2] + (leaf,)), val
            continue
        if leaf == "w" and val.ndim == 2:
            val = val.T
        yield ".".join(parts[:-1] + (_RENAME.get(leaf, leaf),)), val


def port_arrays(tree) -> Iterator[tuple[str, np.ndarray, tuple]]:
    """(port parameter name, value in the port's layout, JAX path) for every
    leaf of a JAX tree (of parameters, or of their gradients)."""
    for path, arr in _flatten(tree):
        for name, val in _port_leaves(path, arr):
            yield name, val, path


def _from_numpy(val: np.ndarray) -> torch.Tensor:
    if val.dtype.name == "bfloat16":  # ml_dtypes' bf16 (a JAX serving tree): same bits
        return torch.from_numpy(np.array(val).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(val))


@torch.no_grad()
def load_jax_params(module: nn.Module, tree) -> dict[str, str]:
    """Fill ``module`` from a JAX parameter tree of numpy arrays or torch tensors.

    Every leaf must land in exactly one parameter and every parameter must be
    filled; values are copied into each parameter's own dtype and device.
    Returns {port parameter name: "/"-joined JAX path}."""
    params = dict(module.named_parameters())
    filled: dict[str, str] = {}
    for name, val, path in port_arrays(tree):
        if name not in params:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no port parameter {name}")
        if name in filled:
            raise KeyError(f"port parameter {name} filled twice")
        p = params[name]
        if tuple(p.shape) != tuple(val.shape):
            raise ValueError(f"{name}: port shape {tuple(p.shape)} != JAX {tuple(val.shape)}")
        p.copy_(val if isinstance(val, torch.Tensor) else _from_numpy(val))
        filled[name] = "/".join(path)
    missing = sorted(set(params) - set(filled))
    if missing:
        raise KeyError(f"port parameters with no JAX leaf: {missing[:8]}")
    return filled
