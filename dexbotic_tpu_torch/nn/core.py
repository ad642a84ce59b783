"""Minimal NN primitives (port of dexbotic_tpu/nn/core.py).

Layers are ``nn.Module``s whose parameter names follow the JAX parameter
tree (``utils/bridge.py`` maps one onto the other).  Every layer computes in
the dtype of its input, as the JAX ``core.linear`` does (``x @ w.astype(x.dtype)``):
bf16 serving weights under an fp32 input run in fp32.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from dexbotic_tpu_torch.ops import norms
from dexbotic_tpu_torch.ops.quant import jax_stack, quantize_weight
from dexbotic_tpu_torch.ops.quant_matmul import quant_linear


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": F.gelu,  # exact erf
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "quick_gelu": _quick_gelu,
}


class Linear(nn.Linear):
    """``nn.Linear`` that casts its weight and bias to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class QuantLinear(nn.Module):
    """Weight-only int8 ``Linear`` (the JAX ``{"w": {"q", "s"}}`` linear):
    ``q`` int8 [out, in] and per-output-channel scales ``s`` [out] in the
    original weight's dtype; ``forward`` is ``ops/quant_matmul.quant_linear``."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, bias: nn.Parameter | None):
        super().__init__()
        self.out_features, self.in_features = q.shape
        self.q = nn.Parameter(q, requires_grad=False)
        self.s = nn.Parameter(s, requires_grad=False)
        self.bias = bias

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "QuantLinear":
        q, s = quantize_weight(lin.weight.detach())
        return cls(q, s[:, 0], lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant_linear(x, self.q, self.s, self.bias)


class QuantEmbedding(nn.Module):
    """Weight-only int8 embedding table, per-row scales: ``q`` int8 [V, D],
    ``s`` [V, 1] in the original table's dtype (read by :func:`embed` and the
    tied ``nn/transformer.lm_logits``)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.num_embeddings, self.embedding_dim = q.shape
        self.q = nn.Parameter(q, requires_grad=False)
        self.s = nn.Parameter(s, requires_grad=False)

    @classmethod
    def from_embedding(cls, emb: nn.Embedding) -> "QuantEmbedding":
        return cls(*quantize_weight(emb.weight.detach()))


def weight_dtype(mod: nn.Module) -> torch.dtype:
    """The dtype a layer's weight is served in (a quantized layer's: its scales')."""
    return mod.s.dtype if isinstance(mod, (QuantLinear, QuantEmbedding)) else mod.weight.dtype


def cast_like_jax_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """The JAX package's bf16 dtype rule, on the JAX tree: fp32 leaves with
    ndim >= 2 -> ``dtype``.  One predicate serves both of its sites, the
    Trainer's ``bf16`` (``dexbotic_tpu/exp/trainer.py:99-105``) and serving
    (``BaseExp.prepare_inference_params``).  A layer of a list the JAX tree
    stacks on a leading axis (``ops/quant.jax_stack``) has one dim more
    there, so its norm scales and biases are cast as JAX casts their [L, D]
    stacks; a list JAX keeps as a Python list (``jax_stacked = False``) and
    every other 1-D or 0-d parameter stay fp32."""
    for name, p in model.named_parameters():
        ndim = p.ndim + (jax_stack(model, name) is not None)
        if p.dtype == torch.float32 and ndim >= 2:
            p.data = p.data.to(dtype)
    return model


# the matmul outputs a "dots" remat keeps (jax.checkpoint_policies.dots_saveable)
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def local(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's (DTensor's) local shard, which in-place writes
    reach; any other tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def remat_call(fn, remat, *args):
    """``fn(*args)`` under the JAX ``remat`` flag of one layer.

    False runs it plainly; True recomputes the layer in the backward pass
    (``jax.checkpoint``: non-reentrant ``torch.utils.checkpoint``); "dots"
    keeps every matmul output and recomputes only the elementwise chain."""
    if remat == "dots":
        return ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy))
    if remat:
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def embed(mod: nn.Module, ids: torch.Tensor) -> torch.Tensor:
    if isinstance(mod, QuantEmbedding):  # rows of q, times their scales, in the scales' dtype
        return mod.q[ids].to(mod.s.dtype) * mod.s[ids]
    return mod(ids)  # the module's call, where tensor parallelism hooks in


class GatedMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int, use_bias: bool = False):
        super().__init__()
        self.gate = Linear(hidden, intermediate, use_bias)
        self.up = Linear(hidden, intermediate, use_bias)
        self.down = Linear(intermediate, hidden, use_bias)

    def forward(self, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
        return self.down(ACTIVATIONS[act](self.gate(x)) * self.up(x))


class MLP(nn.Module):
    """Plain MLP: dims = [in, h1, ..., out], layers named fc0, fc1, ..."""

    def __init__(self, dims: list[int], use_bias: bool = True):
        super().__init__()
        self.n = len(dims) - 1
        for i in range(self.n):
            setattr(self, f"fc{i}", Linear(dims[i], dims[i + 1], use_bias))

    def forward(self, x: torch.Tensor, act: str = "gelu") -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n - 1:
                x = ACTIVATIONS[act](x)
        return x


# ---------------------------------------------------------------------------
# Seeded initialisation (the JAX init's distributions, drawn from a
# torch.Generator; the numbers differ from jax.random's)
# ---------------------------------------------------------------------------


@torch.no_grad()
def torch_linear_init_(mod: nn.Linear, gen: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias."""
    lim = 1.0 / math.sqrt(mod.in_features)
    mod.weight.uniform_(-lim, lim, generator=gen)
    if mod.bias is not None:
        mod.bias.uniform_(-lim, lim, generator=gen)


@torch.no_grad()
def xavier_init_(mod: nn.Linear, gen: torch.Generator) -> None:
    """Xavier-uniform weight, zero bias (the DiT blocks' init)."""
    lim = math.sqrt(6.0 / (mod.in_features + mod.out_features))
    mod.weight.uniform_(-lim, lim, generator=gen)
    if mod.bias is not None:
        mod.bias.zero_()


@torch.no_grad()
def normal_init_(t: torch.Tensor, gen: torch.Generator, std: float = 0.02) -> None:
    t.normal_(0.0, std, generator=gen)


def init_linears_(module: nn.Module, gen: torch.Generator) -> None:
    """torch_linear_init_ for every Linear inside ``module``."""
    for m in module.modules():
        if isinstance(m, Linear):
            torch_linear_init_(m, gen)


@torch.no_grad()
def reset_norms_(module: nn.Module) -> None:
    """Norm scales to their identity (1, or 0 under a weight offset), biases to 0."""
    for m in module.modules():
        if isinstance(m, norms.RMSNorm):
            m.weight.fill_(0.0 if m.weight_offset else 1.0)
        elif isinstance(m, norms.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
