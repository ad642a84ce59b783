"""Seeded weights, made by the benchmark and handed alike to the program and
to the plain reference.

A configuration's reference lists its leaves as an inventory of
``Leaf(name, shape, mean, std)`` in the program's parameter names.  The
values are one stream of standard normals drawn on the device from the
seed by a ``torch.Generator``, in large bf16 calls, cut into the leaves in
inventory order: leaf = bf16(mean + std * z).  Every value is thus a bf16
number, the type the weights are served in, and a leaf the program keeps in
fp32 holds the same value exactly.  The reference draws the same stream
again after the window, so neither side takes weights from the other.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

CHUNK = 1 << 28  # elements a draw (512 MiB of bf16)


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    mean: float
    std: float

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def matrix(name: str, shape: tuple, fan_in: int | None = None) -> Leaf:
    """A weight of a linear layer: the variance of U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    fan_in = fan_in or shape[-1]
    return Leaf(name, tuple(shape), 0.0, 1.0 / math.sqrt(3.0 * fan_in))


def small(name: str, shape: tuple, std: float = 0.02) -> Leaf:
    """An embedding, a bias, a position table or a learned token."""
    return Leaf(name, tuple(shape), 0.0, std)


def scale(name: str, shape: tuple) -> Leaf:
    """A norm's scale: 1 with a spread, so that the scale is exercised."""
    return Leaf(name, tuple(shape), 1.0, 0.02)


class Stream:
    """The seed's normals, handed out in order, drawn CHUNK at a time."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.device = torch.device(device)
        self.buf = torch.empty(0, dtype=torch.bfloat16, device=self.device)
        self.pos = 0

    def take(self, n: int) -> torch.Tensor:
        parts = []
        while n > 0:
            if self.pos == self.buf.numel():
                self.buf = torch.randn(CHUNK, generator=self.gen, dtype=torch.bfloat16,
                                       device=self.device)
                self.pos = 0
            k = min(n, self.buf.numel() - self.pos)
            parts.append(self.buf[self.pos: self.pos + k])
            self.pos += k
            n -= k
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def leaves(inventory, seed: int, device):
    """Yield (leaf, bf16 tensor on ``device``) in inventory order."""
    stream = Stream(seed, device)
    for leaf in inventory:
        z = stream.take(leaf.numel).float()
        yield leaf, (z * leaf.std + leaf.mean).to(torch.bfloat16).reshape(leaf.shape)


@torch.no_grad()
def fill_(model: torch.nn.Module, inventory, seed: int) -> None:
    """Copy the seed's weights into ``model``'s parameters by name.  The
    program's parameters must be exactly the inventory's, name and shape."""
    params = dict(model.named_parameters())
    names = [leaf.name for leaf in inventory]
    missing, extra = sorted(set(names) - set(params)), sorted(set(params) - set(names))
    if missing or extra:
        raise KeyError(f"the program's parameters differ from the inventory: missing {missing[:5]}, "
                       f"not listed {extra[:5]}")
    device = next(iter(params.values())).device
    for leaf, value in leaves(inventory, seed, device):
        p = params[leaf.name]
        if tuple(p.shape) != leaf.shape:
            raise ValueError(f"{leaf.name}: the program holds {tuple(p.shape)}, the inventory {leaf.shape}")
        p.copy_(value.to(p.dtype))
