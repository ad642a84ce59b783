"""Vision transformer encoder, CLIP-ViT or SigLIP (port of dexbotic_tpu/nn/vit.py).

Patch embedding is a reshape plus a matmul over NHWC images, in the JAX
package's (row, col, channel) patch order; attention is bidirectional
(group 0 everywhere) and, with ``attn_impl="xla"``, plain torch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from dexbotic_tpu_torch.nn import core
from dexbotic_tpu_torch.ops.attention import attention
from dexbotic_tpu_torch.ops.norms import LayerNorm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int
    patch_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    act: str = "gelu_tanh"
    ln_eps: float = 1e-6
    use_cls: bool = False  # CLIP prepends a class token
    pre_ln: bool = False  # CLIP applies a LayerNorm before the encoder
    select_layer: Optional[int] = None  # None -> last_hidden_state (post-LN)
    drop_cls: bool = True  # drop CLS from returned features (LLaVA style)
    attn_impl: str = "xla"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_cls else 0)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_output_tokens(self) -> int:
        n = self.seq_len
        if self.use_cls and self.drop_cls:
            n -= 1
        return n


CLIP_VIT_L_336 = ViTConfig(
    image_size=336, patch_size=14, hidden_size=1024, num_layers=24, num_heads=16,
    intermediate_size=4096, act="quick_gelu", ln_eps=1e-5, use_cls=True,
    pre_ln=True, select_layer=-2, drop_cls=True,
)
SIGLIP_SO400M_384 = ViTConfig(
    image_size=384, patch_size=14, hidden_size=1152, num_layers=27, num_heads=16,
    intermediate_size=4304, act="gelu_tanh", select_layer=-2,
)
SIGLIP_SO400M_224 = dataclasses.replace(
    SIGLIP_SO400M_384, image_size=224, select_layer=None
)  # PaliGemma's tower (pi0/pi0.5); head_dim 72 stays on attn_impl="xla"


class _Attn(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.q, self.k, self.v, self.o = (core.Linear(h, h) for _ in range(4))


class _MLP(nn.Module):
    def __init__(self, h: int, inter: int):
        super().__init__()
        self.fc1 = core.Linear(h, inter)
        self.fc2 = core.Linear(inter, h)


class ViTLayer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size, cfg.ln_eps)
        self.ln2 = LayerNorm(cfg.hidden_size, cfg.ln_eps)
        self.attn = _Attn(cfg.hidden_size)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size)


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.patch_embed = core.Linear(cfg.patch_size * cfg.patch_size * 3, h)
        self.pos_embed = nn.Parameter(torch.empty(cfg.seq_len, h))
        self.layers = nn.ModuleList(ViTLayer(cfg) for _ in range(cfg.num_layers))
        self.post_ln = LayerNorm(h, cfg.ln_eps)
        if cfg.use_cls:
            self.cls = nn.Parameter(torch.empty(h))
        if cfg.pre_ln:
            self.pre_ln = LayerNorm(h, cfg.ln_eps)


@torch.no_grad()
def init_vit_(vit: ViT, gen: torch.Generator) -> None:
    """The JAX init's distributions (init_vit), drawn from ``gen``."""
    core.init_linears_(vit, gen)
    core.reset_norms_(vit)
    core.normal_init_(vit.patch_embed.weight, gen)
    vit.patch_embed.bias.zero_()
    core.normal_init_(vit.pos_embed, gen)
    if hasattr(vit, "cls"):
        core.normal_init_(vit.cls, gen)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, h*w, p*p*3] in (row, col, channel) patch order.

    Pixels past the last whole patch are dropped, as the reference's
    stride-``patch`` convolution (VALID padding) drops them: SigLIP-so400m/384
    takes 27 x 14 of its 384 pixels a side.  The JAX package's reshape
    raises there instead."""
    B, H, W, C = images.shape
    h, w = H // patch, W // patch
    images = images[:, : h * patch, : w * patch]
    x = images.reshape(B, h, patch, w, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h * w, patch * patch * C)


def vit_forward(vit: ViT, cfg: ViTConfig, images: torch.Tensor, remat=False) -> torch.Tensor:
    """Encode normalised images [B, H, W, 3] -> [B, N, hidden].

    ``remat`` (False | True | "dots") is the JAX flag, applied per layer."""
    B = images.shape[0]
    x = vit.patch_embed(patchify(images, cfg.patch_size))
    if cfg.use_cls:
        x = torch.cat([vit.cls.to(x.dtype)[None, None, :].expand(B, 1, -1), x], dim=1)
    x = x + vit.pos_embed.to(x.dtype)[None]
    if cfg.pre_ln:
        x = vit.pre_ln(x)
    n_layers = cfg.num_layers
    if cfg.select_layer is not None:
        # hidden_states[l] is the input of layer l: -2 runs all but the last layer
        n_layers = cfg.num_layers + cfg.select_layer + 1
        if not 0 < n_layers <= cfg.num_layers:
            raise ValueError(f"select_layer={cfg.select_layer} out of range")
    S = x.shape[1]
    grp = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    valid = torch.ones((B, S), dtype=torch.int32, device=x.device)
    shape = (B, S, cfg.num_heads, cfg.head_dim)

    def layer(lp, x):
        h = lp.ln1(x)
        q, k, v = (lin(h).reshape(shape) for lin in (lp.attn.q, lp.attn.k, lp.attn.v))
        a = attention(q, k, v, grp, grp, valid, impl=cfg.attn_impl)
        x = x + lp.attn.o(a.reshape(B, S, -1))
        return x + lp.mlp.fc2(core.ACTIVATIONS[cfg.act](lp.mlp.fc1(lp.ln2(x))))

    for lp in vit.layers[:n_layers]:
        x = core.remat_call(layer, remat, lp, x)
    if cfg.select_layer is None:
        x = vit.post_ln(x)
    if cfg.use_cls and cfg.drop_cls:
        x = x[:, 1:]
    return x
