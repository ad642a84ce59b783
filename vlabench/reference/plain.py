"""Plain fp32 layers shared by the references: written from the published
architectures in plain torch, importing nothing of the program.

Linear weights are [out, in].  Attention takes [B, S, H, D] and a boolean
visibility [B, Sq, Skv] (True where query i sees key j).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    """float32 products in float32: a reference never rounds to TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# The control's precision: None computes every product in fp32; "fp8"
# rounds both operands of each linear layer to float8 e4m3 (the gradient
# flowing back to e5m2) with one scale a tensor, as fp8 training does.
QUANT = None


def _fp8(x, dtype):
    amax = x.detach().abs().amax().clamp_min(1e-12)
    s = amax / torch.finfo(dtype).max
    return (x / s).to(dtype).float() * s


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def linear(x, w, b=None):
    if QUANT == "fp8":
        x, w = _FakeQuant.apply(x), _FakeQuant.apply(w)
    return F.linear(x, w, b)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w=None, b=None, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out


ACT = {
    "silu": F.silu,
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


def attention(q, k, v, visible, scale=None):
    """Softmax attention with grouped keys: q [B, Sq, Hq, D], k and v
    [B, Skv, Hkv, D], Hq a multiple of Hkv; a row that sees no key gives 0."""
    B, Sq, Hq, D = q.shape
    rep = Hq // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scale = D ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    s = s.masked_fill(~visible[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def rope(x, positions, theta):
    """Rotate-half rotary embedding of x [B, S, H, D] at integer positions [B, S]."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ang = positions[..., None].float() * inv
    cos = torch.cat([ang, ang], -1).cos()[:, :, None]
    sin = torch.cat([ang, ang], -1).sin()[:, :, None]
    half = D // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def vit_layer_count(num_layers: int, select_layer) -> int:
    """Layers run before the features are read: all, or up to ``select_layer``
    (hidden_states[l] is the input of layer l: -2 skips the last one)."""
    return num_layers if select_layer is None else num_layers + select_layer + 1


def patchify(images, patch: int):
    """[B, H, W, 3] -> [B, h*w, patch*patch*3], each patch's pixels in
    (row, column, channel) order."""
    B, H, W, C = images.shape
    h, w = H // patch, W // patch
    x = images[:, : h * patch, : w * patch].reshape(B, h, patch, w, patch, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, h * w, patch * patch * C)


def vit(W, prefix, cfg, images):
    """A CLIP or SigLIP tower over normalised NHWC images -> [B, N, hidden]."""
    p = lambda n: W[f"{prefix}.{n}"]  # noqa: E731
    x = linear(patchify(images, cfg["patch_size"]), p("patch_embed.weight"), p("patch_embed.bias"))
    B = x.shape[0]
    if cfg["cls_token"]:
        x = torch.cat([p("cls")[None, None].expand(B, 1, -1), x], 1)
    x = x + p("pos_embed")[None]
    eps = cfg["layer_norm_eps"]
    if cfg["pre_layernorm"]:
        x = layer_norm(x, p("pre_ln.weight"), p("pre_ln.bias"), eps)
    S, H = x.shape[1], cfg["num_attention_heads"]
    visible = torch.ones(B, S, S, dtype=torch.bool, device=x.device)
    act = ACT[cfg["hidden_act"]]
    for i in range(vit_layer_count(cfg["num_hidden_layers"], cfg["select_layer"])):
        lp = lambda n: W[f"{prefix}.layers.{i}.{n}"]  # noqa: E731
        h = layer_norm(x, lp("ln1.weight"), lp("ln1.bias"), eps)
        q, k, v = (linear(h, lp(f"attn.{n}.weight"), lp(f"attn.{n}.bias")).reshape(B, S, H, -1)
                   for n in "qkv")
        x = x + linear(attention(q, k, v, visible).reshape(B, S, -1), lp("attn.o.weight"),
                       lp("attn.o.bias"))
        h = layer_norm(x, lp("ln2.weight"), lp("ln2.bias"), eps)
        x = x + linear(act(linear(h, lp("mlp.fc1.weight"), lp("mlp.fc1.bias"))),
                       lp("mlp.fc2.weight"), lp("mlp.fc2.bias"))
    if cfg["select_layer"] is None:
        x = layer_norm(x, p("post_ln.weight"), p("post_ln.bias"), eps)
    if cfg["cls_token"]:
        x = x[:, 1:]
    return x


def decoder_qkv(W, prefix, cfg, x, positions):
    """A decoder layer's q, k and v from its input x [B, S, hidden], rotated
    at ``positions`` [B, S] (left unrotated where None)."""
    B, S, _ = x.shape
    g = lambda n: W.get(f"{prefix}.{n}")  # noqa: E731
    h = rms_norm(x, g("ln1.weight"), cfg["rms_norm_eps"])
    hd = cfg["head_dim"]
    q = linear(h, g("attn.q.weight"), g("attn.q.bias")).reshape(B, S, -1, hd)
    k = linear(h, g("attn.k.weight"), g("attn.k.bias")).reshape(B, S, -1, hd)
    v = linear(h, g("attn.v.weight"), g("attn.v.bias")).reshape(B, S, -1, hd)
    if cfg.get("qk_norm"):
        q = rms_norm(q, g("attn.q_norm.weight"), cfg["rms_norm_eps"])
        k = rms_norm(k, g("attn.k_norm.weight"), cfg["rms_norm_eps"])
    if positions is None:
        return q, k, v
    return rope(q, positions, cfg["rope_theta"]), rope(k, positions, cfg["rope_theta"]), v


def decoder_out(W, prefix, cfg, x, a):
    """The rest of a decoder layer after attention: o projection, residual,
    gated MLP, residual."""
    B, S, _ = x.shape
    g = lambda n: W[f"{prefix}.{n}"]  # noqa: E731
    x = x + linear(a.reshape(B, S, -1), g("attn.o.weight"))
    h = rms_norm(x, g("ln2.weight"), cfg["rms_norm_eps"])
    act = ACT[cfg["hidden_act"]]
    return x + linear(act(linear(h, g("mlp.gate.weight"))) * linear(h, g("mlp.up.weight")),
                      g("mlp.down.weight"))


def causal_decoder(W, prefix, cfg, x):
    """A causal decoder stack over unpadded rows x [B, S, hidden] -> the
    final-normed hidden states."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    visible = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()[None].expand(B, S, S)
    for i in range(cfg["num_hidden_layers"]):
        lp = f"{prefix}.layers.{i}"
        q, k, v = decoder_qkv(W, lp, cfg, x, positions)
        x = decoder_out(W, lp, cfg, x, attention(q, k, v, visible))
    return rms_norm(x, W[f"{prefix}.norm.weight"], cfg["rms_norm_eps"])

