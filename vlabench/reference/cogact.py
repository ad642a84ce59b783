"""Plain fp32 CogACT: CLIP tower, mlp2x_gelu projector, causal decoder
(Qwen2: qkv biases, grouped keys, rotary positions), the cognition feature
at the last prompt token, and a DiT action head sampled by DDIM with
classifier-free guidance; then the served de-normalisation.

Written from CogACT (arXiv:2411.19650) and the published Qwen2 and CLIP
configurations; imports nothing of the program.  It also works out again
from the raw request what the server derives: the prompt's token ids
(a frozen copy of the byte-level tokenizer, the 'dexbotic' conversation and
the image placeholders) and the pixels (PIL decode, centred pad to square
with the mean colour, PIL bicubic resize, normalisation).
"""

from __future__ import annotations

import io
import math

import numpy as np
import torch

from vlabench.reference import plain
from vlabench.weights import matrix, scale, small

IMAGE_TOKEN = -200
SYSTEM = ("A chat between a curious user and an artificial intelligence assistant. "
          "The assistant gives helpful, detailed, and polite answers to the user's questions.")
SPECIALS = ["<pad>", "<s>", "</s>", "<|endoftext|>", "<|im_end|>", "<unk>"]
TEMPLATE = "<image>\nWhat action should the robot take to {prompt}?"


# ---------------------------------------------------------------------------
# The leaves, in the program's names
# ---------------------------------------------------------------------------


def inventory(cfg: dict) -> list:
    llm, vis, head = cfg["llm"], cfg["vision"], cfg["action_head"]
    H, hd, inter = llm["hidden_size"], llm["head_dim"], llm["intermediate_size"]
    qd, kvd = llm["num_attention_heads"] * hd, llm["num_key_value_heads"] * hd
    out = []
    for i in range(llm["num_hidden_layers"]):
        p = f"vlm.llm.layers.{i}"
        out += [scale(f"{p}.ln1.weight", (H,)), scale(f"{p}.ln2.weight", (H,)),
                matrix(f"{p}.attn.q.weight", (qd, H)), matrix(f"{p}.attn.k.weight", (kvd, H)),
                matrix(f"{p}.attn.v.weight", (kvd, H)), matrix(f"{p}.attn.o.weight", (H, qd))]
        if llm["attention_bias"]:
            out += [small(f"{p}.attn.{n}.bias", (d,)) for n, d in (("q", qd), ("k", kvd), ("v", kvd))]
        out += [matrix(f"{p}.mlp.gate.weight", (inter, H)), matrix(f"{p}.mlp.up.weight", (inter, H)),
                matrix(f"{p}.mlp.down.weight", (H, inter))]
    out += [scale("vlm.llm.norm.weight", (H,)), small("vlm.llm.embed.weight", (llm["vocab_size"], H))]
    if not llm["tie_word_embeddings"]:
        out.append(matrix("vlm.llm.lm_head.weight", (llm["vocab_size"], H)))
    out += vit_inventory("vlm.vit", vis)
    V = vis["hidden_size"]
    out += [matrix("vlm.projector.fc0.weight", (H, V)), small("vlm.projector.fc0.bias", (H,)),
            matrix("vlm.projector.fc1.weight", (H, H)), small("vlm.projector.fc1.bias", (H,))]
    D, M, A, T = head["hidden_size"], int(head["hidden_size"] * head["mlp_ratio"]), \
        head["action_dim"], head["chunk_size"]
    F = head["freq_embed_size"]
    out += [small("action_head.pos_embed", (T + 1, D)), small("action_head.uncondition", (H,)),
            matrix("action_head.x_embed.weight", (D, A)), small("action_head.x_embed.bias", (D,)),
            matrix("action_head.t_mlp.fc0.weight", (D, F)), small("action_head.t_mlp.fc0.bias", (D,)),
            matrix("action_head.t_mlp.fc1.weight", (D, D)), small("action_head.t_mlp.fc1.bias", (D,)),
            matrix("action_head.z_embed.weight", (D, H)), small("action_head.z_embed.bias", (D,))]
    for i in range(head["depth"]):
        p = f"action_head.blocks.{i}"
        out += [matrix(f"{p}.attn.qkv.weight", (3 * D, D)), small(f"{p}.attn.qkv.bias", (3 * D,)),
                matrix(f"{p}.attn.o.weight", (D, D)), small(f"{p}.attn.o.bias", (D,)),
                matrix(f"{p}.mlp.fc0.weight", (M, D)), small(f"{p}.mlp.fc0.bias", (M,)),
                matrix(f"{p}.mlp.fc1.weight", (D, M)), small(f"{p}.mlp.fc1.bias", (D,))]
    out += [matrix("action_head.final.weight", (A, D)), small("action_head.final.bias", (A,))]
    return out


def vit_inventory(prefix: str, vis: dict) -> list:
    V, I, P = vis["hidden_size"], vis["intermediate_size"], vis["patch_size"]
    seq = (vis["image_size"] // P) ** 2 + (1 if vis["cls_token"] else 0)
    out = [small(f"{prefix}.pos_embed", (seq, V)), matrix(f"{prefix}.patch_embed.weight", (V, P * P * 3)),
           small(f"{prefix}.patch_embed.bias", (V,))]
    for i in range(vis["num_hidden_layers"]):
        p = f"{prefix}.layers.{i}"
        out += [scale(f"{p}.ln1.weight", (V,)), small(f"{p}.ln1.bias", (V,)),
                scale(f"{p}.ln2.weight", (V,)), small(f"{p}.ln2.bias", (V,))]
        for n in "qkvo":
            out += [matrix(f"{p}.attn.{n}.weight", (V, V)), small(f"{p}.attn.{n}.bias", (V,))]
        out += [matrix(f"{p}.mlp.fc1.weight", (I, V)), small(f"{p}.mlp.fc1.bias", (I,)),
                matrix(f"{p}.mlp.fc2.weight", (V, I)), small(f"{p}.mlp.fc2.bias", (V,))]
    out += [scale(f"{prefix}.post_ln.weight", (V,)), small(f"{prefix}.post_ln.bias", (V,))]
    if vis["cls_token"]:
        out.append(small(f"{prefix}.cls", (V,)))
    if vis["pre_layernorm"]:
        out += [scale(f"{prefix}.pre_ln.weight", (V,)), small(f"{prefix}.pre_ln.bias", (V,))]
    return out


def load_weights(cfg: dict, seed: int, device, keep=lambda name: True) -> dict:
    """{name: fp32 tensor} of the leaves ``keep`` selects, drawn again from the seed."""
    from vlabench.weights import leaves

    return {leaf.name: value.float() for leaf, value in leaves(inventory(cfg), seed, device)
            if keep(leaf.name)}


# ---------------------------------------------------------------------------
# What the server derives from a request, worked out again
# ---------------------------------------------------------------------------


def encode(text: str, bos: bool = True) -> list:
    """Byte-level ids: the specials first, then byte b as len(SPECIALS) + b."""
    ids = [1] if bos else []
    i = 0
    while i < len(text):
        for sid, s in enumerate(SPECIALS):
            if text.startswith(s, i):
                ids.append(sid)
                i += len(s)
                break
        else:
            ids.extend(len(SPECIALS) + b for b in text[i].encode("utf-8"))
            i += 1
    return ids


def prompt_ids(cfg: dict, instruction: str) -> list:
    """The request text -> ids with the image's placeholders, as served."""
    text = TEMPLATE.format(prompt=instruction)
    full = f"{SYSTEM} USER: {text} ASSISTANT:  <|endoftext|>"
    chunks = [encode(c) for c in full.split("<image>")]
    n_img = (cfg["vision"]["image_size"] // cfg["vision"]["patch_size"]) ** 2
    ids = [1]
    for i, c in enumerate(chunks):
        if i:
            ids += [IMAGE_TOKEN] * n_img
        ids += c[1:]
    return ids


def pixels(cfg: dict, png: bytes) -> np.ndarray:
    """Frame bytes -> normalised [size, size, 3] fp32, by PIL alone."""
    from PIL import Image

    vis = cfg["vision"]
    img = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
    h, w = img.shape[:2]
    side = max(h, w)
    fill = np.asarray([int(m * 255) for m in vis["image_mean"]], np.uint8)
    sq = np.empty((side, side, 3), np.uint8)
    sq[:] = fill
    sq[(side - h) // 2: (side - h) // 2 + h, (side - w) // 2: (side - w) // 2 + w] = img
    size = vis["image_size"]
    sq = np.asarray(Image.fromarray(sq).resize((size, size), Image.BICUBIC))
    x = sq.astype(np.float32) / 255.0
    return (x - np.asarray(vis["image_mean"], np.float32)) / np.asarray(vis["image_std"], np.float32)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def cognition(W: dict, cfg: dict, ids: list, image: torch.Tensor) -> torch.Tensor:
    """One request's cognition feature [hidden]: the decoder's final-normed
    state at its last token, the image features spliced at the placeholders."""
    llm = cfg["llm"]
    feats = plain.vit(W, "vlm.vit", cfg["vision"], image[None])
    feats = plain.linear(plain.ACT["gelu"](plain.linear(feats, W["vlm.projector.fc0.weight"],
                                                         W["vlm.projector.fc0.bias"])),
                         W["vlm.projector.fc1.weight"], W["vlm.projector.fc1.bias"])[0]
    ids_t = torch.tensor(ids, device=image.device)
    is_img = ids_t == IMAGE_TOKEN
    x = W["vlm.llm.embed.weight"][torch.where(is_img, 0, ids_t)]
    x[is_img] = feats
    hidden = plain.causal_decoder(W, "vlm.llm", llm, x[None])
    return hidden[0, -1]


def schedule(head: dict):
    """(kept timesteps, their alpha-bar, the previous ones) of DDIM over a
    squared-cosine schedule, float64."""
    N, steps = head["diffusion_steps"], head["ddim_steps"]

    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.array([min(1 - alpha_bar((i + 1) / N) / alpha_bar(i / N), 0.999) for i in range(N)])
    acp = np.cumprod(1.0 - betas)
    stride = next(s for s in range(1, N) if len(range(0, N, s)) == steps)
    kept = np.arange(0, N, stride)
    ab = acp[kept]
    return kept, ab, np.concatenate([[1.0], ab[:-1]])


def dit_eps(W: dict, head: dict, x: torch.Tensor, t: int, z: torch.Tensor) -> torch.Tensor:
    """eps of noisy actions x [R, T, A] at timestep t under conditions z [R, hidden]."""
    g = lambda n: W[f"action_head.{n}"]  # noqa: E731
    R, T, _ = x.shape
    half = head["freq_embed_size"] // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    args = float(t) * freqs
    te = torch.cat([torch.cos(args), torch.sin(args)])[None]
    te = plain.linear(torch.nn.functional.silu(plain.linear(te, g("t_mlp.fc0.weight"), g("t_mlp.fc0.bias"))),
                      g("t_mlp.fc1.weight"), g("t_mlp.fc1.bias"))
    c = te + plain.linear(z, g("z_embed.weight"), g("z_embed.bias"))
    h = torch.cat([c[:, None], plain.linear(x, g("x_embed.weight"), g("x_embed.bias"))], 1) + g("pos_embed")[None]
    S, heads = T + 1, head["num_heads"]
    visible = torch.ones(R, S, S, dtype=torch.bool, device=x.device)
    for i in range(head["depth"]):
        b = lambda n: W[f"action_head.blocks.{i}.{n}"]  # noqa: E731
        qkv = plain.linear(plain.layer_norm(h), b("attn.qkv.weight"), b("attn.qkv.bias"))
        qkv = qkv.reshape(R, S, 3, heads, -1)
        a = plain.attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], visible)
        h = h + plain.linear(a.reshape(R, S, -1), b("attn.o.weight"), b("attn.o.bias"))
        m = plain.linear(plain.layer_norm(h), b("mlp.fc0.weight"), b("mlp.fc0.bias"))
        h = h + plain.linear(plain.ACT["gelu_tanh"](m), b("mlp.fc1.weight"), b("mlp.fc1.bias"))
    return plain.linear(plain.layer_norm(h), g("final.weight"), g("final.bias"))[:, 1:]


def sample(W: dict, cfg: dict, z: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """DDIM (eta 0) with classifier-free guidance: [B, hidden], [B, T, A] -> [B, T, A]."""
    head = cfg["action_head"]
    kept, ab, ab_prev = schedule(head)
    s = head["cfg_scale"]
    B = z.shape[0]
    zz = torch.cat([z, W["action_head.uncondition"][None].expand(B, -1)])
    x = noise.clone()
    for i in range(len(kept) - 1, -1, -1):
        eps2 = dit_eps(W, head, torch.cat([x, x]), int(kept[i]), zz)
        eps = eps2[B:] + s * (eps2[:B] - eps2[B:])
        a, a_prev = float(ab[i]), float(ab_prev[i])
        x0 = (x - math.sqrt(1.0 - a) * eps) / math.sqrt(a)
        x = x0 * math.sqrt(a_prev) + math.sqrt(1.0 - a_prev) * eps
    return x


def denormalize(chunk: np.ndarray, norms: dict) -> np.ndarray:
    """[-1, 1] actions -> robot units by the served statistics (clipped first)."""
    lo, hi = np.asarray(norms["min"], np.float64), np.asarray(norms["max"], np.float64)
    a = np.clip(chunk[..., : len(lo)], -1.0, 1.0)
    return np.concatenate([lo + (a + 1.0) * 0.5 * (hi - lo), chunk[..., len(lo):]], -1)


@torch.no_grad()
def served_chunk(W: dict, cfg: dict, instruction: str, png: bytes, noise: torch.Tensor,
                 norms: dict) -> tuple[np.ndarray, torch.Tensor]:
    """The chunk a request should be answered with, [T, A] float64 in robot
    units, and its cognition feature [hidden]."""
    device = noise.device
    image = torch.from_numpy(pixels(cfg, png)).to(device)
    z = cognition(W, cfg, prompt_ids(cfg, instruction), image)
    x = sample(W, cfg, z[None], noise[None].float())[0].double().cpu().numpy()
    return denormalize(x, norms), z
