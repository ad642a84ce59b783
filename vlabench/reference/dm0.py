"""Plain fp32 DM0 training: SigLIP so400m over each view, a linear
projector, a Qwen3 VLM prefix (causal, qk-norm) and a Qwen3 action expert
joined as a mixture of transformers (one joint attention a layer, each
stream with its own weights), the flow-matching loss over the action chunk,
and AdamW after a clip by the global norm.

Written from the DM0 recipe (dexmal/dexbotic ``libero_dm0.py``), pi0's flow
matching (arXiv:2410.24164) and the published Qwen3 and SigLIP
configurations; imports nothing of the program.  It works out again from
the raw samples what the program derives: the pixels (PIL bicubic resize,
normalisation), the prompt's token ids (a frozen copy of the byte-level
tokenizer and the 'step' template), each micro-batch's noise and flow times
(the documented rule of the trainer's per-micro-batch generator), the
learning-rate schedule and the storage rounding of the parameters that the
configuration keeps in bf16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vlabench.reference import plain
from vlabench.weights import matrix, scale, small

SPECIALS = ["<pad>", "<s>", "</s>", "<|endoftext|>", "<|im_end|>", "<unk>"]
SYSTEM = ("A chat between a curious user and an artificial intelligence assistant. "
          "The assistant gives helpful, detailed, and polite answers to the user's questions.")


# ---------------------------------------------------------------------------
# The leaves, in the program's names
# ---------------------------------------------------------------------------


def decoder_inventory(prefix: str, d: dict, embed_vocab: int | None) -> list:
    H, hd = d["hidden_size"], d["head_dim"]
    qd, kvd, inter = d["num_attention_heads"] * hd, d["num_key_value_heads"] * hd, d["intermediate_size"]
    out = []
    for i in range(d["num_hidden_layers"]):
        p = f"{prefix}.layers.{i}"
        out += [scale(f"{p}.ln1.weight", (H,)), scale(f"{p}.ln2.weight", (H,)),
                matrix(f"{p}.attn.q.weight", (qd, H)), matrix(f"{p}.attn.k.weight", (kvd, H)),
                matrix(f"{p}.attn.v.weight", (kvd, H)), matrix(f"{p}.attn.o.weight", (H, qd))]
        if d["qk_norm"]:
            out += [scale(f"{p}.attn.q_norm.weight", (hd,)), scale(f"{p}.attn.k_norm.weight", (hd,))]
        out += [matrix(f"{p}.mlp.gate.weight", (inter, H)), matrix(f"{p}.mlp.up.weight", (inter, H)),
                matrix(f"{p}.mlp.down.weight", (H, inter))]
    out.append(scale(f"{prefix}.norm.weight", (H,)))
    if embed_vocab:
        out.append(small(f"{prefix}.embed.weight", (embed_vocab, H)))
    return out


def inventory(cfg: dict) -> list:
    from vlabench.reference.cogact import vit_inventory

    vlm, ex, fl = cfg["vlm"], cfg["expert"], cfg["flow"]
    H, E, A = vlm["hidden_size"], ex["hidden_size"], fl["action_dim"]
    out = decoder_inventory("vlm.llm", vlm, vlm["vocab_size"])
    out += vit_inventory("vlm.vit", cfg["vision"])
    out += [matrix("vlm.projector.fc.weight", (H, cfg["vision"]["hidden_size"])),
            small("vlm.projector.fc.bias", (H,))]
    out += decoder_inventory("expert", ex, None)
    out += [matrix("action_in_proj.weight", (E, A)), small("action_in_proj.bias", (E,)),
            matrix("action_out_proj.weight", (A, E)), small("action_out_proj.bias", (A,)),
            matrix("time_mlp_in.weight", (E, 2 * E)), small("time_mlp_in.bias", (E,)),
            matrix("time_mlp_out.weight", (E, E)), small("time_mlp_out.bias", (E,))]
    return out


def stored_bf16(name: str, shape) -> bool:
    """The configuration's storage rule: bf16 for a leaf of two or more dims
    and for every leaf of a stacked layer list, fp32 for the rest."""
    return len(shape) >= 2 or ".layers." in name


def load_weights(cfg: dict, seed: int, device) -> dict:
    """{name: fp32 leaf requiring grad}, drawn again from the seed."""
    from vlabench.weights import leaves

    return {leaf.name: value.float().requires_grad_(True)
            for leaf, value in leaves(inventory(cfg), seed, device)}


# ---------------------------------------------------------------------------
# What the program derives from a sample, worked out again
# ---------------------------------------------------------------------------


def encode(text: str) -> list:
    """Byte-level ids without a BOS: a special as its index, byte b as len(SPECIALS) + b."""
    ids, i = [], 0
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


def prompt(cfg: dict, instruction: str) -> tuple[np.ndarray, np.ndarray]:
    """(ids, valid) of one sample's text under the 'step' template, cut or
    padded (id 0) to the configured length."""
    text = instruction.strip().replace("\n", " ")
    ids = encode(f"{SYSTEM} ") + encode("USER: ") + encode(f"{text} ")
    n = cfg["text_tokens"]
    valid = [1] * min(len(ids), n) + [0] * max(0, n - len(ids))
    ids = (ids + [0] * n)[:n]
    return np.asarray(ids, np.int64), np.asarray(valid, np.int32)


def pixels(cfg: dict, frames: np.ndarray) -> np.ndarray:
    """uint8 views [n, h, w, 3] -> normalised [n, size, size, 3] fp32 by PIL alone."""
    from PIL import Image

    vis = cfg["vision"]
    size = vis["image_size"]
    out = []
    for f in frames:
        a = np.asarray(Image.fromarray(f).resize((size, size), Image.BICUBIC)).astype(np.float32)
        a = a * np.float32(1.0 / 255.0)
        out.append((a - np.asarray(vis["image_mean"], np.float32)) / np.asarray(vis["image_std"], np.float32))
    return np.stack(out)


def step_generator(seed: int, step: int, micro: int, device) -> torch.Generator:
    """The trainer's documented per-micro-batch generator: seeded from
    (seed, step, micro) through numpy's SeedSequence."""
    state = np.random.SeedSequence([seed, step, micro]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2 ** 63 - 1))


def flow_draws(cfg: dict, gen: torch.Generator, rows: int, device) -> tuple:
    """(noise [rows, chunk, dim], times [rows]) in the loss's draw order:
    the noise, then t = U^(1/alpha) mapped to [0.001, 1)."""
    fl = cfg["flow"]
    noise = torch.randn((rows, fl["chunk_size"], fl["action_dim"]), generator=gen,
                        dtype=torch.float32, device=device)
    u = torch.rand(rows, generator=gen, dtype=torch.float32, device=device)
    return noise, u.pow(1.0 / fl["time_beta_alpha"]) * 0.999 + 0.001


def learning_rate(tc: dict, count: int) -> float:
    """The recipe's schedule at update count ``count`` (before the update):
    a linear warmup from 0, then a cosine decay."""
    total = tc["max_steps"]
    warmup = max(1, int(tc["warmup_ratio"] * total))
    base = tc["learning_rate"]
    if count < warmup:
        return base * count / warmup
    decay = max(total, warmup + 1) - warmup
    c = min(count - warmup, decay)
    return base * 0.5 * (1.0 + math.cos(math.pi * c / decay))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def sincos(time: torch.Tensor, dim: int, fl: dict) -> torch.Tensor:
    fraction = np.linspace(0.0, 1.0, dim // 2)
    period = fl["time_min_period"] * (fl["time_max_period"] / fl["time_min_period"]) ** fraction
    sc = torch.tensor(1.0 / period * 2 * np.pi, dtype=torch.float32, device=time.device)
    arg = sc[None, :] * time.float()[:, None]
    return torch.cat([torch.sin(arg), torch.cos(arg)], -1)


def loss(W: dict, cfg: dict, images: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
         actions: torch.Tensor, noise: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    """Mean flow-matching error of a block of rows: images [B, n, s, s, 3],
    ids and valid [B, T], actions and noise [B, chunk, dim], time [B]."""
    vlm, ex, fl = cfg["vlm"], cfg["expert"], cfg["flow"]
    B, n = images.shape[:2]
    feats = plain.vit(W, "vlm.vit", cfg["vision"], images.reshape((B * n,) + images.shape[2:]))
    feats = plain.linear(feats, W["vlm.projector.fc.weight"], W["vlm.projector.fc.bias"])
    feats = feats.reshape(B, -1, feats.shape[-1])
    prefix = torch.cat([feats, W["vlm.llm.embed.weight"][ids]], 1)
    t = time[:, None, None]
    x_t = t * noise + (1 - t) * actions
    tok = plain.linear(x_t, W["action_in_proj.weight"], W["action_in_proj.bias"])
    temb = sincos(time, ex["hidden_size"], fl)[:, None].expand(tok.shape)
    h = plain.linear(torch.cat([tok, temb], -1), W["time_mlp_in.weight"], W["time_mlp_in.bias"])
    suffix = plain.linear(torch.nn.functional.silu(h), W["time_mlp_out.weight"], W["time_mlp_out.bias"])
    P, S = prefix.shape[1], suffix.shape[1]
    mask = torch.cat([torch.ones(B, feats.shape[1], dtype=torch.int32, device=ids.device), valid,
                      torch.ones(B, S, dtype=torch.int32, device=ids.device)], 1)
    ar = torch.ones(B, P + S, dtype=torch.int32, device=ids.device)
    if not fl["causal_prefix"]:
        ar[:, :P] = 0
    ar[:, P + 1:] = 0  # the action tokens see each other; the chunk's first opens a group
    grp = torch.cumsum(ar, 1)
    positions = torch.cumsum(mask, 1) - 1
    visible = (grp[:, None, :] <= grp[:, :, None]) & (mask[:, None, :] != 0)
    xs = [prefix, suffix]
    streams = [("vlm.llm", vlm), ("expert", ex)]
    for i in range(vlm["num_hidden_layers"]):
        qs, ks, vs = [], [], []
        for (pre, d), x in zip(streams, xs):
            q, k, v = plain.decoder_qkv(W, f"{pre}.layers.{i}", d, x, None)
            qs.append(q)
            ks.append(k)
            vs.append(v)
        q, k, v = (torch.cat(z, 1) for z in (qs, ks, vs))
        q = plain.rope(q, positions, vlm["rope_theta"])
        k = plain.rope(k, positions, vlm["rope_theta"])
        a = plain.attention(q, k, v, visible)
        xs = [plain.decoder_out(W, f"{pre}.layers.{i}", d, x, part)
              for (pre, d), x, part in zip(streams, xs, (a[:, :P], a[:, P:]))]
    out = plain.rms_norm(xs[1], W["expert.norm.weight"], ex["rms_norm_eps"])
    v_t = plain.linear(out[:, -fl["chunk_size"]:], W["action_out_proj.weight"], W["action_out_proj.bias"])
    return (v_t - (noise - actions)).square().mean()


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------


def leaf_norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.detach().float())) for n, t in tensors.items()}


def train(W: dict, cfg: dict, steps: list, seed: int, block: int = 1, rows: int | None = None) -> dict:
    """Follow ``steps`` optimizer steps from the weights ``W`` (changed in
    place).  ``steps[s]`` is the list of the step's samples, each (frames
    uint8 [n, h, w, 3], instruction, actions [chunk, dim]) in batch order;
    micro-batch m of a step takes its m-th ``per_device_batch_size`` rows
    and draws from ``step_generator(seed, s, m)``.  The gradient of each
    micro-batch is taken ``block`` rows at a time.  Returns each step's
    loss, the first step's clipped gradient norms by leaf, and the change
    of each leaf after the last step.  ``rows`` (a fault for the checks'
    tests) keeps only the first rows of each micro-batch, the mean taken
    over them."""
    tc = cfg["train"]
    device = next(iter(W.values())).device
    per, accum = tc["per_device_batch_size"], tc["gradient_accumulation_steps"]
    used = rows or per
    b1, b2, eps = tc["adam_beta1"], tc["adam_beta2"], tc["adam_eps"]
    start = {n: w.detach().bfloat16() if stored_bf16(n, w.shape) else w.detach().clone()
             for n, w in W.items()}
    mu = {n: torch.zeros_like(w) for n, w in W.items()}
    nu = {n: torch.zeros_like(w) for n, w in W.items()}
    bf16 = {n: stored_bf16(n, w.shape) for n, w in W.items()}
    losses, first = [], None
    for s, samples in enumerate(steps):
        grads = {n: torch.zeros_like(w) for n, w in W.items()}
        total = 0.0
        for m in range(accum):
            rows = samples[m * per:(m + 1) * per]
            noise, time = flow_draws(cfg, step_generator(seed, s, m, device), per, device)
            for r0 in range(0, used, block):
                part = rows[r0:min(r0 + block, used)]
                images = torch.from_numpy(np.stack([pixels(cfg, f) for f, _, _ in part])).to(device)
                texts = [prompt(cfg, t) for _, t, _ in part]
                ids = torch.from_numpy(np.stack([i for i, _ in texts])).to(device)
                valid = torch.from_numpy(np.stack([v for _, v in texts])).to(device)
                actions = torch.from_numpy(np.stack([a for _, _, a in part])).float().to(device)
                lo = loss(W, cfg, images, ids, valid, actions, noise[r0:r0 + len(part)],
                          time[r0:r0 + len(part)])
                g = torch.autograd.grad(lo, list(W.values()), allow_unused=True)
                for (n, _), gi in zip(W.items(), g):
                    if gi is not None:
                        grads[n].add_(gi, alpha=len(part) / (used * accum))
                total += float(lo.detach()) * len(part) / used
        losses.append(total / accum)
        norm = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
        if tc["max_grad_norm"] and norm >= tc["max_grad_norm"]:
            for g in grads.values():
                g.mul_(tc["max_grad_norm"] / norm)
        if first is None:
            first = leaf_norms(grads)
        lr = learning_rate(tc, s)
        with torch.no_grad():
            for n, w in W.items():
                g = grads[n]
                mu[n].mul_(b1).add_((1 - b1) * g)
                nu[n].mul_(b2).add_((1 - b2) * g * g)
                u = (mu[n] / (1 - b1 ** (s + 1))) / (torch.sqrt(nu[n] / (1 - b2 ** (s + 1))) + eps)
                new = w - lr * u
                w.copy_(new.bfloat16().float() if bf16[n] else new)
        del grads
    change = leaf_norms({n: W[n].detach() - start[n].float() for n in W})
    return {"losses": losses, "grad_norms": first, "change_norms": change}
