"""MemVLA: CogACT with a perceptual-cognitive memory bank (port of
dexbotic_tpu/models/memvla.py).

* The projector's image tokens are compressed by an SE bottleneck into the
  ``per`` tokens; the cognition feature (the last valid token's hidden
  state) is the ``cog`` token.
* Each role keeps a bank of (timestep, feature) entries a row: retrieval is
  two cross-attention blocks over [bank slots ++ the working tokens] whose
  keys carry a timestep embedding, fusion a sigmoid gate; consolidation
  appends, and over ``mem_length`` merges the most similar adjacent pair
  (ToMe, cosine over the token rows) or drops the oldest (FIFO).
* The DiT attends from its tokens to the ``per`` tokens in every block
  (``models/dit.py``'s ``mem_cross_attn``).

The bank is an explicit state of fixed shapes ([B, mem_length, N, D]
features, [B, mem_length] times, [B] counts) passed in and returned, as in
JAX; consolidation computes both of its branches and selects by the count,
so that a step never waits on the device.  The sampler is the plain DDIM
loop over ``dit_forward``: kernel K2 does not serve the memory
cross-attention (``ops/dit_fused.fused_dit_sample`` refuses it).  On a CUDA
device the LLaMA prefill is kernel K1, and under int8 serving the quantized
products are kernel K4.

Training (:func:`memvla_loss`) threads the bank state through the steps in
one of two ways: ``parallel_stream`` keeps a bank a row (each row its own
episode stream, reset where ``episode_reset`` is set); ``group`` / ``stream``
make the rows consecutive frames of one episode sharing a single bank
(:func:`bank_step_sequential`, a loop over the rows, each row's new state
detached before the next).  On a CUDA device its LLaMA forward is K1 and its
backward K3.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dexbotic_tpu_torch.models import dit as dit_mod
from dexbotic_tpu_torch.models.vlm import (
    VLM,
    VLMConfig,
    encode_images,
    gather_last_hidden,
    init_vlm_,
    splice_image_embeds,
    vlm_forward,
)
from dexbotic_tpu_torch.nn import core
from dexbotic_tpu_torch.ops.attention import attention_xla
from dexbotic_tpu_torch.ops.diffusion import DiffusionSchedule
from dexbotic_tpu_torch.ops.norms import LayerNorm, layer_norm


@dataclasses.dataclass(frozen=True)
class MemVLAConfig:
    vlm: VLMConfig
    action_model_type: str = "DiT-B"
    action_dim: int = 7
    chunk_size: int = 16
    diffusion_steps: int = 100
    repeated_diffusion_steps: int = 4
    cfg_scale: float = 1.5
    ddim_steps: int = 10
    per_token_size: int = 256  # the SE bottleneck's output channels
    mem_length: int = 16
    retrieval_layers: int = 2
    retrieval_heads: int = 4
    use_timestep_pe: bool = True
    fusion_type: str = "gate"  # 'gate' | 'add'
    consolidate_type: str = "tome"  # 'tome' | 'fifo'
    update_fused: bool = True

    @property
    def num_per_tokens(self) -> int:
        return self.vlm.num_image_tokens

    @property
    def dit(self) -> dit_mod.DiTConfig:
        return dit_mod.make_dit_config(self.action_model_type, token_size=self.vlm.llm.hidden_size,
                                       action_dim=self.action_dim, chunk_size=self.chunk_size,
                                       mem_cross_attn=True)


# ---------------------------------------------------------------------------
# Modules (names follow the JAX parameter tree)
# ---------------------------------------------------------------------------


class _FC2(nn.Module):
    def __init__(self, dims: tuple[int, int, int]):
        super().__init__()
        self.fc1 = core.Linear(dims[0], dims[1])
        self.fc2 = core.Linear(dims[1], dims[2])


class SEBottleneck(nn.Module):
    """1x1 convs as per-token linears: a global-average excitation, then the
    reduction to ``c_out`` channels."""

    def __init__(self, c_in: int, c_out: int, reduction: int = 16, hidden_ratio: float = 0.5):
        super().__init__()
        self.excite = _FC2((c_in, max(1, c_in // reduction), c_in))
        self.reduce = _FC2((c_in, max(1, int(c_in * hidden_ratio)), c_out))


class CrossBlock(nn.Module):
    """Post-LN cross-attention block; its attention has no output projection."""

    def __init__(self, dim: int):
        super().__init__()
        self.q, self.k, self.v = (core.Linear(dim, dim) for _ in range(3))
        self.attn_ln = LayerNorm(dim, eps=1e-5)
        self.ffn = _FC2((dim, dim * 4, dim))
        self.ffn_ln = LayerNorm(dim, eps=1e-5)


class GateFusion(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = core.Linear(dim * 2, dim)


class TimestepEmbedder(nn.Module):
    def __init__(self, dim: int, freq: int = 256):
        super().__init__()
        self.fc0 = core.Linear(freq, dim)
        self.fc1 = core.Linear(dim, dim)


class MemRole(nn.Module):
    """One role's bank modules: retrieval blocks (a Python list in the JAX
    tree), the fusion gate and the timestep embedder."""

    def __init__(self, dim: int, layers: int):
        super().__init__()
        self.retrieval = nn.ModuleList(CrossBlock(dim) for _ in range(layers))
        self.gate = GateFusion(dim)
        self.time = TimestepEmbedder(dim)


class MemVLA(nn.Module):
    def __init__(self, cfg: MemVLAConfig):
        super().__init__()
        H, P = cfg.vlm.llm.hidden_size, cfg.per_token_size
        self.vlm = VLM(cfg.vlm)
        self.per_compr = SEBottleneck(H, P)
        self.mem_bank = nn.ModuleDict({"per": MemRole(P, cfg.retrieval_layers),
                                       "cog": MemRole(H, cfg.retrieval_layers)})
        self.action_head = dit_mod.DiT(cfg.dit)
        self.action_head.per_token_embedder = core.Linear(P, cfg.dit.hidden_size)


@torch.no_grad()
def init_memvla_(model: MemVLA, gen: torch.Generator) -> None:
    """The JAX init's distributions: torch-style uniform linears, identity
    LayerNorms, gates N(0, 1e-3), the per-token embedder N(0, 0.02) with a
    zero bias, the DiT's own (zero final layer and zero cross-attention
    output projections)."""
    init_vlm_(model.vlm, gen)
    core.init_linears_(model.per_compr, gen)
    for role in model.mem_bank.values():
        core.init_linears_(role, gen)
        core.reset_norms_(role)
        core.normal_init_(role.gate.proj.weight, gen, 1e-3)
        core.normal_init_(role.gate.proj.bias, gen, 1e-3)
    head = model.action_head
    dit_mod.init_dit_(head, gen)
    core.normal_init_(head.per_token_embedder.weight, gen, 0.02)
    head.per_token_embedder.bias.zero_()


def build_memvla(cfg: MemVLAConfig, device, seed: int = 0,
                 prepare: Optional[Callable[[nn.Module], nn.Module]] = None) -> MemVLA:
    """Seeded random MemVLA built in place on ``device``: laid out on the
    meta device, recast by ``prepare`` (a dtype policy), then materialised
    and initialised there, as ``models/cogact.build_cogact``."""
    device = torch.device(device)
    with torch.device("meta"):
        model = MemVLA(cfg)
    if prepare is not None:
        model = prepare(model)
    model = model.to_empty(device=device)
    init_memvla_(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Module functions
# ---------------------------------------------------------------------------


def se_bottleneck(se: SEBottleneck, x: torch.Tensor) -> torch.Tensor:
    """[B, N, C_in] -> [B, N, C_out]."""
    pooled = x.mean(dim=1)  # AdaptiveAvgPool2d(1)
    w = torch.sigmoid(se.excite.fc2(F.relu(se.excite.fc1(pooled))))
    x = x * w[:, None, :]
    return se.reduce.fc2(F.relu(se.reduce.fc1(x)))


def cross_block_kv(blk: CrossBlock, query, keys, values, kv_valid, num_heads: int):
    """Cross-attention of ``query`` [B, N, D] to keys and values [B, M, D]
    (``kv_valid`` [B, M]), residual and LayerNorm, then the GELU FFN,
    residual and LayerNorm."""
    B, N, D = query.shape
    M = keys.shape[1]
    hd = D // num_heads
    q = blk.q(query).reshape(B, N, num_heads, hd)
    k = blk.k(keys).reshape(B, M, num_heads, hd)
    v = blk.v(values).reshape(B, M, num_heads, hd)
    zq = torch.zeros((B, N), dtype=torch.int32, device=query.device)
    zk = torch.zeros((B, M), dtype=torch.int32, device=query.device)
    attn = attention_xla(q, k, v, zq, zk, kv_valid).reshape(B, N, D)
    x = layer_norm(query + attn, blk.attn_ln.weight, blk.attn_ln.bias, eps=1e-5)
    ffn = blk.ffn.fc2(F.gelu(blk.ffn.fc1(x)))
    return layer_norm(x + ffn, blk.ffn_ln.weight, blk.ffn_ln.bias, eps=1e-5)


def cross_block(blk: CrossBlock, query, kv, kv_valid, num_heads: int):
    """:func:`cross_block_kv` with the same tokens as keys and values."""
    return cross_block_kv(blk, query, kv, kv, kv_valid, num_heads)


def gate_fusion(gate: GateFusion, x1, x2):
    scale = torch.sigmoid(gate.proj(torch.cat([x1, x2], dim=-1)))
    return scale * x1 + (1 - scale) * x2


def timestep_embed(te: TimestepEmbedder, t: torch.Tensor, freq: int = 256) -> torch.Tensor:
    """Timesteps of any shape [...] -> [..., D], computed in fp32."""
    emb = dit_mod.timestep_embedding(t.reshape(-1), freq)
    out = te.fc1(F.silu(te.fc0(emb.float())))
    return out.reshape(*t.shape, out.shape[-1])


# ---------------------------------------------------------------------------
# The memory bank
# ---------------------------------------------------------------------------


def init_mem_state(cfg: MemVLAConfig, batch: int, dtype=torch.float32, device="cpu") -> dict:
    def role_state(n_tokens, dim):
        return {"feats": torch.zeros((batch, cfg.mem_length, n_tokens, dim), dtype=dtype,
                                     device=device),
                "times": torch.zeros((batch, cfg.mem_length), dtype=torch.float32, device=device),
                "count": torch.zeros((batch,), dtype=torch.int32, device=device)}

    return {"per": role_state(cfg.num_per_tokens, cfg.per_token_size),
            "cog": role_state(1, cfg.vlm.llm.hidden_size)}


def _retrieve(role: MemRole, cfg: MemVLAConfig, st: dict, tokens, timestep):
    """Masked retrieval over [bank slots ++ working tokens]: the keys carry
    the timestep embedding, the values do not; the working tokens are
    visible only while the bank is empty."""
    B, N, D = tokens.shape
    L = cfg.mem_length
    feats = st["feats"].to(tokens.dtype)  # [B, L, N, D]
    count = st["count"]
    slot_valid = (torch.arange(L, device=tokens.device)[None, :] < count[:, None]).int()
    if cfg.use_timestep_pe:
        pe_bank = timestep_embed(role.time, st["times"])  # [B, L, D]
        pe_now = timestep_embed(role.time, timestep)  # [B, D]
    else:
        pe_bank = torch.zeros((B, L, D), dtype=tokens.dtype, device=tokens.device)
        pe_now = torch.zeros((B, D), dtype=tokens.dtype, device=tokens.device)
    mem_bank = (feats + pe_bank[:, :, None, :].to(feats.dtype)).reshape(B, L * N, D)
    mem_now = tokens + pe_now[:, None, :].to(tokens.dtype)
    keys = torch.cat([mem_bank, mem_now], dim=1)
    values = torch.cat([feats.reshape(B, L * N, D), tokens], dim=1)
    now_valid = (count == 0)[:, None].expand(B, N).int()
    kv_valid = torch.cat([slot_valid.repeat_interleave(N, dim=1), now_valid], dim=1)
    query = tokens
    for blk in role.retrieval:
        query = cross_block_kv(blk, query, keys, values, kv_valid, cfg.retrieval_heads)
    return query


def _consolidate(cfg: MemVLAConfig, feats, times, count, new_feat, new_time):
    """Append each row's new entry; a full row instead merges its most
    similar adjacent pair (ToMe: cosine of the token rows, averaged) into one
    slot and appends at the end, or drops its oldest entry (FIFO).  Both
    branches are computed and selected by the count."""
    B, L = times.shape
    j = torch.arange(L, device=times.device)
    at = j[None, :] == count[:, None].long()  # [B, L]
    f_app = torch.where(at[:, :, None, None], new_feat[:, None], feats)
    t_app = torch.where(at, new_time[:, None], times)
    if cfg.consolidate_type == "fifo":
        f_full = torch.cat([feats[:, 1:], new_feat[:, None]], dim=1)
        t_full = torch.cat([times[:, 1:], new_time[:, None]], dim=1)
    else:
        a, b = feats[:, :-1], feats[:, 1:]
        an = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
        bn = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
        idx = (an * bn).sum(-1).mean(-1).argmax(-1)  # [B]: the first of the most similar pair
        rows = torch.arange(B, device=times.device)
        merged_f = 0.5 * (feats[rows, idx] + feats[rows, idx + 1])
        merged_t = 0.5 * (times[rows, idx] + times[rows, idx + 1])
        src = torch.where(j[None] < idx[:, None], j[None], j[None] + 1).clamp(0, L - 1)
        f_full = feats[rows[:, None], src]
        t_full = torch.gather(times, 1, src)
        here = j[None] == idx[:, None]
        f_full = torch.where(here[:, :, None, None], merged_f[:, None], f_full)
        t_full = torch.where(here, merged_t[:, None], t_full)
        last = j[None] == L - 1
        f_full = torch.where(last[:, :, None, None], new_feat[:, None], f_full)
        t_full = torch.where(last, new_time[:, None], t_full)
    full = count >= L
    return (torch.where(full[:, None, None, None], f_full, f_app),
            torch.where(full[:, None], t_full, t_app),
            torch.where(full, torch.full_like(count, L), count + 1))


def bank_step(model: MemVLA, cfg: MemVLAConfig, state: dict, per_tokens, cog_tokens, timesteps):
    """Retrieve, fuse and consolidate for both roles: (fused_per, fused_cog,
    new_state).  ``timesteps``: float [B], each row's frame in its episode."""
    out, new_state = {}, {}
    for role, tokens in (("per", per_tokens), ("cog", cog_tokens)):
        mod, st = model.mem_bank[role], state[role]
        retrieved = _retrieve(mod, cfg, st, tokens, timesteps)
        if cfg.fusion_type == "gate":
            fused = gate_fusion(mod.gate, tokens, retrieved)
        else:
            fused = 0.5 * (tokens + retrieved)
        store = fused if cfg.update_fused else tokens
        f, t, c = _consolidate(cfg, st["feats"], st["times"], st["count"],
                               store.to(st["feats"].dtype), timesteps.float())
        new_state[role] = {"feats": f, "times": t, "count": c}
        out[role] = fused
    return out["per"], out["cog"], new_state


def bank_step_sequential(model: MemVLA, cfg: MemVLAConfig, state1: dict, per_tokens,
                         cog_tokens, timesteps, resets):
    """'group' / 'stream' semantics: the batch rows are consecutive frames of
    one episode sharing the single bank ``state1`` (``init_mem_state(cfg,
    1)``), so row i retrieves against a bank that holds rows 0..i-1's
    consolidated, detached features.  ``resets`` (bool [B]) empties the bank
    before a row.  Returns (fused_per [B, ..], fused_cog [B, ..], the final
    state1); the JAX ``lax.scan`` over rows is a loop here."""
    per_out, cog_out = [], []
    st = state1
    for i in range(per_tokens.shape[0]):
        st = reset_mem_rows(st, resets[i:i + 1])
        per_f, cog_f, st = bank_step(model, cfg, st, per_tokens[i:i + 1], cog_tokens[i:i + 1],
                                     timesteps[i:i + 1].float())
        st = {r: {k: v.detach() for k, v in role.items()} for r, role in st.items()}
        per_out.append(per_f)
        cog_out.append(cog_f)
    return torch.cat(per_out), torch.cat(cog_out), st


def reset_mem_rows(state: dict, reset_mask: torch.Tensor) -> dict:
    """The bank with the rows of ``reset_mask`` (bool [B]) emptied: an
    episode's first frame."""
    m = reset_mask.to(state["cog"]["count"].device)

    def reset_role(st):
        return {"feats": torch.where(m[:, None, None, None], 0.0, st["feats"]),
                "times": torch.where(m[:, None], 0.0, st["times"]),
                "count": torch.where(m, torch.zeros_like(st["count"]), st["count"])}

    return {r: reset_role(st) for r, st in state.items()}


# ---------------------------------------------------------------------------
# Training and serving
# ---------------------------------------------------------------------------


def encode(model: MemVLA, cfg: MemVLAConfig, input_ids, valid, images, remat=False):
    """(per tokens [B, P_tokens, per_token_size], cog token [B, 1, H]).
    ``remat`` checkpoints every tower and decoder layer in training (the JAX
    loss takes none: see :func:`memvla_loss`)."""
    feats = encode_images(model.vlm, cfg.vlm, images, remat=remat)  # the projector's output
    embeds = splice_image_embeds(model.vlm, cfg.vlm, input_ids, feats)
    hidden = vlm_forward(model.vlm, cfg.vlm, input_ids, valid, inputs_embeds=embeds, remat=remat)
    cog = gather_last_hidden(hidden, valid)[:, None, :]
    return se_bottleneck(model.per_compr, feats), cog


def schedule(cfg: MemVLAConfig) -> DiffusionSchedule:
    return DiffusionSchedule.create(cfg.diffusion_steps)


def memvla_loss(model: MemVLA, cfg: MemVLAConfig, batch: dict, state: dict,
                generator: Optional[torch.Generator] = None, sequential_bank: bool = False,
                remat=False,
                diffusion_t: Optional[torch.Tensor] = None,  # [B*rep] injectable (parity)
                diffusion_noise: Optional[torch.Tensor] = None):  # [B*rep, chunk, dim]
    """The diffusion loss conditioned on the memory-fused cog and per
    tokens: (loss, metrics, new_state).  ``batch`` carries 'timesteps'
    (float [B], each row's frame in its episode) and optionally
    'episode_reset' (bool [B]).  ``sequential_bank`` is the 'group' /
    'stream' semantics (``state`` is one bank, ``init_mem_state(cfg, 1)``);
    by default each row has its own bank (parallel_stream).  Timesteps,
    noise and the condition dropout are drawn from ``generator`` unless
    injected; injected noise turns the dropout off, as in JAX.  ``remat``
    checkpoints the tower and decoder layers, which the JAX loss never does
    (its gradient_checkpointing flag does not reach this loss); the values
    are the same."""
    per, cog = encode(model, cfg, batch["input_ids"], batch["attention_mask"], batch["images"],
                      remat=remat)
    if sequential_bank:
        resets = batch.get("episode_reset")
        if resets is None:
            resets = torch.zeros((per.shape[0],), dtype=torch.bool, device=per.device)
        per_f, cog_f, new_state = bank_step_sequential(model, cfg, state, per, cog,
                                                       batch["timesteps"], resets.bool())
    else:
        if "episode_reset" in batch:
            state = reset_mem_rows(state, batch["episode_reset"].bool())
        per_f, cog_f, new_state = bank_step(model, cfg, state, per, cog,
                                            batch["timesteps"].float())
    B, rep = cog.shape[0], cfg.repeated_diffusion_steps
    actions = batch["actions"].reshape(B, -1, cfg.action_dim)[:, : cfg.chunk_size].float()
    head = model.action_head
    cog_rep = cog_f.float().repeat(rep, 1, 1)
    per_rep = head.per_token_embedder(per_f.float()).repeat(rep, 1, 1)
    drop_gen = None if diffusion_noise is not None else generator

    def eps_fn(x_t, t):
        return dit_mod.dit_forward(head, cfg.dit, x_t, t, cog_rep, drop_gen=drop_gen, mem=per_rep)

    loss = schedule(cfg).training_loss(eps_fn, actions.repeat(rep, 1, 1), generator,
                                       t=diffusion_t, noise=diffusion_noise)
    return loss, {"action_loss": loss, "loss": loss}, new_state


def sample_actions(model: MemVLA, cfg: MemVLAConfig, cog_f, per_f, noise, cfg_scale: float):
    """The DiT's DDIM sampling, conditioned on the fused cog token and
    attending to the fused per tokens: the plain loop (K2 does not serve the
    memory cross-attention).  [B, chunk, dim] fp32."""
    head = model.action_head
    B = cog_f.shape[0]
    per_emb = head.per_token_embedder(per_f.float())
    if cfg_scale > 1.0:
        uncond = head.uncondition[None, None, :].expand(B, 1, cog_f.shape[-1])
        z = torch.cat([cog_f.float(), uncond.float()], dim=0)
        per2 = per_emb.repeat(2, 1, 1)

        def eps_fn(x, t):
            return dit_mod.dit_forward_with_cfg(head, cfg.dit, x, t, z, cfg_scale, mem=per2)

        return schedule(cfg).ddim_sample(eps_fn, torch.cat([noise, noise], dim=0),
                                         cfg.ddim_steps)[:B]

    def eps_fn(x, t):
        return dit_mod.dit_forward(head, cfg.dit, x, t, cog_f.float(), mem=per_emb)

    return schedule(cfg).ddim_sample(eps_fn, noise, cfg.ddim_steps)


@torch.no_grad()
def memvla_inference_action(model: MemVLA, cfg: MemVLAConfig, input_ids, valid, images,
                            state: dict, timestep: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            cfg_scale: Optional[float] = None,
                            noise: Optional[torch.Tensor] = None):
    """One serving step: (actions [B, chunk, dim] fp32, new_state).  The
    caller resets ``state`` on an episode's first frame (reset_mem_rows);
    the initial noise is drawn from ``generator`` unless injected."""
    cfg_scale = cfg.cfg_scale if cfg_scale is None else cfg_scale
    per, cog = encode(model, cfg, input_ids, valid, images)
    per_f, cog_f, new_state = bank_step(model, cfg, state, per, cog, timestep.float())
    if noise is None:
        noise = torch.randn((cog_f.shape[0], cfg.chunk_size, cfg.action_dim),
                            generator=generator, dtype=torch.float32, device=cog_f.device)
    return sample_actions(model, cfg, cog_f, per_f, noise, cfg_scale), new_state
