"""Decoder engine and N-stream mixture-of-transformers (port of dexbotic_tpu/nn/transformer.py).

One configurable LLaMA/Qwen/Gemma-family decoder covers the backbones and
the action experts: ``attn_bias``, ``qk_norm``, ``norm_offset``,
``embed_scale``, ``tie_embeddings`` and pi0.5's adaptive-RMSNorm expert
(``adarms_cond_dim``).  :func:`mot_forward` runs N decoder streams through one
joint attention call per layer (each stream with its own weights), with a KV
cache in three modes:

* no cache: a full-sequence forward (:func:`transformer_forward`, its N=1
  case, is CogACT's prefill and training forward; with two streams, the
  flow VLAs' training forward, gradients through both, ``remat`` per layer);
* prefill (``update_cache=True``): the new tokens' rotated K/V are written
  into the cache at its ``length`` (a fresh cache of the new length when
  ``cache`` is None).  A given cache's K/V buffers are written in place, as
  a JAX program that donates its cache (the decode loop of
  ``models/generate.py``); its ``grp``/``valid`` are new tensors;
* frozen prefix (``update_cache=False`` with a cache): the new K/V are
  concatenated to the cache for the attention call and never written back
  (pi0's Euler steps);
* per-row columns (``write_cols``, with ``update_cache``): row b's new
  tokens go to columns ``write_cols[b]..+T-1`` of a given cache, in place,
  and ``length`` is left as it is: the decode engine
  (``exp/decode_engine.py``), whose slots sit at different depths.  A write
  past the cache's last column is dropped, as XLA drops an out-of-bounds
  scatter (torch would raise).

A config with ``moe_num_experts`` makes every layer's MLP a top-k routed
expert bank (``nn/moe.py``); ``want_aux=True`` also returns the MoE
load-balance loss summed over the layers (``{"moe_aux": ...}``), so that a
loss can train the router with its balance term.

Layers are a ``ModuleList``: ``utils/bridge.py`` unstacks the JAX layer
stacks.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import torch
from torch import nn

from dexbotic_tpu_torch.nn import core, moe
from dexbotic_tpu_torch.ops.attention import attention
from dexbotic_tpu_torch.ops.norms import RMSNorm
from dexbotic_tpu_torch.ops.rope import apply_rope, rope_cos_sin


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Geometry + flavour flags for one decoder stack."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    act: str = "silu"
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    norm_offset: float = 0.0  # 1.0 for Gemma-style (1 + w) RMSNorm scales
    qk_norm: bool = False  # Qwen3 per-head q/k RMSNorm
    attn_bias: bool = False  # Qwen2 qkv biases
    embed_scale: bool = False  # Gemma: embeddings * sqrt(hidden)
    tie_embeddings: bool = True
    has_embed: bool = True  # action experts strip embed_tokens
    adarms_cond_dim: Optional[int] = None  # pi0.5 action expert
    attn_scale: Optional[float] = None  # default head_dim**-0.5
    attn_impl: str = "auto"
    # a top-k routed expert bank in every layer's MLP (nn/moe.py), its
    # expert stacks sharded over an 'expert' mesh axis under expert parallelism
    moe_num_experts: Optional[int] = None
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


class AdaRMSNorm(nn.Module):
    """pi0.5's adaptive RMSNorm: ``dense`` maps the condition to a scale, a
    shift and a residual gate (zero-initialised, as the JAX init)."""

    def __init__(self, cond_dim: int, dim: int):
        super().__init__()
        self.dense = core.Linear(cond_dim, 3 * dim)


def _make_norm(cfg: TransformerConfig, dim: int) -> nn.Module:
    if cfg.adarms_cond_dim is not None:
        return AdaRMSNorm(cfg.adarms_cond_dim, dim)
    return RMSNorm(dim, cfg.rms_eps, cfg.norm_offset)


class _Attn(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        h = cfg.hidden_size
        self.q = core.Linear(h, cfg.q_dim, cfg.attn_bias)
        self.k = core.Linear(h, cfg.kv_dim, cfg.attn_bias)
        self.v = core.Linear(h, cfg.kv_dim, cfg.attn_bias)
        self.o = core.Linear(cfg.q_dim, h, False)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, cfg.rms_eps, cfg.norm_offset)
            self.k_norm = RMSNorm(cfg.head_dim, cfg.rms_eps, cfg.norm_offset)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln1 = _make_norm(cfg, cfg.hidden_size)
        self.ln2 = _make_norm(cfg, cfg.hidden_size)
        self.attn = _Attn(cfg)
        self.mlp = (moe.MoE(cfg.hidden_size, cfg.intermediate_size, cfg.moe_num_experts)
                    if cfg.moe_num_experts else core.GatedMLP(cfg.hidden_size, cfg.intermediate_size))

    def forward(self, fn, *args):
        """``fn(*args)``: :func:`mot_forward` runs a layer's computation as a
        call of the layer, so that hooks on it (``parallel/mesh.shard_model``'s
        per-layer FSDP2 gather) run around it."""
        return fn(*args)


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg  # the head counts tensor parallelism checks (parallel/mesh.tp_plan)
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = _make_norm(cfg, cfg.hidden_size)
        if cfg.has_embed:
            self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            if not cfg.tie_embeddings:
                self.lm_head = core.Linear(cfg.hidden_size, cfg.vocab_size, False)


@torch.no_grad()
def init_transformer_(llm: Transformer, gen: torch.Generator) -> None:
    """The JAX init's distributions (init_transformer), drawn from ``gen``."""
    core.init_linears_(llm, gen)
    core.reset_norms_(llm)
    for m in llm.modules():
        if isinstance(m, AdaRMSNorm):
            m.dense.weight.zero_()
            m.dense.bias.zero_()
        elif isinstance(m, moe.MoE):
            moe.moe_init_(m, gen)
    if hasattr(llm, "embed"):
        core.normal_init_(llm.embed.weight, gen)


def embed_tokens(llm: Transformer, cfg: TransformerConfig, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    x = core.embed(llm.embed, ids)
    if dtype is not None:
        x = x.to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype, device=x.device)
    return x


def lm_logits(llm: Transformer, cfg: TransformerConfig, hidden: torch.Tensor) -> torch.Tensor:
    if hasattr(llm, "lm_head"):
        return llm.lm_head(hidden)
    e = llm.embed  # tied embedding
    if isinstance(e, core.QuantEmbedding):  # int8 rows, per-row scales, in hidden's dtype
        return (hidden @ e.q.to(hidden.dtype).t()) * e.s.to(hidden.dtype).t()
    w = e.weight
    if hasattr(w, "full_tensor"):  # a table split over the 'model' axis: gathered whole
        w = w.full_tensor()
    return hidden @ w.to(hidden.dtype).t()


def _apply_norm(norm: nn.Module, cfg: TransformerConfig, x: torch.Tensor,
                cond: Optional[torch.Tensor]):
    """(normed, gate or None); adaRMS as pi0.5's fork computes it: fp32
    normalisation, then x * (1 + scale) + shift, the gate for the residual."""
    if isinstance(norm, AdaRMSNorm):
        if cond is None:
            raise ValueError("an adaRMS stream needs its condition (Stream.cond)")
        xf = x.float()
        normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + cfg.rms_eps)
        scale, shift, gate = norm.dense(cond.float()).chunk(3, dim=-1)
        normed = normed * (1.0 + scale[:, None, :]) + shift[:, None, :]
        return normed.to(x.dtype), gate.to(x.dtype)
    return norm(x), None


def _gated_residual(x: torch.Tensor, y: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    return x + y if gate is None else x + y * gate[:, None, :]


# ---------------------------------------------------------------------------
# KV cache and the MoT forward
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stream:
    """One decoder taking part in the joint attention; ``embeds`` None leaves
    it out of this call (its weights still set the geometry checks)."""

    cfg: TransformerConfig
    module: Transformer
    embeds: Optional[torch.Tensor]  # [B, T_i, H_i]
    cond: Optional[torch.Tensor] = None  # adaRMS condition [B, cond_dim]


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> dict:
    """An empty cache: k/v [layers, B, max_len, Hkv, D], int32 grp/valid/seg
    [B, max_len] and the write cursor ``length`` (a Python int)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)

    def ints():
        return torch.zeros((batch, max_len), dtype=torch.int32, device=device)

    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "grp": ints(), "valid": ints(), "seg": ints(), "length": 0}


def _i32(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.to(torch.int32).contiguous()


class _RowWrites:
    """Row b's T new tokens written at cache columns ``cols[b]..+T-1``; a
    write past the cache's ends is dropped (XLA's scatter semantics).

    No write leaves the cache and no host sync is needed: a dropped write is
    sent to the nearest column in bounds, carrying the value the row's own
    kept write puts there (the same value twice), or, when the row keeps no
    write at all (a parked or finished slot), the value already there."""

    def __init__(self, cols: torch.Tensor, T: int, C: int):
        w = cols.to(torch.long)[:, None]
        t = torch.arange(T, device=w.device)[None]
        self.rows = torch.arange(w.shape[0], device=w.device)[:, None].expand(-1, T)
        self.tgt = (w + t).clamp(0, C - 1)  # the column each write lands on
        self.src = (self.tgt - w).clamp(0, T - 1)  # the new token whose value it carries
        self.keeps = ((w <= C - 1) & (w + T - 1 >= 0))  # [B, 1]: the row keeps a write

    def put_(self, buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        """Write ``new`` [B, T, ...] into ``buf`` [B, C, ...] in place."""
        keep = self.keeps.reshape(self.keeps.shape + (1,) * (new.ndim - 2))
        vals = torch.where(keep, new.to(buf.dtype)[self.rows, self.src], buf[self.rows, self.tgt])
        buf[self.rows, self.tgt] = vals
        return buf


def _through_layers(layers: tuple, fn, *args):
    """``fn(layers, *args)`` inside a call of each decoder layer of
    ``layers`` (one a stream, nested)."""
    def call(i, *a):
        if i == len(layers):
            return fn(layers, *a)
        return layers[i](functools.partial(call, i + 1), *a)

    return call(0, *args)


def mot_layer(cfgs: Sequence[TransformerConfig], lps: Sequence, xs: Sequence, conds: Sequence,
              cos: torch.Tensor, sin: torch.Tensor, q_grp: torch.Tensor, q_valid: torch.Tensor,
              q_seg: Optional[torch.Tensor] = None, kv=None, attn_group=None) -> tuple:
    """One decoder layer of N streams (the body of :func:`mot_forward`'s
    layers, and of ``parallel/pipeline.mot_decoder_layer``): each active
    stream's q/k/v with its own weights, one joint attention over the
    concatenation, each stream's output projection, MLP or MoE bank and
    (adaRMS-gated) residuals.  A stream whose ``x`` is None sits out.

    ``cos``/``sin`` and the int32 ``q_*`` vectors span the concatenation.
    ``kv`` None attends the new tokens only; ``(join, kv_grp, kv_valid,
    kv_seg)`` attends ``join(k, v)`` (the new K/V with a cache) under those
    vectors.  Returns (outs, aux): the streams' outputs (None for an
    inactive one) and the layer's MoE balance loss (None without an MoE
    stream)."""
    base = cfgs[0]
    scale = base.attn_scale if base.attn_scale is not None else base.head_dim ** -0.5
    first = next(x for x in xs if x is not None)
    aux = (torch.zeros((), dtype=torch.float32, device=first.device)
           if any(c.moe_num_experts for c in cfgs) else None)
    q_list, k_list, v_list, gates1 = [], [], [], []
    for cfg, lp, x, cond in zip(cfgs, lps, xs, conds):
        if x is None:
            gates1.append(None)
            continue
        h, gate1 = _apply_norm(lp.ln1, cfg, x, cond)
        gates1.append(gate1)
        b, n, _ = h.shape
        # heads from the tensor: under tensor parallelism a rank holds
        # num_heads / model of them (parallel/mesh.TP_PLAN)
        q = lp.attn.q(h).reshape(b, n, -1, cfg.head_dim)
        k = lp.attn.k(h).reshape(b, n, -1, cfg.head_dim)
        v = lp.attn.v(h).reshape(b, n, -1, cfg.head_dim)
        if cfg.qk_norm:
            q, k = lp.attn.q_norm(q), lp.attn.k_norm(k)
        q_list.append(q)
        k_list.append(k)
        v_list.append(v)
    q_cat, k_cat, v_cat = (t[0] if len(t) == 1 else torch.cat(t, 1)
                           for t in (q_list, k_list, v_list))
    q_cat, k_cat = apply_rope(q_cat, cos, sin), apply_rope(k_cat, cos, sin)
    if kv is None:
        k_full, v_full, kv_grp, kv_valid, kv_seg = k_cat, v_cat, q_grp, q_valid, q_seg
    else:
        join, kv_grp, kv_valid, kv_seg = kv
        k_full, v_full = join(k_cat, v_cat)
    a = attention(q_cat, k_full, v_full, q_grp, kv_grp, kv_valid, scale=scale,
                  impl=base.attn_impl, q_seg=q_seg, kv_seg=kv_seg, group=attn_group)
    B, T = a.shape[:2]
    outs, offset = [], 0
    for cfg, lp, x, cond, gate1 in zip(cfgs, lps, xs, conds, gates1):
        if x is None:
            outs.append(None)
            continue
        n = x.shape[1]
        o = lp.attn.o((a if n == T else a[:, offset: offset + n]).reshape(B, n, -1))
        x1 = _gated_residual(x, o, gate1)
        h2, gate2 = _apply_norm(lp.ln2, cfg, x1, cond)
        if cfg.moe_num_experts:
            m, layer_aux = lp.mlp(h2, cfg.act, cfg.moe_top_k, cfg.moe_capacity_factor,
                                  valid=q_valid[:, offset: offset + n])
            aux = aux + layer_aux
        else:
            m = lp.mlp(h2, cfg.act)
        offset += n
        outs.append(_gated_residual(x1, m, gate2))
    return tuple(outs), aux


def mot_forward(streams: Sequence[Stream], positions: torch.Tensor, q_grp: torch.Tensor,
                q_valid: torch.Tensor, cache: Optional[dict] = None, update_cache: bool = False,
                remat=False, q_seg: Optional[torch.Tensor] = None, write_cols=None,
                want_aux: bool = False, attn_group=None):
    """Joint attention over N decoder streams; returns (outs, cache), and
    (outs, cache, {"moe_aux": the load-balance loss summed over layers}) with
    ``want_aux`` (0 without an MoE stream).

    The active streams' tokens are concatenated along the sequence; every
    layer computes each stream's q/k/v with its own weights, runs one
    attention over the concatenation (plus the cached K/V), then splits back
    for each stream's output projection, MLP and residuals.  ``positions``,
    ``q_grp``, ``q_valid`` and ``q_seg`` are [B, T] for the new tokens; RoPE
    is applied to the new tokens only (the cached K is already rotated).

    ``outs`` is aligned with ``streams`` (None for an inactive one), each
    final-normed.  ``cache`` is the updated cache (``update_cache``), the
    given one (frozen mode) or None.  Segment ids stay None when neither the
    call nor the cache has any.  ``attn_group`` is the process group of a
    ring attention (``attn_impl="ring:<axis>"``), taken from the caller's
    mesh; None finds the axis on the current mesh."""
    if write_cols is not None and (cache is None or not update_cache):
        raise ValueError("write_cols writes into a given cache (update_cache=True)")
    active = [s for s in streams if s.embeds is not None]
    if not active:
        raise ValueError("at least one stream must have embeddings")
    base = streams[0].cfg
    geometry = (base.num_heads, base.num_kv_heads, base.head_dim, base.num_layers)
    for s in streams:
        if (s.cfg.num_heads, s.cfg.num_kv_heads, s.cfg.head_dim, s.cfg.num_layers) != geometry:
            raise ValueError("MoT streams must share attention geometry and depth")

    T = sum(0 if s.embeds is None else s.embeds.shape[1] for s in streams)
    first = active[0].embeds
    B, dtype, device = first.shape[0], first.dtype, first.device
    cos, sin = rope_cos_sin(positions, base.head_dim, base.rope_theta)

    # the int32 mask vectors of the call, built once for every layer
    q_grp, q_valid, q_seg = _i32(q_grp), _i32(q_valid), _i32(q_seg)
    start = 0
    cache_k = cache_v = None
    if update_cache and cache is None:  # a fresh cache: this call's own, written in place
        shape = (base.num_layers, B, T, base.num_kv_heads, base.head_dim)
        cache_k = torch.empty(shape, dtype=dtype, device=device)
        cache_v = torch.empty(shape, dtype=dtype, device=device)
        kv_grp, kv_valid, kv_seg = q_grp, q_valid, q_seg
    elif cache is not None:
        start = int(cache["length"])
        cache_seg = cache.get("seg")
        segs = q_seg is not None or cache_seg is not None
        if segs:
            q_seg = torch.zeros_like(q_grp) if q_seg is None else q_seg
            cache_seg = torch.zeros_like(cache["grp"]) if cache_seg is None else cache_seg
        if update_cache and write_cols is not None:
            rw = _RowWrites(write_cols, T, cache["grp"].shape[1])
            kv_grp = rw.put_(cache["grp"].clone(), q_grp)
            kv_valid = rw.put_(cache["valid"].clone(), q_valid)
            kv_seg = rw.put_(cache_seg.clone(), q_seg) if segs else None
            cache_k, cache_v = cache["k"], cache["v"]
        elif update_cache:
            if start + T > cache["grp"].shape[1]:
                raise ValueError(f"{T} tokens at {start} overflow a cache of {cache['grp'].shape[1]}")
            new = slice(start, start + T)
            kv_grp, kv_valid = cache["grp"].clone(), cache["valid"].clone()
            kv_grp[:, new], kv_valid[:, new] = q_grp, q_valid
            kv_seg = None
            if segs:
                kv_seg = cache_seg.clone()
                kv_seg[:, new] = q_seg
            cache_k, cache_v = cache["k"], cache["v"]
        else:
            kv_grp = torch.cat([cache["grp"], q_grp], 1)
            kv_valid = torch.cat([cache["valid"], q_valid], 1)
            kv_seg = torch.cat([cache_seg, q_seg], 1) if segs else None
            cache_k, cache_v = cache["k"], cache["v"]
    else:
        kv_grp, kv_valid, kv_seg = q_grp, q_valid, q_seg

    moe_streams = any(s.cfg.moe_num_experts for s in streams)
    cfgs = tuple(s.cfg for s in streams)

    def join_cache(ck, cv, k_cat, v_cat):
        if update_cache and write_cols is not None:  # per-row columns, in place
            k_full, v_full = rw.put_(ck, k_cat), rw.put_(cv, v_cat)
        elif update_cache:  # ck/cv: this layer's slice of the call's own buffer
            ck[:, start:start + T] = k_cat
            cv[:, start:start + T] = v_cat
            k_full, v_full = ck, cv
        else:
            k_full = torch.cat([ck, k_cat.to(ck.dtype)], 1)
            v_full = torch.cat([cv, v_cat.to(cv.dtype)], 1)
        return k_full.to(k_cat.dtype), v_full.to(v_cat.dtype)

    def layer(layers, ck, cv, conds, *xs):
        kv = None if ck is None else (functools.partial(join_cache, ck, cv), kv_grp, kv_valid,
                                      kv_seg)
        outs, aux = mot_layer(cfgs, layers, xs, conds, cos, sin, q_grp, q_valid, q_seg, kv=kv,
                              attn_group=attn_group)
        return outs + ((aux,) if moe_streams else ())

    xs = tuple(s.embeds for s in streams)
    # the conditions go in as arguments, where a layer's hooks see them
    conds = tuple(s.cond for s in streams)
    # the MoE balance loss summed over the layers (no tensor is made without MoE or want_aux)
    aux = torch.zeros((), dtype=torch.float32, device=device) if moe_streams or want_aux else None
    for i, layers in enumerate(zip(*(s.module.layers for s in streams))):
        ck = None if cache_k is None else cache_k[i]
        cv = None if cache_v is None else cache_v[i]
        xs = core.remat_call(_through_layers, remat, layers, layer, ck, cv, conds, *xs)
        if moe_streams:
            aux, xs = aux + xs[-1], xs[:-1]

    outs = [None if x is None else _apply_norm(s.module.norm, s.cfg, x, s.cond)[0]
            for s, x in zip(streams, xs)]
    if update_cache:
        cache = {"k": cache_k, "v": cache_v, "grp": kv_grp, "valid": kv_valid, "seg": kv_seg,
                 "length": start if write_cols is not None else start + T}
    if want_aux:
        return outs, cache, {"moe_aux": aux}
    return outs, cache


def transformer_forward(cfg: TransformerConfig, llm: Transformer, embeds: torch.Tensor,
                        positions: torch.Tensor, grp: torch.Tensor, valid: torch.Tensor,
                        q_seg: Optional[torch.Tensor] = None, remat=False, want_aux: bool = False,
                        attn_group=None):
    """Single-stream full-sequence forward, the N=1 case of
    :func:`mot_forward`; returns the final-normed hidden states, and with
    ``want_aux`` (hidden, {"moe_aux": ...}), so that an MoE decoder's loss
    can add the load-balance term.

    ``remat`` (False | True | "dots") is the JAX flag, applied per layer
    (``core.remat_call``)."""
    res = mot_forward([Stream(cfg, llm, embeds)], positions, grp, valid, remat=remat,
                      q_seg=q_seg, want_aux=want_aux, attn_group=attn_group)
    return (res[0][0], res[2]) if want_aux else res[0][0]
