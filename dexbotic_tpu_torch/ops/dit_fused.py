"""Fused DiT sampler: the whole diffusion sampling loop in one kernel launch.

Port of dexbotic_tpu/ops/dit_fused.py.  :func:`fused_dit_sample` is the
wrapper of kernel K2 (``csrc/dit_sampler.cu``): on a CUDA tensor it does the
same host precompute as the JAX wrapper (scheduler coefficient table in
execution order, per-step condition tokens ``t_mlp(te) + z_embed(z)``) and
launches the kernel or raises; on a CPU tensor it runs
:func:`dit_sample_ref`, the plain version: the samplers of
``ops/diffusion.py`` looped over ``dit_forward``.

The kernel takes the block weights stacked per layer K-major, [depth, out,
in], in the head's dtype or, when every block layer is quantized
(``nn/core.QuantLinear``), as int8 with [depth, out] scales in the head's
dtype, dequantized in the kernel as the JAX kernel does
(``w.astype(cdtype) * s.astype(cdtype)``).  The wrapper builds those
buffers, the scheduler table and the timestep MLP's output once per head and
caches them on it (rebuilt when a parameter they come from is replaced or
changed in place).  ``t_mlp`` and ``z_embed`` run as the head's own layers:
through K4 (``ops/quant_matmul.py``) when quantized.

Which shapes K2 serves is one rule, :func:`k2_serves`: up to 288 padded
tokens (16 rows of 17 at DiT-B, 272: CogACT's 8-frame micro-batch with CFG).
:func:`plan` picks, per row count, the kernel's N tile and each product's k
chunks (its split-K into ordered fp32 partials).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from dexbotic_tpu_torch.models.dit import DiT, DiTConfig, dit_forward, dit_forward_with_cfg
from dexbotic_tpu_torch.nn.core import QuantLinear, weight_dtype
from dexbotic_tpu_torch.ops.diffusion import DiffusionSchedule, ddim_timesteps, dpm_coefficients
from dexbotic_tpu_torch.ops.quant import dequantize_weight

_BLOCK_LINEARS = ("qkv", "o", "fc0", "fc1")


@torch.no_grad()
def dit_sample_ref(head: DiT, cfg: DiTConfig, z: torch.Tensor, noise: torch.Tensor,
                   schedule: DiffusionSchedule, *, steps: int, cfg_scale: float,
                   sampler: str = "ddim") -> torch.Tensor:
    """Plain version of K2: sampler loop over dit_forward(_with_cfg). [B, T, A] fp32."""
    B = noise.shape[0]
    if cfg_scale > 1.0:
        uncond = head.uncondition.float()[None, None, :].expand(B, 1, -1)
        z2 = torch.cat([z.float(), uncond], dim=0)
        x0 = torch.cat([noise, noise], dim=0)

        def eps_fn(x, t):
            return dit_forward_with_cfg(head, cfg, x, t, z2, cfg_scale)
    else:
        z2, x0 = z.float(), noise

        def eps_fn(x, t):
            return dit_forward(head, cfg, x, t, z2)

    if sampler == "dpm":
        out = schedule.dpm_solver_pp_2m(eps_fn, x0, steps)
    elif sampler == "ddim":
        out = schedule.ddim_sample(eps_fn, x0, steps)
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    return out[:B]


def coefficient_table(schedule: DiffusionSchedule, steps: int, sampler: str):
    """(coef [N, 6] fp32, timesteps [N] float64), both in execution order."""
    acp = np.asarray(schedule.alphas_cumprod, np.float64)
    kept = ddim_timesteps(schedule.num_steps, steps)
    C = np.zeros((steps, 6), np.float32)
    if sampler == "ddim":
        ab = acp[kept][::-1]
        ab_prev = np.concatenate([[1.0], acp[kept][:-1]])[::-1]
        C[:, 0], C[:, 1] = np.sqrt(ab), np.sqrt(1.0 - ab)
        C[:, 2], C[:, 3] = np.sqrt(ab_prev), np.sqrt(1.0 - ab_prev)
    elif sampler == "dpm":
        c = dpm_coefficients(acp, schedule.num_steps, steps)
        C[:, 0], C[:, 1], C[:, 2] = c["a_s"], c["s_s"], c["sig_ratio"]
        C[:, 3], C[:, 4] = c["coef"], c["inv_2r"]
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    return C, np.asarray(kept[::-1], np.float64)


def _cached(head: DiT, name: str, params, extra, build):
    """``build()``, cached on the head until a tensor of ``params`` is replaced
    or changed in place, or ``extra`` changes."""
    key = (extra, tuple((p.data_ptr(), p._version, p.dtype, p.device) for p in params))
    hit = head._k2_cache.get(name)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, build())
        head._k2_cache[name] = hit
    return hit[1]


def _dense_weight(lin) -> torch.Tensor:
    """A layer's [out, in] weight; a quantized one dequantized once, as the
    JAX wrapper does for x_embed and final (``dit_fused.py:290-297``): the
    fp32 product q * s rounded once to the scales' dtype, which is what the
    kernel's in-register ``w.astype(cdtype) * s.astype(cdtype)`` gives."""
    return dequantize_weight(lin.q, lin.s) if isinstance(lin, QuantLinear) else lin.weight


def _stacked_weights(head: DiT) -> dict:
    """[depth, out, in] weights in the head's dtype, or int8 [depth, out, in]
    with [depth, out] scales ``s*`` when every block layer is quantized, and
    [depth, out] fp32 biases."""
    lins = {
        "qkv": [b.attn.qkv for b in head.blocks], "o": [b.attn.o for b in head.blocks],
        "fc0": [b.mlp.fc0 for b in head.blocks], "fc1": [b.mlp.fc1 for b in head.blocks],
    }
    cdtype = weight_dtype(head.x_embed)
    int8 = all(isinstance(lin, QuantLinear) for ls in lins.values() for lin in ls)

    def build():
        bufs = {}
        for name, ls in lins.items():
            if int8:
                bufs["w" + name] = torch.stack([lin.q for lin in ls]).contiguous()
                bufs["s" + name] = torch.stack([lin.s.to(cdtype) for lin in ls]).contiguous()
            else:
                bufs["w" + name] = torch.stack([_dense_weight(lin) for lin in ls]).contiguous()
            bufs["b" + name] = torch.stack([lin.bias.float() for lin in ls]).contiguous()
        return bufs

    params = [p for ls in lins.values() for lin in ls for p in lin.parameters()]
    return _cached(head, "stacked", params, None, build)


def _step_tables(head: DiT, cfg: DiTConfig, schedule: DiffusionSchedule, steps: int,
                 sampler: str, dev) -> tuple:
    """(coefficient table [N, 6] fp32, t_mlp(timestep embedding) [N, H]) on ``dev``."""
    cdtype = weight_dtype(head.x_embed)

    def build():
        C, ts = coefficient_table(schedule, steps, sampler)
        half = cfg.freq_embed_size // 2
        freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
        args = ts[:, None] * freqs[None]
        te = np.concatenate([np.cos(args), np.sin(args)], axis=1).astype(np.float32)
        te = torch.from_numpy(te).to(dev, cdtype)
        return torch.from_numpy(C).to(dev), head.t_mlp.fc1(F.silu(head.t_mlp.fc0(te)))

    extra = (steps, sampler, schedule.num_steps, np.asarray(schedule.alphas_cumprod).tobytes(),
             str(dev))
    return _cached(head, "tables", list(head.t_mlp.parameters()), extra, build)


def prepare(head: DiT, cfg: DiTConfig, z: torch.Tensor, schedule: DiffusionSchedule,
            steps: int, cfg_scale: float, sampler: str) -> dict:
    """Everything K2 reads besides the noise, in the kernel's layouts.

    What depends only on the weights and the schedule is built once and cached
    on the head; per call only the condition tokens are computed."""
    cdtype = weight_dtype(head.x_embed)
    coef, te = _step_tables(head, cfg, schedule, steps, sampler, z.device)
    with torch.no_grad():
        zc = z[:, 0, :].to(cdtype)
        if cfg_scale > 1.0:
            zc = torch.cat([zc, head.uncondition.to(cdtype)[None].expand_as(zc)], dim=0)
        cond = (te[:, None, :] + head.z_embed(zc)[None]).to(cdtype).contiguous()
    small = _cached(head, "small", [head.pos_embed, *head.x_embed.parameters(),
                                    *head.final.parameters()], None, lambda: {
        "pos": head.pos_embed.to(cdtype).contiguous(),
        "xw": _dense_weight(head.x_embed).t().to(cdtype).contiguous(),
        "xb": head.x_embed.bias.float().contiguous(),
        "fw": _dense_weight(head.final).t().to(cdtype).contiguous(),
        "fb": head.final.bias.float().contiguous(),
    })
    return {"coef": coef, "cond": cond, **small, **_stacked_weights(head)}


# K2's shapes (csrc/dit_sampler.cu): N tiles of these padded token rows, at
# most four; 128-channel items of 64-deep k steps; 25 KB of shared memory for
# the attention and LayerNorm phases.
BN_TILES = (24, 40, 72)
MAX_TILES = 4
_MAX_ITEMS = 24  # a block's items in one product (the kernel's Table)
_CB, _K_STEP, _SCRATCH_BYTES, _AMAX = 128, 64, 25 * 1024, 16
# a product item's own cost beside its k steps, in k steps: the wait for its
# activations and the store of its partial plane
_ITEM_STEPS = 2


def k2_serves(rows: int, T: int, A: int, H: int, M: int, heads: int) -> bool:
    """Whether K2 serves ``rows`` sample rows (2 B with CFG) of T + 1 tokens,
    action dim A, width H, MLP width M and ``heads`` heads: at most 288
    padded tokens, four N tiles of 72 (CogACT's 8-frame micro-batch with CFG
    at DiT-B: 16 rows of 17), 128-aligned widths, and the attention of one
    head in the kernel's shared memory.  Past it the sampler runs the plain
    loop."""
    S = T + 1
    return (rows >= 1 and rows * S <= BN_TILES[-1] * MAX_TILES and 1 <= A <= _AMAX and S <= 32
            and H % _CB == 0 and M % _CB == 0 and heads > 0 and H % heads == 0
            and 3 * S * (H // heads + 1) * 4 <= _SCRATCH_BYTES and (H + 8) * 4 <= _SCRATCH_BYTES)


def products(H: int, M: int) -> tuple:
    """(name, N, K) of a block's four products, in the kernel's order."""
    return (("qkv", 3 * H, H), ("o", H, H), ("fc0", M, H), ("fc1", H, M))


@dataclasses.dataclass(frozen=True)
class Plan:
    """K2's work split: N tiles of ``bn`` rows (``nt`` of them) and the k
    chunks of each product (qkv, o, fc0, fc1), whose fp32 partial planes the
    next phase sums in chunk order."""

    bn: int
    nt: int
    chunks: tuple

    @property
    def rp(self) -> int:
        """Padded token rows of the activations."""
        return self.bn * self.nt

    def items(self, N: int, K: int, chunks: int, sms: int) -> list:
        """The kernel's walk of one product: per block, its items as (chunk,
        channel block, N tile, first k step, end k step); item
        i = (chunk * N / 128 + channel block) * nt + tile, block b takes
        [b * total / sms, (b + 1) * total / sms)."""
        nb, ks = N // _CB, K // _K_STEP
        total = chunks * nb * self.nt
        out = []
        for b in range(sms):
            walk = []
            for i in range(b * total // sms, (b + 1) * total // sms):
                c = i // (self.nt * nb)
                walk.append((c, (i // self.nt) % nb, i % self.nt, c * ks // chunks,
                             (c + 1) * ks // chunks))
            out.append(walk)
        return out

    def partial_bytes(self, H: int, M: int) -> dict:
        """fp32 partial bytes a layer writes, per product."""
        return {name: nc * self.rp * N * 4
                for (name, N, _), nc in zip(products(H, M), self.chunks)}

    def describe(self, H: int, M: int) -> dict:
        """Items and partial MB per product, for the record."""
        part = self.partial_bytes(H, M)
        return {"rows_per_tile": self.bn, "tiles": self.nt, **{
            name: {"chunks": nc, "items": nc * (N // _CB) * self.nt, "partial_mb": part[name] / 1e6}
            for (name, N, _), nc in zip(products(H, M), self.chunks)}}


@functools.lru_cache(maxsize=None)
def plan(rows: int, T: int, H: int, M: int, sms: int = 132) -> Plan:
    """The N tile: the smallest of BN_TILES that holds the padded tokens, or
    tiles of 72.  Each product's k chunks: the fewest that reach the least
    time of the slowest block, rounds x (k steps an item + _ITEM_STEPS) with
    rounds = ceil(items / sms) (items close under a multiple of the blocks);
    then, while a layer's partial bytes exceed its bf16 weight bytes, the
    product whose fewer chunks cost the least time per byte saved takes
    fewer.  The budget is the bf16 bytes for int8 blocks too: at 272 rows one
    chunk a product already writes 7.5 MB, more than DiT-B's 7.1 MB of int8
    weights, and holding int8 to its own bytes (one chunk a product) made K2
    1.5x slower at B=8 on an H100 (script/probe_dit_sampler_torch.py plans)."""
    tokens = rows * (T + 1)
    bn = next((b for b in BN_TILES if tokens <= b), BN_TILES[-1])
    nt = -(-tokens // bn)
    prods = products(H, M)

    def cost(N, K, nc):
        return -(-(N // _CB * nt * nc) // sms) * (-(-(K // _K_STEP) // nc) + _ITEM_STEPS)

    def fits(N, nc):  # the items a block takes stay within the kernel's table
        return -(-(N // _CB * nt * nc) // sms) <= _MAX_ITEMS

    chunks = [min((nc for nc in range(1, K // _K_STEP + 1) if fits(N, nc)),
                  key=lambda nc: (cost(N, K, nc), nc)) for _, N, K in prods]
    budget = sum(N * K for _, N, K in prods) * 2

    def partial(i, nc):
        return nc * bn * nt * prods[i][1] * 4

    while sum(partial(i, nc) for i, nc in enumerate(chunks)) > budget:
        moves = [((cost(N, K, nc) - cost(N, K, chunks[i])) / (partial(i, chunks[i]) - partial(i, nc)),
                  i, nc)
                 for i, (_, N, K) in enumerate(prods) for nc in range(1, chunks[i])]
        if not moves:
            break
        _, i, nc = min(moves)
        chunks[i] = nc
    return Plan(bn, nt, tuple(chunks))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


PROBE_WORDS = 6  # a record of K2's probe: start, end, wait, product, store, issue


def probe_words(sms: int, steps: int, depth: int) -> int:
    """uint64 words of K2's probe buffer (``_launch(probe=...)``): a header
    of 4 a block, then PROBE_WORDS a (step, phase, block) for 3 + 9 depth
    phases a step."""
    return 4 * sms + steps * (3 + 9 * depth) * sms * PROBE_WORDS


def _launch(head: DiT, cfg: DiTConfig, z, noise, schedule, steps, cfg_scale, sampler,
            k2_plan: Plan | None = None, probe: torch.Tensor | None = None):
    """Launch K2.  ``k2_plan``: a plan other than :func:`plan`'s (the tests
    run every tile); ``probe``: an int64 buffer of :func:`probe_words` that
    the kernel fills with its per-phase times (script/probe_dit_sampler_torch.py)."""
    from dexbotic_tpu_torch.kernels import build

    cdtype = weight_dtype(head.x_embed)
    if cdtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"DiT sampler kernel takes bf16 or fp32 weights, got {cdtype}")
    if cfg_scale > 1.0 and not hasattr(head, "uncondition"):
        raise ValueError("CFG needs the head's uncondition embedding")
    B, T, A = noise.shape
    H, M = cfg.hidden_size, cfg.mlp_dim
    rows = (2 if cfg_scale > 1.0 else 1) * B
    if not k2_serves(rows, T, A, H, M, cfg.num_heads):
        raise ValueError(f"DiT sampler kernel does not serve rows={rows} T={T} A={A} H={H} M={M} "
                         f"heads={cfg.num_heads}")
    prep = prepare(head, cfg, z, schedule, steps, cfg_scale, sampler)
    for name, t in prep.items():
        if t.device != noise.device or not t.is_contiguous():
            raise ValueError(f"K2 operand {name} not contiguous on {noise.device}")
    int8 = prep["wqkv"].dtype == torch.int8
    dense = () if int8 else tuple("w" + n for n in _BLOCK_LINEARS)
    if any(prep[k].dtype != cdtype for k in (*dense, "cond", "pos", "xw", "fw")):
        raise TypeError(f"DiT head weights must share one dtype, {cdtype}")
    if int8 and any(prep["w" + n].dtype != torch.int8 or prep["s" + n].dtype != cdtype
                    for n in _BLOCK_LINEARS):
        raise TypeError(f"int8 block weights need int8 q and scales in {cdtype}")
    dev = noise.device
    sms = _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    pl = k2_plan or plan(rows, T, H, M, sms)
    if pl.rp < rows * (T + 1):
        raise ValueError(f"plan {pl} holds fewer than {rows * (T + 1)} rows")
    if probe is not None and (probe.device != dev or probe.dtype != torch.int64
                              or probe.numel() < probe_words(sms, steps, cfg.depth)):
        raise ValueError("K2's probe is int64 on the noise's device, probe_words() long")
    RP = pl.rp
    x0 = noise.float().contiguous()
    out = torch.empty_like(x0)
    h = torch.zeros((RP, H), dtype=cdtype, device=dev)
    hn, attn = torch.zeros_like(h), torch.zeros_like(h)
    qkv = torch.zeros((RP, 3 * H), dtype=cdtype, device=dev)
    m = torch.zeros((RP, M), dtype=cdtype, device=dev)
    x, xp = torch.empty_like(x0), torch.empty_like(x0)
    # fp32 partial products [chunks, RP, N] of the largest product
    part = torch.empty(max(pl.partial_bytes(H, M).values()) // 4, dtype=torch.float32, device=dev)
    p = prep

    def scales(name):  # int8 scales of a block linear, or none
        return p["s" + name].data_ptr() if int8 else None

    code = build.load().dbx_dit_sample(
        int(cdtype == torch.bfloat16), int(int8), p["coef"].data_ptr(), p["cond"].data_ptr(),
        x0.data_ptr(), p["pos"].data_ptr(), p["xw"].data_ptr(), p["xb"].data_ptr(),
        p["fw"].data_ptr(), p["fb"].data_ptr(), p["wqkv"].data_ptr(), scales("qkv"),
        p["bqkv"].data_ptr(), p["wo"].data_ptr(), scales("o"), p["bo"].data_ptr(),
        p["wfc0"].data_ptr(), scales("fc0"), p["bfc0"].data_ptr(), p["wfc1"].data_ptr(),
        scales("fc1"), p["bfc1"].data_ptr(), out.data_ptr(), h.data_ptr(),
        hn.data_ptr(), qkv.data_ptr(), attn.data_ptr(), m.data_ptr(), x.data_ptr(),
        xp.data_ptr(), part.data_ptr(), B, T, A, H, cfg.num_heads, M, cfg.depth, steps, RP,
        int(cfg_scale > 1.0), float(cfg_scale), int(sampler == "dpm"), pl.bn, pl.nt, *pl.chunks,
        None if probe is None else probe.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "dbx_dit_sample")
    fused_dit_sample.launches += 1
    return out


@torch.no_grad()
def fused_dit_sample(head: DiT, cfg: DiTConfig, z: torch.Tensor, noise: torch.Tensor,
                     schedule: DiffusionSchedule, *, steps: int, cfg_scale: float,
                     sampler: str = "ddim") -> torch.Tensor:
    """Sample an action chunk [B, T, A] fp32 from condition z [B, 1, token]."""
    if cfg.mem_cross_attn:
        raise NotImplementedError("K2 does not serve a DiT with memory cross-attention "
                                  "(MemVLA); its sampler runs the plain loop")
    if sampler not in ("ddim", "dpm"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if noise.device.type == "cuda":
        return _launch(head, cfg, z, noise, schedule, steps, cfg_scale, sampler)
    if noise.device.type == "cpu":
        return dit_sample_ref(head, cfg, z, noise, schedule, steps=steps,
                              cfg_scale=cfg_scale, sampler=sampler)
    raise RuntimeError(f"DiT sampler has no kernel for device {noise.device}")


fused_dit_sample.launches = 0  # K2 launches in this process
