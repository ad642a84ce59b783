"""Fused DiT sampler: the whole diffusion sampling loop in one kernel launch.

Port of dexbotic_tpu/ops/dit_fused.py.  :func:`fused_dit_sample` is the
wrapper of kernel K2 (``csrc/dit_sampler.cu``): on a CUDA tensor it does the
same host precompute as the JAX wrapper (scheduler coefficient table in
execution order, per-step condition tokens ``t_mlp(te) + z_embed(z)``) and
launches the kernel or raises; on a CPU tensor it runs
:func:`dit_sample_ref`, the plain version: the samplers of
``ops/diffusion.py`` looped over ``dit_forward``.

The kernel takes the block weights stacked per layer as [depth, in, out], or,
when every block layer is quantized (``nn/core.QuantLinear``), as int8
[depth, out, in] with [depth, out] scales in the head's dtype, dequantized in
the kernel as the JAX kernel does (``w.astype(cdtype) * s.astype(cdtype)``).
The wrapper builds those buffers, the scheduler table and the timestep MLP's
output once per head and caches them on it (rebuilt when a parameter they
come from is replaced or changed in place).  ``t_mlp`` and ``z_embed`` run as
the head's own layers: through K4 (``ops/quant_matmul.py``) when quantized.
"""

from __future__ import annotations

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
    """[depth, in, out] weights in the head's dtype, or int8 [depth, out, in] with
    [depth, out] scales ``s*`` when every block layer is quantized, and
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
                bufs["w" + name] = torch.stack([_dense_weight(lin).t() for lin in ls]).contiguous()
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


def _launch(head: DiT, cfg: DiTConfig, z, noise, schedule, steps, cfg_scale, sampler):
    from dexbotic_tpu_torch.kernels import build

    cdtype = weight_dtype(head.x_embed)
    if cdtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"DiT sampler kernel takes bf16 or fp32 weights, got {cdtype}")
    if cfg_scale > 1.0 and not hasattr(head, "uncondition"):
        raise ValueError("CFG needs the head's uncondition embedding")
    B, T, A = noise.shape
    H, M = cfg.hidden_size, cfg.mlp_dim
    rows = (2 if cfg_scale > 1.0 else 1) * B
    RP = -(-rows * (T + 1) // 16) * 16
    if RP > 80 or A > 16 or T + 1 > 32 or H % 128 or M % 128 or H % cfg.num_heads:
        raise ValueError(f"DiT sampler kernel does not serve rows={rows} T={T} A={A} H={H} M={M}")
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
    x0 = noise.float().contiguous()
    out = torch.empty_like(x0)
    h = torch.zeros((RP, H), dtype=cdtype, device=dev)
    hn, attn = torch.zeros_like(h), torch.zeros_like(h)
    qkv = torch.zeros((RP, 3 * H), dtype=cdtype, device=dev)
    m = torch.zeros((RP, M), dtype=cdtype, device=dev)
    x, xp = torch.empty_like(x0), torch.empty_like(x0)
    # fp32 partial products [K / 128, RP, N] of the largest product
    part = torch.empty(max(3 * H * H, H * M) // 128 * RP, dtype=torch.float32, device=dev)
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
        int(cfg_scale > 1.0), float(cfg_scale), int(sampler == "dpm"),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "dbx_dit_sample")
    fused_dit_sample.launches += 1
    return out


@torch.no_grad()
def fused_dit_sample(head: DiT, cfg: DiTConfig, z: torch.Tensor, noise: torch.Tensor,
                     schedule: DiffusionSchedule, *, steps: int, cfg_scale: float,
                     sampler: str = "ddim") -> torch.Tensor:
    """Sample an action chunk [B, T, A] fp32 from condition z [B, 1, token]."""
    if sampler not in ("ddim", "dpm"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if noise.device.type == "cuda":
        return _launch(head, cfg, z, noise, schedule, steps, cfg_scale, sampler)
    if noise.device.type == "cpu":
        return dit_sample_ref(head, cfg, z, noise, schedule, steps=steps,
                              cfg_scale=cfg_scale, sampler=sampler)
    raise RuntimeError(f"DiT sampler has no kernel for device {noise.device}")


fused_dit_sample.launches = 0  # K2 launches in this process
