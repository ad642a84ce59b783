"""Gaussian diffusion schedule and samplers (port of dexbotic_tpu/ops/diffusion.py).

The coefficient math stays on the host in float64 numpy; the sampling loop
is a Python loop over steps in the JAX scan's order (i = N-1 ... 0 for
DDIM).  These loops over ``dit_forward`` are the plain version of kernel K2
(``ops/dit_fused.py``).  ``training_loss`` draws its timesteps and noise from
a ``torch.Generator``; both are injectable, since torch cannot reproduce the
JAX streams.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def cosine_betas(num_steps: int, max_beta: float = 0.999) -> np.ndarray:
    """squaredcos_cap_v2 schedule."""

    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    return np.array([min(1 - alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps), max_beta)
                     for i in range(num_steps)], dtype=np.float64)


def ddim_timesteps(num_steps: int, ddim_steps: int) -> np.ndarray:
    """DDIM-paper fixed striding."""
    if ddim_steps == 1:
        return np.array([num_steps // 2])
    for stride in range(1, num_steps):
        if len(range(0, num_steps, stride)) == ddim_steps:
            return np.array(sorted(range(0, num_steps, stride)))
    raise ValueError(f"cannot stride {num_steps} into {ddim_steps} DDIM steps")


def dpm_coefficients(alphas_cumprod: np.ndarray, num_steps: int, steps: int) -> dict:
    """DPM-Solver++(2M) per-step coefficients, execution order, float64."""
    kept = ddim_timesteps(num_steps, steps)
    ab_src = np.asarray(alphas_cumprod, np.float64)[kept][::-1]  # T -> 0
    ab_tgt = np.concatenate([ab_src[1:], [1.0]])
    a_s, s_s = np.sqrt(ab_src), np.sqrt(1.0 - ab_src)
    a_t, s_t = np.sqrt(ab_tgt), np.sqrt(1.0 - ab_tgt)
    with np.errstate(divide="ignore"):
        lam_s = np.log(a_s / s_s)
        lam_t = np.log(a_t / np.where(s_t == 0.0, 1e-300, s_t))
    h = lam_t - lam_s  # > 0; inf at the terminal step
    h_prev = np.concatenate([[np.inf], h[:-1]])
    inv_2r = np.where(np.isfinite(h), h_prev / (2.0 * h), 0.0)
    inv_2r = np.where(np.isfinite(inv_2r), inv_2r, 0.0)  # first step: 1st order
    return {
        "ts": kept[::-1].copy(),
        "a_s": a_s, "s_s": s_s,
        "sig_ratio": np.where(s_s > 0, s_t / s_s, 0.0),
        "coef": -a_t * (np.exp(-h) - 1.0),
        "inv_2r": inv_2r,
    }


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    num_steps: int
    alphas_cumprod: np.ndarray  # float64 [T]

    @classmethod
    def create(cls, num_steps: int = 100) -> "DiffusionSchedule":
        betas = cosine_betas(num_steps)
        return cls(num_steps=num_steps, alphas_cumprod=np.cumprod(1.0 - betas))

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t) eps;  t int[B]."""
        ab = torch.as_tensor(self.alphas_cumprod, dtype=torch.float32, device=x0.device)[t.long()]
        ab = ab.reshape((-1,) + (1,) * (x0.ndim - 1))
        return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise

    def training_loss(self, eps_fn, x0: torch.Tensor, generator: torch.Generator | None = None,
                      t: torch.Tensor | None = None, noise: torch.Tensor | None = None,
                      reduction: str = "mean") -> torch.Tensor:
        """Epsilon-prediction MSE at uniformly drawn t (fp32).

        ``reduction="none"`` returns the per-sample mean [B]."""
        B = x0.shape[0]
        if t is None:
            t = torch.randint(0, self.num_steps, (B,), generator=generator, device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, dtype=torch.float32,
                                device=x0.device)
        x_t = self.q_sample(x0.float(), t, noise)
        se = torch.square(eps_fn(x_t, t).float() - noise)
        if reduction == "none":
            return se.reshape(B, -1).mean(dim=1)
        return se.mean()

    def ddim_sample(self, eps_fn, noise: torch.Tensor, ddim_steps: int = 10) -> torch.Tensor:
        """Deterministic DDIM (eta=0, clip_denoised=False).

        eps_fn(x, t_orig[B]) -> eps, t_orig being original-process timesteps."""
        kept = ddim_timesteps(self.num_steps, ddim_steps)
        ab = np.asarray(self.alphas_cumprod)[kept]
        ab_prev = np.concatenate([[1.0], ab[:-1]])
        dev = noise.device
        ab = torch.tensor(ab, dtype=torch.float32, device=dev)
        ab_prev = torch.tensor(ab_prev, dtype=torch.float32, device=dev)
        B = noise.shape[0]
        x = noise.float()
        for i in range(ddim_steps - 1, -1, -1):
            t = torch.full((B,), int(kept[i]), dtype=torch.int32, device=dev)
            eps = eps_fn(x, t).float()
            a, a_prev = ab[i], ab_prev[i]
            pred_x0 = (x - torch.sqrt(1.0 - a) * eps) / torch.sqrt(a)
            x = pred_x0 * torch.sqrt(a_prev) + torch.sqrt(1.0 - a_prev) * eps
        return x

    def dpm_solver_pp_2m(self, eps_fn, noise: torch.Tensor, steps: int = 5) -> torch.Tensor:
        """DPM-Solver++(2M): 2nd-order multistep in data-prediction space."""
        c = dpm_coefficients(self.alphas_cumprod, self.num_steps, steps)
        f32 = {k: np.asarray(v, np.float32) for k, v in c.items() if k != "ts"}
        B = noise.shape[0]
        x = noise.float()
        x0_prev = torch.zeros_like(x)
        for i in range(steps):
            t = torch.full((B,), int(c["ts"][i]), dtype=torch.int32, device=noise.device)
            eps = eps_fn(x, t).float()
            x0 = (x - float(f32["s_s"][i]) * eps) / float(f32["a_s"][i])
            r = float(f32["inv_2r"][i])
            d = (1.0 + r) * x0 - r * x0_prev
            x = float(f32["sig_ratio"][i]) * x + float(f32["coef"][i]) * d
            x0_prev = x0
        return x


def flow_euler_sample(v_fn, noise: torch.Tensor, num_steps: int = 10) -> torch.Tensor:
    """The pi0/DM0 flow-matching Euler integrator: x' = v(x, t) from t = 1 to
    0 with dt = -1/num_steps; ``v_fn(x, t)`` takes t as a 0-d tensor in
    noise's dtype, accumulated in that dtype as the JAX scan carries it."""
    dt = -1.0 / num_steps
    x, t = noise, torch.tensor(1.0, dtype=noise.dtype, device=noise.device)
    for _ in range(num_steps):
        x, t = x + v_fn(x, t) * dt, t + dt
    return x
