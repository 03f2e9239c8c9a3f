"""Variance-preserving DDPM with a cosine alpha-bar schedule (forward
noising, reverse steps from an eps or an x0 prediction); counterpart of
``arreau_tpu/diffusion/vp.py``.

Every random number is passed in (``noise``, standard normal)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

EPSILON = 1e-8


class VPSchedule(NamedTuple):
    alpha_bars: torch.Tensor  # [T + 1]
    betas: torch.Tensor  # [T + 1] (betas[0] = 0)
    sigmas: torch.Tensor  # [T + 1] (sigmas[0] = 0)


def make_vp_schedule(
    num_steps: int = 1000,
    s: float = 0.0001,
    power: int = 2,
    clipmax: float = 0.999,
    device="cpu",
) -> VPSchedule:
    """Cosine alpha-bar schedule (Nichol & Dhariwal 2021)."""
    t = torch.arange(0, num_steps + 1, dtype=torch.float32, device=device)
    f_t = torch.cos((math.pi / 2) * ((t / num_steps) + s) / (1 + s)) ** power
    alpha_bars = f_t / f_t[0]
    zero = torch.zeros((1,), device=device)
    betas = torch.cat([zero, 1 - alpha_bars[1:] / alpha_bars[:-1]])
    betas = torch.clamp(betas, max=clipmax)
    sigmas = torch.sqrt(betas[1:] * (1 - alpha_bars[:-1]) / (1 - alpha_bars[1:]))
    return VPSchedule(alpha_bars=alpha_bars, betas=betas, sigmas=torch.cat([zero, sigmas]))


def vp_forward(
    schedule: VPSchedule, noise: torch.Tensor, h0: torch.Tensor, t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """q(h_t | h_0) for ``h0 [B, D]``, ``t [B]``: (``sqrt(abar) h0 +
    sqrt(1 - abar) noise``, noise)."""
    abar = schedule.alpha_bars[t][:, None]
    return torch.sqrt(abar) * h0 + torch.sqrt(1 - abar) * noise, noise


def vp_reverse_without_noise(
    schedule: VPSchedule, ht: torch.Tensor, pred_eps: torch.Tensor, t: torch.Tensor
) -> torch.Tensor:
    """The mean of the DDPM ancestral step from an eps prediction (Ho et
    al. 2020, alg. 2), alpha clamped at ``1 - betas[-2]`` as the reference
    clamps it."""
    alpha = torch.maximum(1 - schedule.betas[t], 1 - schedule.betas[-2])
    abar = schedule.alpha_bars[t]
    coef = (1.0 / torch.sqrt(alpha + EPSILON))[:, None]
    eps_coef = ((1 - alpha) / torch.sqrt(1 - abar + EPSILON))[:, None]
    return coef * (ht - eps_coef * pred_eps)


def vp_reverse_step(
    schedule: VPSchedule,
    noise: torch.Tensor,
    ht: torch.Tensor,
    pred_eps: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """The DDPM ancestral step from an eps prediction: its mean plus
    ``sigmas[t] * noise``, the noise gated off at t <= 1."""
    z = torch.where((t > 1)[:, None], noise, 0.0)
    return vp_reverse_without_noise(schedule, ht, pred_eps, t) + schedule.sigmas[t][:, None] * z


def vp_reverse_given_x0(
    schedule: VPSchedule,
    noise: torch.Tensor,
    xt: torch.Tensor,
    pred_x0: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """Posterior q(x_{t-1} | x_t, x0) step; the noise is scaled by the
    posterior variance (not its square root), as the reference does."""
    abar_t = schedule.alpha_bars[t][:, None]
    abar_prev = schedule.alpha_bars[torch.clamp(t - 1, min=0)][:, None]
    beta_t = schedule.betas[t][:, None]
    alpha_t = 1 - beta_t
    denominator = 1 - abar_t
    mean = (
        torch.sqrt(abar_prev) * beta_t * pred_x0 + torch.sqrt(alpha_t) * (1 - abar_prev) * xt
    ) / denominator
    variance = (1 - abar_prev) * beta_t / denominator
    z = torch.where((t > 1)[:, None], noise, 0.0)
    return mean + variance * z


def vp_ddim_step_given_x0(
    schedule: VPSchedule,
    noise: torch.Tensor,
    xt: torch.Tensor,
    pred_x0: torch.Tensor,
    t: torch.Tensor,
    s: torch.Tensor,
    eta: float = 0.0,
) -> torch.Tensor:
    """DDIM step t -> s from an x0 prediction: ``x_s = sqrt(abar_s) x0 +
    sqrt(1 - abar_s - sig^2) eps_implied + sig z``."""
    abar_t = schedule.alpha_bars[t][:, None]
    abar_s = schedule.alpha_bars[s][:, None]
    eps_implied = (xt - torch.sqrt(abar_t) * pred_x0) / torch.sqrt(1 - abar_t + EPSILON)
    sig = eta * torch.sqrt((1 - abar_s) / (1 - abar_t + EPSILON)) * torch.sqrt(
        torch.clamp(1 - abar_t / (abar_s + EPSILON), min=0.0)
    )
    dir_coef = torch.sqrt(torch.clamp(1 - abar_s - sig**2, min=0.0))
    z = torch.where((s > 0)[:, None], noise, 0.0)
    return torch.sqrt(abar_s) * pred_x0 + dir_coef * eps_implied + sig * z
