"""Variance-exploding score diffusion on fractional coordinates;
counterpart of ``arreau_tpu/diffusion/ve.py``.

Every random number is passed in (``noise``, standard normal, shaped like
the state), so callers decide where it comes from.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from arreau_tpu_torch.ops.lattice import cart_to_frac, frac_to_cart
from arreau_tpu_torch.ops.pbc import min_distance_pbc


class VESchedule(NamedTuple):
    """Geometric sigma ladder ``sigmas[0..T]`` (sigmas[t] used at step t)."""

    sigmas: torch.Tensor  # [T + 1]


def make_ve_schedule(num_steps: int, sigma_min: float, sigma_max: float, device="cpu") -> VESchedule:
    log_s = torch.linspace(math.log(sigma_min), math.log(sigma_max), num_steps + 1, device=device)
    return VESchedule(sigmas=torch.exp(log_s))


def ve_forward_pbc(
    schedule: VESchedule,
    noise: torch.Tensor,
    frac_x0: torch.Tensor,
    t: torch.Tensor,
    lattice: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(noisy frac ``(x0 + sigma_t z) mod 1``, target, sigmas ``[B, 1, 1]``)
    for ``t [B]`` in [1, T]; the target is the min-image displacement from
    the clean point's nearest image to the noisy point, in fractional
    coordinates wrapped into [0, 1)."""
    sigmas = schedule.sigmas[t][:, None, None]
    frac_noisy = (frac_x0 + noise * sigmas) % 1.0
    _, min_vec = min_distance_pbc(frac_to_cart(frac_noisy, lattice),
                                  frac_to_cart(frac_x0, lattice), lattice)
    return frac_noisy, cart_to_frac(min_vec, lattice), sigmas


def ve_reverse_step(
    schedule: VESchedule,
    noise: torch.Tensor,
    frac_xt: torch.Tensor,
    pred_eps: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """Annealed-Langevin step ``x_{t-1} = (x_t - eps (s_t^2 - s_{t-1}^2) +
    std z) mod 1``, std ``sqrt(s_{t-1}^2 (s_t^2 - s_{t-1}^2) / s_t^2)``."""
    sig = schedule.sigmas[t][:, None, None]
    prev = schedule.sigmas[torch.clamp(t - 1, min=0)][:, None, None]
    adj = torch.where((t == 0)[:, None, None], 0.0, prev)
    mean = frac_xt - pred_eps * (sig**2 - adj**2)
    std = torch.sqrt(torch.clamp(adj**2 * (sig**2 - adj**2) / (sig**2), min=0.0))
    return (mean + std * noise) % 1.0


def ve_ddim_step(
    schedule: VESchedule,
    noise: torch.Tensor,
    frac_xt: torch.Tensor,
    pred_eps: torch.Tensor,
    t: torch.Tensor,
    s: torch.Tensor,
    eta: float = 0.0,
) -> torch.Tensor:
    """Strided step sigma_t -> sigma_s: ``x_s = x0_hat + sqrt(sig_s^2 -
    sig_n^2)/sig_t pred_eps + sig_n z`` with ``x0_hat = x_t - pred_eps`` and
    ``sig_n = eta sig_s sqrt(1 - sig_s^2/sig_t^2)``, re-wrapped mod 1."""
    sig_t = schedule.sigmas[t][:, None, None]
    sig_s = torch.where(
        (s == 0)[:, None, None], 0.0, schedule.sigmas[torch.clamp(s, min=0)][:, None, None]
    )
    sig_n = eta * sig_s * torch.sqrt(torch.clamp(1 - sig_s**2 / sig_t**2, min=0.0))
    dir_coef = torch.sqrt(torch.clamp(sig_s**2 - sig_n**2, min=0.0)) / sig_t
    x0_hat = frac_xt - pred_eps
    return (x0_hat + dir_coef * pred_eps + sig_n * noise) % 1.0
