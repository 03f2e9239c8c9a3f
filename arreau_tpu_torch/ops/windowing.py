"""Smooth radial cutoff envelope (DimeNet eq. 8); counterpart of
``arreau_tpu/ops/windowing.py``."""

from __future__ import annotations

from typing import Optional

import torch


def polynomial_cutoff(x: torch.Tensor, r_max: Optional[float], p: int = 6) -> torch.Tensor:
    """``1 - (p+1)(p+2)/2 u^p + p(p+2) u^(p+1) - p(p+1)/2 u^(p+2)`` with
    ``u = x / r_max``, times the indicator ``x < r_max``; ``r_max=None``
    gives ones (no window)."""
    if r_max is None:
        return torch.ones_like(x)
    u = x / r_max
    pf = float(p)
    envelope = (
        1.0
        - (pf + 1.0) * (pf + 2.0) / 2.0 * u**p
        + pf * (pf + 2.0) * u ** (p + 1)
        - pf * (pf + 1.0) / 2.0 * u ** (p + 2)
    )
    return envelope * (x < r_max)
