"""Gaussian Fourier time-step embedding with fixed frequencies.

Counterpart of ``arreau_tpu/ops/fourier.py``. The JAX package draws its
frequencies as ``make_fourier_weights(PRNGKey(fourier_seed), 32, 16.0)``
in its default float32 mode; :func:`default_fourier_weights` draws the
same numbers for any seed through ``ops/prng.py``. A checkpoint's
``meta.json`` carries its frequencies (``fourier_w``) all the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from arreau_tpu_torch.ops.prng import normal, prng_key


def default_fourier_weights(seed: int, embedding_size: int, scale: float = 16.0) -> torch.Tensor:
    """The JAX package's frequencies ``[embedding_size]`` float32 for
    ``seed``: ``normal(PRNGKey(seed), (embedding_size,)) * scale``."""
    w = normal(prng_key(seed), (embedding_size,), np.float32) * np.float32(scale)
    return torch.from_numpy(w)


def gaussian_fourier_features(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Embed ``x [..., 1]`` into ``[..., 2*embedding_size]`` as
    ``[sin(2 pi w x) || cos(2 pi w x)]``."""
    proj = x * weights * (2 * math.pi)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
