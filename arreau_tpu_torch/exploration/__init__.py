"""Exploration tools of the port (``python -m arreau_tpu_torch.exploration.<tool>``);
counterparts of ``arreau_tpu/exploration/``: dataset statistics, the VP
prior check, lattice EDA, crystal viewers, the equivariance check and the
reverse-chain diagnosis. The tools that compute take ``--device`` (default
``cuda``, which raises where CUDA is unavailable); the Alexandria shards and
``crystals.h5`` files are read by ``data/hdf5.py``."""

from __future__ import annotations

import torch

def open_device(name: str) -> torch.device:
    """``torch.device(name)``; a CUDA device where CUDA is unavailable raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
    return device
