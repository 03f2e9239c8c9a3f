"""One training step and one evaluation step; counterpart of
``arreau_tpu/train/loop.py``. A training step is the loss (noise, PBC
graph, backbone, losses), its backward through the kernels' backward
passes, the clipped AdamW update and the EMA update. Metrics come back as
tensors on the device: the caller gathers them once at the end of an epoch,
as the JAX loop does, so no step waits on the host."""

from __future__ import annotations

from typing import Optional

import torch

from arreau_tpu_torch.tasks.diffusion import CrystalBatch, DiffusionModel, LossNoise
from arreau_tpu_torch.train.optim import AdamW
from arreau_tpu_torch.train.state import EMA


def train_step(model: DiffusionModel, optimizer: AdamW, ema: Optional[EMA], batch: CrystalBatch,
               noise: LossNoise) -> dict:
    """Update the model's parameters (and the EMA) from one batch; returns
    the loss metrics and ``grad_norm`` (before clipping)."""
    for p in model.model.parameters():
        p.grad = None
    loss, metrics = model.loss(batch, noise)
    loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = optimizer.step()
    if ema is not None:
        ema.update(model.model)
    return metrics


@torch.no_grad()
def eval_step(model: DiffusionModel, batch: CrystalBatch, noise: LossNoise,
              ema: Optional[EMA] = None) -> dict:
    """The loss metrics of one batch, with the EMA weights when given."""
    if ema is None:
        return model.loss(batch, noise)[1]
    with ema.swapped_in(model.model):
        return model.loss(batch, noise)[1]


def gather_metrics(pending: list) -> list:
    """Device metric dicts -> host float dicts, with one transfer."""
    if not pending:
        return []
    keys = list(pending[0])
    stacked = torch.stack([torch.stack([m[k].to(torch.float64) for k in keys]) for m in pending])
    return [dict(zip(keys, row)) for row in stacked.cpu().tolist()]
