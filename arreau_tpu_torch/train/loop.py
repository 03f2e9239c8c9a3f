"""One training step and one evaluation step; counterpart of
``arreau_tpu/train/loop.py``. ``model`` is a task (``DiffusionModel``,
``NBodyModel``, ``EGNNNBody``, ``MnistModel``, ``QM9Model``, ``MD17Model``):
its ``.model`` is the
module that carries the parameters, and ``model.loss(batch, *loss_args)``
returns ``(loss, metrics)``. A training step is that loss, its backward
(through the kernels' backward passes on the kernel branch), the clipped
AdamW update and the EMA update. Metrics come back as tensors on the
device: the caller gathers them once at the end of an epoch, as the JAX
loop does, so no step waits on the host.

Under data parallelism (the task's ``mesh``, ``parallel/mesh.py``) the
gradients are all-reduced over the data group after ``backward``, in one
flat bucket: summed for a task whose loss divides by the global batch's
counts (``global_denominators``: the diffusion loss, whose metrics are
already global), averaged for a plain mean over shards of equal size (the
backbone tasks, whose metrics are averaged too). Split parameters under
tensor parallelism are reduced with the ranks that hold the same shard."""

from __future__ import annotations

from typing import Optional

import torch

from arreau_tpu_torch.parallel.mesh import data_mean, data_parallel, reduce_gradients
from arreau_tpu_torch.train.optim import AdamW
from arreau_tpu_torch.train.state import EMA


def train_step(model, optimizer: AdamW, ema: Optional[EMA], batch, *loss_args) -> dict:
    """Update the model's parameters (and the EMA) from one batch; returns
    the loss metrics and ``grad_norm`` (before clipping)."""
    for p in model.model.parameters():
        p.grad = None
    loss, metrics = model.loss(batch, *loss_args)
    loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    mesh = getattr(model, "mesh", None)
    if data_parallel(mesh):
        global_loss = getattr(model, "global_denominators", False)
        reduce_gradients(model.model, mesh, mean=not global_loss)
        if not global_loss:
            metrics = data_mean(metrics, mesh)
    metrics["grad_norm"] = optimizer.step()
    if ema is not None:
        ema.update(model.model)
    return metrics


@torch.no_grad()
def eval_step(model, batch, *loss_args, ema: Optional[EMA] = None) -> dict:
    """The loss metrics of one batch, with the EMA weights when given, under
    ``no_grad``. A task whose metrics need a gradient (MD17's forces,
    -dE/dpos) takes it inside its own ``torch.enable_grad()`` block and
    returns detached values; every other task's evaluation records no
    graph."""
    if ema is None:
        metrics = model.loss(batch, *loss_args)[1]
    else:
        with ema.swapped_in(model.model):
            metrics = model.loss(batch, *loss_args)[1]
    if getattr(model, "global_denominators", False):
        return metrics
    return data_mean(metrics, getattr(model, "mesh", None))


def gather_metrics(pending: list) -> list:
    """Device metric dicts -> host float dicts, with one transfer."""
    if not pending:
        return []
    keys = list(pending[0])
    stacked = torch.stack([torch.stack([m[k].to(torch.float64) for k in keys]) for m in pending])
    return [dict(zip(keys, row)) for row in stacked.cpu().tolist()]
