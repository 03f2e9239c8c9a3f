"""MD17 energies and forces on the point-cloud Ponita; counterpart of
``arreau_tpu/tasks/md17.py``.

A graph-level energy, the forces its negative gradient in the positions,
both in z-scored units (shift the training energies' mean, scale the RMS
of the training forces); the loss is the energy MSE over ``lambda_F`` plus
the force MSE over the three components; SO(3) rotations as augmentation
(the forces co-rotate); at test time the predictions are averaged over
random rotations. No CUDA kernel of the port runs here.

The forces are ``-torch.autograd.grad(E.sum(), pos)``, taken under
``torch.enable_grad()`` so that they exist in evaluation too (the training
loop evaluates under ``no_grad``), with ``create_graph`` where the caller
records a graph: a training step's loss then differentiates through them,
a double backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from arreau_tpu_torch.models.blocks import pin_precision
from arreau_tpu_torch.models.point_cloud import PointCloudConfig, PonitaPointCloud
from arreau_tpu_torch.tasks.qm9 import point_cloud_inputs

KCAL_TO_MEV = 43.3634


class MD17Batch(NamedTuple):
    pos: torch.Tensor  # [B, A, 3]
    one_hot: torch.Tensor  # [B, A, F]
    mask: torch.Tensor  # [B, A]
    energy: torch.Tensor  # [B]
    force: torch.Tensor  # [B, A, 3]


@dataclass(frozen=True)
class MD17Config:
    input_dim: int = 9
    hidden_dim: int = 128
    basis_dim: int = 256
    degree: int = 3
    num_layers: int = 5
    widening_factor: int = 4
    layer_scale: Optional[float] = None
    multiple_readouts: bool = True
    radius: Optional[float] = None
    max_neighbors: int = 8
    lambda_F: float = 500.0
    lifted: bool = True

    def pc_config(self) -> PointCloudConfig:
        return PointCloudConfig(
            input_dim_scalar=self.input_dim,
            hidden_dim=self.hidden_dim,
            basis_dim=self.basis_dim,
            degree=self.degree,
            num_layers=self.num_layers,
            widening_factor=self.widening_factor,
            layer_scale=self.layer_scale,
            multiple_readouts=self.multiple_readouts,
            radius=self.radius,
            output_dim_scalar=1,
            output_dim_vec=0,
            lifted=self.lifted,
            graph_pooling=True,
            expected_degree=float(self.max_neighbors),
        )


def rotate_md17_batch(rotations: torch.Tensor, batch: MD17Batch) -> MD17Batch:
    """One rotation ``[B, 3, 3]`` per molecule applied to positions and forces."""
    def r(v):
        return torch.einsum("bij,bnj->bni", rotations, v)

    return batch._replace(pos=r(batch.pos), force=r(batch.force))


class MD17Model:
    """The backbone on one device, with the energy shift and scale."""

    def __init__(self, config: MD17Config, shift: float = 0.0, scale: float = 1.0,
                 device="cuda", dtype=torch.float32):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        pin_precision()
        self.config = config
        self.shift, self.scale = shift, scale
        self.device = device
        self.model = PonitaPointCloud(config.pc_config()).to(device=device, dtype=dtype)

    def init(self, key, batch: Optional[MD17Batch] = None) -> None:
        """The parameters the JAX package's ``model.init(key, ...)`` draws
        (``key`` a JAX key, uint32 ``[2]``)."""
        self.model.init_parameters(key)

    def predict_energy(self, pos: torch.Tensor, batch: MD17Batch) -> torch.Tensor:
        """``[B]`` energies (z-scored units) at ``pos``, the graph built from it."""
        inputs = point_cloud_inputs(self.model, self.config, pos, batch.one_hot, batch.mask)
        return self.model(inputs).scalar[..., 0]

    def predict_energy_and_force(self, batch: MD17Batch):
        """(energy ``[B]``, force ``[B, A, 3]`` = -dE/dpos, 0 on padded atoms),
        both in z-scored units; see the module docstring for grad mode."""
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            pos = batch.pos if batch.pos.requires_grad else batch.pos.detach().requires_grad_()
            energy = self.predict_energy(pos, batch)
            (grad,) = torch.autograd.grad(energy.sum(), pos, create_graph=create_graph)
        force = torch.where(batch.mask[..., None], -grad, 0.0)
        return (energy, force) if create_graph else (energy.detach(), force)

    def loss(self, batch: MD17Batch):
        energy, force = self.predict_energy_and_force(batch)
        e_target = (batch.energy - self.shift) / self.scale
        f_target = batch.force / self.scale
        e_mse = torch.mean((energy - e_target) ** 2)
        n_atoms = torch.clamp(batch.mask.sum(), min=1)
        f_sq = torch.sum((force - f_target) ** 2, dim=-1)
        f_mse = torch.where(batch.mask, f_sq, 0.0).sum() / n_atoms / 3.0
        loss = e_mse / self.config.lambda_F + f_mse
        e_mae = torch.mean(torch.abs(energy * self.scale + self.shift - batch.energy))
        f_abs = torch.abs(force * self.scale - batch.force).mean(dim=-1)
        f_mae = torch.where(batch.mask, f_abs, 0.0).sum() / n_atoms
        return loss, {"loss": loss, "mae_energy": e_mae, "mae_force": f_mae}

    def test_repeats(self, batch: MD17Batch, rotations: torch.Tensor) -> list:
        """(energy MAE, force MAE) of the predictions averaged over the first
        r + 1 of the random rotations ``[R, B, 3, 3]``, for each r (the
        forces rotated back into the batch's frame)."""
        energies, forces = [], []
        for rot in rotations:
            e, f = self.predict_energy_and_force(rotate_md17_batch(rot, batch))
            energies.append(e)
            forces.append(torch.einsum("bji,bnj->bni", rot, f))
        n_atoms = torch.clamp(batch.mask.sum(), min=1)
        results = []
        for r in range(len(rotations)):
            e_avg = torch.stack(energies[:r + 1]).mean(dim=0)
            f_avg = torch.stack(forces[:r + 1]).mean(dim=0)
            e_mae = torch.mean(torch.abs(e_avg * self.scale + self.shift - batch.energy))
            f_abs = torch.abs(f_avg * self.scale - batch.force).mean(dim=-1)
            results.append((e_mae, torch.where(batch.mask, f_abs, 0.0).sum() / n_atoms))
        return results
