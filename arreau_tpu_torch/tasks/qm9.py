"""QM9 scalar regression on the point-cloud Ponita; counterpart of
``arreau_tpu/tasks/qm9.py``.

A graph-level target of each molecule, the lifted point cloud (or the
plain one), the loss the MAE of the z-scored target, the metric the MAE in
the target's units, SO(3) rotations of the positions as augmentation. The
neighbour list is rebuilt from the positions in every forward: radius
``radius or 1000`` (fully connected up to K = ``max_neighbors``), no
self-edges (a lifted orientation needs two distinct endpoints). No CUDA
kernel of the port runs here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from arreau_tpu_torch.models.blocks import pin_precision
from arreau_tpu_torch.models.point_cloud import (
    PointCloudConfig,
    PointCloudInputs,
    PonitaPointCloud,
)
from arreau_tpu_torch.ops.radius import radius_neighbor_list


class MoleculeBatch(NamedTuple):
    pos: torch.Tensor  # [B, A, 3]
    one_hot: torch.Tensor  # [B, A, F]
    mask: torch.Tensor  # [B, A]
    y: torch.Tensor  # [B]


@dataclass(frozen=True)
class QM9Config:
    input_dim: int = 5
    hidden_dim: int = 128
    basis_dim: int = 256
    degree: int = 3
    num_layers: int = 5
    widening_factor: int = 4
    layer_scale: Optional[float] = None
    multiple_readouts: bool = True
    radius: Optional[float] = None  # None: fully connected (up to K), no window
    max_neighbors: int = 8
    lifted: bool = True  # num_ori = -1

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


def rotate_molecule_batch(rotations: torch.Tensor, batch: MoleculeBatch) -> MoleculeBatch:
    """One rotation ``[B, 3, 3]`` per molecule applied to the positions."""
    return batch._replace(pos=torch.einsum("bij,bnj->bni", rotations, batch.pos))


def point_cloud_inputs(model: PonitaPointCloud, config, pos: torch.Tensor, one_hot: torch.Tensor,
                       mask: torch.Tensor) -> PointCloudInputs:
    """The backbone's inputs: the neighbour list of ``pos`` (differentiable
    in ``pos``), one-hot scalars, no vectors, in the model's type."""
    B, A, _ = pos.shape
    dt = next(model.parameters()).dtype
    neighbors = radius_neighbor_list(pos.to(dt), mask, config.radius or 1000.0,
                                     config.max_neighbors, loop=False)
    return PointCloudInputs(pos=pos.to(dt), scalar=one_hot.to(dt),
                            vec=torch.zeros((B, A, 0, 3), dtype=dt, device=pos.device),
                            neighbors=neighbors, node_mask=mask)


class QM9Model:
    """The backbone on one device, with the target's shift and scale."""

    def __init__(self, config: QM9Config, shift: float = 0.0, scale: float = 1.0, device="cuda",
                 dtype=torch.float32):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        pin_precision()
        self.config = config
        self.shift, self.scale = shift, scale
        self.device = device
        self.model = PonitaPointCloud(config.pc_config()).to(device=device, dtype=dtype)

    def init(self, generator: torch.Generator, batch: Optional[MoleculeBatch] = None) -> None:
        """Seeded parameters with the JAX package's init distributions."""
        self.model.init_parameters(generator)

    def build_inputs(self, batch: MoleculeBatch) -> PointCloudInputs:
        return point_cloud_inputs(self.model, self.config, batch.pos, batch.one_hot, batch.mask)

    def predict(self, batch: MoleculeBatch,
                inputs: Optional[PointCloudInputs] = None) -> torch.Tensor:
        """``[B]`` in z-scored units; ``inputs`` to give a graph of one's own."""
        return self.model(inputs if inputs is not None else self.build_inputs(batch)).scalar[..., 0]

    def loss(self, batch: MoleculeBatch, inputs: Optional[PointCloudInputs] = None):
        pred = self.predict(batch, inputs)
        target = (batch.y - self.shift) / self.scale
        mae_scaled = torch.mean(torch.abs(pred - target))
        mae = torch.mean(torch.abs(pred * self.scale + self.shift - batch.y))
        return mae_scaled, {"loss": mae_scaled, "mae": mae}
