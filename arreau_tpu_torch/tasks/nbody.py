"""N-body trajectory prediction: the Ponita fiber bundle predicts each
charged particle's displacement; counterpart of ``arreau_tpu/tasks/nbody.py``.

Scalar input the charge, vector input the velocity, a node-vector head;
``pred_pos = pos + vec_out``, MSE against the final positions, on a fully
connected graph with self-loops (radius ``radius or 1000``, K = n) built
per batch. With ``radius=None`` the conv is not windowed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from arreau_tpu_torch.models.blocks import pin_precision
from arreau_tpu_torch.models.ponita import FiberBundleInputs, PonitaConfig, PonitaFiberBundle
from arreau_tpu_torch.ops.grids import cached_grid_s2
from arreau_tpu_torch.ops.radius import radius_neighbor_list


class NBodyBatch(NamedTuple):
    pos: torch.Tensor  # [B, n, 3]
    vel: torch.Tensor  # [B, n, 3]
    charges: torch.Tensor  # [B, n]
    target_pos: torch.Tensor  # [B, n, 3]


@dataclass(frozen=True)
class NBodyConfig:
    hidden_dim: int = 128
    basis_dim: int = 256
    degree: int = 3
    num_layers: int = 5
    num_ori: int = 16
    widening_factor: int = 4
    layer_scale: Optional[float] = None
    multiple_readouts: bool = True
    radius: Optional[float] = None  # None: fully connected, no window
    n_balls: int = 5
    # None = the CUDA kernels on a CUDA device; True/False = force
    use_pallas: Optional[bool] = None

    def ponita_config(self) -> PonitaConfig:
        return PonitaConfig(
            input_dim_scalar=1,  # charge
            input_dim_vec=1,  # velocity
            hidden_dim=self.hidden_dim,
            basis_dim=self.basis_dim,
            degree=self.degree,
            num_layers=self.num_layers,
            widening_factor=self.widening_factor,
            layer_scale=self.layer_scale,
            multiple_readouts=self.multiple_readouts,
            radius=self.radius,
            num_ori=self.num_ori,
            output_dim_vec=1,
            num_edge_scalar_features=0,
            expected_degree=float(self.n_balls),
            remat=False,
            use_kernels=self.use_pallas,
        )


def rotate_nbody_batch(rotations: torch.Tensor, batch: NBodyBatch) -> NBodyBatch:
    """One rotation ``[B, 3, 3]`` per system applied to pos, vel and target."""
    def r(x):
        return torch.einsum("bij,bnj->bni", rotations, x)

    return NBodyBatch(r(batch.pos), r(batch.vel), batch.charges, r(batch.target_pos))


class NBodyModel:
    """The backbone and its orientation grid on one device."""

    def __init__(self, config: NBodyConfig, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        pin_precision()
        self.config = config
        self.device = device
        self.model = PonitaFiberBundle(config.ponita_config()).to(device)
        self.ori_grid = torch.as_tensor(cached_grid_s2(config.num_ori), dtype=torch.float32,
                                        device=device)

    def init(self, key, batch: Optional[NBodyBatch] = None) -> None:
        """The parameters the JAX package's ``model.init(key, ...)`` draws
        (``key`` a JAX key, uint32 ``[2]``)."""
        self.model.init_parameters(key)

    def build_inputs(self, batch: NBodyBatch) -> FiberBundleInputs:
        B, n, _ = batch.pos.shape
        mask = torch.ones((B, n), dtype=torch.bool, device=batch.pos.device)
        neighbors = radius_neighbor_list(batch.pos, mask, radius=self.config.radius or 1000.0,
                                         max_neighbors=n, loop=True)
        return FiberBundleInputs(
            scalar=batch.charges[..., None],
            vec=batch.vel[:, :, None, :],
            neighbors=neighbors,
            atom_mask=mask,
            lattice=torch.zeros((B, 3, 3), dtype=batch.pos.dtype, device=batch.pos.device),
            ori_grid=self.ori_grid.to(batch.pos.dtype),
        )

    def predict_positions(self, batch: NBodyBatch, inputs: Optional[FiberBundleInputs] = None):
        """``[B, n, 3]`` predicted final positions; ``inputs`` (from
        :meth:`build_inputs`) to give the backbone a graph of one's own."""
        out = self.model(inputs if inputs is not None else self.build_inputs(batch))
        return batch.pos + out.node_vec[:, :, 0, :]

    def loss(self, batch: NBodyBatch, inputs: Optional[FiberBundleInputs] = None):
        mse = torch.mean((self.predict_positions(batch, inputs) - batch.target_pos) ** 2)
        return mse, {"loss": mse, "mse": mse}
