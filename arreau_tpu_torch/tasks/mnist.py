"""MNIST-superpixel graph classification on the R^2 x S^1 grid; counterpart
of ``arreau_tpu/tasks/mnist.py``.

One scalar input (the gray value), ten classes by cross-entropy, SO(2)
rotation augmentation. Sparsify is a mask, not a filter, so shapes stay
static: nodes at or below the gray threshold are masked out, and a graph
with none left keeps its first node.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from arreau_tpu_torch.models.blocks import pin_precision
from arreau_tpu_torch.models.ponita import FiberBundleInputs, PonitaConfig, PonitaFiberBundle
from arreau_tpu_torch.ops.grids import uniform_grid_s1
from arreau_tpu_torch.ops.radius import radius_neighbor_list


class Mnist2DBatch(NamedTuple):
    pos: torch.Tensor  # [B, N, 2]
    value: torch.Tensor  # [B, N] gray values
    mask: torch.Tensor  # [B, N]
    label: torch.Tensor  # [B]


@dataclass(frozen=True)
class MnistConfig:
    hidden_dim: int = 64
    basis_dim: int = 128
    degree: int = 3
    num_layers: int = 4
    num_ori: int = 10
    widening_factor: int = 4
    layer_scale: Optional[float] = None
    multiple_readouts: bool = True
    radius: Optional[float] = 10.0
    max_neighbors: int = 8
    num_classes: int = 10
    sparsify_threshold: float = 0.5
    # None = the CUDA kernels on a CUDA device; True/False = force
    use_pallas: Optional[bool] = None

    def ponita_config(self) -> PonitaConfig:
        return PonitaConfig(
            input_dim_scalar=1,  # gray value
            input_dim_vec=0,
            hidden_dim=self.hidden_dim,
            basis_dim=self.basis_dim,
            degree=self.degree,
            num_layers=self.num_layers,
            widening_factor=self.widening_factor,
            layer_scale=self.layer_scale,
            multiple_readouts=self.multiple_readouts,
            radius=self.radius,
            num_ori=self.num_ori,
            output_dim_global_scalar=self.num_classes,
            num_edge_scalar_features=0,
            expected_degree=float(self.max_neighbors),
            remat=False,
            use_kernels=self.use_pallas,
        )


def rotate_mnist_batch(rotations: torch.Tensor, batch: Mnist2DBatch) -> Mnist2DBatch:
    """One rotation ``[B, 2, 2]`` per image applied to the positions."""
    return batch._replace(pos=torch.einsum("bij,bnj->bni", rotations, batch.pos))


class MnistModel:
    """The backbone and its S^1 grid on one device."""

    def __init__(self, config: MnistConfig, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        pin_precision()
        self.config = config
        self.device = device
        self.model = PonitaFiberBundle(config.ponita_config()).to(device)
        self.ori_grid = uniform_grid_s1(config.num_ori, device=device)

    def init(self, key, batch: Optional[Mnist2DBatch] = None) -> None:
        """The parameters the JAX package's ``model.init(key, ...)`` draws
        (``key`` a JAX key, uint32 ``[2]``)."""
        self.model.init_parameters(key)

    def node_mask(self, batch: Mnist2DBatch) -> torch.Tensor:
        """Sparsify: the valid nodes above the gray threshold, and the first
        node of a graph that has none."""
        mask = batch.mask & (batch.value > self.config.sparsify_threshold)
        first = mask[:, :1] | ~mask.any(dim=1, keepdim=True)
        return torch.cat([first, mask[:, 1:]], dim=1)

    def build_inputs(self, batch: Mnist2DBatch) -> FiberBundleInputs:
        B, N, _ = batch.pos.shape
        mask = self.node_mask(batch)
        neighbors = radius_neighbor_list(batch.pos, mask, self.config.radius or 100.0,
                                         self.config.max_neighbors, loop=True)
        dt, dev = batch.pos.dtype, batch.pos.device
        return FiberBundleInputs(
            scalar=batch.value[..., None].to(dt),
            vec=torch.zeros((B, N, 0, 2), dtype=dt, device=dev),
            neighbors=neighbors,
            atom_mask=mask,
            lattice=torch.zeros((B, 2, 2), dtype=dt, device=dev),
            ori_grid=self.ori_grid.to(dt),
        )

    def logits(self, batch: Mnist2DBatch, inputs: Optional[FiberBundleInputs] = None):
        """``[B, num_classes]``; ``inputs`` (from :meth:`build_inputs`) to give
        the backbone a graph of one's own."""
        return self.model(inputs if inputs is not None else self.build_inputs(batch)).global_scalar

    def loss(self, batch: Mnist2DBatch, inputs: Optional[FiberBundleInputs] = None):
        logits = self.logits(batch, inputs)
        nll = F.cross_entropy(logits, batch.label.long())
        acc = torch.mean((torch.argmax(logits, dim=-1) == batch.label).to(logits.dtype))
        return nll, {"loss": nll, "accuracy": acc}
