"""EGNN baseline (Satorras et al. 2021) for the N-body comparison;
counterpart of ``arreau_tpu/models/egnn.py``, on the same dense all-pairs
layout (every ordered pair of distinct particles is an edge).

A layer computes edge messages from ``[h_i, h_j, |x_i - x_j|^2]`` (two
SiLU Dense layers), moves each position by ``sum_j (x_i - x_j) /
sqrt(|x_i - x_j|^2 + 1) * phi_x(m_ij)`` plus the EGNN-vel term
``phi_v([h_i, h_0]) * v_i``, and updates ``h`` by a residual node MLP on
``[h_i, sum_j m_ij]``. No CUDA kernel: the JAX package has no Pallas
kernel here. Parameter names follow the flax tree (``embed``,
``layers.{i}.edge_1`` for ``layer_{i}/edge_1``, ...), so
``interop/from_jax.py`` carries it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from arreau_tpu_torch.models.blocks import pin_precision

# jax.nn.initializers' truncated-normal std correction for the [-2, 2] cut
_TRUNC_STD = 0.87962566103423978
_COORD_SCALE = 0.001  # variance scale of the coordinate head's init (flax ``coord``)


@dataclass(frozen=True)
class EGNNConfig:
    hidden_dim: int = 64
    num_layers: int = 4


class EGNNLayer(nn.Module):
    def __init__(self, hidden_dim: int, channels: int):
        super().__init__()
        self.edge_1 = nn.Linear(2 * channels + 1, hidden_dim)
        self.edge_2 = nn.Linear(hidden_dim, hidden_dim)
        self.coord = nn.Linear(hidden_dim, 1, bias=False)
        self.vel_gate = nn.Linear(2 * channels, 1)
        self.node_1 = nn.Linear(channels + hidden_dim, hidden_dim)
        self.node_2 = nn.Linear(hidden_dim, channels)

    def forward(self, h, pos, vel, h_init, edge_mask):
        """h ``[B, N, C]``, pos and vel ``[B, N, 3]``, edge_mask ``[B, N, N]``
        -> (h, pos) updated."""
        B, N, C = h.shape
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        dist_sqr = torch.sum(diff**2, dim=-1, keepdim=True)
        edge_in = torch.cat([h[:, :, None, :].expand(B, N, N, C),
                             h[:, None, :, :].expand(B, N, N, C), dist_sqr], dim=-1)
        m = F.silu(self.edge_2(F.silu(self.edge_1(edge_in))))
        m = torch.where(edge_mask[..., None], m, 0.0)
        coord_w = self.coord(m)
        denom = torch.sqrt(dist_sqr + 1.0)
        pos_delta = torch.where(edge_mask[..., None], diff / denom * coord_w, 0.0).sum(dim=2)
        pos_delta = pos_delta + self.vel_gate(torch.cat([h, h_init], dim=-1)) * vel
        upd = self.node_2(F.silu(self.node_1(torch.cat([h, m.sum(dim=2)], dim=-1))))
        return h + upd, pos + pos_delta


class EGNN(nn.Module):
    """EGNN predicting the final positions of the N-body task."""

    def __init__(self, config: EGNNConfig):
        super().__init__()
        self.config = config
        self.embed = nn.Linear(2, config.hidden_dim)  # [charge, speed]
        self.layers = nn.ModuleList(EGNNLayer(config.hidden_dim, config.hidden_dim)
                                    for _ in range(config.num_layers))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation with flax's distributions: lecun-normal
        Dense kernels (variance scale 0.001 for ``coord``), zero biases."""
        for name, p in self.named_parameters():
            if not name.endswith("weight"):
                p.zero_()
                continue
            scale = _COORD_SCALE if name.endswith("coord.weight") else 1.0
            std = math.sqrt(scale / p.shape[1]) / _TRUNC_STD
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)

    def forward(self, pos, vel, charges):
        B, N, _ = pos.shape
        speed = torch.linalg.norm(vel, dim=-1, keepdim=True)
        h = self.embed(torch.cat([charges[..., None], speed], dim=-1))
        edge_mask = ~torch.eye(N, dtype=torch.bool, device=pos.device)[None].expand(B, N, N)
        x, h0 = pos, h
        for layer in self.layers:
            h, x = layer(h, x, vel, h0, edge_mask)
        return x


class EGNNNBody:
    """The N-body task's interface (``tasks/nbody.py:NBodyModel``) on the
    EGNN baseline."""

    def __init__(self, config: EGNNConfig = EGNNConfig(), device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        pin_precision()
        self.config = config
        self.device = device
        self.model = EGNN(config).to(device)

    def init(self, generator: torch.Generator, batch=None) -> None:
        self.model.init_parameters(generator)

    def predict_positions(self, batch) -> torch.Tensor:
        return self.model(batch.pos, batch.vel, batch.charges)

    def loss(self, batch):
        mse = torch.mean((self.predict_positions(batch) - batch.target_pos) ** 2)
        return mse, {"loss": mse, "mse": mse}
