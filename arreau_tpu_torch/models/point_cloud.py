"""Ponita on point clouds (the QM9 and MD17 backbones); counterpart of
``arreau_tpu/models/point_cloud.py``.

Two modes, as the JAX package's:

* lifted (``lifted=True``, the reference's ``num_ori = -1``): a lifted node
  is a slot ``(t, k)`` of the fixed-degree neighbour list, oriented along
  the edge from its sender to receiver t; lifted node (t, k) receives from
  every slot of the K + 1 base nodes ``{t} U N(t)``, a dense gather with
  masks. The per-pair attributes are the three point-cloud invariants.
* plain (``lifted=False``, ``num_ori = 0``): a depthwise conv on the base
  nodes with the edge length as the only attribute.

The basis MLP is the plain chain (``BasisMLP.forward``) and every Dense a
``nn.Linear``, as the JAX package's point-cloud model uses no Pallas
kernel: this model launches no CUDA kernel of the port. The arithmetic is
the JAX package's, broadcasts included: the lifted conv forms its
invariants on ``B * N * K * (K + 1) * K`` rows (663,552 at QM9's defaults,
96 molecules of 12 atoms, K = 8) and its basis on as many rows of
``basis_dim``, in every layer. Everything is differentiable through the
positions (MD17's forces are ``-dE/dpos``): the square roots carry an eps,
and a padded atom's empty slots give finite gradients.

Parameter names follow the JAX tree (``interop/from_jax.py:
point_cloud_params_from_jax``): ``x_embedder``, ``convs.{i}`` (``conv_{i}``:
``basis_fn``, ``kernel``, ``bias``), ``layers.{i}`` (``layer_{i}``:
``norm``, ``linear_1``, ``linear_2``, ``layer_scale``) and ``readouts.{i}``
(``readout_{i}``). A layer's conv is a sibling of its block, not a child, as
the flax module creates it in the parent's scope.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch import nn

from arreau_tpu_torch.models.blocks import BasisMLP, LayerNorm, gelu
from arreau_tpu_torch.ops.pbc import NeighborList
from arreau_tpu_torch.ops.windowing import polynomial_cutoff

_EPS = 1e-8
# jax.nn.initializers' truncated-normal std correction for the [-2, 2] cut
_TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class PointCloudConfig:
    input_dim_scalar: int
    input_dim_vec: int = 0
    hidden_dim: int = 128
    basis_dim: int = 256
    degree: int = 3
    num_layers: int = 5
    widening_factor: int = 4
    layer_scale: Optional[float] = None
    multiple_readouts: bool = True
    radius: Optional[float] = None
    output_dim_scalar: int = 1
    output_dim_vec: int = 0
    lifted: bool = True  # False: the plain point cloud (num_ori = 0)
    graph_pooling: bool = True  # a graph-level target
    expected_degree: float = 8.0


class PointCloudInputs(NamedTuple):
    pos: torch.Tensor  # [B, N, D]
    scalar: torch.Tensor  # [B, N, F]
    vec: torch.Tensor  # [B, N, V, D], V may be 0
    neighbors: NeighborList  # the base fixed-degree list
    node_mask: torch.Tensor  # [B, N]


class PointCloudOutputs(NamedTuple):
    scalar: torch.Tensor  # [B, out_s] pooled, else [B, N, out_s]
    vec: Optional[torch.Tensor]  # [B, out_v, D] pooled, else [B, N, out_v, D]; None without


def _gather_nodes(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr [B, N, ...]`` at ``idx [B, N, J]`` -> ``[B, N, J, ...]``."""
    B, N, J = idx.shape
    flat = arr.reshape(B, N, -1)
    out = torch.gather(flat, 1, idx.reshape(B, N * J, 1).expand(B, N * J, flat.shape[-1]))
    return out.reshape(B, N, J, *arr.shape[2:])


class _LiftedConv(nn.Module):
    """Depthwise conv over the implicit lifted adjacency: ``x [B, N, K, C]``
    lifted features; receiver (t, k) sums over the slots of the K + 1 base
    nodes ``{t} U N(t)``, with the invariants ``<rel, ori_r>``, the norm of
    the rejection and ``<ori_s, ori_r>``."""

    def __init__(self, channels: int, basis_dim: int, hidden_dim: int, degree: int,
                 radius: Optional[float]):
        super().__init__()
        self.radius = radius
        self.basis_fn = BasisMLP(3, hidden_dim, basis_dim, degree)
        self.kernel = nn.Linear(basis_dim, channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, lifted_ori, pos, neighbors: NeighborList, lifted_mask):
        B, N, K, C = x.shape
        node = torch.arange(N, device=x.device).expand(B, N)[..., None]
        bases = torch.cat([node, neighbors.src], dim=2)  # [B, N, K+1]
        base_valid = torch.cat([torch.ones_like(neighbors.mask[..., :1]), neighbors.mask], dim=2)
        pos_s = _gather_nodes(pos, bases)  # [B, N, K+1, D]
        ori_s = _gather_nodes(lifted_ori, bases)  # [B, N, K+1, K, D]
        x_s = _gather_nodes(x, bases)  # [B, N, K+1, K, C]
        mask_s = _gather_nodes(lifted_mask, bases) & base_valid[..., None]  # [B, N, K+1, K]

        # receiver slot axis Kr, source base axis K+1, source slot axis Ks
        rel = (pos_s - pos[:, :, None, :])[:, :, None, :, None, :]  # [B, N, 1, K+1, 1, D]
        ori_r = lifted_ori[:, :, :, None, None, :]  # [B, N, Kr, 1, 1, D]
        ori_sb = ori_s[:, :, None]  # [B, N, 1, K+1, Ks, D]
        inv1 = torch.sum(rel * ori_r, dim=-1, keepdim=True)
        rej = rel - ori_r * inv1
        inv2 = torch.sqrt(torch.sum(rej**2, dim=-1, keepdim=True) + _EPS**2)
        inv3 = torch.sum(ori_sb * ori_r, dim=-1, keepdim=True)
        shape = (*inv3.shape[:-1], 1)
        attr = torch.cat([inv1.expand(shape), inv2.expand(shape), inv3], dim=-1)

        basis = self.basis_fn(attr)  # [B, N, Kr, K+1, Ks, D]
        if self.radius is not None:
            dist = torch.sqrt(torch.sum(rel**2, dim=-1) + _EPS**2)
            basis = basis * polynomial_cutoff(dist, self.radius)[..., None]
        msg = self.kernel(basis) * x_s[:, :, None]
        msg = torch.where(mask_s[:, :, None, :, :, None], msg, 0.0)
        return msg.sum(dim=(3, 4)) + self.bias


class _PlainConv(nn.Module):
    """Depthwise conv on the base nodes with the edge length as the only
    attribute (the reference's ``num_ori = 0`` mode)."""

    def __init__(self, channels: int, basis_dim: int, hidden_dim: int, degree: int,
                 radius: Optional[float]):
        super().__init__()
        self.radius = radius
        self.basis_fn = BasisMLP(1, hidden_dim, basis_dim, degree)
        self.kernel = nn.Linear(basis_dim, channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, neighbors: NeighborList):
        B, N, C = x.shape
        basis = self.basis_fn(neighbors.dist[..., None])  # [B, N, K, D]
        if self.radius is not None:
            basis = basis * polynomial_cutoff(neighbors.dist, self.radius)[..., None]
        src = neighbors.src.reshape(B, -1, 1).expand(B, -1, C)
        x_j = torch.gather(x, 1, src).reshape(B, N, -1, C)
        msg = torch.where(neighbors.mask[..., None], self.kernel(basis) * x_j, 0.0)
        return msg.sum(dim=2) + self.bias


class _ConvNextPC(nn.Module):
    """conv -> LayerNorm -> widen Dense -> GELU -> Dense -> layer scale ->
    + residual; the conv is the caller's (a sibling in the parameter tree)."""

    def __init__(self, channels: int, widening_factor: int, layer_scale_init: Optional[float]):
        super().__init__()
        self.norm = LayerNorm(channels)
        self.linear_1 = nn.Linear(channels, widening_factor * channels)
        self.linear_2 = nn.Linear(widening_factor * channels, channels)
        self.layer_scale = (nn.Parameter(torch.full((channels,), float(layer_scale_init)))
                            if layer_scale_init is not None else None)

    def forward(self, x, conv: nn.Module, *conv_args):
        residual = x
        x = self.linear_2(gelu(self.linear_1(self.norm(conv(x, *conv_args)))))
        if self.layer_scale is not None:
            x = self.layer_scale * x
        return residual + x


class PonitaPointCloud(nn.Module):
    def __init__(self, config: PointCloudConfig):
        super().__init__()
        cfg = self.config = config
        in_dim = cfg.input_dim_scalar + (cfg.input_dim_vec if cfg.lifted else 0)
        self.x_embedder = nn.Linear(in_dim, cfg.hidden_dim, bias=False)
        conv = _LiftedConv if cfg.lifted else _PlainConv
        self.convs = nn.ModuleList(
            conv(cfg.hidden_dim, cfg.basis_dim, cfg.hidden_dim, cfg.degree, cfg.radius)
            for _ in range(cfg.num_layers))
        self.layers = nn.ModuleList(
            _ConvNextPC(cfg.hidden_dim, cfg.widening_factor, cfg.layer_scale)
            for _ in range(cfg.num_layers))
        out_total = cfg.output_dim_scalar + cfg.output_dim_vec
        self.readouts = nn.ModuleDict({
            str(i): nn.Linear(cfg.hidden_dim, out_total)
            for i in range(cfg.num_layers)
            if cfg.multiple_readouts or i == cfg.num_layers - 1})

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the JAX package's distributions:
        lecun-normal Dense kernels, each conv's kernel scaled by
        ``1/sqrt(expected_degree)``, zero biases, unit LayerNorm scale,
        constant layer scale."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and p.dim() == 2:
                scale = 1.0 / math.sqrt(self.config.expected_degree) if (
                    name.startswith("convs.") and name.endswith("kernel.weight")) else 1.0
                std = math.sqrt(scale / p.shape[1]) / _TRUNC_STD
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
            elif leaf == "weight":  # LayerNorm scale
                p.fill_(1.0)
            elif leaf == "layer_scale":
                p.fill_(self.config.layer_scale)
            else:  # biases
                p.zero_()

    def forward(self, inputs: PointCloudInputs) -> PointCloudOutputs:
        cfg = self.config
        nb = inputs.neighbors
        B, N, _ = inputs.pos.shape
        K = nb.src.shape[-1]

        if cfg.lifted:
            # lifted node (t, k): base t, oriented along the edge from its
            # sender to t (direction is sender minus receiver)
            lifted_ori = nb.direction / torch.clamp(nb.dist[..., None], min=_EPS)  # [B, N, K, D]
            lifted_mask = nb.mask & inputs.node_mask[..., None]
            F = inputs.scalar.shape[-1]
            feats = [inputs.scalar[:, :, None, :].expand(B, N, K, F)]
            if inputs.vec is not None and inputs.vec.shape[-2] > 0:
                feats.append(torch.einsum("bnvd,bnkd->bnkv", inputs.vec, lifted_ori))
            h = self.x_embedder(torch.cat(feats, dim=-1))
        else:
            h = self.x_embedder(inputs.scalar)

        readouts = []
        for i, (conv, block) in enumerate(zip(self.convs, self.layers)):
            if cfg.lifted:
                h = block(h, conv, lifted_ori, inputs.pos, nb, lifted_mask)
            else:
                h = block(h, conv, nb)
            if str(i) in self.readouts:
                readouts.append(self.readouts[str(i)](h))
        readout = sum(readouts) / len(readouts)
        r_scalar = readout[..., :cfg.output_dim_scalar]
        r_vec = readout[..., cfg.output_dim_scalar:]

        node_vec = None
        if cfg.lifted:
            # back to the base nodes: the mean over each node's lifted slots
            denom = torch.clamp(lifted_mask.sum(dim=2), min=1)[..., None]
            node_scalar = torch.where(lifted_mask[..., None], r_scalar, 0.0).sum(dim=2) / denom
            if cfg.output_dim_vec:
                weighted = r_vec[..., None] * lifted_ori[:, :, :, None, :]
                node_vec = torch.where(lifted_mask[..., None, None], weighted,
                                       0.0).sum(dim=2) / denom[..., None]
        else:
            node_scalar = r_scalar

        if not cfg.graph_pooling:
            return PointCloudOutputs(scalar=node_scalar, vec=node_vec)
        nmask = inputs.node_mask[..., None]
        return PointCloudOutputs(
            scalar=torch.where(nmask, node_scalar, 0.0).sum(dim=1),
            vec=None if node_vec is None else torch.where(nmask[..., None], node_vec,
                                                          0.0).sum(dim=1))
