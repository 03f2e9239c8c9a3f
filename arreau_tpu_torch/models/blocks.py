"""Building blocks of the Ponita backbone: polynomial features, sphere
codecs, the basis MLP, the separable fiber-bundle convolution and the
ConvNext block; counterpart of ``arreau_tpu/models/blocks.py``.

Two layouts run through these blocks. The plain layout keeps crystals and
atoms apart (``x [B, A, O, C]``, basis ``[B, A, K, O, D]``). The kernel
layout folds T crystals into one super-crystal of TA = T*A atoms, with
orientation-major features ``x [B', O, TA, C]`` and k-major edge rows
``[B', O, E = K*TA, D]``; it is the layout of the CUDA kernels. There
the basis MLP and the spatial conv are ``torch.autograd.Function``s whose
forwards and backwards are the kernels (``kernels/basis_mlp.py``,
``kernels/spatial_conv.py``); with ``fuse_fiber`` the spatial conv and the
fiber mixing are one (``kernels/fiber_conv.py``).

Two numerical details follow the JAX package: GELU is the tanh
approximation (flax ``nn.gelu``), and LayerNorm takes the fast variance
``E[x^2] - E[x]^2`` with eps 1e-5 (flax ``LayerNorm``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from arreau_tpu_torch.kernels.basis_mlp import basis_mlp_multi
from arreau_tpu_torch.kernels.fiber_conv import fused_fiber_conv
from arreau_tpu_torch.kernels.spatial_conv import fused_spatial_conv

LN_EPS = 1e-5


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def polynomial_features(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Tensor-power features ``[x, x (x) x, ...]`` flattened; output dim
    ``d + d^2 + ... + d^degree``."""
    feats = [x]
    for _ in range(1, degree):
        outer = feats[-1][..., :, None] * x[..., None, :]
        feats.append(outer.reshape(*outer.shape[:-2], -1))
    return torch.cat(feats, dim=-1)


def polynomial_feature_dim(input_dim: int, degree: int) -> int:
    return sum(input_dim**i for i in range(1, degree + 1))


def scalar_to_sphere(scalar: torch.Tensor, num_ori: int) -> torch.Tensor:
    """``[..., F] -> [..., O, F]`` by repetition over the orientation grid."""
    return scalar[..., None, :].expand(*scalar.shape[:-1], num_ori, scalar.shape[-1])


def vec_to_sphere(vec: torch.Tensor, ori_grid: torch.Tensor) -> torch.Tensor:
    """``[..., V, 3] x [O, 3] -> [..., O, V]`` inner products."""
    return torch.einsum("...vd,od->...ov", vec, ori_grid)


def sphere_to_scalar(signal: torch.Tensor) -> torch.Tensor:
    """Mean over the orientation axis: ``[..., O, F] -> [..., F]``."""
    return signal.mean(dim=-2)


def sphere_to_vec(signal: torch.Tensor, ori_grid: torch.Tensor) -> torch.Tensor:
    """Signal-weighted grid average: ``[..., O, V] -> [..., V, 3]``."""
    return torch.einsum("...ov,od->...vd", signal, ori_grid) / ori_grid.shape[-2]


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's fast variance."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (self.weight * torch.rsqrt(var + self.eps)) + self.bias


class BasisMLP(nn.Module):
    """Kernel-basis network: polynomial features -> Dense -> GELU -> Dense ->
    GELU, over the last axis of ``attr``."""

    def __init__(self, input_dim: int, hidden_dim: int, basis_dim: int, degree: int,
                 use_bias: bool = True, out_bias: Optional[bool] = None):
        super().__init__()
        self.degree = degree
        out_bias = use_bias if out_bias is None else out_bias
        in_dim = polynomial_feature_dim(input_dim, degree)
        self.dense_in = nn.Linear(in_dim, hidden_dim, bias=use_bias)
        self.dense_out = nn.Linear(hidden_dim, basis_dim, bias=out_bias)

    def forward(self, attr: torch.Tensor) -> torch.Tensor:
        h = gelu(self.dense_in(polynomial_features(attr, self.degree)))
        return gelu(self.dense_out(h))

    def forward_kernel_layout(self, attrT: torch.Tensor, n_out: int) -> tuple[torch.Tensor, ...]:
        """The same function from lane-major ``attrT [B', O, d, E]`` to
        ``n_out`` aliases of the ``[B', O, E, D]`` basis, one per consuming
        conv layer (the JAX package's ``MultiBasisMLP``): first layer in the
        ``basis_h1`` kernel, backward in the ``basis_mlp_bwd`` kernel, no
        cotangent for ``attrT``."""

        def bias(linear: nn.Linear) -> torch.Tensor:
            if linear.bias is not None:
                return linear.bias
            return torch.zeros(linear.out_features, dtype=linear.weight.dtype,
                               device=linear.weight.device)

        return basis_mlp_multi(attrT, self.dense_in.weight.t().contiguous(), bias(self.dense_in),
                               self.dense_out.weight.t().contiguous(), bias(self.dense_out),
                               self.degree, n_out)


class FiberBundleConv(nn.Module):
    """Separable depthwise R^3 x S^2 convolution over the fixed-degree
    neighbour list: the spatial step (per-edge kernel from the basis,
    gathered senders, sum over the K slots) then the dense orientation
    mixing ``x[.., o, c] K[o, p, c] / O``. With ``fuse_fiber`` the kernel
    layout runs both steps in one kernel (``fused_fiber_conv``)."""

    def __init__(self, basis_dim: int, channels: int, fuse_fiber: bool = False):
        super().__init__()
        self.fuse_fiber = fuse_fiber
        self.kernel = nn.Parameter(torch.empty(basis_dim, channels))  # [D, C]
        self.fiber_kernel = nn.Linear(basis_dim, channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, kernel_basis, fiber_kernel_basis, src, edge_mask, window=None,
                kernel_layout: bool = False):
        """Plain layout: ``x [B, A, O, C]``, windowed ``kernel_basis [B, A,
        K, O, D]``, ``src``/``edge_mask [B, A, K]``. Kernel layout: ``x [B',
        O, TA, C]``, ``kernel_basis [B', O, E, D]``, tile-local ``src [B',
        E]`` int32 (-1 = empty slot), ``window [B', E]`` (``None`` with
        ``fuse_fiber``: the window is folded into the basis)."""
        fiber_kernel = self.fiber_kernel(fiber_kernel_basis)  # [O, P, C]
        num_ori = fiber_kernel.shape[0]
        if kernel_layout and self.fuse_fiber:
            y = fused_fiber_conv(kernel_basis, self.kernel, x.contiguous(), src,
                                 fiber_kernel / num_ori)
            return y + self.bias
        if kernel_layout:
            x_sp = fused_spatial_conv(kernel_basis, self.kernel, x.contiguous(), src, window)
            y = torch.einsum("botc,opc->bptc", x_sp, fiber_kernel) / num_ori
            return y + self.bias
        kernel = torch.einsum("bakod,dc->bakoc", kernel_basis, self.kernel)
        B, A, K = src.shape
        idx = src.reshape(B, A * K)[:, :, None, None].expand(B, A * K, *x.shape[2:])
        x_j = torch.gather(x, 1, idx).reshape(B, A, K, *x.shape[2:])
        messages = torch.where(edge_mask[..., None, None], kernel * x_j, 0.0)
        x_spatial = messages.sum(dim=2)
        x_out = torch.einsum("baoc,opc->bapc", x_spatial, fiber_kernel) / num_ori
        return x_out + self.bias


class ConvNextBlock(nn.Module):
    """Residual block: conv -> LayerNorm -> widen Dense -> GELU -> Dense ->
    layer scale -> + residual."""

    def __init__(self, basis_dim: int, channels: int, widening_factor: int = 4,
                 layer_scale_init: Optional[float] = 1e-6, fuse_fiber: bool = False):
        super().__init__()
        self.conv = FiberBundleConv(basis_dim, channels, fuse_fiber)
        self.norm = LayerNorm(channels)
        self.linear_1 = nn.Linear(channels, widening_factor * channels)
        self.linear_2 = nn.Linear(widening_factor * channels, channels)
        self.layer_scale = (
            nn.Parameter(torch.full((channels,), float(layer_scale_init)))
            if layer_scale_init is not None
            else None
        )

    def forward(self, x, kernel_basis, fiber_kernel_basis, src, edge_mask, window=None,
                kernel_layout: bool = False):
        residual = x
        x = self.conv(x, kernel_basis, fiber_kernel_basis, src, edge_mask, window, kernel_layout)
        x = self.linear_2(gelu(self.linear_1(self.norm(x))))
        if self.layer_scale is not None:
            x = self.layer_scale * x
        return residual + x
