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

A compute type (``dtype``: None for float32, or ``torch.bfloat16``) is cast
at the JAX package's cast points, by hand (no autocast, whose cast list is
not flax's): the parameters stay float32 and are cast at use, a Dense is
:func:`dense` (flax's ``Dense(dtype=...)``), LayerNorm statistics are
float32, and where the JAX package writes ``preferred_element_type=f32`` on
bfloat16 operands the port upcasts the operands and multiplies in float32
(bfloat16 products are exact in float32). With ``fuse_convnext`` the
kernel layout runs the ConvNext MLP tail and its readout in one kernel pair
(``kernels/convnext_mlp.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from arreau_tpu_torch.kernels.basis_mlp import basis_mlp_multi
from arreau_tpu_torch.kernels.convnext_mlp import fused_convnext_mlp
from arreau_tpu_torch.kernels.fiber_conv import fused_fiber_conv
from arreau_tpu_torch.kernels.spatial_conv import fused_spatial_conv

LN_EPS = 1e-5


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def dense(linear: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """flax ``Dense(dtype=dtype)``: with a compute type, the input and the
    float32 weights are cast to it, the product is rounded to it and the
    bias is added in it (two roundings); without one, ``linear(x)``."""
    if dtype is None:
        return linear(x)
    y = torch.matmul(x.to(dtype), linear.weight.to(dtype).t())
    return y if linear.bias is None else y + linear.bias.to(dtype)


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

    def forward(self, attr: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``attr`` in its own type: the features are formed in it (the
        caller casts where the JAX package does), the Dense layers run in
        ``dtype``."""
        h = gelu(dense(self.dense_in, polynomial_features(attr, self.degree), dtype))
        return gelu(dense(self.dense_out, h, dtype))

    def forward_kernel_layout(self, attrT: torch.Tensor, n_out: int) -> tuple[torch.Tensor, ...]:
        """The same function from lane-major ``attrT [B', O, d, E]`` to
        ``n_out`` aliases of the ``[B', O, E, D]`` basis, one per consuming
        conv layer (the JAX package's ``MultiBasisMLP``): first layer in the
        ``basis_h1`` kernel, backward in the ``basis_mlp_bwd`` kernel, no
        cotangent for ``attrT``. The weights and biases are cast to
        ``attrT``'s type (float32 or bfloat16)."""
        dt = attrT.dtype

        def weight(linear: nn.Linear) -> torch.Tensor:
            return linear.weight.t().to(dt).contiguous()

        def bias(linear: nn.Linear) -> torch.Tensor:
            if linear.bias is not None:
                return linear.bias.to(dt)
            return torch.zeros(linear.out_features, dtype=dt, device=linear.weight.device)

        return basis_mlp_multi(attrT, weight(self.dense_in), bias(self.dense_in),
                               weight(self.dense_out), bias(self.dense_out), self.degree, n_out)


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
                kernel_layout: bool = False, dtype: Optional[torch.dtype] = None):
        """Plain layout: ``x [B, A, O, C]``, windowed ``kernel_basis [B, A,
        K, O, D]``, ``src``/``edge_mask [B, A, K]``. Kernel layout: ``x [B',
        O, TA, C]``, ``kernel_basis [B', O, E, D]``, tile-local ``src [B',
        E]`` int32 (-1 = empty slot), ``window [B', E]`` (``None`` with
        ``fuse_fiber``: the window is folded into the basis). With a compute
        ``dtype`` the spatial step runs in it and the fiber mixing takes its
        operands with float32 sums; the output is float32."""
        w = self.kernel if dtype is None else self.kernel.to(dtype)
        fiber_kernel = dense(self.fiber_kernel, fiber_kernel_basis, dtype)  # [O, P, C]
        num_ori = fiber_kernel.shape[0]
        if kernel_layout and self.fuse_fiber:
            y = fused_fiber_conv(kernel_basis, self.kernel, x.contiguous(), src,
                                 fiber_kernel / num_ori)
            return y + self.bias
        if kernel_layout:
            x_sp = fused_spatial_conv(kernel_basis, w, x.to(w.dtype).contiguous(), src, window)
            y = torch.einsum("botc,opc->bptc", x_sp.float(), fiber_kernel.float()) / num_ori
            return y + self.bias
        kernel = torch.einsum("bakod,dc->bakoc", kernel_basis.to(w.dtype), w)
        B, A, K = src.shape
        idx = src.reshape(B, A * K)[:, :, None, None].expand(B, A * K, *x.shape[2:])
        x_j = torch.gather(x, 1, idx).reshape(B, A, K, *x.shape[2:])
        messages = torch.where(edge_mask[..., None, None], kernel * x_j.to(kernel.dtype), 0.0)
        x_spatial = messages.sum(dim=2)  # a bfloat16 sum accumulates in float32, as jnp.sum's
        x_out = torch.einsum("baoc,opc->bapc", x_spatial.float(), fiber_kernel.float()) / num_ori
        return x_out + self.bias


class ConvNextBlock(nn.Module):
    """Residual block: conv -> LayerNorm -> widen Dense -> GELU -> Dense ->
    layer scale -> + residual. With a compute ``dtype`` the LayerNorm
    statistics are float32, its output and the MLP are in ``dtype``, and the
    residual stream stays in ``dtype``. With ``fuse_convnext`` and a compute
    type, the kernel layout runs the tail (and the layer's readout) as
    ``fused_convnext_mlp``."""

    def __init__(self, basis_dim: int, channels: int, widening_factor: int = 4,
                 layer_scale_init: Optional[float] = 1e-6, fuse_fiber: bool = False,
                 fuse_convnext: bool = False):
        super().__init__()
        self.fuse_convnext = fuse_convnext
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
                kernel_layout: bool = False, dtype: Optional[torch.dtype] = None,
                readout: Optional[nn.Linear] = None):
        """``(x_out, r)``: ``r`` is the layer's readout ``x_out @ W + b``
        computed by the fused kernel (float32), or None where the caller
        applies ``readout`` itself (every path but the fused one)."""
        residual = x
        x = self.conv(x, kernel_basis, fiber_kernel_basis, src, edge_mask, window, kernel_layout,
                      dtype)
        if self.fuse_convnext and kernel_layout and dtype is not None:
            C = x.shape[-1]
            gamma = (self.layer_scale if self.layer_scale is not None
                     else torch.ones(C, dtype=torch.float32, device=x.device))
            wr = readout.weight.t().contiguous() if readout is not None else None
            return fused_convnext_mlp(
                x.float().contiguous(), residual.to(dtype).contiguous(), self.norm.weight,
                self.norm.bias, self.linear_1.weight.t().to(dtype).contiguous(),
                self.linear_1.bias.to(dtype), self.linear_2.weight.t().to(dtype).contiguous(),
                self.linear_2.bias.to(dtype), gamma, wr,
                readout.bias if readout is not None else None)
        x = self.norm(x.float())
        if dtype is not None:
            x = x.to(dtype)
        x = dense(self.linear_2, gelu(dense(self.linear_1, x, dtype)), dtype)
        if self.layer_scale is not None:
            x = self.layer_scale.to(x.dtype) * x
        return residual + x, None
