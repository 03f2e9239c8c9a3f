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

Under tensor parallelism (``parallel/mesh.py``: ``shard_state`` sets a
module's ``tp`` to the mesh) a ``BasisMLP`` or ``ConvNextBlock`` holds its
shards of the split pair (``dense_in``/``linear_1`` by output features,
``dense_out``/``linear_2`` by input features). The plain chain then runs
the local column product, GELU and the local row product, sums the
partial products over the model group and adds the whole bias; a CUDA
kernel gets the weights gathered whole at its boundary, as JAX's
``shard_map`` gathers them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from arreau_tpu_torch.kernels.basis_mlp import basis_mlp_multi
from arreau_tpu_torch.kernels.convnext_mlp import fused_convnext_mlp
from arreau_tpu_torch.kernels.fiber_conv import fused_fiber_conv
from arreau_tpu_torch.kernels.fused_basis_mlp import fused_basis_mlp_fn
from arreau_tpu_torch.kernels.spatial_conv import fused_spatial_conv
from arreau_tpu_torch.parallel.mesh import copy_to_model, gather_from_model, reduce_from_model

LN_EPS = 1e-5


def pin_precision() -> None:
    """float32 products stay float32 on the card (no TF32 rounding), and
    bfloat16 products sum in float32 (cuBLAS may otherwise reduce partial
    sums in bfloat16; the JAX package accumulates in float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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


def row_parallel_dense(linear: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype], tp):
    """:func:`dense` of a layer split by input features over ``tp``'s model
    group: the local partial products in float32 (bfloat16 operands are
    exact in it), summed over the group, rounded to ``dtype`` and then the
    whole bias added, as :func:`dense` adds it."""
    if dtype is None:
        y = reduce_from_model(F.linear(x, linear.weight), tp)
    else:
        y = torch.matmul(x.to(dtype).float(), linear.weight.to(dtype).float().t())
        y = reduce_from_model(y, tp).to(dtype)
    return y if linear.bias is None else y + linear.bias.to(y.dtype)


def whole_weight(linear: nn.Linear, dim: int, tp) -> torch.Tensor:
    """``linear.weight`` as one card holds it: gathered over the model group
    under tensor parallelism (``dim`` its split dimension)."""
    return linear.weight if tp is None else gather_from_model(linear.weight, dim, tp)


def whole_bias(linear: nn.Linear, tp) -> Optional[torch.Tensor]:
    """A column-split layer's bias, whole (None without a bias)."""
    if linear.bias is None or tp is None:
        return linear.bias
    return gather_from_model(linear.bias, 0, tp)


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
    """``[..., V, D] x [O, D] -> [..., O, V]`` inner products (D = 3 or 2;
    V = 0 gives an empty signal)."""
    return torch.einsum("...vd,od->...ov", vec, ori_grid)


def sphere_to_scalar(signal: torch.Tensor) -> torch.Tensor:
    """Mean over the orientation axis: ``[..., O, F] -> [..., F]``."""
    return signal.mean(dim=-2)


def sphere_to_vec(signal: torch.Tensor, ori_grid: torch.Tensor) -> torch.Tensor:
    """Signal-weighted grid average: ``[..., O, V] -> [..., V, D]``."""
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
    GELU, over the last axis of ``attr``.

    With ``fused`` (the JAX package's ``BasisMLP(fused=True)``), no bias on
    either layer, a 4-D ``attr [B', O, E, d]`` and degree <= 3, the whole
    chain is the fused kernel pair #5/#6 (``kernels/fused_basis_mlp.py``):
    ``attr`` and both weights are cast to the compute type (``dtype``, else
    the weights' float32), the output is in it, and ``attr`` gets a zero
    cotangent. Otherwise, as in the JAX package, the plain chain runs. The
    parameters are the same either way. ``tp``: the mesh under tensor
    parallelism (module docstring), else None."""

    tp = None

    def __init__(self, input_dim: int, hidden_dim: int, basis_dim: int, degree: int,
                 use_bias: bool = True, out_bias: Optional[bool] = None, fused: bool = False):
        super().__init__()
        self.degree = degree
        self.fused = fused
        out_bias = use_bias if out_bias is None else out_bias
        in_dim = polynomial_feature_dim(input_dim, degree)
        self.dense_in = nn.Linear(in_dim, hidden_dim, bias=use_bias)
        self.dense_out = nn.Linear(hidden_dim, basis_dim, bias=out_bias)

    def forward(self, attr: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``attr`` in its own type: the features are formed in it (the
        caller casts where the JAX package does), the Dense layers run in
        ``dtype``; see the class docstring for the fused path."""
        if (self.fused and self.dense_in.bias is None and self.dense_out.bias is None
                and attr.dim() == 4 and self.degree <= 3):
            cdt = dtype or self.dense_in.weight.dtype
            w_in = whole_weight(self.dense_in, 0, self.tp)
            w_out = whole_weight(self.dense_out, 1, self.tp)
            return fused_basis_mlp_fn(attr.to(cdt).contiguous(), w_in.t().to(cdt).contiguous(),
                                      w_out.t().to(cdt).contiguous(), self.degree)
        feats = polynomial_features(attr, self.degree)
        if self.tp is None:
            return gelu(dense(self.dense_out, gelu(dense(self.dense_in, feats, dtype)), dtype))
        h = gelu(dense(self.dense_in, copy_to_model(feats, self.tp), dtype))
        return gelu(row_parallel_dense(self.dense_out, h, dtype, self.tp))

    def forward_kernel_layout(self, attrT: torch.Tensor, n_out: int) -> tuple[torch.Tensor, ...]:
        """The same function from lane-major ``attrT [B', O, d, E]`` to
        ``n_out`` aliases of the ``[B', O, E, D]`` basis, one per consuming
        conv layer (the JAX package's ``MultiBasisMLP``): first layer in the
        ``basis_h1`` kernel, backward in the ``basis_mlp_bwd`` kernel, no
        cotangent for ``attrT``. The weights and biases are cast to
        ``attrT``'s type (float32 or bfloat16)."""
        dt = attrT.dtype

        def weight(linear: nn.Linear, dim: int) -> torch.Tensor:
            return whole_weight(linear, dim, self.tp).t().to(dt).contiguous()

        def bias(linear: nn.Linear, b: Optional[torch.Tensor], width: int) -> torch.Tensor:
            if b is not None:
                return b.to(dt)
            return torch.zeros(width, dtype=dt, device=linear.weight.device)

        w_in, w_out = weight(self.dense_in, 0), weight(self.dense_out, 1)
        return basis_mlp_multi(attrT, w_in, bias(self.dense_in, whole_bias(self.dense_in, self.tp),
                                                 w_in.shape[1]),
                               w_out, bias(self.dense_out, self.dense_out.bias, w_out.shape[1]),
                               self.degree, n_out)


class FiberBundleConv(nn.Module):
    """Separable depthwise R^3 x S^2 convolution over the fixed-degree
    neighbour list: the spatial step (per-edge kernel from the basis,
    gathered senders, sum over the K slots) then the dense orientation
    mixing ``x[.., o, c] K[o, p, c] / O``. With ``fuse_fiber`` the kernel
    layout runs both steps in one call (``fused_fiber_conv``)."""

    def __init__(self, basis_dim: int, channels: int, fuse_fiber: bool = False):
        super().__init__()
        self.fuse_fiber = fuse_fiber
        self.kernel = nn.Parameter(torch.empty(basis_dim, channels))  # [D, C]
        self.fiber_kernel = nn.Linear(basis_dim, channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, kernel_basis, fiber_kernel_basis, src, edge_mask, window=None,
                kernel_layout: bool = False, dtype: Optional[torch.dtype] = None,
                position_grads: bool = False, return_messages: bool = False):
        """Plain layout: ``x [B, A, O, C]``, windowed ``kernel_basis [B, A,
        K, O, D]``, ``src``/``edge_mask [B, A, K]``. Kernel layout: ``x [B',
        O, TA, C]``, ``kernel_basis [B', O, E, D]``, tile-local ``src [B',
        E]`` int32 (-1 = empty slot), ``window [B', E]`` (``None`` with
        ``fuse_fiber``: the window is folded into the basis), which gets a
        cotangent with ``position_grads`` (the spatial conv's
        ``window_grad``). With a compute ``dtype`` the spatial step runs in it
        and the fiber mixing takes its operands with float32 sums; the output
        is float32. ``return_messages`` (plain layout only) also returns the
        per-edge messages ``[B, A, K, O, C]``, empty slots included, as the
        JAX package's conv returns them."""
        w = self.kernel if dtype is None else self.kernel.to(dtype)
        fiber_kernel = dense(self.fiber_kernel, fiber_kernel_basis, dtype)  # [O, P, C]
        num_ori = fiber_kernel.shape[0]
        if kernel_layout and self.fuse_fiber:
            # the basis, w, x and the fiber kernel in the compute type, y float32
            y = fused_fiber_conv(kernel_basis.to(w.dtype), w, x.to(w.dtype).contiguous(), src,
                                 fiber_kernel / num_ori)
            return y + self.bias
        if kernel_layout:
            x_sp = fused_spatial_conv(kernel_basis, w, x.to(w.dtype).contiguous(), src, window,
                                      window_grad=position_grads)
            y = torch.einsum("botc,opc->bptc", x_sp.float(), fiber_kernel.float()) / num_ori
            return y + self.bias
        kernel = torch.einsum("bakod,dc->bakoc", kernel_basis.to(w.dtype), w)
        B, A, K = src.shape
        idx = src.reshape(B, A * K)[:, :, None, None].expand(B, A * K, *x.shape[2:])
        x_j = torch.gather(x, 1, idx).reshape(B, A, K, *x.shape[2:])
        messages = kernel * x_j.to(kernel.dtype)
        # a bfloat16 sum accumulates in float32, as jnp.sum's
        x_spatial = torch.where(edge_mask[..., None, None], messages, 0.0).sum(dim=2)
        x_out = torch.einsum("baoc,opc->bapc", x_spatial.float(), fiber_kernel.float()) / num_ori
        return (x_out + self.bias, messages) if return_messages else x_out + self.bias


class ConvNextBlock(nn.Module):
    """Residual block: conv -> LayerNorm -> widen Dense -> GELU -> Dense ->
    layer scale -> + residual. With a compute ``dtype`` the LayerNorm
    statistics are float32, its output and the MLP are in ``dtype``, and the
    residual stream stays in ``dtype``. With ``fuse_convnext`` and a compute
    type, the kernel layout runs the tail (and the layer's readout) as
    ``fused_convnext_mlp``. ``tp``: the mesh under tensor parallelism
    (module docstring), else None."""

    tp = None

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
                readout: Optional[nn.Linear] = None, position_grads: bool = False,
                return_messages: bool = False):
        """``(x_out, r)``: ``r`` is the layer's readout ``x_out @ W + b``
        computed by the fused kernel (float32), or None where the caller
        applies ``readout`` itself (every path but the fused one).
        ``return_messages`` (plain layout): ``(x_out, None, messages)``,
        the conv's per-edge messages for the edge readouts."""
        residual = x
        x = self.conv(x, kernel_basis, fiber_kernel_basis, src, edge_mask, window, kernel_layout,
                      dtype, position_grads, return_messages)
        if return_messages:
            x, messages = x
        if self.fuse_convnext and kernel_layout and dtype is not None:
            C = x.shape[-1]
            gamma = (self.layer_scale if self.layer_scale is not None
                     else torch.ones(C, dtype=torch.float32, device=x.device))
            wr = readout.weight.t().contiguous() if readout is not None else None
            w1 = whole_weight(self.linear_1, 0, self.tp)
            w2 = whole_weight(self.linear_2, 1, self.tp)
            return fused_convnext_mlp(
                x.float().contiguous(), residual.to(dtype).contiguous(), self.norm.weight,
                self.norm.bias, w1.t().to(dtype).contiguous(),
                whole_bias(self.linear_1, self.tp).to(dtype), w2.t().to(dtype).contiguous(),
                self.linear_2.bias.to(dtype), gamma, wr,
                readout.bias if readout is not None else None)
        x = self.norm(x.float())
        if dtype is not None:
            x = x.to(dtype)
        if self.tp is None:
            x = dense(self.linear_2, gelu(dense(self.linear_1, x, dtype)), dtype)
        else:
            h = gelu(dense(self.linear_1, copy_to_model(x, self.tp), dtype))
            x = row_parallel_dense(self.linear_2, h, dtype, self.tp)
        if self.layer_scale is not None:
            x = self.layer_scale.to(x.dtype) * x
        return (residual + x, None, messages) if return_messages else (residual + x, None)
