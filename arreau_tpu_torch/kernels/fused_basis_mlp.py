"""The bias-free edge-basis MLP as one fused function, forward and backward:
the path of ``BasisMLP(fused=True)``.

Replaces the TPU kernels ``arreau_tpu/ops/pallas_basis.py:_fwd_kernel`` (#5)
and ``_bwd_kernel`` (#6) (public entry ``fused_basis_mlp``, a
``jax.custom_vjp``) with the hand-written CUDA kernels
``csrc/fused_basis_mlp.cu`` and ``csrc/fused_basis_mlp_bwd.cu``, joined by
the ``torch.autograd.Function`` :func:`fused_basis_mlp_fn`. The forward is

    basis = gelu(round(gelu(round(poly(attr) @ w1)) @ w2))

over the last axis of ``attr [B', O, E, d]``, with ``poly`` the degree <= 3
tensor-power features (``models/blocks.py:polynomial_features``), ``w1
[F, H]``, ``w2 [H, D]``, no biases, and ``round`` the rounding to the
compute type. The backward gives the weight gradients only: the
attributes derive from positions and the lattice, which training does not
differentiate, and the JAX VJP returns zeros for them (so does
:class:`_FusedBasisMLP`).

On the H100 both directions are bound by arithmetic (2*rows*(F*H + H*D)
operations forward, 2*rows*(2*F*H + 3*H*D) backward, against one write of
the basis or one read of its cotangent) and run their products on the
tensor cores (``mma.sync``: bfloat16, or 3xTF32 for float32). The forward
is two tile products: ``poly @ w1`` with the features built in shared
memory (#8's product, ``csrc/basis_h1.cuh``), its epilogue writing the
hidden activations to a scratch in the compute type, then ``h @ w2``. The
backward is #7's chain of five products (``csrc/basis_mlp_bwd.cuh``)
without biases: the forward recomputed, device-memory scratch between the
products, split-K weight gradients added in a fixed order. See the sources.

attr, w1, w2 (and the cotangent) are float32, or all bfloat16 under a
bfloat16 compute type, with the JAX kernel's rounding points: the features
formed in float32 and rounded once, both products summed in float32 and
rounded before their GELU, the cotangent rounded to the compute type, and
``db_pre``, ``dh`` and ``dh_pre`` rounded as ``pallas_basis.py:129-143``
writes ``.astype(cdt)``. GELU is the tanh approximation evaluated in
float32 from the rounded value and rounded once (the JAX kernel evaluates
it in the compute type step by step; ROADMAP Queue C 3). The backward's
weight gradients are float32 sums; the Function returns them in the
weights' type, as the JAX VJP's ``.astype(w.dtype)``.

:func:`fused_basis_mlp` and :func:`fused_basis_mlp_bwd` launch their
kernels for CUDA tensors and run :func:`fused_basis_mlp_plain` /
:func:`fused_basis_mlp_bwd_plain` for CPU tensors; they never fall back.
"""

from __future__ import annotations

import ctypes

import torch

from arreau_tpu_torch.kernels.basis_h1 import _MAX_D, DTYPES
from arreau_tpu_torch.kernels.basis_mlp import gelu_and_deriv

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 5 + (_I,) * 8 + (_P,)
_BWD_ARGTYPES = (_P,) * 11 + (_I,) * 10 + (_P,)
_XR = 8  # row stride of the backward's invariant scratch (csrc/basis_h1.cuh: XR)


def padded_rows(n: int) -> int:
    """Row length of an ``[rows, n]`` scratch in the compute type: n rounded
    up to 8 elements, so that every row starts 16-byte aligned."""
    return -(-n // 8) * 8


def poly_features(attr, degree: int):
    """``[..., F]`` features of ``attr [..., d]``, formed in float32 (float64
    stays float64), rounded once to ``attr``'s type and returned in the
    working type."""
    from arreau_tpu_torch.models.blocks import polynomial_features

    wt = torch.promote_types(attr.dtype, torch.float32)
    return polynomial_features(attr.to(wt), degree).to(attr.dtype).to(wt)


def fused_basis_mlp_plain(attr, w1, w2, degree: int):
    """Plain PyTorch version: materialised features and hidden layer,
    float32 products, rounded to ``attr``'s type where the kernel rounds."""
    dt, wt = attr.dtype, torch.promote_types(attr.dtype, torch.float32)

    def rnd(v):
        return v.to(dt).to(wt)

    poly = poly_features(attr, degree)
    h = rnd(gelu_and_deriv(rnd(poly @ w1.to(wt)))[0])
    return gelu_and_deriv(rnd(h @ w2.to(wt)))[0].to(dt)


def fused_basis_mlp_bwd_plain(attr, w1, w2, degree: int, g):
    """Plain PyTorch version of the backward: (dw1 ``[F, H]``, dw2 ``[H,
    D]``), float32 sums, for the cotangent ``g`` of the basis (rounded to
    ``attr``'s type first)."""
    dt, wt = attr.dtype, torch.promote_types(attr.dtype, torch.float32)

    def rnd(v):
        return v.to(dt).to(wt)

    F_, H = w1.shape
    w1, w2 = w1.to(wt), w2.to(wt)
    poly = poly_features(attr, degree).reshape(-1, F_)
    h, dg1 = (rnd(v) for v in gelu_and_deriv(rnd(poly @ w1)))
    dg2 = rnd(gelu_and_deriv(rnd(h @ w2))[1])
    db_pre = rnd(rnd(g.reshape(-1, w2.shape[1])) * dg2)
    dh_pre = rnd(rnd(db_pre @ w2.t()) * dg1)
    return poly.t() @ dh_pre, h.t() @ db_pre


def _check(attr, w1, w2, degree):
    if attr.dim() != 4 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("fused_basis_mlp expects attr [B',O,E,d], w1 [F,H], w2 [H,D]")
    d = attr.shape[3]
    F_, H = w1.shape
    if not 1 <= degree <= 3:
        raise ValueError(f"fused_basis_mlp supports degree 1..3, got {degree}")
    if F_ != sum(d**i for i in range(1, degree + 1)) or w2.shape[0] != H:
        raise ValueError(f"shape mismatch: attr {tuple(attr.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    if attr.dtype not in DTYPES:
        raise TypeError(f"attr must be float32 or bfloat16, got {attr.dtype}")
    for name, t in (("w1", w1), ("w2", w2)):
        if t.dtype != attr.dtype:
            raise TypeError(f"{name} must be {attr.dtype} like attr, got {t.dtype}")
    if len({t.device for t in (attr, w1, w2)}) != 1:
        raise ValueError("all fused_basis_mlp inputs must be on one device")


def _check_cuda(name, attr, *tensors):
    if attr.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {attr.device}")
    if not all(t.is_contiguous() for t in (attr, *tensors)):
        raise ValueError(f"{name}'s CUDA kernels need contiguous inputs")
    if attr.shape[3] > _MAX_D:
        raise ValueError(f"{name}'s CUDA kernels stage at most {_MAX_D} invariants, "
                         f"got {attr.shape[3]}")


def fused_basis_mlp(attr, w1, w2, degree: int):
    """``[B', O, E, D]`` basis in ``attr``'s type; see the module docstring."""
    _check(attr, w1, w2, degree)
    if attr.device.type == "cpu":
        return fused_basis_mlp_plain(attr, w1, w2, degree)
    _check_cuda("fused_basis_mlp", attr, w1, w2)
    Bp, O, E, d = attr.shape
    F_, H = w1.shape
    D = w2.shape[1]
    from arreau_tpu_torch.kernels.build import check, kernel_function

    dev = attr.device
    h = torch.empty((Bp * O * E, padded_rows(H)), dtype=attr.dtype, device=dev)
    out = torch.empty((Bp, O, E, D), dtype=attr.dtype, device=dev)
    fn = kernel_function("arreau_fused_basis_mlp_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(attr.data_ptr(), w1.data_ptr(), w2.data_ptr(), h.data_ptr(), out.data_ptr(), Bp, O,
             E, d, F_, H, D, int(attr.dtype == torch.bfloat16), stream)
    check("arreau_fused_basis_mlp_fwd", err)
    fused_basis_mlp.launches += 1
    return out


fused_basis_mlp.launches = 0


@torch.library.custom_op("arreau_tpu_torch::fused_basis_mlp", mutates_args=(),
                         schema="(Tensor attr, Tensor w1, Tensor w2, int degree) -> Tensor")
def fused_basis_mlp_op(attr, w1, w2, degree):
    """:func:`fused_basis_mlp` as the operator
    ``torch.ops.arreau_tpu_torch.fused_basis_mlp``, which ``torch.export``
    keeps as one node (a fake tensor has no ``data_ptr``); the wrapper is
    looked up in this module when the operator runs. Its outputs are
    contiguous, as the kernel's are (see
    :func:`~arreau_tpu_torch.kernels.spatial_conv.spatial_conv_op`)."""
    return fused_basis_mlp(attr, w1, w2, degree).contiguous()


@fused_basis_mlp_op.register_fake
def _(attr, w1, w2, degree):
    return attr.new_empty((*attr.shape[:3], w2.shape[1]))


def fused_basis_mlp_bwd(attr, w1, w2, degree: int, g):
    """(dw1 ``[F, H]``, dw2 ``[H, D]``), float32, for the cotangent ``g [B',
    O, E, D]`` of :func:`fused_basis_mlp`'s output (``attr``'s type)."""
    _check(attr, w1, w2, degree)
    Bp, O, E, d = attr.shape
    F_, H = w1.shape
    D = w2.shape[1]
    if tuple(g.shape) != (Bp, O, E, D) or g.dtype != attr.dtype or g.device != attr.device:
        raise ValueError(f"g must be {attr.dtype} {(Bp, O, E, D)} on {attr.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    if attr.device.type == "cpu":
        return fused_basis_mlp_bwd_plain(attr, w1, w2, degree, g)
    _check_cuda("fused_basis_mlp_bwd", attr, w1, w2, g)
    from arreau_tpu_torch.kernels.build import check, kernel_function, row_splits

    rows = Bp * O * E
    splits, per_split = row_splits(rows)
    dev, dt = attr.device, attr.dtype
    h1 = torch.empty((rows, padded_rows(H)), dtype=dt, device=dev)
    dg1 = torch.empty_like(h1)
    dpre2 = torch.empty((rows, D), dtype=dt, device=dev)
    xr = torch.empty((rows, _XR), dtype=dt, device=dev)
    partial = torch.empty(splits * max(F_ * H, H * D), dtype=torch.float32, device=dev)
    dw1 = torch.empty((F_, H), dtype=torch.float32, device=dev)
    dw2 = torch.empty((H, D), dtype=torch.float32, device=dev)
    fn = kernel_function("arreau_fused_basis_mlp_bwd", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(attr.data_ptr(), w1.data_ptr(), w2.data_ptr(), g.data_ptr(), h1.data_ptr(),
             dg1.data_ptr(), dpre2.data_ptr(), xr.data_ptr(), partial.data_ptr(), dw1.data_ptr(),
             dw2.data_ptr(), Bp, O, E, d, F_, H, D, splits, per_split,
             int(dt == torch.bfloat16), stream)
    check("arreau_fused_basis_mlp_bwd", err)
    fused_basis_mlp_bwd.launches += 1
    return dw1, dw2


fused_basis_mlp_bwd.launches = 0


class _FusedBasisMLP(torch.autograd.Function):
    """``fused_basis_mlp``'s custom VJP: :func:`fused_basis_mlp` forward
    (#5) through its operator, :func:`fused_basis_mlp_bwd` backward (#6);
    zeros for ``attr``."""

    @staticmethod
    def forward(ctx, attr, w1, w2, degree):
        ctx.save_for_backward(attr, w1, w2)
        ctx.degree = degree
        return torch.ops.arreau_tpu_torch.fused_basis_mlp(attr, w1, w2, degree)

    @staticmethod
    def backward(ctx, g):
        attr, w1, w2 = ctx.saved_tensors
        # the cotangent rounded to the compute type, as the JAX kernel's g.astype(cdt)
        dw1, dw2 = fused_basis_mlp_bwd(attr, w1, w2, ctx.degree, g.to(attr.dtype).contiguous())
        dattr = torch.zeros_like(attr) if ctx.needs_input_grad[0] else None
        # in the weights' type, as the JAX VJP's .astype(w.dtype)
        return dattr, dw1.to(w1.dtype), dw2.to(w2.dtype), None


def fused_basis_mlp_fn(attr, w1, w2, degree: int):
    """Differentiable :func:`fused_basis_mlp`: ``[B', O, E, D]`` from ``attr
    [B', O, E, d]``, ``w1 [F, H]`` and ``w2 [H, D]``, all in one type."""
    return _FusedBasisMLP.apply(attr, w1, w2, degree)
