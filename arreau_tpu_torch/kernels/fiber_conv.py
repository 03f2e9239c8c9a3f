"""Fused fiber-bundle convolution over super-crystal tiles (spatial conv,
sum over the K neighbour slots and fiber mixing in one call), forward and
backward.

Replaces the TPU kernels ``arreau_tpu/ops/pallas_conv.py:_fwd_kernel`` and
``_bwd_kernel`` (public entry ``fused_fiber_conv``, a ``jax.custom_vjp``)
with the hand-written CUDA kernels ``csrc/fiber_conv.cu`` (#1) and
``csrc/fiber_conv_bwd.cu`` (#2), joined by the ``torch.autograd.Function``
:func:`fused_fiber_conv`. The forward is

    y[b',p,t,c] = sum_o Kf[o,p,c] * sum_k (basis[b',o,e,:] @ w)[c] * x[b',o,src[b',e],c]

with ``e = k*TA + t``, the window already folded into the basis and the
fiber kernel ``Kf`` pre-scaled by ``1/O``. The layouts are those of
:mod:`arreau_tpu_torch.kernels.spatial_conv`: the tile-local sender ``src
[B', E]`` int32 (a value outside ``[0, TA)``, -1 by convention, marks an
empty slot) takes the place of the JAX package's one-hot ``sel``.

On the H100 the forward's per-edge kernel ``basis @ w`` runs on the
tensor cores, through the spatial conv's forward mainloop
(``csrc/conv_fwd.cuh``, 3xTF32 in float32), which folds the K slots in
registers, so nothing per edge reaches device memory; it stores the
float32 spatial conv ``x_sp [B', O, TA, C]``, and a second hand-written
kernel mixes it over the orientations in ascending o. When gradients are
wanted ``x_sp`` is the backward's residual (the TPU kernel recomputes it);
otherwise it is scratch. The backward launches the fiber cotangent, the
fiber-kernel gradient with a fixed-order second pass, and the spatial
conv's own backward kernels, three products of the forward's size on the
tensor cores. Every output of both is the same bit for bit on every call.
See the sources.

:func:`fiber_conv` and :func:`fiber_conv_bwd` launch their kernels for CUDA
tensors and run :func:`fiber_conv_plain` / :func:`fiber_conv_bwd_plain` for
CPU tensors; they never fall back.

basis, w, x and the fiber kernel are float32, or all bfloat16 on the
``compute_dtype="bfloat16"`` path; y, the saved spatial conv ``x_sp`` and
the cotangent ``g`` are float32 in both. In bfloat16 the functions follow
the JAX kernels' cast points (``pallas_conv.py:82-161``): the forward
multiplies and sums in float32 and rounds nothing; the backward keeps
``g_o`` float32, rounds ``gxw = g_o * x`` to bfloat16 before its products,
rounds the per-edge kernel and ``g_o`` to bfloat16 apart before their
product for dx (where #4's own backward rounds the product once), stores
dbasis and dx in bfloat16, and returns dw and dfiber_kernel, float32 sums,
in the weights' type (the JAX VJP's ``.astype``).
"""

from __future__ import annotations

import ctypes

import torch

from arreau_tpu_torch.kernels.spatial_conv import (
    DTYPES,
    edge_cotangent_scratch,
    sender_order,
    spatial_conv_bwd_plain,
    spatial_conv_plain,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 7 + (_I,) * 8 + (_P,)
_BWD_ARGTYPES = (_P,) * 18 + (_I,) * 10 + (_P,)
_MAX_P = 16  # orientations the kernels hold in registers (csrc/*.cu: MAX_P, MAX_O)


def _unit_window(src):
    return torch.ones(src.shape, dtype=torch.float32, device=src.device)


def fiber_conv_plain(basis, w, x, src, fiber_kernel, save_x_sp: bool = False):
    """Plain PyTorch version: the spatial conv's plain version with a unit
    window in float32 (float64 stays float64), then the fiber mixing as one
    einsum; with ``save_x_sp`` also the spatial conv."""
    wt = torch.promote_types(basis.dtype, torch.float32)
    x_sp = spatial_conv_plain(basis.to(wt), w.to(wt), x.to(wt), src, _unit_window(src))
    y = torch.einsum("botc,opc->bptc", x_sp, fiber_kernel.to(wt))
    return (y, x_sp) if save_x_sp else y


def fiber_conv_bwd_plain(basis, w, x, src, fiber_kernel, g, x_sp):
    """Plain PyTorch version of the backward: (dbasis, dw, dx, dfiber_kernel)
    for the cotangent ``g [B', P, TA, C]`` of :func:`fiber_conv_plain`,
    whose spatial conv ``x_sp`` the forward saved."""
    g_o = torch.einsum("bptc,opc->botc", g, fiber_kernel.to(g.dtype))
    dfk = torch.einsum("botc,bptc->opc", x_sp, g)
    return (*spatial_conv_bwd_plain(basis, w, x, src, _unit_window(src), g_o, fiber=True),
            dfk.to(fiber_kernel.dtype))


def _check(basis, w, x, src, fiber_kernel):
    if basis.dim() != 4 or x.dim() != 4 or w.dim() != 2 or src.dim() != 2 or fiber_kernel.dim() != 3:
        raise ValueError("fiber_conv expects basis [B',O,E,D], w [D,C], x [B',O,TA,C], src [B',E], "
                         "fiber_kernel [O,P,C]")
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    if x.shape[:2] != (Bp, O) or E % TA or tuple(w.shape) != (D, C):
        raise ValueError(f"shape mismatch: basis {tuple(basis.shape)}, w {tuple(w.shape)}, "
                         f"x {tuple(x.shape)}")
    if tuple(src.shape) != (Bp, E):
        raise ValueError(f"src {tuple(src.shape)} must be {(Bp, E)}")
    if fiber_kernel.shape[0] != O or fiber_kernel.shape[2] != C:
        raise ValueError(f"fiber_kernel {tuple(fiber_kernel.shape)} must be [{O}, P, {C}]")
    if basis.dtype not in DTYPES:
        raise TypeError(f"basis must be float32 or bfloat16, got {basis.dtype}")
    for name, t in (("w", w), ("x", x), ("fiber_kernel", fiber_kernel)):
        if t.dtype != basis.dtype:
            raise TypeError(f"{name} must be {basis.dtype} like the basis, got {t.dtype}")
    if src.dtype != torch.int32:
        raise TypeError(f"src must be int32, got {src.dtype}")
    if len({t.device for t in (basis, w, x, src, fiber_kernel)}) != 1:
        raise ValueError("all fiber_conv inputs must be on one device")


def _check_cuda(name, *tensors):
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}'s CUDA kernels need contiguous inputs")


def fiber_conv(basis, w, x, src, fiber_kernel, save_x_sp: bool = False):
    """``[B', P, TA, C]`` float32 fused fiber conv; see the module docstring.
    With ``save_x_sp``, (y, the float32 spatial conv ``x_sp [B', O, TA,
    C]``).

    basis ``[B', O, E, D]``, w ``[D, C]``, x ``[B', O, TA, C]``, fiber_kernel
    ``[O, P, C]``, all float32 or all bfloat16; src ``[B', E]`` int32."""
    _check(basis, w, x, src, fiber_kernel)
    if basis.device.type == "cpu":
        return fiber_conv_plain(basis, w, x, src, fiber_kernel, save_x_sp)
    _check_cuda("fiber_conv", basis, w, x, src, fiber_kernel)
    from arreau_tpu_torch.kernels.build import check, kernel_function

    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    P = fiber_kernel.shape[1]
    if O > _MAX_P or P > _MAX_P or Bp * O > 65535:
        raise ValueError(f"fiber_conv's kernels take O, P <= {_MAX_P} and B'*O <= 65535, not "
                         f"O = {O}, P = {P}, B'*O = {Bp * O}")
    y = torch.empty((Bp, P, TA, C), dtype=torch.float32, device=basis.device)
    # the spatial conv: the backward's residual, or scratch
    x_sp = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    fn = kernel_function("arreau_fiber_conv_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(basis.device).cuda_stream
    err = fn(basis.data_ptr(), w.data_ptr(), x.data_ptr(), src.data_ptr(),
             fiber_kernel.data_ptr(), y.data_ptr(), x_sp.data_ptr(),
             Bp, O, P, E // TA, TA, D, C, int(basis.dtype == torch.bfloat16), stream)
    check("arreau_fiber_conv_fwd", err)
    fiber_conv.launches += 1
    return (y, x_sp) if save_x_sp else y


fiber_conv.launches = 0


@torch.library.custom_op(
    "arreau_tpu_torch::fiber_conv", mutates_args=(),
    schema="(Tensor basis, Tensor w, Tensor x, Tensor src, Tensor fiber_kernel, bool save_x_sp)"
           " -> (Tensor, Tensor)")
def fiber_conv_op(basis, w, x, src, fiber_kernel, save_x_sp):
    """:func:`fiber_conv` as the operator ``torch.ops.arreau_tpu_torch.fiber_conv``,
    which ``torch.export`` keeps as one node (a fake tensor has no
    ``data_ptr``): (y, x_sp) with ``save_x_sp``, else (y, an empty tensor);
    the wrapper is looked up in this module when the operator runs. Its
    outputs are contiguous, as the kernel's are (see
    :func:`~arreau_tpu_torch.kernels.spatial_conv.spatial_conv_op`)."""
    out = fiber_conv(basis, w, x, src, fiber_kernel, save_x_sp)
    y, x_sp = out if save_x_sp else (out, out.new_empty(0))
    return y.contiguous(), x_sp.contiguous()


@fiber_conv_op.register_fake
def _(basis, w, x, src, fiber_kernel, save_x_sp):
    Bp, _, TA, C = x.shape
    y = x.new_empty((Bp, fiber_kernel.shape[1], TA, C), dtype=torch.float32)
    return y, x.new_empty(x.shape if save_x_sp else (0,), dtype=torch.float32)


def fiber_conv_bwd(basis, w, x, src, fiber_kernel, g, x_sp):
    """(dbasis ``[B', O, E, D]``, dw ``[D, C]``, dx ``[B', O, TA, C]``,
    dfiber_kernel ``[O, P, C]``): the cotangents of :func:`fiber_conv`'s
    inputs for the output cotangent ``g [B', P, TA, C]`` (float32), given
    the spatial conv ``x_sp [B', O, TA, C]`` (float32) the forward saved;
    dbasis and dx in the basis's type, dw and dfiber_kernel in their
    weights' type."""
    _check(basis, w, x, src, fiber_kernel)
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    P = fiber_kernel.shape[1]
    for name, t, shape in (("g", g, (Bp, P, TA, C)), ("x_sp", x_sp, (Bp, O, TA, C))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be float32 {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if basis.device.type == "cpu":
        return fiber_conv_bwd_plain(basis, w, x, src, fiber_kernel, g, x_sp)
    _check_cuda("fiber_conv_bwd", basis, w, x, src, fiber_kernel, g, x_sp)
    from arreau_tpu_torch.kernels.build import check, kernel_function, row_splits

    if Bp * O > 65535 or P > _MAX_P:
        raise ValueError(f"fiber_conv_bwd's kernels take B'*O <= 65535 and P <= {_MAX_P}")
    dev = basis.device
    splits, per_split = row_splits(Bp * O * E)
    ones = _unit_window(src)
    order, offsets = sender_order(src, TA)
    g_o = torch.empty_like(x_sp)
    dfk_partial = torch.empty((Bp, O, P, C), dtype=torch.float32, device=dev)
    dw_partial = torch.empty((splits, D, C), dtype=torch.float32, device=dev)
    gxw = edge_cotangent_scratch(basis, C)
    dbasis = torch.empty_like(basis)
    dw = torch.empty(w.shape, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dfk = torch.empty(fiber_kernel.shape, dtype=torch.float32, device=dev)
    fn = kernel_function("arreau_fiber_conv_bwd", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(basis.data_ptr(), w.data_ptr(), x.data_ptr(), src.data_ptr(), order.data_ptr(),
             offsets.data_ptr(), fiber_kernel.data_ptr(), g.data_ptr(), x_sp.data_ptr(),
             ones.data_ptr(), g_o.data_ptr(), dfk_partial.data_ptr(), dw_partial.data_ptr(),
             gxw.data_ptr(), dbasis.data_ptr(), dw.data_ptr(), dx.data_ptr(), dfk.data_ptr(), Bp, O,
             P, E // TA, TA, D, C, splits, per_split, int(basis.dtype == torch.bfloat16), stream)
    check("arreau_fiber_conv_bwd", err)
    fiber_conv_bwd.launches += 1
    return dbasis, dw.to(w.dtype), dx, dfk.to(fiber_kernel.dtype)


fiber_conv_bwd.launches = 0


class _FiberConv(torch.autograd.Function):
    """``fused_fiber_conv``'s custom VJP: :func:`fiber_conv` forward (#1)
    through its operator, :func:`fiber_conv_bwd` backward (#2); ``src`` gets
    no cotangent. With ``save`` the forward keeps the spatial conv for the
    backward."""

    @staticmethod
    def forward(ctx, basis, w, x, src, fiber_kernel, save):
        y, x_sp = torch.ops.arreau_tpu_torch.fiber_conv(basis, w, x, src, fiber_kernel, save)
        if save:
            ctx.save_for_backward(basis, w, x, src, fiber_kernel, x_sp)
        return y

    @staticmethod
    def backward(ctx, g):
        basis, w, x, src, fiber_kernel, x_sp = ctx.saved_tensors
        dbasis, dw, dx, dfk = fiber_conv_bwd(basis, w, x, src, fiber_kernel, g.contiguous(), x_sp)
        return dbasis, dw, dx, None, dfk, None


def fused_fiber_conv(basis, w, x, src, fiber_kernel):
    """Differentiable :func:`fiber_conv` (cotangents for basis, w, x and the
    fiber kernel); the residual is kept only where a gradient can flow."""
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (basis, w, x, fiber_kernel))
    return _FiberConv.apply(basis, w, x, src, fiber_kernel, save)
