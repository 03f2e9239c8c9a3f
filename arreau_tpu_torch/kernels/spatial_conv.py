"""Spatial fiber-bundle convolution over super-crystal tiles, forward and
backward.

Replaces the TPU kernels ``arreau_tpu/ops/pallas_conv.py:_fwd_spatial_kernel``
and ``_bwd_spatial_kernel`` (public entry ``fused_spatial_conv``, a
``jax.custom_vjp``) with the hand-written CUDA kernels
``csrc/spatial_conv.cu`` and ``csrc/spatial_conv_bwd.cu``, joined by the
``torch.autograd.Function`` :func:`fused_spatial_conv`. The forward is

    out[b',o,t,c] = sum_k win[b',e] * (basis[b',o,e,:] @ w)[c] * x[b',o,src[b',e],c]

with ``e = k*TA + t``. The JAX package gathers senders through a one-hot
matrix ``sel [B', E, TA]`` (an MXU trick); here the layout code hands over
``src [B', E]`` int32, the tile-local sender; a value outside ``[0, TA)``
(-1 by convention) marks an empty slot.

On the H100 the function is bound by arithmetic (2*B'*O*E*D*C operations
against one read of the basis); the kernel keeps the per-edge ``[E, C]``
kernel in registers and reduces over k there (see the source). The
backward (:func:`spatial_conv_bwd`) returns the cotangents of the basis, of
``w`` and of ``x``; the window's is not computed (it is a function of
positions, which training does not differentiate: the JAX package's
``window_grad = position_grads = False``), so ``win`` gets none.

basis, w and x are float32, or all bfloat16 on the ``compute_dtype=
"bfloat16"`` path; the window stays float32. In bfloat16 the functions
follow the JAX kernels' cast points: products and sums in float32, the
output (``out_dtype``) and the backward's dbasis and dx stored in
bfloat16, the backward's ``gxw`` and ``kern * win * g`` rounded to
bfloat16 before their products, and dW summed in float32 and returned in
``w``'s type (as the JAX VJP's ``.astype(w.dtype)``).

:func:`spatial_conv` and :func:`spatial_conv_bwd` launch their kernels for
CUDA tensors and run :func:`spatial_conv_plain` / :func:`spatial_conv_bwd_plain`
for CPU tensors; they never fall back.
"""

from __future__ import annotations

import ctypes

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
_BWD_ARGTYPES = (_P,) * 10 + (_I,) * 9 + (_P,)
DTYPES = (torch.float32, torch.bfloat16)  # the element types the kernels take


def spatial_conv_plain(basis, w, x, src, win):
    """Plain PyTorch version: the per-edge kernel as one matmul, a gather of
    the senders and a sum over the K neighbour slots, in float32 (bfloat16
    operands are exact in it; float64 stays float64), stored in the basis's
    type."""
    dt, wt = basis.dtype, torch.promote_types(basis.dtype, torch.float32)
    basis, w, x = basis.to(wt), w.to(wt), x.to(wt)
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    kern = torch.matmul(basis, w) * win[:, None, :, None]  # [B', O, E, C]
    live = (src >= 0) & (src < TA)
    idx = torch.where(live, src, 0).long()[:, None, :, None].expand(Bp, O, E, C)
    xj = torch.gather(x, 2, idx)
    msg = torch.where(live[:, None, :, None], kern * xj, 0.0)
    return msg.reshape(Bp, O, E // TA, TA, C).sum(dim=2).to(dt)


def spatial_conv_bwd_plain(basis, w, x, src, win, g):
    """Plain PyTorch version of the backward: (dbasis, dw, dx) for the
    cotangent ``g [B', O, TA, C]`` of :func:`spatial_conv_plain`'s output;
    float32 arithmetic, rounded to the basis's type where the JAX kernel
    rounds."""
    dt, wt = basis.dtype, torch.promote_types(basis.dtype, torch.float32)

    def rnd(v):
        return v.to(dt).to(wt)

    basis, w, x, g = basis.to(wt), w.to(wt), x.to(wt), g.to(wt)
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    live = (src >= 0) & (src < TA)
    idx = torch.where(live, src, 0).long()[:, None, :, None].expand(Bp, O, E, C)
    live = live[:, None, :, None]
    g_e = g.repeat(1, 1, E // TA, 1)  # row e = k*TA + t holds g[t]
    win_e = win[:, None, :, None]
    gxw = rnd(torch.where(live, g_e * torch.gather(x, 2, idx), 0.0) * win_e)
    dbasis = torch.matmul(gxw, w.t())
    dw = torch.einsum("boed,boec->dc", basis, gxw)
    dxc = rnd(torch.where(live, torch.matmul(basis, w) * win_e * g_e, 0.0))
    dx = torch.zeros_like(x).scatter_add_(2, idx, dxc)
    return dbasis.to(dt), dw.to(dt), dx.to(dt)


def _check(basis, w, x, src, win):
    if basis.dim() != 4 or x.dim() != 4 or w.dim() != 2 or src.dim() != 2 or win.dim() != 2:
        raise ValueError("spatial_conv expects basis [B',O,E,D], w [D,C], x [B',O,TA,C], "
                         "src/win [B',E]")
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    if x.shape[:2] != (Bp, O) or E % TA or tuple(w.shape) != (D, C):
        raise ValueError(f"shape mismatch: basis {tuple(basis.shape)}, w {tuple(w.shape)}, "
                         f"x {tuple(x.shape)}")
    if tuple(src.shape) != (Bp, E) or tuple(win.shape) != (Bp, E):
        raise ValueError(f"src {tuple(src.shape)} / win {tuple(win.shape)} must be {(Bp, E)}")
    if basis.dtype not in DTYPES:
        raise TypeError(f"basis must be float32 or bfloat16, got {basis.dtype}")
    for name, t in (("w", w), ("x", x)):
        if t.dtype != basis.dtype:
            raise TypeError(f"{name} must be {basis.dtype} like the basis, got {t.dtype}")
    if win.dtype != torch.float32:
        raise TypeError(f"win must be float32, got {win.dtype}")
    if src.dtype != torch.int32:
        raise TypeError(f"src must be int32, got {src.dtype}")
    if len({t.device for t in (basis, w, x, src, win)}) != 1:
        raise ValueError("all spatial_conv inputs must be on one device")


def spatial_conv(basis, w, x, src, win):
    """``[B', O, TA, C]`` spatial conv in the basis's type; see the module
    docstring.

    basis ``[B', O, E, D]``, w ``[D, C]``, x ``[B', O, TA, C]``, all float32
    or all bfloat16; src ``[B', E]`` int32; win ``[B', E]`` float32."""
    _check(basis, w, x, src, win)
    if basis.device.type == "cpu":
        return spatial_conv_plain(basis, w, x, src, win)
    if basis.device.type != "cuda":
        raise ValueError(f"spatial_conv runs on cuda or cpu, not {basis.device}")
    if not all(t.is_contiguous() for t in (basis, w, x, src, win)):
        raise ValueError("spatial_conv's CUDA kernel needs contiguous inputs")
    from arreau_tpu_torch.kernels.build import check, kernel_function

    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    if Bp * O > 65535:
        raise ValueError(f"B'*O = {Bp * O} exceeds the kernel's grid limit")
    out = torch.empty((Bp, O, TA, C), dtype=basis.dtype, device=basis.device)
    fn = kernel_function("arreau_spatial_conv_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(basis.device).cuda_stream
    err = fn(basis.data_ptr(), w.data_ptr(), x.data_ptr(), src.data_ptr(), win.data_ptr(),
             out.data_ptr(), Bp, O, E // TA, TA, D, C, int(basis.dtype == torch.bfloat16),
             stream)
    check("arreau_spatial_conv_fwd", err)
    spatial_conv.launches += 1
    return out


spatial_conv.launches = 0


def spatial_conv_bwd(basis, w, x, src, win, g):
    """(dbasis ``[B', O, E, D]``, dw ``[D, C]``, dx ``[B', O, TA, C]``): the
    cotangents of :func:`spatial_conv`'s inputs for the output cotangent
    ``g [B', O, TA, C]`` (the basis's type); see the module docstring."""
    _check(basis, w, x, src, win)
    if g.shape != x.shape or g.dtype != basis.dtype or g.device != x.device:
        raise ValueError(f"g must be {basis.dtype} {tuple(x.shape)} on {x.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    if basis.device.type == "cpu":
        return spatial_conv_bwd_plain(basis, w, x, src, win, g)
    if basis.device.type != "cuda":
        raise ValueError(f"spatial_conv_bwd runs on cuda or cpu, not {basis.device}")
    if not all(t.is_contiguous() for t in (basis, w, x, src, win, g)):
        raise ValueError("spatial_conv_bwd's CUDA kernels need contiguous inputs")
    from arreau_tpu_torch.kernels.build import check, kernel_function, row_splits

    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    if Bp * O > 65535:
        raise ValueError(f"B'*O = {Bp * O} exceeds the kernels' grid limit")
    if TA * 64 * 4 > 227 * 1024:
        raise ValueError(f"TA = {TA} receivers exceed the dx kernel's shared memory")
    splits, per_split = row_splits(Bp * O * E)
    dbasis = torch.empty_like(basis)
    dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    dx = torch.empty_like(x)
    partial = torch.empty((splits, D, C), dtype=torch.float32, device=basis.device)
    fn = kernel_function("arreau_spatial_conv_bwd", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(basis.device).cuda_stream
    err = fn(basis.data_ptr(), w.data_ptr(), x.data_ptr(), src.data_ptr(), win.data_ptr(),
             g.data_ptr(), dbasis.data_ptr(), dw.data_ptr(), dx.data_ptr(), partial.data_ptr(),
             Bp, O, E // TA, TA, D, C, splits, per_split, int(basis.dtype == torch.bfloat16),
             stream)
    check("arreau_spatial_conv_bwd", err)
    spatial_conv_bwd.launches += 1
    return dbasis, dw.to(w.dtype), dx


spatial_conv_bwd.launches = 0


class _SpatialConv(torch.autograd.Function):
    """``fused_spatial_conv``'s custom VJP: :func:`spatial_conv` forward,
    :func:`spatial_conv_bwd` backward; ``src`` and ``win`` get no cotangent."""

    @staticmethod
    def forward(ctx, basis, w, x, src, win):
        ctx.save_for_backward(basis, w, x, src, win)
        return spatial_conv(basis, w, x, src, win)

    @staticmethod
    def backward(ctx, g):
        dbasis, dw, dx = spatial_conv_bwd(*ctx.saved_tensors, g.contiguous())
        return dbasis, dw, dx, None, None


def fused_spatial_conv(basis, w, x, src, win):
    """Differentiable :func:`spatial_conv` (cotangents for basis, w and x)."""
    return _SpatialConv.apply(basis, w, x, src, win)
