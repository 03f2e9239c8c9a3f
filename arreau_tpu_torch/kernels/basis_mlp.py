"""The edge-basis MLP that every conv layer consumes, as one differentiable
function with one output per consuming layer.

Counterpart of ``arreau_tpu/ops/pallas_basis.py:_basis_mlp_multi_p`` (a
``jax.custom_vjp``): the forward

    basis = gelu(gelu(poly(attrT) @ w1 + b1) @ w2 + b2)

runs its first layer in the ``basis_h1`` kernel (TPU kernel ``_h1_fwd``),
through its operator, and its second Dense as a plain matmul (the JAX
package leaves that one to XLA); the backward is hand-written CUDA,
``csrc/basis_mlp_bwd_sm90.cu``, which replaces ``_multi_bwd_kernel``.

:func:`basis_mlp_multi` returns ``n_out`` aliases of the basis, one per conv
layer, so the backward receives the layers' cotangents apart and the kernel
sums them as it reads them. With one output, autograd would first add the
``n_out`` cotangents into one buffer: ``n_out - 1`` extra read-read-write
passes over a ``[B', O, E, D]`` tensor (537 MB at the training shape). The
cost is memory: the ``n_out`` cotangents are alive together until the
kernel runs.

On the H100 the backward runs on Hopper's ``wgmma`` and TMA in both types,
sized by ``basis_h1.sm90_plan``, the weights' K-major copies made once for
each state of the weights (``basis_h1.weight_copy``). In bfloat16 one kernel
takes each 128-row tile through h1, dpre2 (the cotangents read once) and
dpre1 in registers and shared memory, and two split-K products reduce the
weight gradients over the rows (``csrc/basis_sm90.cuh``); the cotangent
reads bound it. In float32 (3xTF32 on tf32 ``wgmma``,
``csrc/basis_f32_sm90.cuh``) the chain runs as five passes through
device-memory scratch (h1_pre, dpre2, dpre1), each a product with its
elementwise work in the epilogue, the weight gradients split-K over the
rows; the 2*rows*(2*F*H + 3*H*D) operations bound it. It returns (dw1, db1,
dw2, db2) and no cotangent for the invariants: they derive from positions
and the lattice, which training does not differentiate (the JAX package
zeroes it). Both take H and D up to 256 and raise above.

The invariants, weights, biases and cotangents are float32, or all
bfloat16 on the ``compute_dtype="bfloat16"`` path, where the backward
rounds at the JAX kernel's points (``pallas_basis.py:289-331``): the
recomputed ``h1_pre``/``h2_pre``, the GELU values and derivatives, ``dpre2``
and ``dpre1`` are rounded to bfloat16, the cotangents are summed in
float32, and the weight and bias gradients are float32 sums (autograd
rounds them to the bfloat16 weights' type, as the JAX VJP's ``.astype``).

:func:`basis_mlp_bwd` launches its kernel for CUDA tensors and runs
:func:`basis_mlp_bwd_plain` for CPU tensors; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from arreau_tpu_torch.kernels.basis_h1 import poly_features_t

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = ((_P,) * 3 + (ctypes.POINTER(ctypes.c_void_p), _I) + (_P,) * 7 + (_I,) * 7
             + (_P, _I, _P))
_MAX_G = 16  # cotangents one launch sums (csrc/basis_sm90.cuh: SM90_MAX_G)
_GELU_C0 = 0.7978845608028654  # sqrt(2 / pi)
_GELU_C1 = 0.044715


def gelu_and_deriv(x):
    """Tanh-approximation GELU and its derivative from one tanh (the JAX
    package's ``_gelu_fwd_and_deriv``)."""
    t = torch.tanh(_GELU_C0 * (x + _GELU_C1 * x * x * x))
    value = 0.5 * x * (1.0 + t)
    deriv = 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * _GELU_C0 * (1.0 + 3.0 * _GELU_C1 * x * x)
    return value, deriv


def basis_mlp_bwd_plain(attrT, w1, b1, w2, b2, degree: int, gs):
    """Plain PyTorch version of the backward: (dw1, db1, dw2, db2), float32,
    for the cotangents ``gs`` (a sequence of ``[B', O, E, D]``) of the
    basis; float32 arithmetic, rounded to the inputs' type where the JAX
    kernel rounds."""
    dt, wt = attrT.dtype, torch.promote_types(attrT.dtype, torch.float32)

    def rnd(v):
        return v.to(dt).to(wt)

    D = w2.shape[1]
    w1, b1, w2, b2 = w1.to(wt), b1.to(wt), w2.to(wt), b2.to(wt)
    poly = poly_features_t(attrT, degree).reshape(-1, w1.shape[0])
    h1, dg1 = (rnd(v) for v in gelu_and_deriv(rnd(torch.addmm(b1, poly, w1))))
    dg2 = rnd(gelu_and_deriv(rnd(torch.addmm(b2, h1, w2)))[1])
    g = gs[0].to(wt)
    for gi in gs[1:]:
        g = g + gi.to(wt)
    dpre2 = rnd(g.reshape(-1, D) * dg2)
    dpre1 = rnd(torch.matmul(dpre2, w2.t()) * dg1)
    return poly.t() @ dpre1, dpre1.sum(dim=0), h1.t() @ dpre2, dpre2.sum(dim=0)


def _check(attrT, w1, b1, w2, b2, gs):
    Bp, O, _, E = attrT.shape
    H, D = w2.shape
    if w1.shape[1] != H or tuple(b2.shape) != (D,):
        raise ValueError(f"shape mismatch: w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}, "
                         f"b2 {tuple(b2.shape)}")
    if not gs:
        raise ValueError("basis_mlp_bwd needs at least one cotangent")
    for g in gs:
        if tuple(g.shape) != (Bp, O, E, D) or g.dtype != attrT.dtype or g.device != attrT.device:
            raise ValueError(f"each cotangent must be {attrT.dtype} {(Bp, O, E, D)} on "
                             f"{attrT.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    for name, t in (("w2", w2), ("b2", b2)):
        if t.dtype != attrT.dtype or t.device != attrT.device:
            raise TypeError(f"{name} must be {attrT.dtype} on {attrT.device}")


def basis_mlp_bwd(attrT, w1, b1, w2, b2, degree: int, gs):
    """(dw1 ``[F, H]``, db1 ``[H]``, dw2 ``[H, D]``, db2 ``[D]``) for the sum
    of the basis cotangents ``gs``; see the module docstring."""
    from arreau_tpu_torch.kernels.basis_h1 import _check as check_h1

    check_h1(attrT, w1, b1, degree)
    _check(attrT, w1, b1, w2, b2, gs)
    if attrT.device.type == "cpu":
        return basis_mlp_bwd_plain(attrT, w1, b1, w2, b2, degree, gs)
    if attrT.device.type != "cuda":
        raise ValueError(f"basis_mlp_bwd runs on cuda or cpu, not {attrT.device}")
    if not all(t.is_contiguous() for t in (attrT, w1, b1, w2, b2, *gs)):
        raise ValueError("basis_mlp_bwd's CUDA kernels need contiguous inputs")
    if len(gs) > _MAX_G:
        raise ValueError(f"basis_mlp_bwd sums at most {_MAX_G} cotangents, got {len(gs)}")
    from arreau_tpu_torch.kernels.basis_h1 import _MAX_D, kernel_plan, sm90_plan, weight_copy
    from arreau_tpu_torch.kernels.build import check, kernel_function

    Bp, O, d, E = attrT.shape
    F_, H = w1.shape
    D = w2.shape[1]
    if d > _MAX_D:
        raise ValueError(f"basis_mlp_bwd's kernels take d <= {_MAX_D}, got {d}")
    rows = Bp * O * E
    shape = (rows, F_, H, D, attrT.dtype)
    p = sm90_plan(*shape)
    # the weights' K-major copies W1^T, W2^T and W2 (referenced until queued)
    copies = (weight_copy(w1, True, p["nh"], p["kw1"]), weight_copy(w2, True, p["nd"], p["kw2"]),
              weight_copy(w2, False, p["nh"], p["kw3"]))
    maps = ctypes.create_string_buffer(b"".join(m.raw for _, m in copies), 3 * 128)
    dev = attrT.device
    if attrT.dtype == torch.bfloat16:  # transposed scratch: h1 with db2's row of ones, dpre2, dpre1
        scratch = [torch.empty((n, p["ld"]), dtype=attrT.dtype, device=dev) for n in (H + 1, D, H)]
    else:  # h1_pre, dpre2, dpre1 row-major
        scratch = [torch.empty((rows, n), dtype=attrT.dtype, device=dev)
                   for n in (p["hp"], p["dp"], p["hp"])]
    partial = torch.empty(p["splits"] * max((F_ + 1) * H, (H + 1) * D), dtype=torch.float32,
                          device=dev)
    dw1_ext = torch.empty((F_ + 1, H), dtype=torch.float32, device=dev)
    dw2_ext = torch.empty((H + 1, D), dtype=torch.float32, device=dev)
    pointers = (ctypes.c_void_p * len(gs))(*[g.data_ptr() for g in gs])
    name = "arreau_basis_mlp_bwd_sm90"
    err = kernel_function(name, _ARGTYPES)(
        attrT.data_ptr(), b1.data_ptr(), b2.data_ptr(), pointers, len(gs), maps,
        *(t.data_ptr() for t in scratch), partial.data_ptr(), dw1_ext.data_ptr(),
        dw2_ext.data_ptr(), Bp, O, d, E, F_, H, D, ctypes.byref(kernel_plan(*shape)),
        int(attrT.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    check(name, err)
    basis_mlp_bwd.launches += 1
    return dw1_ext[:F_], dw1_ext[F_], dw2_ext[:H], dw2_ext[H]


basis_mlp_bwd.launches = 0


class _BasisMLPMulti(torch.autograd.Function):
    """``_basis_mlp_multi_p``'s custom VJP; only the weights and biases get
    cotangents."""

    @staticmethod
    def forward(ctx, attrT, w1, b1, w2, b2, degree, n_out):
        h1 = F.gelu(torch.ops.arreau_tpu_torch.basis_h1(attrT, w1, b1, degree),
                    approximate="tanh")
        basis = F.gelu(torch.matmul(h1, w2) + b2, approximate="tanh")
        ctx.save_for_backward(attrT, w1, b1, w2, b2)
        ctx.degree = degree
        ctx.set_materialize_grads(False)  # a layer that gets no cotangent passes None
        return tuple(basis.view_as(basis) for _ in range(n_out))

    @staticmethod
    def backward(ctx, *gs):
        gs = [g.contiguous() for g in gs if g is not None]
        if not gs:
            return (None,) * 7
        attrT = ctx.saved_tensors[0]
        grads = basis_mlp_bwd(*ctx.saved_tensors, ctx.degree, gs)
        # in the weights' type, as the JAX VJP's .astype(w.dtype)
        return (None, *(g.to(attrT.dtype) for g in grads), None, None)


def basis_mlp_multi(attrT, w1, b1, w2, b2, degree: int, n_out: int):
    """``n_out`` aliases of the ``[B', O, E, D]`` basis from lane-major
    invariants ``attrT [B', O, d, E]``; w1 ``[F, H]``, b1 ``[H]``, w2 ``[H,
    D]``, b2 ``[D]`` (pass zeros for an absent bias)."""
    return _BasisMLPMulti.apply(attrT, w1, b1, w2, b2, degree, n_out)
