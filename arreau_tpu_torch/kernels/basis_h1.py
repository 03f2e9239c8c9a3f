"""First layer of the edge-basis MLP: polynomial features, Dense, bias.

Replaces the TPU kernel ``arreau_tpu/ops/pallas_basis.py:_h1_fwd_kernel``
(reached from ``basis_mlp_multi`` through ``_h1``) with the hand-written
CUDA kernel ``csrc/basis_h1.cu``:

    h1_pre[b',o,e,h] = poly(attrT[b',o,:,e]) @ w1[:, h] + b1[h]

where ``poly`` is the degree-``degree`` tensor-power feature vector of the
d edge invariants (``models/blocks.py:polynomial_features``). GELU and the
second Dense stay outside, as in the JAX package.

On the H100 the function is bound by arithmetic (2*B'*O*E*F*H operations
against one write of ``h1_pre``); the kernel builds the features slice by
slice in shared memory, so the ``[E, F]`` feature tensor never reaches
device memory (see the source).

The inputs and ``h1_pre`` are float32, or all bfloat16 on the
``compute_dtype="bfloat16"`` path. In bfloat16 the features are formed in
float32 from the bfloat16 invariants and rounded to bfloat16 before the
product with ``w1``, and ``poly @ w1 + b1`` is summed in float32 and rounded
once (the JAX kernel's ``_poly_block_t`` and ``_h1_fwd_kernel``).

The JAX package engages its kernel only from ``E >= 1024`` rows per cell,
a speed threshold measured on a TPU; the port launches its kernel at every
``E`` on CUDA. :func:`basis_h1` runs :func:`basis_h1_plain` for a CPU
tensor and never falls back for a CUDA one.
"""

from __future__ import annotations

import ctypes

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
_MAX_D = 8  # invariants per edge the kernel stages (csrc/basis_h1.cu: MAX_D)
DTYPES = (torch.float32, torch.bfloat16)  # the element types the kernel takes


def poly_features_t(attrT, degree: int):
    """``[B', O, E, F]`` features of lane-major ``attrT [B', O, d, E]``,
    formed in float32 (float64 stays float64) and rounded once to
    ``attrT``'s type."""
    from arreau_tpu_torch.models.blocks import polynomial_features

    wt = torch.promote_types(attrT.dtype, torch.float32)
    poly = polynomial_features(attrT.to(wt).transpose(-1, -2), degree)
    return poly.to(attrT.dtype).to(wt)


def basis_h1_plain(attrT, w1, b1, degree: int):
    """Plain PyTorch version: materialised features, one float32 matmul,
    bias, rounded to the inputs' type."""
    poly = poly_features_t(attrT, degree)  # [B', O, E, F]
    return (torch.matmul(poly, w1.to(poly.dtype)) + b1.to(poly.dtype)).to(attrT.dtype)


def _check(attrT, w1, b1, degree):
    if attrT.dim() != 4 or w1.dim() != 2 or b1.dim() != 1:
        raise ValueError("basis_h1 expects attrT [B',O,d,E], w1 [F,H], b1 [H]")
    d = attrT.shape[2]
    F, H = w1.shape
    if not 1 <= degree <= 3:
        raise ValueError(f"basis_h1 supports degree 1..3, got {degree}")
    if F != sum(d**i for i in range(1, degree + 1)) or tuple(b1.shape) != (H,):
        raise ValueError(f"shape mismatch: attrT {tuple(attrT.shape)}, w1 {tuple(w1.shape)}, "
                         f"b1 {tuple(b1.shape)}")
    if attrT.dtype not in DTYPES:
        raise TypeError(f"attrT must be float32 or bfloat16, got {attrT.dtype}")
    for name, t in (("w1", w1), ("b1", b1)):
        if t.dtype != attrT.dtype:
            raise TypeError(f"{name} must be {attrT.dtype} like attrT, got {t.dtype}")
    if len({t.device for t in (attrT, w1, b1)}) != 1:
        raise ValueError("all basis_h1 inputs must be on one device")


def basis_h1(attrT, w1, b1, degree: int):
    """``[B', O, E, H]`` pre-activation of the basis MLP's first layer from
    lane-major invariants ``attrT [B', O, d, E]``, in ``attrT``'s type."""
    _check(attrT, w1, b1, degree)
    if attrT.device.type == "cpu":
        return basis_h1_plain(attrT, w1, b1, degree)
    if attrT.device.type != "cuda":
        raise ValueError(f"basis_h1 runs on cuda or cpu, not {attrT.device}")
    if not all(t.is_contiguous() for t in (attrT, w1, b1)):
        raise ValueError("basis_h1's CUDA kernel needs contiguous inputs")
    Bp, O, d, E = attrT.shape
    F, H = w1.shape
    if d > _MAX_D:
        raise ValueError(f"basis_h1's CUDA kernel stages at most {_MAX_D} invariants, got {d}")
    if Bp * O > 65535:
        raise ValueError(f"B'*O = {Bp * O} exceeds the kernel's grid limit")
    from arreau_tpu_torch.kernels.build import check, kernel_function

    out = torch.empty((Bp, O, E, H), dtype=attrT.dtype, device=attrT.device)
    fn = kernel_function("arreau_basis_h1_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(attrT.device).cuda_stream
    err = fn(attrT.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(),
             Bp, O, d, E, F, H, int(attrT.dtype == torch.bfloat16), stream)
    check("arreau_basis_h1_fwd", err)
    basis_h1.launches += 1
    return out


basis_h1.launches = 0
