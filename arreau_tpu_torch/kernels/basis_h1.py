"""First layer of the edge-basis MLP: polynomial features, Dense, bias.

Replaces the TPU kernel ``arreau_tpu/ops/pallas_basis.py:_h1_fwd_kernel``
(reached from ``basis_mlp_multi`` through ``_h1``) with hand-written CUDA
kernels, ``csrc/basis_h1_sm90.cu`` in bfloat16 and ``csrc/basis_h1.cu`` in
float32:

    h1_pre[b',o,e,h] = poly(attrT[b',o,:,e]) @ w1[:, h] + b1[h]

where ``poly`` is the degree-``degree`` tensor-power feature vector of the
d edge invariants (``models/blocks.py:polynomial_features``). GELU and the
second Dense stay outside, as in the JAX package.

On the H100 the bfloat16 kernel runs on Hopper's warpgroup products
(``wgmma``) with W1 fed by TMA, all H columns of 64 rows in one
accumulator (``csrc/basis_sm90.cuh``; its host-side tile plan is
:func:`sm90_plan`), bound by its output write; the float32 kernel is one
``mma.sync`` 3xTF32 tile product (``csrc/basis_h1.cuh``, which #5 shares),
bound by its 2*B'*O*E*F*H operations. Both build the features in shared
memory a K-panel at a time, so the ``[E, F]`` feature tensor never reaches
device memory.

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
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_SM90_ARGTYPES = (_P,) * 5 + (_I,) * 9 + (_P,)
_MAX_D = 8  # invariants per edge the kernel stages (csrc/basis_h1.cu: MAX_D)
DTYPES = (torch.float32, torch.bfloat16)  # the element types the kernel takes


# width classes of the hidden width H and of the basis width D: the N of the
# bfloat16 kernels' wgmma products (csrc/basis_sm90.cuh: NH, ND)
SM90_HIDDEN = (64, 128, 208, 256)
SM90_BASIS = (128, 256)
_PANEL = 64  # bfloat16 elements of K in a 128-byte shared-memory panel row


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _width(n: int, classes: tuple, what: str) -> int:
    for c in classes:
        if n <= c:
            return c
    raise ValueError(f"the bfloat16 basis kernels take {what} <= {classes[-1]}, got {n}")


def sm90_plan(rows: int, F: int, H: int, D: int | None = None,
              rows_per_split: int = 4096, max_splits: int = 256) -> dict:
    """Host-side tile plan of the bfloat16 #8 (``D=None``) and #7 kernels
    (``csrc/basis_sm90.cuh``), from the shapes alone:

    - ``nh`` / ``nd``: the width classes of H / D, the N of their ``wgmma``
      products (all columns of 64 rows in one accumulator, N <= 256; the
      columns beyond H or D multiply the zeros TMA reads outside a weight);
    - ``kw1`` / ``kw2`` / ``kw3``: F / H / D rounded up to a 64-element
      panel, the row lengths of the K-major weight copies ``w1t [H, kw1]``,
      ``w2t [D, kw2]``, ``w2c [H, kw3]`` (rows of 128-byte multiples, which
      TMA can address; W1 and W2 themselves have rows of 2F and 2D bytes);
    - ``tma_store``: #8's output rows (2H bytes) are 16-byte multiples, so
      TMA stores write them (else the threads copy them out);
    - ``ld``: the row length of #7's transposed scratch (rows rounded up to
      a panel, 2 ld bytes a row for TMA);
    - ``splits`` x ``per_split``: the weight gradients' split over the rows,
      about ``rows_per_split`` rows each and at most ``max_splits``,
      ``per_split`` a multiple of the 64-row panel so that no panel reaches
      into the next split."""
    if rows < 1 or F < 1 or H < 1:
        raise ValueError(f"empty basis MLP: rows={rows}, F={F}, H={H}")
    plan = {"nh": _width(H, SM90_HIDDEN, "H"), "kw1": _cdiv(F, _PANEL) * _PANEL,
            "tma_store": 2 * H % 16 == 0}
    if D is not None:
        splits = max(1, min(max_splits, _cdiv(rows, rows_per_split)))
        per = _cdiv(_cdiv(rows, splits), _PANEL) * _PANEL
        plan.update(nd=_width(D, SM90_BASIS, "D"), kw2=_cdiv(H, _PANEL) * _PANEL,
                    kw3=_cdiv(D, _PANEL) * _PANEL, ld=_cdiv(rows, _PANEL) * _PANEL,
                    splits=_cdiv(rows, per), per_split=per)
    return plan


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
    stream = torch.cuda.current_stream(attrT.device).cuda_stream
    if attrT.dtype == torch.bfloat16:
        plan = sm90_plan(Bp * O * E, F, H)
        w1t = torch.empty((H, plan["kw1"]), dtype=attrT.dtype, device=attrT.device)
        name = "arreau_basis_h1_sm90"
        err = kernel_function(name, _SM90_ARGTYPES)(
            attrT.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(), w1t.data_ptr(),
            Bp, O, d, E, F, H, plan["nh"], plan["kw1"], int(plan["tma_store"]), stream)
    else:
        name = "arreau_basis_h1_fwd"
        err = kernel_function(name, _ARGTYPES)(
            attrT.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(), Bp, O, d, E, F, H,
            stream)
    check(name, err)
    basis_h1.launches += 1
    return out


basis_h1.launches = 0


@torch.library.custom_op("arreau_tpu_torch::basis_h1", mutates_args=(),
                         schema="(Tensor attrT, Tensor w1, Tensor b1, int degree) -> Tensor")
def basis_h1_op(attrT, w1, b1, degree):
    """:func:`basis_h1` as the operator ``torch.ops.arreau_tpu_torch.basis_h1``,
    which ``torch.export`` keeps as one node (a fake tensor has no
    ``data_ptr``); the wrapper is looked up in this module when the operator
    runs. Its outputs are contiguous, as the kernel's are (see
    :func:`~arreau_tpu_torch.kernels.spatial_conv.spatial_conv_op`)."""
    return basis_h1(attrT, w1, b1, degree).contiguous()


@basis_h1_op.register_fake
def _(attrT, w1, b1, degree):
    Bp, O, _, E = attrT.shape
    return attrT.new_empty((Bp, O, E, w1.shape[1]))
