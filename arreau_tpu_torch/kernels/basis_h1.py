"""First layer of the edge-basis MLP: polynomial features, Dense, bias.

Replaces the TPU kernel ``arreau_tpu/ops/pallas_basis.py:_h1_fwd_kernel``
(reached from ``basis_mlp_multi`` through ``_h1``) with the hand-written CUDA
kernels of ``csrc/basis_h1_sm90.cu``:

    h1_pre[b',o,e,h] = poly(attrT[b',o,:,e]) @ w1[:, h] + b1[h]

where ``poly`` is the degree-``degree`` tensor-power feature vector of the
d edge invariants (``models/blocks.py:polynomial_features``). GELU and the
second Dense stay outside, as in the JAX package.

On the H100 both types run on Hopper's warpgroup products (``wgmma``) with
W1 fed by TMA from a K-major copy made once for each state of W1
(:func:`weight_copy`), all H columns of 64 rows in one accumulator, sized by
the host-side plan :func:`sm90_plan`: bfloat16 (``csrc/basis_sm90.cuh``) is
bound by its output write; float32 runs as 3xTF32 on tf32 ``wgmma``, W1
streamed through a ring and split into its tf32 halves in shared memory
(``csrc/basis_f32_sm90.cuh``), bound by its 2*B'*O*E*F*H operations. Both build the features in shared memory a
K-panel at a time, so the ``[E, F]`` feature tensor never reaches device
memory. Both take H up to 256 and raise above.

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

import collections
import ctypes
import functools

import torch

from arreau_tpu_torch.kernels.spatial_conv import held_for_state

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 6 + (_I,) * 6 + (_P, _I, _P)
_COPY_ARGTYPES = (_P,) * 3 + (_I,) * 6 + (_P,)
_MAX_D = 8  # invariants per edge the kernels stage (csrc/poly_features.cuh: MAX_D)
DTYPES = (torch.float32, torch.bfloat16)  # the element types the kernel takes


# width classes of the hidden width H and of the basis width D: the N of the
# kernels' wgmma products (csrc/basis_sm90.cuh, csrc/basis_f32_sm90.cuh: NH, ND)
SM90_HIDDEN = (64, 128, 208, 256)
SM90_BASIS = (128, 256)
_ROWS = 64  # rows of a warpgroup's tile (wgmma's M), and of a split's panel
_PANEL = _ROWS * 128  # bytes of a 64-row panel, 128 bytes of K a row
_MAX_STAGES = 8  # csrc/conv_sm90.cuh: MAX_STAGES
# dynamic shared memory a float32 kernel may ask for, its 1024 bytes of
# alignment included: sm_90's 227 KB less 8 KB for the static barriers,
# invariants and feature terms
SMEM_BUDGET = 232448 - 8192
# the weight gradients' split over the rows: about _ROWS_PER_SPLIT rows a
# split, or more splits where that leaves fewer than _MIN_DW_BLOCKS blocks
# (about two waves of the H100's 132 SMs), at most _MAX_SPLITS
_ROWS_PER_SPLIT = 4096
_MIN_DW_BLOCKS = 256
_MAX_SPLITS = 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _width(n: int, classes: tuple, what: str) -> int:
    for c in classes:
        if n <= c:
            return c
    raise ValueError(f"the basis kernels take {what} <= {classes[-1]}, got {n}")


def _round_up(n: int, m: int) -> int:
    return _cdiv(n, m) * m


@functools.lru_cache(maxsize=None)
def sm90_plan(rows: int, F: int, H: int, D: int | None = None, dtype=torch.bfloat16) -> dict:
    """Host-side plan of #8 (``D=None``) and #7 (``csrc/basis_sm90.cuh`` in
    bfloat16, ``csrc/basis_f32_sm90.cuh`` in float32), from the shapes and
    the element type alone; the kernels take it as it is (:func:`kernel_plan`)
    and check it:

    - ``nh`` / ``nd``: the width classes of H / D, the N of their ``wgmma``
      products (all columns of 64 rows in one accumulator, N <= 256; the
      columns beyond H or D multiply the zeros of the weights' padding);
    - ``kw1`` / ``kw2`` / ``kw3``: F / H / D rounded up to a K-panel (64
      bfloat16 or 32 float32 elements, 128 bytes), the row lengths of the
      K-major weight copies W1^T, W2^T and W2; ``w1t`` / ``w2t`` / ``w2c``
      their elements (float32: ``nh`` or ``nd`` zero-padded rows, which the
      kernels split into tf32 halves; bfloat16: H or D rows);
    - ``tma_store``: bfloat16 #8's output rows (2H bytes) are 16-byte
      multiples, so TMA stores write them (else the threads copy them out);
    - ``ld``: the row length of bfloat16 #7's transposed scratch (rows
      rounded up to a 64-row panel); ``hp`` / ``dp``: H / D rounded up to 4,
      the rows of float32 #7's scratch (16-byte multiples, which TMA reads);
    - float32: the ring slots (or stage buffers) and dynamic shared memory of
      the kernels whose product is ``nh`` wide (``h_stages`` / ``h_smem``:
      #8 and #7's first pass, dpre1, dW1) and ``nd`` wide (``d_stages`` /
      ``d_smem``: dpre2, dW2), a slot holding A's 128 rows and B's N rows,
      each as tf32 halves;
    - ``splits`` x ``per_split``: the weight gradients' split over the rows,
      about ``_ROWS_PER_SPLIT`` rows each, or more splits where that leaves
      fewer than ``_MIN_DW_BLOCKS`` blocks of the smaller of the two (128
      rows of H + 1 or of F + 1 a block), at most ``_MAX_SPLITS``;
      ``per_split`` a multiple of the 64-row panel so that no panel reaches
      into the next split.

    Cached (a wrapper call looks it up); the dict is not to be changed."""
    if rows < 1 or F < 1 or H < 1 or (D is not None and D < 1):
        raise ValueError(f"empty basis MLP: rows={rows}, F={F}, H={H}, D={D}")
    f32 = dtype == torch.float32
    pk = 32 if f32 else 64
    nh = _width(H, SM90_HIDDEN, "H")
    plan = {"nh": nh, "kw1": _round_up(F, pk), "tma_store": 2 * H % 16 == 0}
    plan["w1t"] = (nh if f32 else H) * plan["kw1"]

    def fit(n):  # a ring slot: both warpgroups' A panels and B, each split in halves
        slot = 4 * _PANEL + 2 * n * 128
        stages = min(_MAX_STAGES, (SMEM_BUDGET - 1024) // slot)
        return stages, 1024 + stages * slot

    if f32:
        plan["h_stages"], plan["h_smem"] = fit(nh)
    if D is not None:
        nd = _width(D, SM90_BASIS, "D")
        plan.update(nd=nd, kw2=_round_up(H, pk), kw3=_round_up(D, pk),
                    ld=_round_up(rows, _ROWS))
        blocks = min(_cdiv(H + 1, 2 * _ROWS), _cdiv(F + 1, 2 * _ROWS))
        splits = max(_cdiv(rows, _ROWS_PER_SPLIT), _cdiv(_MIN_DW_BLOCKS, blocks))
        splits = max(1, min(_MAX_SPLITS, splits))
        per = _round_up(_cdiv(rows, splits), _ROWS)
        plan.update(splits=_cdiv(rows, per), per_split=per)
        if f32:
            plan.update(w2t=nd * plan["kw2"], w2c=nh * plan["kw3"], hp=_round_up(H, 4),
                        dp=_round_up(D, 4))
            plan["d_stages"], plan["d_smem"] = fit(nd)
        else:
            plan.update(w2t=D * plan["kw2"], w2c=H * plan["kw3"])
    return plan


class _BasisPlan(ctypes.Structure):
    """``csrc/basis_f32_sm90.cuh``'s ``BasisPlan``: the plan as the kernels take
    it (0 where a kernel of the plan's type or of #8 has no use for it)."""
    _fields_ = [("ld", ctypes.c_longlong)] + [(name, ctypes.c_int) for name in (
        "nh", "nd", "kw1", "kw2", "kw3", "hp", "dp", "tma_store", "splits", "per_split",
        "h_stages", "h_smem", "d_stages", "d_smem")]


@functools.lru_cache(maxsize=None)
def kernel_plan(*shape_and_dtype) -> _BasisPlan:
    """:func:`sm90_plan` as the kernels' ``BasisPlan`` (cached)."""
    plan = sm90_plan(*shape_and_dtype)
    return _BasisPlan(*(int(plan.get(name, 0)) for name, _ in _BasisPlan._fields_))


_copies_held = collections.OrderedDict()


def weight_copy(w, transpose: bool, nb: int, kw: int) -> tuple:
    """(copy, map): the K-major zero-padded copy of the weight ``w [R, C]``
    that the basis kernels read as a ``wgmma`` B operand, ``w`` transposed
    (``copy[n, k] = w[k, n]``) or not, rows of ``kw`` elements (float32:
    ``nb`` rows), and a buffer holding its TMA tensor map (boxes of ``nb``
    rows), made by ``arreau_basis_weight_copy_sm90``. Made once for each
    state of ``w`` (``spatial_conv.held_for_state``), so that #7 reuses #8's
    copy of W1. An inference tensor has no state to key a kept copy on:
    :func:`basis_h1` has its launch copy such a W1 in the same call."""
    from arreau_tpu_torch.kernels.build import check, kernel_function

    def make():
        R, C = w.shape
        rows = nb if w.dtype == torch.float32 else (C if transpose else R)
        copy = torch.empty((rows, kw), dtype=w.dtype, device=w.device)
        tensor_map = ctypes.create_string_buffer(128)
        name = "arreau_basis_weight_copy_sm90"
        check(name, kernel_function(name, _COPY_ARGTYPES)(
            w.data_ptr(), copy.data_ptr(), tensor_map, R, C, int(transpose), nb, kw,
            int(w.dtype == torch.bfloat16), torch.cuda.current_stream(w.device).cuda_stream))
        return copy, tensor_map

    return held_for_state(_copies_held, (id(w), transpose, nb, kw), w, make)


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
    from arreau_tpu_torch.kernels.build import check, kernel_function

    shape = (Bp * O * E, F, H, None, attrT.dtype)
    plan = sm90_plan(*shape)
    if w1.is_inference():  # no copy is kept: the launch makes W1's in its own call
        w1_copy, w1_map = torch.empty(plan["w1t"], dtype=w1.dtype, device=w1.device), None
    else:
        w1_copy, w1_map = weight_copy(w1, True, plan["nh"], plan["kw1"])  # kept until queued
    out = torch.empty((Bp, O, E, H), dtype=attrT.dtype, device=attrT.device)
    name = "arreau_basis_h1_sm90"
    err = kernel_function(name, _ARGTYPES)(
        attrT.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(), w1_map,
        w1_copy.data_ptr(), Bp, O, d, E, F, H, ctypes.byref(kernel_plan(*shape)),
        int(attrT.dtype == torch.bfloat16), torch.cuda.current_stream(attrT.device).cuda_stream)
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
