"""Spatial fiber-bundle convolution over super-crystal tiles, forward and
backward.

Replaces the TPU kernels ``arreau_tpu/ops/pallas_conv.py:_fwd_spatial_kernel``
and ``_bwd_spatial_kernel`` (public entry ``fused_spatial_conv``, a
``jax.custom_vjp``) with the hand-written CUDA kernels
``csrc/spatial_conv_sm90.cu`` and ``csrc/spatial_conv_bwd_sm90.cu``, joined by
the ``torch.autograd.Function`` :func:`fused_spatial_conv`. The forward is

    out[b',o,t,c] = sum_k win[b',e] * (basis[b',o,e,:] @ w)[c] * x[b',o,src[b',e],c]

with ``e = k*TA + t``. The JAX package gathers senders through a one-hot
matrix ``sel [B', E, TA]`` (an MXU trick); here the layout code hands over
``src [B', E]`` int32, the tile-local sender; a value outside ``[0, TA)``
(-1 by convention) marks an empty slot.

On the H100 the per-edge kernel is 2*B'*O*E*D*C operations against one
read of the basis: bytes bound it in bfloat16, operations in float32. Both
directions run on Hopper's warpgroup products (``wgmma``) and the Tensor
Memory Accelerator (``csrc/conv_sm90.cuh``; 3xTF32 on tf32 ``wgmma`` in
float32): a persistent block's two warpgroups share a 64-row tile of one
neighbour slot's basis rows, loaded by TMA through a 3-D map that clips it at
TA, and split the columns in two halves (:func:`conv_sm90_plan`). The forward
(``csrc/spatial_conv_sm90.cu``) folds each slot into the output in registers
in ascending k, so the ``[E, C]`` per-edge kernel never reaches device memory,
and repeats its output bit for bit. The backward (:func:`spatial_conv_bwd`,
``csrc/spatial_conv_bwd_sm90.cu``) returns the cotangents of the basis, of
``w`` and of ``x``, and with ``window_grad`` that of the window,

    dwin[b',e] = sum_o sum_c (basis[b',o,e,:] @ w)[c] * g[b',o,t,c] * x[b',o,src[b',e],c]

(0 on an empty slot), which the model needs only where something
differentiates through positions (the JAX package's ``window_grad =
position_grads``: forces, relaxation); without it ``win`` gets none, the
JAX VJP's symbolic zero. It builds the edge cotangent in shared memory for
``dbasis``, forms the per-edge kernel again for the dx terms (and ``dwin``
in the same epilogue), sums dW over split partials on ``wgmma`` (in float32
both operands transposed as the threads stage them, tf32 ``wgmma`` taking
K-major operands only) and dx over each sender's run; every output,
dx and dwin included, is the same bit for bit on every call. Both take at
most 256 channels C (224 in float32) and basis widths D (one accumulator a
warpgroup half), and raise above. W's K-major copies, the kernels' B
operands, are made once for each state of W (:func:`weight_copies`).

basis, w and x are float32, or all bfloat16 on the ``compute_dtype=
"bfloat16"`` path; the window stays float32. In bfloat16 the functions
follow the JAX kernels' cast points: products and sums in float32, the
output (``out_dtype``) and the backward's dbasis and dx stored in
bfloat16, the backward's ``gxw`` and ``kern * win * g`` rounded to
bfloat16 before their products, and dW summed in float32 and returned in
``w``'s type (as the JAX VJP's ``.astype(w.dtype)``); ``dwin`` is float32,
from the per-edge kernel accumulated in float32 and ``g`` and ``x`` upcast,
nothing rounded before its sum (``pallas_conv.py:369-370``).

:func:`spatial_conv` and :func:`spatial_conv_bwd` launch their kernels for
CUDA tensors and run :func:`spatial_conv_plain` / :func:`spatial_conv_bwd_plain`
for CPU tensors; they never fall back.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 6 + (_I,) * 6 + (_P,) + (_I,) * 2 + (_P,)
_BWD_ARGTYPES = (_P,) * 15 + (_I,) * 6 + (_P,) + (_I,) * 2 + (_P,)
_WEIGHTS_ARGTYPES = (_P,) * 4 + (_I,) * 2 + (_P, _I, _P)
_TILE_ARGTYPES = (_P, _P, _P) + (_I,) * 6 + (_P,)
DTYPES = (torch.float32, torch.bfloat16)  # the element types the kernels take

# width classes (csrc/conv_sm90.cuh): the N of a warpgroup's half of the
# columns of #3's and #4's per-edge products (C, or D for dbasis), and of #4's
# bfloat16 weight gradient (all of C in one accumulator)
SM90_CONV_HALF = (32, 64, 112, 128)
SM90_DW_WIDTH = (64, 128, 208, 256)
_ROWS = 64                 # rows of a tile (wgmma's M)
_PANEL = _ROWS * 128       # bytes of a 64-row panel, 128 bytes of K a row
_MAX_STAGES = 8            # csrc/conv_sm90.cuh: MAX_STAGES
# dynamic shared memory a block may ask for, its 1024 bytes of alignment
# included: sm_90's 227 KB less 1 KB for the static barriers and rows
SMEM_BUDGET = 232448 - 1024
# dW's split over the edge rows: about _ROWS_PER_SPLIT rows a split, or more
# splits where that leaves fewer than _MIN_DW_BLOCKS blocks (about two waves
# of the H100's 132 SMs), at most _MAX_SPLITS
_ROWS_PER_SPLIT = 4096
_MIN_DW_BLOCKS = 256
_MAX_SPLITS = 256
# weight copies that stay cached (the least recent go first)
_HELD_WEIGHTS = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _width(n: int, classes: tuple, name: str) -> int:
    for c in classes:
        if n <= c:
            return c
    raise ValueError(f"spatial_conv's kernels take {name} up to {2 * classes[-1]}")


@functools.lru_cache(maxsize=None)
def conv_sm90_plan(Bp: int, O: int, K: int, TA: int, D: int, C: int, dtype) -> dict:
    """Host-side tile plan of #3's and #4's kernels (``csrc/conv_sm90.cuh``)
    from the shapes and the element type alone; the kernels take it as it
    is (:func:`_kernel_plan`) and only check that their layouts fit it:

    - ``nc`` / ``nd``: the width classes of half of C / half of D, the N of a
      warpgroup's product (#3 and #4's per-edge kernel / #4's dbasis); ``nw``
      that of C, #4's weight gradient;
    - ``kd`` / ``kc``: D / C rounded up to a K-panel (64 bfloat16 or 32
      float32 elements, 128 bytes), the row lengths of W's zero-padded K-major
      copies ``wt [planes * 2 nc, kd]`` (W^T) and ``wk [planes * 2 nd, kc]``
      (W; float32 keeps tf32 big and small halves: two planes), whose
      element counts are ``wt`` and ``wk``; ``cg``: C rounded up to 8, the
      row length of #4's edge scratch;
    - ``tma``: the basis rows (D elements) are 16-byte multiples, so TMA
      reads them (else the threads stage them);
    - ``stages`` / ``smem``: the ring slots and shared memory of the
      slot-tile products (#3, #4's per-edge kernel): bfloat16 keeps W^T
      resident beside a ring of 64-row basis panels, float32 streams both
      operands' halves; ``dbasis_stages`` / ``dbasis_smem``: #4's dbasis,
      the same product on panels of the edge scratch (gxw) with W for B;
      ``dw_stages`` / ``dw_smem``: #4's dW;
    - ``splits`` x ``per_split``: dW's split over the edge rows, about
      ``_ROWS_PER_SPLIT`` rows each, or more splits where that leaves fewer
      than ``_MIN_DW_BLOCKS`` blocks (a block is 128 rows of D), at most
      ``_MAX_SPLITS``; ``per_split`` a multiple of the 64-row panel so that
      no panel reaches into the next split.

    Cached (a wrapper call looks it up); the dict is not to be changed."""
    if min(Bp, O, K, TA, D, C) < 1:
        raise ValueError(f"empty spatial conv: B'={Bp}, O={O}, K={K}, TA={TA}, D={D}, C={C}")
    size = dtype.itemsize
    f32 = size == 4
    pk, planes = 128 // size, 2 if f32 else 1
    nc = _width(_cdiv(C, 2), SM90_CONV_HALF, "C")
    nd = _width(_cdiv(D, 2), SM90_CONV_HALF, "D")
    nw = _width(C, SM90_DW_WIDTH, "C")
    kd, kc = _cdiv(D, pk) * pk, _cdiv(C, pk) * pk

    def fit(fixed, slot):
        stages = min(_MAX_STAGES, (SMEM_BUDGET - fixed) // slot)
        return stages, fixed + stages * slot

    def staging(nb):  # both warpgroups' staging tiles: 64 rows of nb + 16 bytes
        return 2 * _ROWS * (nb * size + 16)

    # the slot-tile products: bfloat16's resident W^T, the ring, and staging
    # tiles as wide as a warpgroup's columns
    slot = 2 * _PANEL + 2 * (2 * nc * 128) if f32 else _PANEL
    stages, smem = fit(1024 + (0 if f32 else kd // pk * 2 * nc * 128) + staging(nc), slot)
    # dbasis: the same product on 64-row panels of the edge scratch, B = W,
    # its output staged 64 columns at a time
    db_slot = 2 * _PANEL + 2 * (2 * nd * 128) if f32 else _PANEL
    db_stages, db_smem = fit(1024 + (0 if f32 else kc // pk * 2 * nd * 128) + staging(64),
                             db_slot)
    if f32:  # two stages of 32-row panels staged transposed: A's 128 d and B's nw c, both halves
        dw_stages, dw_smem = 2, 1024 + 2 * (4 * _PANEL + 2 * nw * 128)
    else:
        dw_stages, dw_smem = fit(1024, (2 + _cdiv(nw, 64)) * _PANEL)
    if stages < 2:  # float32 above C = 224: W's halves and the staging tiles
        raise ValueError(f"spatial_conv's {dtype} kernels take C up to 224 (a ring of two "
                         f"slots and the staging tiles in shared memory), not {C}")
    rows = Bp * O * K * TA
    blocks = _cdiv(D, 128)  # a split's dW blocks
    splits = max(_cdiv(rows, _ROWS_PER_SPLIT), _cdiv(_MIN_DW_BLOCKS, blocks))
    splits = max(1, min(_MAX_SPLITS, splits))
    per = _cdiv(_cdiv(rows, splits), _ROWS) * _ROWS
    return {"nc": nc, "nd": nd, "nw": nw, "kd": kd, "kc": kc, "cg": _cdiv(C, 8) * 8,
            "wt": planes * 2 * nc * kd, "wk": planes * 2 * nd * kc, "tma": D * size % 16 == 0,
            "stages": stages, "smem": smem, "dbasis_stages": db_stages, "dbasis_smem": db_smem,
            "dw_stages": dw_stages, "dw_smem": dw_smem, "splits": _cdiv(rows, per),
            "per_split": per}


class _ConvPlan(ctypes.Structure):
    """``csrc/conv_sm90.cuh``'s ``ConvPlan``: the plan as the kernels take it."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "nc", "nd", "nw", "kd", "kc", "cg", "stages", "smem", "dbasis_stages", "dbasis_smem",
        "dw_stages", "dw_smem", "splits", "per_split")]


@functools.lru_cache(maxsize=None)
def _kernel_plan(*shape_and_dtype) -> _ConvPlan:
    """:func:`conv_sm90_plan` as the kernels' ``ConvPlan`` (cached)."""
    plan = conv_sm90_plan(*shape_and_dtype)
    return _ConvPlan(*(plan[name] for name, _ in _ConvPlan._fields_))


def held_for_state(held: collections.OrderedDict, key, w, make):
    """``make()``'s value for the current state of the weight ``w`` (its
    storage and version counter: an in-place update or a new storage makes
    it anew), kept in ``held`` under ``key`` for the last ``_HELD_WEIGHTS``
    keys. A tensor made in inference mode has no version counter and gets a
    value of its own on each call, which the caller keeps until its launch is
    queued."""
    state = None if w.is_inference() else (w.data_ptr(), w._version)
    entry = held.get(key)
    if state is not None and entry is not None and entry[0] is w and entry[1] == state:
        held.move_to_end(key)
        return entry[2]
    value = make()
    if state is not None:
        held[key] = (w, state, value)
        held.move_to_end(key)
        while len(held) > _HELD_WEIGHTS:
            held.popitem(last=False)
    return value


_weight_copies_held = collections.OrderedDict()


def weight_copies(w, plan: dict, kernel_plan: _ConvPlan) -> tuple:
    """(wt, wk, maps): W's K-major zero-padded copies for the kernels' B
    operands, ``wt`` = W^T and ``wk`` = W (``plan["wt"]`` / ``plan["wk"]``
    elements; float32 as tf32 halves), and a buffer of their two TMA tensor
    maps, made by ``arreau_conv_weights_sm90``. Made once for each state of
    ``w`` (:func:`held_for_state`), so that a layer's backward and every
    sampler step reuse its forward's copies."""
    from arreau_tpu_torch.kernels.build import check, kernel_function

    def make():
        wt = torch.empty(plan["wt"], dtype=w.dtype, device=w.device)
        wk = torch.empty(plan["wk"], dtype=w.dtype, device=w.device)
        maps = ctypes.create_string_buffer(256)
        fn = kernel_function("arreau_conv_weights_sm90", _WEIGHTS_ARGTYPES)
        err = fn(w.data_ptr(), wt.data_ptr(), wk.data_ptr(), maps, w.shape[0], w.shape[1],
                 ctypes.byref(kernel_plan), int(w.dtype == torch.bfloat16),
                 torch.cuda.current_stream(w.device).cuda_stream)
        check("arreau_conv_weights_sm90", err)
        return wt, wk, maps

    return held_for_state(_weight_copies_held, id(w), w, make)


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


def spatial_conv_bwd_plain(basis, w, x, src, win, g, window_grad: bool = False,
                           fiber: bool = False):
    """Plain PyTorch version of the backward: (dbasis, dw, dx), and with
    ``window_grad`` dwin ``[B', E]`` float32 after them, for the cotangent
    ``g [B', O, TA, C]`` of :func:`spatial_conv_plain`'s output; float32
    arithmetic, rounded to the basis's type where the JAX kernel rounds
    (dwin nowhere). With ``fiber`` (the fused fiber conv's backward, whose
    ``g`` is float32), each dx term rounds ``kern * win`` and ``g`` apart
    before their product, as ``pallas_conv.py:158`` does, where #4 rounds the
    product once (:376)."""
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
    kern_e = torch.matmul(basis, w)
    kern = kern_e * win_e
    dxc = rnd(torch.where(live, rnd(kern) * rnd(g_e) if fiber else kern * g_e, 0.0))
    dx = torch.zeros_like(x).scatter_add_(2, idx, dxc)
    if not window_grad:
        return dbasis.to(dt), dw.to(dt), dx.to(dt)
    # sum over c for each (b', o, e), then over o, as the JAX kernel adds
    # one o block after another (pallas_conv.py:369-370)
    gx = torch.where(live, g_e * torch.gather(x, 2, idx), 0.0)
    dwin = (kern_e * gx).sum(dim=-1).sum(dim=1)
    return dbasis.to(dt), dw.to(dt), dx.to(dt), dwin.to(win.dtype)


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
    shape = (Bp, O, E // TA, TA, D, C, basis.dtype)
    plan, kernel_plan = conv_sm90_plan(*shape), _kernel_plan(*shape)
    wt, wk, maps = weight_copies(w, plan, kernel_plan)  # referenced until the launch is queued
    out = torch.empty((Bp, O, TA, C), dtype=basis.dtype, device=basis.device)
    fn = kernel_function("arreau_spatial_conv_fwd_sm90", _ARGTYPES)
    stream = torch.cuda.current_stream(basis.device).cuda_stream
    err = fn(basis.data_ptr(), x.data_ptr(), src.data_ptr(), win.data_ptr(), out.data_ptr(),
             maps, Bp, O, E // TA, TA, D, C, ctypes.byref(kernel_plan),
             int(plan["tma"] and basis.data_ptr() % 16 == 0), int(basis.dtype == torch.bfloat16),
             stream)
    check("arreau_spatial_conv_fwd_sm90", err)
    spatial_conv.launches += 1
    return out


spatial_conv.launches = 0


@torch.library.custom_op(
    "arreau_tpu_torch::spatial_conv", mutates_args=(),
    schema="(Tensor basis, Tensor w, Tensor x, Tensor src, Tensor win) -> Tensor")
def spatial_conv_op(basis, w, x, src, win):
    """:func:`spatial_conv` as the operator
    ``torch.ops.arreau_tpu_torch.spatial_conv``, which ``torch.export``
    keeps as one node (a fake tensor has no ``data_ptr``); the wrapper is
    looked up in this module when the operator runs. Its outputs are
    contiguous, as the kernel's are, so that their fake (``torch.export``'s)
    and real layouts agree on either device."""
    return spatial_conv(basis, w, x, src, win).contiguous()


@spatial_conv_op.register_fake
def _(basis, w, x, src, win):
    return basis.new_empty(x.shape)


def spatial_conv_bwd(basis, w, x, src, win, g, window_grad: bool = False):
    """(dbasis ``[B', O, E, D]``, dw ``[D, C]``, dx ``[B', O, TA, C]``), and
    with ``window_grad`` dwin ``[B', E]`` (float32) after them: the
    cotangents of :func:`spatial_conv`'s inputs for the output cotangent
    ``g [B', O, TA, C]`` (the basis's type); see the module docstring."""
    _check(basis, w, x, src, win)
    if g.shape != x.shape or g.dtype != basis.dtype or g.device != x.device:
        raise ValueError(f"g must be {basis.dtype} {tuple(x.shape)} on {x.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    if basis.device.type == "cpu":
        return spatial_conv_bwd_plain(basis, w, x, src, win, g, window_grad)
    if basis.device.type != "cuda":
        raise ValueError(f"spatial_conv_bwd runs on cuda or cpu, not {basis.device}")
    if not all(t.is_contiguous() for t in (basis, w, x, src, win, g)):
        raise ValueError("spatial_conv_bwd's CUDA kernels need contiguous inputs")
    from arreau_tpu_torch.kernels.build import check, kernel_function

    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    shape = (Bp, O, E // TA, TA, D, C, basis.dtype)
    plan, kernel_plan = conv_sm90_plan(*shape), _kernel_plan(*shape)
    wt, wk, maps = weight_copies(w, plan, kernel_plan)  # referenced until the launch is queued
    order, offsets = sender_order(src, TA)
    dev = basis.device
    dbasis = torch.empty_like(basis)
    dw = torch.empty(w.shape, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    gxw = edge_cotangent_scratch(basis, C)
    partial = torch.empty((plan["splits"], D, C), dtype=torch.float32, device=dev)
    dwin = dwin_partial = None
    if window_grad:
        # one float32 partial per warpgroup half of the columns and edge row
        dwin = torch.empty((Bp, E), dtype=torch.float32, device=dev)
        dwin_partial = torch.empty((2, Bp * O * E), dtype=torch.float32, device=dev)
    fn = kernel_function("arreau_spatial_conv_bwd_sm90", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(basis.data_ptr(), x.data_ptr(), src.data_ptr(), win.data_ptr(), order.data_ptr(),
             offsets.data_ptr(), g.data_ptr(), dbasis.data_ptr(), dw.data_ptr(), dx.data_ptr(),
             gxw.data_ptr(), partial.data_ptr(), None if dwin is None else dwin.data_ptr(),
             None if dwin_partial is None else dwin_partial.data_ptr(), maps, Bp, O, E // TA,
             TA, D, C, ctypes.byref(kernel_plan),
             int(plan["tma"] and basis.data_ptr() % 16 == 0), int(basis.dtype == torch.bfloat16),
             stream)
    check("arreau_spatial_conv_bwd_sm90", err)
    spatial_conv_bwd.launches += 1
    if dwin is None:
        return dbasis, dw.to(w.dtype), dx
    return dbasis, dw.to(w.dtype), dx, dwin


spatial_conv_bwd.launches = 0


def sender_order(src, TA):
    """(order ``[B', E]``, offsets ``[B', TA + 1]``), int32: each row's live
    edges (``0 <= src < TA``) listed by sender, stably, so in ascending e
    within a sender, then the empty slots; ``offsets[b, s]`` is where sender
    s's run starts and ``offsets[b, TA]`` where the empty slots start. The
    backward's dx sums each sender's run in this order."""
    key = torch.where((src >= 0) & (src < TA), src, TA)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    bounds = torch.arange(TA + 1, dtype=key.dtype, device=src.device).expand(src.shape[0], -1)
    offsets = torch.searchsorted(sorted_key, bounds.contiguous())
    return order.to(torch.int32).contiguous(), offsets.to(torch.int32).contiguous()


def edge_cotangent_scratch(basis, C):
    """The backward's scratch for the edge cotangent ``gxw`` (and then for
    the per-edge dx terms): one row per edge row of ``basis [B', O, E, D]``,
    C rounded up to 8 elements so that every row starts 16-byte aligned; in
    the basis's type."""
    rows = basis.numel() // basis.shape[-1]
    return torch.empty((rows, -(-C // 8) * 8), dtype=basis.dtype, device=basis.device)


def tile_product(a, b, built: bool = False, staged: bool = False):
    """``a [M, K] @ b [K, N]`` in float32 through the backward's tensor-core
    tile product (``csrc/mma.cuh``: bfloat16 fragments, or 3xTF32 for
    float32), for the card test of its fragment layouts; with ``built``,
    through its variant whose A tile the block writes into shared memory
    itself (``TileProduct::run_built``, the polynomial features of #8/#7);
    with ``staged``, through ``TileProduct::product`` on tiles the block
    stages itself, 13 n8 tiles a warp (#9/#10's row blocks). ``a`` and ``b``
    are each contiguous or the transpose of a contiguous tensor (which
    selects the shared-memory layout), of one type. On the CPU: a float64
    product rounded to float32."""
    if built and staged:
        raise ValueError("tile_product takes built or staged, not both")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tile_product expects [M, K] @ [K, N], got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"tile_product takes two float32 or two bfloat16 tensors, got {a.dtype} "
                        f"and {b.dtype}")
    if a.device.type == "cpu":
        return (a.double() @ b.double()).float()
    if a.device.type != "cuda":
        raise ValueError(f"tile_product runs on cuda or cpu, not {a.device}")
    if not (a.is_contiguous() or a.t().is_contiguous()) or not (
            b.is_contiguous() or b.t().is_contiguous()):
        raise ValueError("tile_product takes contiguous operands or their transposes")
    from arreau_tpu_torch.kernels.build import check, kernel_function

    (M, K), N = a.shape, b.shape[1]
    a_kmajor, b_kmajor = a.is_contiguous(), not b.is_contiguous()
    d = torch.empty((M, N), dtype=torch.float32, device=a.device)
    name = ("arreau_tile_product_built" if built else
            "arreau_tile_product_staged" if staged else "arreau_tile_product")
    fn = kernel_function(name, _TILE_ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), M, N, K, int(a_kmajor), int(b_kmajor),
             int(a.dtype == torch.bfloat16), torch.cuda.current_stream(a.device).cuda_stream)
    check(name, err)
    tile_product.launches += 1
    return d


tile_product.launches = 0

_WGMMA_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def wgmma_product(a, b, tma: bool = False, slab: int | None = None, mn_major: bool = False):
    """``a [M, K] @ b [N, K]^T`` in float32 through ``csrc/wgmma.cuh``'s
    warpgroup products (``csrc/wgmma_product.cu``: bfloat16, or 3xTF32 for
    float32; both operands K-major in 128-byte-swizzled shared memory, one
    warpgroup a 64-row tile, N <= 256), for the card test of its
    descriptors and fragment layouts; with ``tma``, both operands staged by
    TMA (bfloat16, K a multiple of 8). Two more layouts, bfloat16 by TMA:
    with ``slab``, A read through a 3-D map over ``a`` viewed as ``[M /
    slab, slab, K]``, each 64-row box clipped at its slab's end (M a multiple
    of slab); with ``mn_major``, ``a [K, M]^T @ b [K, N]``, both operands
    MN-major (M and N multiples of 8). On the CPU: a float64 product rounded
    to float32."""
    if mn_major and (a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]):
        raise ValueError(f"wgmma_product(mn_major) expects [K, M] and [K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not mn_major and (a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]):
        raise ValueError(f"wgmma_product expects [M, K] and [N, K], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"wgmma_product takes two float32 or two bfloat16 tensors, got {a.dtype} "
                        f"and {b.dtype}")
    if (slab is not None or mn_major) and a.dtype != torch.bfloat16:
        raise TypeError("wgmma_product's slab and mn_major layouts are bfloat16")
    if a.device.type == "cpu":
        a64, b64 = a.double(), b.double()
        return (a64.t() @ b64 if mn_major else a64 @ b64.t()).float()
    if a.device.type != "cuda":
        raise ValueError(f"wgmma_product runs on cuda or cpu, not {a.device}")
    N = b.shape[1] if mn_major else b.shape[0]
    if not (a.is_contiguous() and b.is_contiguous()) or N > 256:
        raise ValueError("wgmma_product takes contiguous operands and N <= 256")
    from arreau_tpu_torch.kernels.build import check, kernel_function

    M, K = (a.shape[1], a.shape[0]) if mn_major else a.shape
    d = torch.empty((M, N), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if slab is not None or mn_major:
        name = "arreau_wgmma_product_layout"
        err = kernel_function(name, _WGMMA_ARGTYPES)(
            a.data_ptr(), b.data_ptr(), d.data_ptr(), M, N, K, slab or 0, int(mn_major), stream)
    else:
        name = "arreau_wgmma_product"
        err = kernel_function(name, _WGMMA_ARGTYPES)(
            a.data_ptr(), b.data_ptr(), d.data_ptr(), M, N, K, int(tma),
            int(a.dtype == torch.bfloat16), stream)
    check(name, err)
    wgmma_product.launches += 1
    return d


wgmma_product.launches = 0


class _SpatialConv(torch.autograd.Function):
    """``fused_spatial_conv``'s custom VJP: :func:`spatial_conv` forward
    through its operator, :func:`spatial_conv_bwd` backward; ``src`` gets no
    cotangent, and ``win`` one only with ``window_grad``."""

    @staticmethod
    def forward(ctx, basis, w, x, src, win, window_grad):
        ctx.save_for_backward(basis, w, x, src, win)
        ctx.window_grad = window_grad
        return torch.ops.arreau_tpu_torch.spatial_conv(basis, w, x, src, win)

    @staticmethod
    def backward(ctx, g):
        if not ctx.window_grad:
            dbasis, dw, dx = spatial_conv_bwd(*ctx.saved_tensors, g.contiguous())
            return dbasis, dw, dx, None, None, None
        dbasis, dw, dx, dwin = spatial_conv_bwd(*ctx.saved_tensors, g.contiguous(), True)
        return dbasis, dw, dx, None, dwin, None


def fused_spatial_conv(basis, w, x, src, win, window_grad: bool = False):
    """Differentiable :func:`spatial_conv`: cotangents for basis, w and x,
    and with ``window_grad`` for ``win`` (the JAX entry's flag; the model
    passes ``position_grads``). Without it ``win`` gets none, the JAX VJP's
    symbolic zero."""
    return _SpatialConv.apply(basis, w, x, src, win, window_grad)
