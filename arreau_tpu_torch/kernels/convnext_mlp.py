"""The ConvNext block's MLP tail with the per-layer readout, forward and
backward.

Replaces the TPU kernels ``arreau_tpu/ops/pallas_convnext.py:_fwd_kernel``
and ``_bwd_kernel`` (public entry ``fused_convnext_mlp``, a
``jax.custom_vjp``) with the hand-written CUDA kernels
``csrc/convnext_mlp.cu`` (#9) and ``csrc/convnext_mlp_bwd.cu`` (#10), joined
by the ``torch.autograd.Function`` behind :func:`fused_convnext_mlp`. Per
row of the conv output ``xc [..., C]`` and the residual ``res``:

    yl  = LayerNorm(xc) (scale ln_s, bias ln_b; fast variance, eps 1e-5)
    out = res + gamma * (gelu(yl @ w1 + b1) @ w2 + b2)
    r   = out @ wr + br                          (optional readout)

The compute type ``cdt`` is ``res``'s: float32, or bfloat16 on the
``compute_dtype="bfloat16"`` path. ``xc``, the LayerNorm parameters,
``gamma`` and the readout are float32; ``w1``, ``b1``, ``w2`` and ``b2`` are
in ``cdt``. The rounding points are the JAX kernel's (``_forward_block``):
``yl``, ``pre1 = yl @ w1 + b1`` (summed in float32), ``h = gelu(pre1)``,
``m = h @ w2 + b2`` and every step of ``out`` are rounded to ``cdt``; the
readout is float32 from ``out``. The backward rounds ``dm = g_total *
gamma``, ``dh`` and ``dpre1`` to ``cdt`` and returns ``dxc`` and every
parameter gradient in float32 (the Function casts each to its input's type,
as the JAX VJP's ``.astype``) and ``dres`` in ``cdt``.

On the H100 both directions are bound by arithmetic (2*M*(2*C*W + C*R)
operations forward, about three times that backward), and every product of
width C or W runs on the tensor cores. In bfloat16 they run on Hopper's
``wgmma`` with the weights by TMA (``csrc/convnext_sm90.cuh``: the two
products of a hidden chunk back to back, the first one's activations the
second one's A operand from registers), sized by the host-side plan
:func:`sm90_plan`, the weights' K-major copies made by each call; in float32
on ``mma.sync`` in 3xTF32
(``csrc/convnext_rows.cuh``). :func:`convnext_mlp` and
:func:`convnext_mlp_bwd` launch their kernels for CUDA tensors and run the
plain versions for CPU tensors; they never fall back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from arreau_tpu_torch.kernels.basis_mlp import gelu_and_deriv

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 13 + (_I,) * 4 + (_P,)
_BWD_ARGTYPES = (_P,) * 25 + (_I,) * 6 + (_P,)
_SM90_ARGTYPES = (_P,) * 14 + (_I,) * 4 + (_P, _P)
_SM90_BWD_ARGTYPES = (_P,) * 31 + (_I,) * 4 + (_P, _P)
DTYPES = (torch.float32, torch.bfloat16)  # the compute types the kernels take
MAX_C = 256  # channels a row block holds (csrc/convnext_rows.cuh: MAX_CHANNELS)
MAX_R = 64  # readout columns the backward kernel takes (csrc/convnext_rows.cuh: MAX_READOUT)
MIN_ROW_BLOCK = 64  # the fewest rows a row block of float32 #10 holds (its partials' count)
LN_EPS = 1e-5

# the bfloat16 kernels (csrc/convnext_sm90.cuh): the width classes of C (the
# N of m's and dyln's wgmma products), a warpgroup's rows, a block's tile,
# a 64-row K-panel's bytes, the hidden chunk, C's K-panels
SM90_WIDTHS = (208, 256)
_ROWS, _TILE, _PANEL, _WC, _KPANELS = 64, 128, 64 * 128, 64, 4
_STAGES = 2  # the row kernels' ring slots
_MAX_STAGES = 8  # csrc/wgmma.cuh: MAX_STAGES
SMEM_LIMIT = 232448  # shared memory an H100 block may take
# the row kernels' static shared memory beside the plan's dynamic (cnx_rows_kernel's,
# the larger): b2, each warpgroup's threads' four 16-byte pre1 fragments, the
# barriers
ROWS_STATIC = 256 * 4 + 2 * 4 * 128 * 16 + 64
_DW_STATIC = 2 * _MAX_STAGES * 8  # cnx_dw_kernel's barriers and counts (rounded up)
_DW_N1 = 208  # [dW1; db1]'s column tile
# the weight gradients' split over the rows (as basis_h1.sm90_plan's): about
# _ROWS_PER_SPLIT rows a split, more where that leaves fewer than _MIN_DW_BLOCKS
# blocks, at most _MAX_SPLITS; [dWr; dbr]'s about _R_SPLITS splits
_ROWS_PER_SPLIT, _MIN_DW_BLOCKS, _MAX_SPLITS, _R_SPLITS = 4096, 256, 256, 256


def padded_hidden(H: int) -> int:
    """Row length of the backward's ``[rows, Hg]`` scratch: the H units and a
    ones column (the bias row of a weight-gradient product), rounded up to 8
    elements so that every row starts 16-byte aligned
    (``csrc/convnext_mlp_bwd.cu``)."""
    return -(-(H + 1) // 8) * 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(n: int, m: int) -> int:
    return _cdiv(n, m) * m


@functools.lru_cache(maxsize=None)
def sm90_plan(M: int, C: int, W: int, R: int = 0) -> dict:
    """Host-side plan of the bfloat16 kernels (``csrc/convnext_sm90.cuh``)
    for M rows, C channels, W hidden units and R readout columns, from the
    shapes alone; the kernels take it as it is (:func:`kernel_plan`) and check
    it:

    - ``cn``: the width class of C (208 or 256), the N of m's and dyln's
      ``wgmma`` products (one accumulator for all C columns of 64 rows; the
      columns beyond C multiply the zeros of the weights' padding);
    - ``nch``: W's chunks of 64 hidden units, ``kw`` = ``nch`` * 64 the row
      length of the weights' [C, kw] copies (W2^T, W1); the [W, 256] copies
      (W1^T, W2) hold C's four 64-element K-panels; a call makes them first
      (the weights change with every step, and the sampler casts them anew
      on every call);
    - ``slot`` / ``smem``: a ring slot (four 64-row panels and one ``cn``-row
      panel of the weights) and the row kernels' dynamic shared memory (the
      1024 bytes of alignment, the two warpgroups' 64 x 256 tiles, two
      slots), which with ``ROWS_STATIC`` fits the block's 227 KB;
    - ``cg`` / ``wg``: the row lengths of #10's ``[yl | 1]`` and ``[h | 1]``
      scratch (C + 1 and W + 1 rounded up to 8: 16-byte rows, which TMA
      reads); ``cp`` / ``wp``: of dm and out, and of dpre1 (C and W rounded up
      to 8);
    - ``splits`` x ``per_split``: the weight gradients' split over the rows,
      about 4096 rows each, or more splits where that leaves fewer than 256
      blocks of the smaller product ([dW2; db2]: 128 rows of W + 1 a block,
      [dW1; db1]: 128 rows of C + 1 by ``n1`` = 208 columns of W), at most
      256, in whole 64-row panels; ``r_splits`` x ``r_per_split`` the same for
      [dWr; dbr] (about 256 splits of whole panels);
    - ``dw_stages`` / ``dw_smem``: the weight gradients' ring slots (both
      warpgroups' 64-column boxes of A and four of B, 48 KB a slot) and
      shared memory;
    - the scratch's elements: ``copies`` (both weights' K-major copies,
      made by each call), ``pre1s`` (pre1 in the accumulators' layout,
      every 64-row tile's chunks of the row kernels' 128-row tiles),
      ``colpart`` (each 64-row tile's three column sums) and ``partial``.

    Cached (a wrapper call looks it up); the dict is not to be changed."""
    if M < 1 or W < 1 or not 1 <= C <= MAX_C or not 0 <= R <= MAX_R:
        raise ValueError(f"convnext_mlp's bfloat16 kernels take C <= {MAX_C} and R <= {MAX_R}; "
                         f"got M={M}, C={C}, W={W}, R={R}")
    cn = SM90_WIDTHS[0] if C <= SM90_WIDTHS[0] else SM90_WIDTHS[1]
    nch = _cdiv(W, _WC)
    slot = _KPANELS * _PANEL + cn * 128
    plan = {"cn": cn, "nch": nch, "kw": nch * _WC, "slot": slot,
            "smem": 1024 + 2 * _KPANELS * _PANEL + _STAGES * slot, "cg": padded_hidden(C),
            "wg": padded_hidden(W), "cp": _round_up(C, 8), "wp": _round_up(W, 8), "n1": _DW_N1}
    dw_slot = (2 + _KPANELS) * _PANEL
    stages = min(_MAX_STAGES, (SMEM_LIMIT - 1024 - _DW_STATIC) // dw_slot)
    plan.update(dw_stages=stages, dw_smem=1024 + stages * dw_slot)
    blocks = min(_cdiv(W + 1, _TILE), _cdiv(C + 1, _TILE) * _cdiv(W, _DW_N1))
    splits = max(_cdiv(M, _ROWS_PER_SPLIT), _cdiv(_MIN_DW_BLOCKS, blocks))
    splits = max(1, min(_MAX_SPLITS, splits))
    per = _round_up(_cdiv(M, splits), _ROWS)
    r_per = _round_up(_cdiv(M, _R_SPLITS), _ROWS)
    plan.update(splits=_cdiv(M, per), per_split=per, r_splits=_cdiv(M, r_per), r_per_split=r_per)
    tiles = _cdiv(M, _TILE)
    plan.update(copies=2 * (W * _KPANELS * 64 + C * nch * _WC),
                pre1s=2 * tiles * nch * _ROWS * _WC, colpart=_cdiv(M, _ROWS) * 3 * C,
                partial=max(plan["splits"] * max((W + 1) * C, (C + 1) * W),
                            plan["r_splits"] * (C + 1) * max(R, 1)))
    return plan


class _CnxPlan(ctypes.Structure):
    """``csrc/convnext_sm90.cuh``'s ``CnxPlan``: the plan as the kernels take it."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "cn", "nch", "smem", "cg", "wg", "cp", "wp", "splits", "per_split", "r_splits",
        "r_per_split", "dw_stages", "dw_smem", "n1")]


@functools.lru_cache(maxsize=None)
def kernel_plan(M: int, C: int, W: int, R: int) -> _CnxPlan:
    """:func:`sm90_plan` as the kernels' ``CnxPlan`` (cached)."""
    plan = sm90_plan(M, C, W, R)
    return _CnxPlan(*(int(plan[name]) for name, _ in _CnxPlan._fields_))


def _forward(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """The plain forward's intermediates, in the working type, each rounded
    to ``res``'s type where the JAX kernel rounds."""
    cdt = res.dtype
    wt = torch.promote_types(cdt, torch.float32)

    def rnd(v):
        return v.to(cdt).to(wt)

    x = xc.to(wt)
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (x - mu) * rstd
    yl = rnd(xhat * ln_s.to(wt) + ln_b.to(wt))
    pre1 = rnd(torch.matmul(yl, w1.to(wt)) + b1.to(wt))
    h = rnd(gelu_and_deriv(pre1)[0])
    m = rnd(torch.matmul(h, w2.to(wt)) + b2.to(wt))
    out = rnd(res.to(wt) + rnd(rnd(gamma.to(wt)) * m))
    return dict(rnd=rnd, wt=wt, xhat=xhat, rstd=rstd, yl=yl, pre1=pre1, h=h, m=m, out=out)


def convnext_mlp_plain(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr=None, br=None):
    """Plain PyTorch version: ``(out [..., C]`` in ``res``'s type, ``r [...,
    R]`` float32 or None)."""
    f = _forward(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma)
    out = f["out"]
    r = None
    if wr is not None:
        r = torch.matmul(out, wr.to(f["wt"])) + br.to(f["wt"])
    return out.to(res.dtype), r


def convnext_mlp_bwd_plain(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, g_out, g_r):
    """Plain PyTorch version of the backward: (dxc, dres, dln_s, dln_b, dw1,
    db1, dw2, db2, dgamma, dwr, dbr) for the cotangents ``g_out`` of out and
    ``g_r`` of r (None without a readout; then dwr and dbr are None)."""
    f = _forward(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma)
    rnd, wt = f["rnd"], f["wt"]
    rows = lambda v: v.reshape(-1, v.shape[-1])  # noqa: E731
    g_total = g_out.to(wt)
    dwr = dbr = None
    if wr is not None:
        gr = g_r.to(wt)
        g_total = g_total + torch.matmul(gr, wr.to(wt).t())
        dwr = rows(f["out"]).t() @ rows(gr)
        dbr = rows(gr).sum(dim=0)
    dgamma = rows(g_total * f["m"]).sum(dim=0)
    dm = rnd(g_total * gamma.to(wt))
    dw2 = rows(f["h"]).t() @ rows(dm)
    db2 = rows(dm).sum(dim=0)
    dh = rnd(torch.matmul(dm, w2.to(wt).t()))
    dpre1 = rnd(dh * gelu_and_deriv(f["pre1"])[1])
    dw1 = rows(f["yl"]).t() @ rows(dpre1)
    db1 = rows(dpre1).sum(dim=0)
    dyln = torch.matmul(dpre1, w1.to(wt).t())
    xhat = f["xhat"]
    dln_s = rows(dyln * xhat).sum(dim=0)
    dln_b = rows(dyln).sum(dim=0)
    dxhat = dyln * ln_s.to(wt)
    dxc = f["rstd"] * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                       - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return (dxc.to(xc.dtype), g_total.to(res.dtype), dln_s, dln_b, dw1, db1, dw2, db2, dgamma,
            dwr, dbr)


def _check(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br):
    C = xc.shape[-1]
    W = w1.shape[-1] if w1.dim() == 2 else -1
    if res.shape != xc.shape or w1.dim() != 2 or tuple(w1.shape) != (C, W):
        raise ValueError(f"convnext_mlp expects xc/res [..., C], w1 [C, W]; got xc "
                         f"{tuple(xc.shape)}, res {tuple(res.shape)}, w1 {tuple(w1.shape)}")
    shapes = {"ln_s": (ln_s, (C,)), "ln_b": (ln_b, (C,)), "b1": (b1, (W,)),
              "w2": (w2, (W, C)), "b2": (b2, (C,)), "gamma": (gamma, (C,))}
    if (wr is None) != (br is None):
        raise ValueError("pass both wr and br, or neither")
    if wr is not None:
        R = wr.shape[-1]
        shapes.update(wr=(wr, (C, R)), br=(br, (R,)))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    cdt = res.dtype
    if cdt not in DTYPES:
        raise TypeError(f"res (the compute type) must be float32 or bfloat16, got {cdt}")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != cdt:
            raise TypeError(f"{name} must be {cdt} like res, got {t.dtype}")
    f32 = {"xc": xc, "ln_s": ln_s, "ln_b": ln_b, "gamma": gamma}
    if wr is not None:
        f32.update(wr=wr, br=br)
    for name, t in f32.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    tensors = [xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma] + ([wr, br] if wr is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all convnext_mlp inputs must be on one device")
    return tensors


def _cuda_ready(name, tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}'s CUDA kernels need contiguous inputs")
    C = tensors[0].shape[-1]
    if C > MAX_C:
        raise ValueError(f"{name}'s CUDA kernels hold at most {MAX_C} channels, got {C}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def convnext_mlp(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr=None, br=None):
    """``(out, r)``: see the module docstring; ``r`` is None without ``wr``."""
    tensors = _check(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br)
    if xc.device.type == "cpu":
        return convnext_mlp_plain(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br)
    _cuda_ready("convnext_mlp", tensors)
    from arreau_tpu_torch.kernels.build import check, kernel_function

    C, W = w1.shape
    M = xc.numel() // C
    R = wr.shape[1] if wr is not None else 0
    out = torch.empty_like(res)
    r = torch.empty((*xc.shape[:-1], R), dtype=torch.float32, device=xc.device) if R else None
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    if res.dtype == torch.bfloat16:
        copies = torch.empty(sm90_plan(M, C, W, R)["copies"], dtype=res.dtype, device=xc.device)
        name = "arreau_convnext_fwd_sm90"
        err = kernel_function(name, _SM90_ARGTYPES)(
            *(_ptr(t) for t in (xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, out, r,
                                copies)),
            M, C, W, R, ctypes.byref(kernel_plan(M, C, W, R)), stream)
    else:
        name = "arreau_convnext_mlp_fwd"
        err = kernel_function(name, _ARGTYPES)(
            *(_ptr(t) for t in (xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, out, r)),
            M, C, W, R, stream)
    check(name, err)
    convnext_mlp.launches += 1
    return out, r


convnext_mlp.launches = 0


@torch.library.custom_op(
    "arreau_tpu_torch::convnext_mlp", mutates_args=(),
    schema="(Tensor xc, Tensor res, Tensor ln_s, Tensor ln_b, Tensor w1, Tensor b1, Tensor w2, "
           "Tensor b2, Tensor gamma, Tensor? wr, Tensor? br) -> (Tensor, Tensor)")
def convnext_mlp_op(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br):
    """:func:`convnext_mlp` as the operator
    ``torch.ops.arreau_tpu_torch.convnext_mlp``, which ``torch.export`` keeps
    as one node (a fake tensor has no ``data_ptr``): (out, r), r with 0
    columns without a readout; the wrapper is looked up in this module when
    the operator runs. Its outputs are contiguous, as the kernel's are (see
    :func:`~arreau_tpu_torch.kernels.spatial_conv.spatial_conv_op`)."""
    out, r = convnext_mlp(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br)
    r = r if r is not None else xc.new_empty((*xc.shape[:-1], 0))
    return out.contiguous(), r.contiguous()


@convnext_mlp_op.register_fake
def _(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br):
    R = wr.shape[1] if wr is not None else 0
    return torch.empty_like(res), xc.new_empty((*xc.shape[:-1], R), dtype=torch.float32)


def convnext_mlp_bwd(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, g_out, g_r):
    """(dxc, dres, dln_s, dln_b, dw1, db1, dw2, db2, dgamma, dwr, dbr) for the
    cotangents ``g_out`` (``res``'s type and shape) and ``g_r`` (float32, None
    without a readout); the parameter gradients are float32."""
    tensors = _check(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br)
    if g_out.shape != res.shape or g_out.dtype != res.dtype or g_out.device != res.device:
        raise ValueError(f"g_out must be {res.dtype} {tuple(res.shape)} on {res.device}, got "
                         f"{g_out.dtype} {tuple(g_out.shape)} on {g_out.device}")
    if (g_r is None) != (wr is None):
        raise ValueError("g_r must be given exactly when there is a readout")
    if g_r is not None and (tuple(g_r.shape) != (*xc.shape[:-1], wr.shape[1])
                            or g_r.dtype != torch.float32 or g_r.device != xc.device):
        raise ValueError(f"g_r must be float32 {(*xc.shape[:-1], wr.shape[1])} on {xc.device}, "
                         f"got {g_r.dtype} {tuple(g_r.shape)} on {g_r.device}")
    if xc.device.type == "cpu":
        return convnext_mlp_bwd_plain(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br,
                                      g_out, g_r)
    _cuda_ready("convnext_mlp_bwd", tensors + [g_out] + ([g_r] if g_r is not None else []))
    if wr is not None and wr.shape[1] > MAX_R:
        raise ValueError(f"convnext_mlp_bwd's CUDA kernels take at most {MAX_R} readout columns, "
                         f"got {wr.shape[1]}")
    from arreau_tpu_torch.kernels.build import check, kernel_function, row_splits

    C, W = w1.shape
    M = xc.numel() // C
    R = wr.shape[1] if wr is not None else 0
    dev, cdt = xc.device, res.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = lambda *shape: torch.empty(shape, dtype=cdt, device=dev)  # noqa: E731
    dxc = torch.empty_like(xc)
    dres = torch.empty_like(res)
    dw1_ext = torch.empty((C + 1, W), **f32)
    dw2_ext = torch.empty((W + 1, C), **f32)
    dwr_ext = torch.empty((C + 1, max(R, 1)), **f32)
    colsum = torch.empty((3, C), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if cdt == torch.bfloat16:
        plan = sm90_plan(M, C, W, R)
        # g_total, dyln and each row's LayerNorm statistics; [yl | 1], [h |
        # 1], dm, m, out, dpre1 (rows 16-byte aligned); pre1 in the
        # accumulators' layout; the 64-row tiles' column sums; split partials
        tensors = (torch.empty((M, C), **f32), torch.empty((M, C), **f32),
                   torch.empty((M, 2), **f32), scratch(M, plan["cg"]), scratch(M, plan["wg"]),
                   scratch(M, plan["cp"]), scratch(M, plan["cp"]), scratch(M, plan["cp"]),
                   scratch(M, plan["wp"]), scratch(plan["pre1s"]),
                   torch.empty(plan["colpart"], **f32), torch.empty(plan["partial"], **f32))
        name = "arreau_convnext_bwd_sm90"
        err = kernel_function(name, _SM90_BWD_ARGTYPES)(
            *(_ptr(t) for t in (xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, g_out, g_r,
                                scratch(plan["copies"]), dxc, dres, dw1_ext, dw2_ext, dwr_ext,
                                colsum, *tensors)),
            M, C, W, R, ctypes.byref(kernel_plan(M, C, W, R)), stream)
        check(name, err)
        convnext_mlp_bwd.launches += 1
        return _bwd_outputs(C, R, dxc, dres, dw1_ext, dw2_ext, dwr_ext, colsum)
    splits, per_split = row_splits(M)
    # yl and h with a ones column (the bias gradients), rows 16-byte aligned;
    # pre1, then dpre1 over it
    yl_s, h_s = scratch(M, padded_hidden(C)), scratch(M, padded_hidden(W))
    pre1_s, dm_s = scratch(M, W), scratch(M, C)
    # each row block's column sums (dgamma, dln_s, dln_b), then its [dWr; dbr]
    colpart = torch.empty(-(-M // MIN_ROW_BLOCK) * (3 * C + (C + 1) * R), **f32)
    partial = torch.empty(splits * max((W + 1) * C, (C + 1) * W), **f32)
    fn = kernel_function("arreau_convnext_mlp_bwd", _BWD_ARGTYPES)
    err = fn(*(_ptr(t) for t in (xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, g_out, g_r,
                                 dxc, dres, dw1_ext, dw2_ext, dwr_ext, colsum, yl_s, pre1_s,
                                 h_s, dm_s, colpart, partial)),
             M, C, W, R, splits, per_split, stream)
    check("arreau_convnext_mlp_bwd", err)
    convnext_mlp_bwd.launches += 1
    return _bwd_outputs(C, R, dxc, dres, dw1_ext, dw2_ext, dwr_ext, colsum)


convnext_mlp_bwd.launches = 0


def _bwd_outputs(C, R, dxc, dres, dw1_ext, dw2_ext, dwr_ext, colsum):
    """The backward kernels' outputs as :func:`convnext_mlp_bwd` returns them."""
    W = dw1_ext.shape[1]
    dgamma, dln_s, dln_b = colsum
    dwr, dbr = (dwr_ext[:C], dwr_ext[C]) if R else (None, None)
    return (dxc, dres, dln_s, dln_b, dw1_ext[:C], dw1_ext[C], dw2_ext[:W], dw2_ext[W], dgamma,
            dwr, dbr)


class _ConvNextMLP(torch.autograd.Function):
    """``fused_convnext_mlp``'s custom VJP: :func:`convnext_mlp` forward
    through its operator, :func:`convnext_mlp_bwd` backward; every input
    gets its cotangent."""

    @staticmethod
    def forward(ctx, xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br):
        ctx.save_for_backward(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br)
        out, r = torch.ops.arreau_tpu_torch.convnext_mlp(xc, res, ln_s, ln_b, w1, b1, w2, b2,
                                                         gamma, wr, br)
        return (out, r) if wr is not None else out

    @staticmethod
    def backward(ctx, g_out, g_r=None):
        inputs = ctx.saved_tensors
        grads = convnext_mlp_bwd(*inputs, g_out.contiguous(),
                                 g_r.contiguous() if g_r is not None else None)
        # in each input's type, as the JAX VJP's .astype
        return tuple(None if g is None else g.to(t.dtype) for g, t in zip(grads, inputs))


def fused_convnext_mlp(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr=None, br=None):
    """Differentiable :func:`convnext_mlp`: ``(out, r)``, ``r`` None without a
    readout. xc ``[..., C]`` float32, res ``[..., C]`` in the compute type;
    w1 ``[C, W]``, b1 ``[W]``, w2 ``[W, C]``, b2 ``[C]`` in the compute type;
    ln_s, ln_b, gamma ``[C]`` and wr ``[C, R]``, br ``[R]`` float32. Pass
    ``gamma`` of ones for a block without a layer scale."""
    if wr is None:
        return _ConvNextMLP.apply(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, None, None), None
    return _ConvNextMLP.apply(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br)
