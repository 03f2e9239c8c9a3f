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
operations forward, about three times that backward); see the sources for
the designs. :func:`convnext_mlp` and :func:`convnext_mlp_bwd` launch their
kernels for CUDA tensors and run the plain versions for CPU tensors; they
never fall back.
"""

from __future__ import annotations

import ctypes

import torch

from arreau_tpu_torch.kernels.basis_mlp import gelu_and_deriv

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 13 + (_I,) * 5 + (_P,)
_BWD_ARGTYPES = (_P,) * 26 + (_I,) * 7 + (_P,)
DTYPES = (torch.float32, torch.bfloat16)  # the compute types the kernels take
MAX_C = 256  # channels a row block holds (csrc/convnext_rows.cuh: 16 * CT_MAX)
LN_EPS = 1e-5


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
    fn = kernel_function("arreau_convnext_mlp_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    err = fn(*(_ptr(t) for t in (xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, out, r)),
             M, C, W, R, int(res.dtype == torch.bfloat16), stream)
    check("arreau_convnext_mlp_fwd", err)
    convnext_mlp.launches += 1
    return out, r


convnext_mlp.launches = 0


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
    from arreau_tpu_torch.kernels.build import check, kernel_function, row_splits

    C, W = w1.shape
    M = xc.numel() // C
    R = wr.shape[1] if wr is not None else 0
    dev, cdt = xc.device, res.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    splits, per_split = row_splits(M)
    blocks = -(-M // 64)
    dxc = torch.empty_like(xc)
    dres = torch.empty_like(res)
    dw1_ext = torch.empty((C + 1, W), **f32)
    dw2_ext = torch.empty((W + 1, C), **f32)
    dwr_ext = torch.empty((C + 1, max(R, 1)), **f32)
    colsum = torch.empty((3, C), **f32)
    yl_s = torch.empty((M, C), dtype=cdt, device=dev)
    pre1_s = torch.empty((M, W), dtype=cdt, device=dev)
    dm_s = torch.empty((M, C), dtype=cdt, device=dev)
    out_s = torch.empty((M, C), dtype=cdt, device=dev) if R else None
    stats = torch.empty((2, M), **f32)
    colpart = torch.empty((blocks, 3, C), **f32)
    partial = torch.empty(splits * max((W + 1) * C, (C + 1) * W, (C + 1) * R), **f32)
    fn = kernel_function("arreau_convnext_mlp_bwd", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*(_ptr(t) for t in (xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, g_out, g_r,
                                 dxc, dres, dw1_ext, dw2_ext, dwr_ext, colsum, yl_s, pre1_s,
                                 dm_s, out_s, stats, colpart, partial)),
             M, C, W, R, splits, per_split, int(cdt == torch.bfloat16), stream)
    check("arreau_convnext_mlp_bwd", err)
    convnext_mlp_bwd.launches += 1
    dgamma, dln_s, dln_b = colsum
    dwr, dbr = (dwr_ext[:C], dwr_ext[C]) if R else (None, None)
    return (dxc, dres, dln_s, dln_b, dw1_ext[:C], dw1_ext[C], dw2_ext[:W], dw2_ext[W], dgamma,
            dwr, dbr)


convnext_mlp_bwd.launches = 0


class _ConvNextMLP(torch.autograd.Function):
    """``fused_convnext_mlp``'s custom VJP: :func:`convnext_mlp` forward,
    :func:`convnext_mlp_bwd` backward; every input gets its cotangent."""

    @staticmethod
    def forward(ctx, xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br):
        ctx.save_for_backward(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br)
        out, r = convnext_mlp(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br)
        return (out, r) if r is not None else out

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
