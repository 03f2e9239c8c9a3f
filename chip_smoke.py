#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: the sampler and
the training path, on the default conv path, on the fused fiber conv path
(``fuse_fiber``), in bfloat16 (``compute_dtype="bfloat16"``) and on the
fused ConvNext path (``fuse_convnext``, bfloat16), every CUDA kernel
against its plain PyTorch version.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its elapsed seconds and raising on any failure:

1. device: requires CUDA; prints the card's name and power limit (nvidia-smi).
2. build: builds the port's CUDA kernels (one nvcc call) or loads a current build.
3. serving kernels: captures the inputs each forward kernel gets in one
   full-width forward of the sampler (batch 128 x 8 atoms), holds both
   against their plain PyTorch versions and times kernel, plain version and
   a library yardstick with CUDA events.
4. sampler path: writes a seeded full-width checkpoint (random weights;
   ``meta.json`` and ``last/params.npz``) and runs the generate CLI on it:
   256 crystals, batch 128 x 8 atoms, 50 strided steps. Checks the crystals
   and that every forward went through both forward kernels and no other
   (launch counts, set to 0 just before the path).
5. forward reference: one backbone forward of the full-width model on
   realistic crystals, CUDA kernel branch against the plain branch on the
   CPU, on one neighbour list.
6. training kernels: captures the inputs of all four kernels (forwards
   spatial_conv and basis_h1, backwards spatial_conv_bwd and basis_mlp_bwd)
   in one training step at the canonical shape (256 crystals x 16 atoms,
   hidden 200), holds each against its plain version and times it.
7. training step: one training step's time at that batch (CUDA events) and
   where it goes (torch.profiler: the device's busy share and its largest
   kernels).
8. training reference: one training step's loss terms and every parameter
   gradient on the card's kernel branch against the CPU's plain branch, on
   one neighbour list.
9. training path: the training CLI on the synthetic dataset at batch 256,
   hidden 200, for TRAIN_STEPS steps. Checks that every step launched each
   forward kernel once per layer / once, and each backward kernel once per
   layer / once, and that every loss is finite; prints steps/s.
10. trained sampling: the generate CLI on the checkpoint the training path
   wrote (``--tag best``, its EMA weights where it kept them).
11. fiber kernels: captures the fused fiber conv's inputs (#1) in one
   ``fuse_fiber`` sampler forward (128 x 8) and #1's and #2's in one
   ``fuse_fiber`` training step (256 x 16), holds both against their plain
   versions and times kernel, plain version and library chain.
12. fiber sampler path: the sampler path on a ``fuse_fiber`` checkpoint:
   every forward launches #1 once per layer and no other kernel.
13. fiber training: one ``fuse_fiber`` training step on the card's kernel
   branch against the CPU's plain branch (as phase 8), then the step time
   at 256 x 16, its launches (#1 and #2 once per layer, no other kernel)
   and its profile (as phase 7).
14. bf16 kernels: the bfloat16 instantiations of #3 and #8 on one bfloat16
   sampler forward (128 x 8) and of #3, #8, #4 and #7 on one bfloat16
   training step (256 x 16), each against its bfloat16 plain version
   (1e-2 of each output's scale), timed; bounds at the bf16 tensor-core
   rate.
15. bf16 training reference: one bfloat16 training step, card kernel branch
   against CPU plain branch (loss terms 5e-3, gradients 5e-2), without and
   with ``fuse_convnext``.
16. bf16 training path: the training CLI with ``--compute_dtype bfloat16``
   (as phase 9: 5/1/5/1 launches of #3/#8/#4/#7 a step, no other kernel),
   then the step time and profile at 256 x 16; and the generate CLI on its
   checkpoint (``--tag best``: 5 of #3 and 1 of #8 a forward).
17. convnext kernels: #9 on one ``fuse_convnext`` bfloat16 sampler forward
   and #9/#10 on one such training step (layer scale 1, so that the MLP
   weighs in ``out``), with and without the readout, against their plain
   versions, timed; and the float32 instantiations on the same values.
18. fuse_convnext path: a bfloat16 ``fuse_convnext`` training step (5 of
   #9, #10, #3 and #4, 1 of #8 and #7, nothing else), its time and
   profile; then 256 crystals through ``DiffusionModel.sample`` (5 of #9
   and #3 and 1 of #8 a forward).

The last two lines are the kernels' JSON record (training-shape numbers;
``launches`` from the training paths, ``launches_sampler`` from the
sampler paths; bfloat16 instantiations as entries of their own, named
``*_bf16``; #9/#10 in bfloat16, their float32 instantiation, serving
shape and no-readout call beside) and the result
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of the
repository beside it, the script exits non-zero before printing either.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from functools import reduce
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, float32 outside the
# tensor cores, and the dense bfloat16 tensor cores (the bound of the same
# work in bfloat16)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TIMED_RUNS = 20
KERNEL_REL_TOL = 1e-4  # max |kernel - plain| / max |plain|: float32, other summation order
# bfloat16 kernel against its bfloat16 plain version: both sum in float32 and
# round at the same points, but a value next to a rounding boundary may
# round the other way (one bf16 ulp, 2^-8) and carry
BF16_KERNEL_REL_TOL = 1e-2
# a bfloat16 training step, card kernel branch against CPU plain branch: loss
# terms 5e-3 relative, every gradient 5e-2 of its largest entry (the two
# branches round at different points, as the JAX package's two do)
BF16_LOSS_REL_TOL = 5e-3
BF16_GRAD_REL_TOL = 5e-2
# a fuse_fiber training step's loss terms, card kernel branch vs CPU plain
# branch (the default path measured 7e-6 on the H100, PERF.md)
FIBER_LOSS_REL_TOL = 1e-5
# a training step's gradients, card kernel branch vs CPU plain branch: each
# parameter's max |difference| over its max |gradient| (float32 forward and
# backward through five layers in other summation orders)
GRAD_REL_TOL = 1e-3
BATCH, ATOMS, CRYSTALS, STEPS, SEED = 128, 8, 256, 50, 0
TRAIN_BATCH, TRAIN_HIDDEN, TRAIN_STEPS = 256, 200, 35  # 35 steps = 5 epochs of the synthetic set


class Phase:
    """Prints a phase's name and, when it ends, its elapsed seconds."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        print(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s", flush=True)


class Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Mean milliseconds per call over ``runs`` calls, after warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensors_of(*items) -> list:
    """The tensors among ``items``, lists and tuples opened."""
    out = []
    for item in items:
        if torch.is_tensor(item):
            out.append(item)
        elif isinstance(item, (list, tuple)):
            out.extend(tensors_of(*item))
    return out


def nbytes(*items) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_of(*items))


def as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def training_chunk():
    """(synthetic set, chunk, bucket): the 16-atom bucket's fullest batch at
    the node budget TRAIN_BATCH x 16, 256 crystals (B' = 32 super-crystals
    of 128 atoms)."""
    from arreau_tpu_torch.data.crystal import BucketedLoader
    from arreau_tpu_torch.data.synthetic import synthetic_packed

    dataset = synthetic_packed(2000, seed=SEED)
    loader = BucketedLoader(dataset, np.arange(len(dataset)), node_budget=TRAIN_BATCH * 16)
    bucket, chunk = max(((b, c) for b, c in loader.chunks() if b == 16),
                        key=lambda bc: int((bc[1] >= 0).sum()))
    return dataset, chunk, bucket


def first_step_inputs(model, noise):
    """``predict_scores`` arguments of the sampler's first step."""
    B, A = noise.frac0.shape[:2]
    cfg, dev = model.config, model.device
    types = torch.full((B, A), cfg.num_atomic_states - 1, device=dev)
    return (noise.frac0, torch.nn.functional.one_hot(types, cfg.num_atomic_states).float(),
            torch.full((B,), cfg.num_timesteps - 1, device=dev), torch.full((B,), A, device=dev),
            noise.lengths0, noise.angles, torch.ones((B, A), dtype=torch.bool, device=dev))


def kernel_sites():
    """{kernel name: (module, attribute)} where the port's autograd
    Functions look each kernel wrapper up when they run."""
    from arreau_tpu_torch.kernels import basis_mlp, convnext_mlp, fiber_conv, spatial_conv

    return {"spatial_conv": (spatial_conv, "spatial_conv"),
            "spatial_conv_bwd": (spatial_conv, "spatial_conv_bwd"),
            "basis_h1": (basis_mlp, "basis_h1"),
            "basis_mlp_bwd": (basis_mlp, "basis_mlp_bwd"),
            "fiber_conv": (fiber_conv, "fiber_conv"),
            "fiber_conv_bwd": (fiber_conv, "fiber_conv_bwd"),
            "convnext_mlp": (convnext_mlp, "convnext_mlp"),
            "convnext_mlp_bwd": (convnext_mlp, "convnext_mlp_bwd")}


def wrappers() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in kernel_sites().items()}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


class Recorder:
    """Stands in for a kernel wrapper: keeps the arguments of its first call
    and passes every call on. Its ``launches`` is the wrapper's (a wrapper
    counts through its module-level name, which is this object meanwhile)."""

    def __init__(self, fn, captured: dict, name: str):
        self.fn, self.captured, self.name = fn, captured, name

    def __call__(self, *args):
        self.captured.setdefault(self.name, args)
        return self.fn(*args)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


@contextlib.contextmanager
def capturing():
    """Records the arguments of the first call of each kernel wrapper."""
    captured = {}
    originals = wrappers()
    for name, (mod, attr) in kernel_sites().items():
        setattr(mod, attr, Recorder(originals[name], captured, name))
    try:
        yield captured
    finally:
        for name, (mod, attr) in kernel_sites().items():
            setattr(mod, attr, originals[name])


def conv_library(basis, w, x, src, win):
    """The spatial conv as a chain of library calls: the per-edge kernel by
    bmm, then gather, multiply, sum (PyTorch has no one call for it)."""
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    kern = torch.bmm(basis.reshape(Bp * O, E, D), w.expand(Bp * O, D, C))
    kern = kern.view(Bp, O, E, C) * win[:, None, :, None].to(kern.dtype)
    live = ((src >= 0) & (src < TA))[:, None, :, None]
    idx = torch.where(live, src[:, None, :, None], 0).long().expand(Bp, O, E, C)
    msg = torch.where(live, kern * torch.gather(x, 2, idx), 0.0)
    return msg.view(Bp, O, E // TA, TA, C).sum(dim=2)


def check_kernel(name, kernel, plain, library, args, flops, source, replaces,
                 tol=KERNEL_REL_TOL, peak=FP32_FLOP_PER_S):
    """Hold ``kernel`` against ``plain`` on ``args`` (every output within
    ``tol`` of that output's scale; an output the plain version gives as
    None the kernel must give as None), then time kernel, plain version and
    library yardstick; returns the kernel's JSON record, its bound taken at
    the ``peak`` operation rate."""
    out_k, out_p = as_tuple(kernel(*args)), as_tuple(plain(*args))
    torch.cuda.synchronize()
    err = 0.0
    for i, (a, b) in enumerate(zip(out_k, out_p)):
        if b is None:
            if a is not None:
                raise RuntimeError(f"{name} output {i}: the plain version gives None")
            continue
        if a.dtype != b.dtype:
            raise RuntimeError(f"{name} output {i}: {a.dtype}, the plain version's {b.dtype}")
        e, scale = (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()
        if not scale > 0:
            raise RuntimeError(f"{name} output {i}: the plain version's output is all zero")
        print(f"{name} output {i}: max_abs_err {e:.3e}, max |plain| {scale:.3e}, "
              f"rel {e / scale:.3e} (tolerance {tol:g})")
        if not math.isfinite(e) or e > tol * scale:
            raise RuntimeError(f"{name} disagrees with its plain version")
        err = max(err, e)
    ms, plain_ms, lib_ms = cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args)), cuda_ms(library)
    b_ms, b_by = bound_ms(nbytes(args, out_p), flops, peak)
    print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def forward_kernel_records(args, label, suffix="", tol=KERNEL_REL_TOL, peak=FP32_FLOP_PER_S):
    """Records of the two forward kernels (#3, #8) on captured arguments,
    named with ``suffix`` (``_bf16`` for the bfloat16 instantiations)."""
    from arreau_tpu_torch.kernels.basis_h1 import basis_h1, basis_h1_plain
    from arreau_tpu_torch.kernels.spatial_conv import spatial_conv, spatial_conv_plain
    from arreau_tpu_torch.models.blocks import polynomial_features

    basis, w, x, src, win = args["spatial_conv"]
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    n_valid = int(((src >= 0) & (src < TA)).sum())
    print(f"{label}: spatial_conv shapes B'={Bp} O={O} E={E} TA={TA} K={E // TA} D={D} C={C}, "
          f"{n_valid}/{Bp * E} edge slots filled")
    conv = check_kernel(
        "spatial_conv" + suffix, spatial_conv, spatial_conv_plain,
        lambda: conv_library(basis, w, x, src, win), args["spatial_conv"],
        O * n_valid * (2 * D * C + 3 * C),
        "arreau_tpu_torch/csrc/spatial_conv.cu", "arreau_tpu/ops/pallas_conv.py:298", tol, peak,
    )
    attrT, w1, b1, degree = args["basis_h1"]
    d = attrT.shape[2]
    F_, H = w1.shape
    print(f"{label}: basis_h1 shapes B'={Bp} O={O} d={d} E={E} F={F_} H={H}")
    poly = polynomial_features(attrT.transpose(-1, -2), degree).reshape(-1, F_)
    h1 = check_kernel(
        "basis_h1" + suffix, basis_h1, basis_h1_plain, lambda: torch.addmm(b1, poly, w1),
        args["basis_h1"], O * n_valid * (2 * F_ * H + H),  # rows of filled edge slots
        "arreau_tpu_torch/csrc/basis_h1.cu", "arreau_tpu/ops/pallas_basis.py:397", tol, peak,
    )
    return conv, h1, n_valid


def backward_kernel_records(args, n_valid, suffix="", tol=KERNEL_REL_TOL,
                            peak=FP32_FLOP_PER_S):
    """Records of the two backward kernels (#4, #7) on captured arguments;
    the library yardstick is autograd's backward through the library chain
    of the same forward."""
    from arreau_tpu_torch.kernels.basis_mlp import basis_mlp_bwd, basis_mlp_bwd_plain
    from arreau_tpu_torch.kernels.spatial_conv import spatial_conv_bwd, spatial_conv_bwd_plain
    from arreau_tpu_torch.models.blocks import gelu, polynomial_features

    basis, w, x, src, win, g = args["spatial_conv_bwd"]
    Bp, O, E, D = basis.shape
    C = x.shape[3]
    leaves = [t.detach().requires_grad_() for t in (basis, w, x)]
    with torch.enable_grad():
        out = conv_library(*leaves, src, win)
    conv_bwd = check_kernel(
        "spatial_conv_bwd" + suffix, spatial_conv_bwd, spatial_conv_bwd_plain,
        lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), args["spatial_conv_bwd"],
        O * n_valid * (6 * D * C + 5 * C),
        "arreau_tpu_torch/csrc/spatial_conv_bwd.cu", "arreau_tpu/ops/pallas_conv.py:331", tol,
        peak,
    )
    del out, leaves

    attrT, w1, b1, w2, b2, degree, gs = args["basis_mlp_bwd"]
    F_, H = w1.shape
    print(f"basis_mlp_bwd shapes: B'={Bp} O={O} E={E} F={F_} H={H} D={w2.shape[1]}, "
          f"{len(gs)} cotangents")
    poly = polynomial_features(attrT.transpose(-1, -2), degree).reshape(-1, F_)
    leaves = [t.detach().requires_grad_() for t in (w1, b1, w2, b2)]
    with torch.enable_grad():
        lib_basis = gelu(torch.addmm(leaves[3], gelu(torch.addmm(leaves[1], poly, leaves[0])),
                                     leaves[2]))
    flat_gs = [t.reshape(lib_basis.shape) for t in gs]
    mlp_bwd = check_kernel(
        "basis_mlp_bwd" + suffix, basis_mlp_bwd, basis_mlp_bwd_plain,
        lambda: torch.autograd.grad(lib_basis, leaves, reduce(torch.add, flat_gs), retain_graph=True),
        args["basis_mlp_bwd"], O * n_valid * 2 * (2 * F_ * H + 3 * H * w2.shape[1]),
        "arreau_tpu_torch/csrc/basis_mlp_bwd.cu", "arreau_tpu/ops/pallas_basis.py:289", tol, peak,
    )
    return conv_bwd, mlp_bwd


def fiber_library(basis, w, x, src, fiber_kernel):
    """The fused fiber conv as a chain of library calls: the spatial conv's
    chain with a unit window, then the fiber mixing as one einsum."""
    ones = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    return torch.einsum("botc,opc->bptc", conv_library(basis, w, x, src, ones), fiber_kernel)


def fiber_records(args, label):
    """Records of #1 (and of #2 where ``args`` holds its inputs: a training
    step, whose forward also stores the spatial conv for the backward) on
    captured arguments; the backward's library yardstick is autograd's
    backward through :func:`fiber_library`."""
    from arreau_tpu_torch.kernels.fiber_conv import (
        fiber_conv,
        fiber_conv_bwd,
        fiber_conv_bwd_plain,
        fiber_conv_plain,
    )

    basis, w, x, src, fk, save = args["fiber_conv"]
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    P = fk.shape[1]
    n_valid = int(((src >= 0) & (src < TA)).sum())
    mixing = 2 * Bp * O * P * TA * C  # the fiber mixing; the backward's g_o and dKf each as much
    print(f"{label}: fiber_conv shapes B'={Bp} O={O} P={P} E={E} TA={TA} K={E // TA} D={D} "
          f"C={C}, {n_valid}/{Bp * E} edge slots filled")
    records = [check_kernel(
        "fiber_conv", fiber_conv, fiber_conv_plain, lambda: fiber_library(basis, w, x, src, fk),
        args["fiber_conv"], O * n_valid * (2 * D * C + 2 * C) + mixing,
        "arreau_tpu_torch/csrc/fiber_conv.cu", "arreau_tpu/ops/pallas_conv.py:82",
    )]
    if "fiber_conv_bwd" in args:
        basis, w, x, src, fk, g, _ = args["fiber_conv_bwd"]
        leaves = [t.detach().requires_grad_() for t in (basis, w, x, fk)]
        with torch.enable_grad():
            out = fiber_library(leaves[0], leaves[1], leaves[2], src, leaves[3])
        # dbasis, dW and dx: three edge products, as the spatial conv's backward
        records.append(check_kernel(
            "fiber_conv_bwd", fiber_conv_bwd, fiber_conv_bwd_plain,
            lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), args["fiber_conv_bwd"],
            O * n_valid * (6 * D * C + 5 * C) + 2 * mixing,
            "arreau_tpu_torch/csrc/fiber_conv_bwd.cu", "arreau_tpu/ops/pallas_conv.py:108",
        ))
        del out, leaves
    return records


def convnext_library(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr=None, br=None):
    """The fused ConvNext MLP as a chain of library calls in the compute
    type: layer_norm, linear, tanh-GELU, linear, scale and add, and the
    float32 readout linear."""
    F = torch.nn.functional
    dt = res.dtype
    y = F.layer_norm(xc, (xc.shape[-1],), ln_s, ln_b, eps=1e-5).to(dt)
    h = F.gelu(F.linear(y, w1.t(), b1), approximate="tanh")
    out = res + gamma.to(dt) * F.linear(h, w2.t(), b2)
    return out, (F.linear(out.float(), wr.t(), br) if wr is not None else None)


def convnext_records(args, label, tol, peak):
    """Records of #9 (and of #10 where ``args`` holds its inputs: a training
    step) on captured arguments, each with its no-readout call checked and
    timed beside it; the backward's library yardstick is autograd's backward
    through :func:`convnext_library`."""
    from arreau_tpu_torch.kernels.convnext_mlp import (
        convnext_mlp,
        convnext_mlp_bwd,
        convnext_mlp_bwd_plain,
        convnext_mlp_plain,
    )

    fargs = args["convnext_mlp"]
    xc, res, w1, wr = fargs[0], fargs[1], fargs[4], fargs[9]
    C, W = w1.shape
    M, R = xc.numel() // C, wr.shape[1]
    print(f"{label}: convnext_mlp shapes M={M} rows ({tuple(xc.shape)}) C={C} W={W} R={R}, "
          f"compute type {res.dtype}")
    # a check passes a kernel that returns out = res unless the MLP's share
    # of out exceeds the tolerance
    out = convnext_mlp_plain(*fargs)[0].float()
    share = (out - res.float()).abs().max().item() / out.abs().max().item()
    print(f"{label}: the MLP's share of out {share:.3e} (must exceed the tolerance {tol:g})")
    if not share > tol:
        raise RuntimeError(f"{label}: the MLP's share of out is within the tolerance")
    del out
    src, rep = "arreau_tpu_torch/csrc/convnext_mlp.cu", "arreau_tpu/ops/pallas_convnext.py:61"
    fwd = check_kernel("convnext_mlp", convnext_mlp, convnext_mlp_plain,
                       lambda: convnext_library(*fargs), fargs, 2 * M * (2 * C * W + C * R),
                       src, rep, tol, peak)
    bare = fargs[:9] + (None, None)
    fwd["no_readout"] = check_kernel("convnext_mlp", convnext_mlp, convnext_mlp_plain,
                                     lambda: convnext_library(*bare), bare, 4 * M * C * W, src,
                                     rep, tol, peak)
    records = [fwd]
    if "convnext_mlp_bwd" in args:
        bargs = args["convnext_mlp_bwd"]
        src, rep = ("arreau_tpu_torch/csrc/convnext_mlp_bwd.cu",
                    "arreau_tpu/ops/pallas_convnext.py:78")

        def library_bwd(call_args):
            leaves = [t.detach().requires_grad_() for t in call_args[:11] if t is not None]
            with torch.enable_grad():
                out, r = convnext_library(*leaves, *([None, None] if len(leaves) == 9 else []))
            outs, cots = [out], [call_args[11]]
            if r is not None:
                outs.append(r)
                cots.append(call_args[12])
            return lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True)

        bwd = check_kernel("convnext_mlp_bwd", convnext_mlp_bwd, convnext_mlp_bwd_plain,
                           library_bwd(bargs), bargs, 2 * M * (6 * C * W + 2 * C * R), src, rep,
                           tol, peak)
        # without the readout, the cotangent the readout adds to out's
        # (the captured layer is the last: its out feeds only its readout)
        g_nr = (bargs[11].float() + bargs[12] @ bargs[9].t()).to(bargs[11].dtype)
        bare = bargs[:9] + (None, None, g_nr, None)
        bwd["no_readout"] = check_kernel("convnext_mlp_bwd", convnext_mlp_bwd,
                                         convnext_mlp_bwd_plain, library_bwd(bare), bare,
                                         12 * M * C * W, src, rep, tol, peak)
        records.append(bwd)
    return records


def write_checkpoint(ckpt: Path, cfg, model, z_table) -> dict:
    """A checkpoint directory as generate reads it: ``meta.json`` and the
    tag ``last`` with ``params.npz``; returns the meta."""
    from arreau_tpu_torch.interop.from_jax import params_to_jax, save_params_npz

    (ckpt / "last").mkdir(parents=True)
    meta = {
        "config": dataclasses.asdict(cfg),
        "z_table_zs": [int(z) for z in z_table.zs],
        # the synthetic training data's lattice lengths are U(3, 8) angstrom
        "length_stats": {"min": 3.0, "max": 8.0},
    }
    (ckpt / "meta.json").write_text(json.dumps(meta, indent=2))
    save_params_npz(str(ckpt / "last" / "params.npz"), params_to_jax(model.model))
    return meta


def sampler_path(ckpt: Path, out_dir: Path, meta: dict, z_table, card: str,
                 per_forward: dict, tag: str = "last") -> dict:
    """The generate CLI on ``ckpt`` (``--tag``): CRYSTALS crystals, batch
    BATCH x ATOMS, STEPS strided steps. Checks the crystals and that every
    forward launched ``per_forward`` kernels and no other (counts set to 0
    just before); returns the launch counts."""
    from arreau_tpu_torch.cli import generate
    from arreau_tpu_torch.inference.io import load_sample_results
    from arreau_tpu_torch.tasks.diffusion import strided_levels

    reset_launch_counts()
    t0 = time.perf_counter()
    generate.main([
        "--checkpoint_dir", str(ckpt), "--batch_size", str(BATCH),
        "--num_atoms_per_sample", str(ATOMS), "--num_crystals", str(CRYSTALS),
        "--sample_steps", str(STEPS), "--seed", str(SEED), "--out_dir", str(out_dir),
        "--device", "cuda", "--tag", tag,
    ])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    T = meta["config"]["num_timesteps"]
    forwards = math.ceil(CRYSTALS / BATCH) * (len(strided_levels(T, STEPS)) - 1)
    print(f"forwards {forwards}: launches {counts}")
    want = {name: per_forward.get(name, 0) * forwards for name in counts}
    if counts != want:
        raise RuntimeError(f"the sampler path launched {counts}, not {want}")
    crystal_checks(load_sample_results(str(out_dir / "crystals.npz")), z_table, CRYSTALS,
                   ATOMS, generate.length_bounds_from_meta(meta))
    print(f"sampler path: {CRYSTALS} crystals in {wall:.2f} s wall, checkpoint load and first "
          f"batch included ({CRYSTALS / wall * 60:.0f} crystals/min on {card})")
    return counts


def training_reference(ref_cfg, z_table, seed: int, loss_rel_tol: float,
                       grad_rel_tol: float = GRAD_REL_TOL, fuse_convnext: bool = False) -> None:
    """One training step's loss terms and every parameter gradient at full
    width on 32 crystals of 8 atoms: the card's kernel branch (with
    ``fuse_convnext``: its backbone built so) against the CPU's plain
    branch, both given the neighbour list the CPU built."""
    from arreau_tpu_torch.data.synthetic import make_synthetic_batch
    from arreau_tpu_torch.ops.pbc import NeighborList
    from arreau_tpu_torch.tasks import diffusion
    from arreau_tpu_torch.tasks.diffusion import (
        DiffusionModel,
        LossNoise,
        batch_to_device,
        draw_loss_noise,
    )

    dev = torch.device("cuda")
    B = 32
    host = make_synthetic_batch(np.random.default_rng(seed), z_table, B, ATOMS)
    model = DiffusionModel(ref_cfg, device=dev)
    if fuse_convnext:
        model.model = fused_convnext_backbone(model)
    model.model.init_parameters(torch.Generator(device=dev).manual_seed(seed))
    plain = DiffusionModel(dataclasses.replace(ref_cfg, use_pallas=False), device="cpu")
    plain.model.load_state_dict({k: v.cpu() for k, v in model.model.state_dict().items()})
    noise = draw_loss_noise(torch.Generator().manual_seed(seed), B, ATOMS,
                            ref_cfg.num_atomic_states, ref_cfg.num_timesteps, True, "cpu")
    graphs = []
    build_graph = diffusion.pbc_neighbor_list
    try:
        diffusion.pbc_neighbor_list = lambda *a: graphs.append(build_graph(*a)) or graphs[-1]
        want_loss, want_m = plain.loss(batch_to_device(host, "cpu"), noise)
        want_loss.backward()
        diffusion.pbc_neighbor_list = lambda *a: NeighborList(*(x.to(dev) for x in graphs[0]))
        card_noise = LossNoise(**{f.name: getattr(noise, f.name).to(dev)
                                  for f in dataclasses.fields(noise)})
        got_loss, got_m = model.loss(batch_to_device(host, dev), card_noise)
        got_loss.backward()
    finally:
        diffusion.pbc_neighbor_list = build_graph
    for name, value in want_m.items():
        err, scale = abs(got_m[name].item() - value.item()), abs(value.item())
        print(f"{name}: card {got_m[name].item():.6f}, cpu {value.item():.6f}, "
              f"rel {err / max(scale, 1e-3):.3e} (tolerance {loss_rel_tol:g})")
        if not err <= loss_rel_tol * max(scale, 1e-3):
            raise RuntimeError(f"{name}: the card's loss disagrees with the CPU's")
    worst = 0.0
    want_grads = dict(plain.model.named_parameters())
    for name, p in model.model.named_parameters():
        want = want_grads[name].grad
        err = (p.grad.cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        if not (scale > 0 and err <= grad_rel_tol * scale):
            raise RuntimeError(f"gradient of {name}: max_abs_err {err:.3e}, max |cpu| "
                               f"{scale:.3e} (tolerance {grad_rel_tol:g} rel)")
        worst = max(worst, err / scale)
    print(f"{graphs[0].mask.sum().item()} edges; {len(want_grads)} parameter gradients, "
          f"worst max_abs_err / max |cpu| {worst:.3e} (tolerance {grad_rel_tol:g})")


def fused_convnext_backbone(model):
    """A backbone like ``model``'s with ``fuse_convnext=True``: how a caller
    reaches the fused ConvNext path (DiffusionConfig has no such field, in
    either package)."""
    from arreau_tpu_torch.models.ponita import PonitaFiberBundle

    cfg = dataclasses.replace(model.model.config, fuse_convnext=True)
    return PonitaFiberBundle(cfg).to(model.device).eval()


def profile_step(one_step, step_ms: float, steps: int = 3) -> None:
    """Where a training step's time goes: a torch.profiler trace of
    ``steps`` steps, the device's busy share and its largest kernels."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values()) / steps
    if device_ms > 0:
        print(f"device busy {device_ms:.4f} ms per step of {step_ms:.4f} ms "
              f"(busy share {device_ms / step_ms:.1%}, idle share {1 - device_ms / step_ms:.1%}); "
              f"{len(by_name)} distinct device activities; the largest, ms per step:")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {ms / steps:9.4f}  {name[:110]}")
    else:
        print("device busy share: not measured (the profiler recorded no device activity)")


def crystal_checks(result, z_table, n, atoms, bounds) -> None:
    lengths = np.linalg.norm(result.lattice, axis=-1)
    lo, hi = bounds
    checks = {
        f"{n} crystals": result.num_crystals == n,
        f"{atoms} atoms each": bool(np.all(result.num_atoms == atoms))
        and len(result.frac_x) == n * atoms,
        "finite": all(np.isfinite(a).all() for a in (result.frac_x, result.lattice)),
        "frac in [0, 1)": bool(np.all((result.frac_x >= 0) & (result.frac_x < 1))),
        "lengths positive and clamped": bool(np.all((lengths > 0) & (lengths >= lo - 1e-4)
                                                    & (lengths <= hi + 1e-4))),
        "types in the z-table": bool(np.isin(result.atomic_numbers, z_table.zs).all()),
    }
    print("checks: " + ", ".join(f"{k} {'ok' if v else 'FAILED'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise RuntimeError("generated crystals failed their checks")


def training_path(ckpt: Path, extra_args: list, want_step: dict, card: str) -> dict:
    """The training CLI on the synthetic dataset at batch TRAIN_BATCH, hidden
    TRAIN_HIDDEN, for TRAIN_STEPS steps (``extra_args`` appended). Checks
    that every step launched ``want_step`` kernels and no other (counts set
    to 0 just before) and that every loss is finite; prints steps/s and
    returns the launch counts of the whole run."""
    from arreau_tpu_torch.cli import train_diffusion

    per_step, step_metrics = [], []
    step = train_diffusion.train_step

    def counted_step(*a, **kw):
        before = launch_counts()
        metrics = step(*a, **kw)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        step_metrics.append(metrics)
        return metrics

    reset_launch_counts()
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    try:
        train_diffusion.train_step = counted_step
        with contextlib.redirect_stdout(tee):
            test_loss = train_diffusion.main([
                "--dataset", "synthetic", "--batch_size", str(TRAIN_BATCH),
                "--hidden_dim", str(TRAIN_HIDDEN), "--warmup", "0",
                "--max_steps", str(TRAIN_STEPS), "--seed", str(SEED),
                "--checkpoint_dir", str(ckpt), "--device", "cuda", *extra_args,
            ])
    finally:
        train_diffusion.train_step = step
    wall = time.perf_counter() - t0
    train_counts = launch_counts()
    want_step = {name: want_step.get(name, 0) for name in train_counts}
    bad = [i for i, c in enumerate(per_step) if c != want_step]
    print(f"{len(per_step)} steps; launches per step {per_step[0] if per_step else None}; "
          f"launches in the whole run (evaluation forwards included) {train_counts}")
    if len(per_step) != TRAIN_STEPS or bad:
        raise RuntimeError(f"steps {bad} did not launch {want_step}")
    values = torch.stack([torch.stack(list(m.values())) for m in step_metrics]).cpu()
    if not torch.isfinite(values).all() or not math.isfinite(test_loss):
        raise RuntimeError("a training loss is not finite")
    rate = re.search(r"train throughput: ([0-9.]+) steps/s", tee.buf.getvalue())
    if rate is None:
        raise RuntimeError("the training CLI printed no throughput")
    print(f"training path {' '.join(extra_args)}: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, "
          f"hidden {TRAIN_HIDDEN} in {wall:.2f} s wall (build of the data, evaluation and "
          f"checkpoints included); {float(rate.group(1)):.3f} steps/s warm on {card}")
    return train_counts


def step_time(model, batch, noise, label: str, want_step: dict, kernels_ms: float) -> float:
    """One training step's launches (``want_step`` and no other kernel), its
    time at ``batch`` (CUDA events) and where it goes (profile_step);
    returns the step's milliseconds."""
    from arreau_tpu_torch.train.loop import train_step
    from arreau_tpu_torch.train.optim import AdamW

    optimizer = AdamW(model.model, lambda count: 1e-3, weight_decay=1e-10)

    def one_step():
        train_step(model, optimizer, None, batch, noise)

    reset_launch_counts()
    one_step()
    first = launch_counts()
    want = {name: want_step.get(name, 0) for name in first}
    print(f"launches of one {label} step: {first}")
    if first != want:
        raise RuntimeError(f"a {label} step launched {first}, not {want}")
    step_ms = cuda_ms(one_step, runs=5)
    counts = launch_counts()
    steps = 1 + 3 + 5  # the counted step, cuda_ms's warm-up and timed steps
    if counts != {name: n * steps for name, n in want.items()}:
        raise RuntimeError(f"{steps} {label} steps launched {counts}")
    print(f"{label} training step at {tuple(batch.atom_types.shape)}: {step_ms:.4f} ms (CUDA "
          f"events, 5 steps), of which the kernels' launches {kernels_ms:.4f} ms "
          f"({kernels_ms / step_ms:.1%})")
    profile_step(one_step, step_ms)
    return step_ms, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from arreau_tpu_torch.cli import generate
    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.data.crystal import pack_dense_batch
    from arreau_tpu_torch.inference.io import concat_results, from_dense_batch
    from arreau_tpu_torch.kernels import build
    from arreau_tpu_torch.tasks.diffusion import (
        DiffusionConfig,
        DiffusionModel,
        batch_to_device,
        draw_loss_noise,
        draw_sampler_noise,
        strided_levels,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    with Phase("device"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    with Phase("build"):
        seconds = build.build_library()
        build.library()
        print(f"nvcc build: {seconds:.2f} s" if seconds else "kernel library up to date")

    z_table = synthetic_z_table()
    cfg = DiffusionConfig(num_atomic_states=len(z_table))
    model = DiffusionModel(cfg, device=dev)
    model.model.init_parameters(torch.Generator(device=dev).manual_seed(SEED))

    with Phase("serving kernels"):
        noise = draw_sampler_noise(torch.Generator(device=dev).manual_seed(SEED), 1, BATCH, ATOMS,
                                   cfg.num_atomic_states, "monoclinic", False, dev)
        with torch.inference_mode():
            inputs = first_step_inputs(model, noise)
            with capturing() as args:
                model.predict_scores(*inputs)
            serve_conv, serve_h1, _ = forward_kernel_records(args, f"serving {BATCH}x{ATOMS}")
            fwd_ms = cuda_ms(lambda: model.predict_scores(*inputs), runs=10)
            kernels_ms = cfg.num_layers * serve_conv["ms"] + serve_h1["ms"]
            print(f"forward at {BATCH}x{ATOMS}: {fwd_ms:.4f} ms (CUDA events, 10 runs), of which "
                  f"{cfg.num_layers} x spatial_conv + basis_h1 = {kernels_ms:.4f} ms")
            del args, inputs

    L = cfg.num_layers
    with Phase("sampler path"), tempfile.TemporaryDirectory() as tmp:
        meta = write_checkpoint(Path(tmp) / "ckpt", cfg, model, z_table)
        del model
        torch.cuda.empty_cache()
        sampler_counts = sampler_path(Path(tmp) / "ckpt", Path(tmp) / "out", meta, z_table, card,
                                      {"spatial_conv": L, "basis_h1": 1})

    with Phase("forward reference"):
        # one backbone forward on realistic crystals (lengths U(3, 8) angstrom,
        # angles U(75, 105) degrees): the CUDA kernel branch against the plain
        # branch on the CPU, on one neighbour list built on the CPU (the top-K
        # may pick either of two equidistant images, so two devices' graphs
        # can differ in an edge)
        B = 32
        g = torch.Generator().manual_seed(SEED + 1)
        lengths = 3.0 + 5.0 * torch.rand((B, 3), generator=g)
        angles = torch.deg2rad(75.0 + 30.0 * torch.rand((B, 3), generator=g))
        frac = torch.rand((B, ATOMS, 3), generator=g)
        types = torch.randint(0, cfg.num_atomic_states - 1, (B, ATOMS), generator=g)
        t = torch.randint(1, cfg.num_timesteps + 1, (B,), generator=g)
        # layer scale 1 (not the init's 1e-6) so the conv layers weigh in the outputs
        ref_cfg = dataclasses.replace(cfg, layer_scale=1.0)
        model = DiffusionModel(ref_cfg, device=dev)
        model.model.init_parameters(torch.Generator(device=dev).manual_seed(SEED + 1))
        plain = DiffusionModel(dataclasses.replace(ref_cfg, use_pallas=False), device="cpu")
        plain.model.load_state_dict({k: v.cpu() for k, v in model.model.state_dict().items()})
        with torch.inference_mode():
            want_in = plain._build_inputs(
                frac, torch.nn.functional.one_hot(types, cfg.num_atomic_states).float(), t,
                torch.full((B,), ATOMS), lengths, angles, torch.ones((B, ATOMS), dtype=torch.bool))
            got_in = want_in._replace(
                neighbors=type(want_in.neighbors)(*(a.to(dev) for a in want_in.neighbors)),
                **{f: getattr(want_in, f).to(dev)
                   for f in ("scalar", "vec", "atom_mask", "lattice", "ori_grid")})
            got, want = model.model(got_in), plain.model(want_in)
        print(f"{want_in.neighbors.mask.sum().item()} edges")
        for name, a, b in zip(("node scalar", "node vec", "global scalar"), got, want):
            err, scale = (a.cpu() - b).abs().max().item(), b.abs().max().item()
            print(f"{name}: kernel branch (cuda) vs plain branch (cpu), {B}x{ATOMS}: "
                  f"max_abs_err {err:.3e}, max |plain| {scale:.3e} (tolerance {KERNEL_REL_TOL:g} rel)")
            if not err <= KERNEL_REL_TOL * scale:
                raise RuntimeError(f"{name}: kernel branch disagrees with the plain branch")
        del model, plain

    # the training CLI's model at the canonical width (BASELINE.md: hidden 200,
    # basis 256, 5 layers, 16 orientations, K=8, radius 5, T=1000) with its
    # default diffuse_angles: four loss terms
    train_cfg = dataclasses.replace(cfg, hidden_dim=TRAIN_HIDDEN, diffuse_angles=True)

    with Phase("training kernels"):
        dataset, chunk, bucket = training_chunk()
        batch = batch_to_device(pack_dense_batch(dataset, chunk, bucket), dev)
        model = DiffusionModel(train_cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(SEED), batch)
        noise = draw_loss_noise(torch.Generator(device=dev).manual_seed(SEED), *batch.atom_types.shape,
                                train_cfg.num_atomic_states, train_cfg.num_timesteps, True, dev)
        with capturing() as args:
            model.loss(batch, noise)[0].backward()
        with torch.no_grad():
            conv, h1, n_valid = forward_kernel_records(args, f"training {TRAIN_BATCH}x{bucket}")
            conv_bwd, mlp_bwd = backward_kernel_records(args, n_valid)
        records = {"spatial_conv": conv, "basis_h1": h1, "spatial_conv_bwd": conv_bwd,
                   "basis_mlp_bwd": mlp_bwd}
        del args

    default_step = {"spatial_conv": L, "basis_h1": 1, "spatial_conv_bwd": L, "basis_mlp_bwd": 1}
    with Phase("training step"):
        # where one training step's time goes, at the same batch: CUDA-event
        # step time, then a torch.profiler trace of the device's kernels
        step_time(model, batch, noise, "default", default_step,
                  sum(records[k]["ms"] * n for k, n in default_step.items()))
        del model, batch, noise
        torch.cuda.empty_cache()

    with Phase("training reference"):
        training_reference(dataclasses.replace(train_cfg, layer_scale=1.0), z_table, SEED + 2,
                           KERNEL_REL_TOL)

    with Phase("training path"), tempfile.TemporaryDirectory() as tmp:
        train_counts = training_path(Path(tmp) / "ckpt", [], default_step, card)
        for name, record in records.items():
            record["launches"] = train_counts[name]
        for name in ("spatial_conv", "basis_h1"):
            records[name]["launches_sampler"] = sampler_counts[name]

        with Phase("trained sampling"):
            reset_launch_counts()
            n = 128
            ckpt = Path(tmp) / "ckpt"
            result = generate.main([
                "--checkpoint_dir", str(ckpt), "--tag", "best", "--batch_size", str(n),
                "--num_atoms_per_sample", str(ATOMS), "--num_crystals", str(n),
                "--sample_steps", str(STEPS), "--seed", str(SEED), "--out_dir", str(Path(tmp) / "out"),
                "--device", "cuda",
            ])
            counts = launch_counts()
            print(f"launches {counts}")
            forwards = len(strided_levels(train_cfg.num_timesteps, STEPS)) - 1
            if counts["spatial_conv"] != L * forwards or counts["basis_h1"] != forwards:
                raise RuntimeError("sampling from the trained checkpoint missed a kernel launch")
            meta = json.loads((ckpt / "meta.json").read_text())
            crystal_checks(result, z_table, n, ATOMS, generate.length_bounds_from_meta(meta))

    # the fused fiber conv path: the same model and shapes with fuse_fiber
    fiber_cfg = dataclasses.replace(cfg, fuse_fiber=True)
    fiber_train_cfg = dataclasses.replace(train_cfg, fuse_fiber=True)

    with Phase("fiber kernels"):
        model = DiffusionModel(fiber_cfg, device=dev)
        model.model.init_parameters(torch.Generator(device=dev).manual_seed(SEED))
        noise = draw_sampler_noise(torch.Generator(device=dev).manual_seed(SEED), 1, BATCH, ATOMS,
                                   cfg.num_atomic_states, "monoclinic", False, dev)
        with torch.inference_mode():
            inputs = first_step_inputs(model, noise)
            with capturing() as args:
                model.predict_scores(*inputs)
            [serve_fiber] = fiber_records(args, f"fiber serving {BATCH}x{ATOMS}")
            fwd_ms = cuda_ms(lambda: model.predict_scores(*inputs), runs=10)
            print(f"fuse_fiber forward at {BATCH}x{ATOMS}: {fwd_ms:.4f} ms (CUDA events, 10 runs), "
                  f"of which {L} x fiber_conv = {L * serve_fiber['ms']:.4f} ms")
            del args, inputs, model

        batch = batch_to_device(pack_dense_batch(dataset, chunk, bucket), dev)
        model = DiffusionModel(fiber_train_cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(SEED), batch)
        noise = draw_loss_noise(torch.Generator(device=dev).manual_seed(SEED), *batch.atom_types.shape,
                                train_cfg.num_atomic_states, train_cfg.num_timesteps, True, dev)
        with capturing() as args:
            model.loss(batch, noise)[0].backward()
        with torch.no_grad():
            fiber_fwd, fiber_bwd = fiber_records(args, f"fiber training {TRAIN_BATCH}x{bucket}")
        fiber_fwd["serve"] = {k: serve_fiber[k] for k in
                              ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
        records.update(fiber_conv=fiber_fwd, fiber_conv_bwd=fiber_bwd)
        del args
        model.model.zero_grad(set_to_none=True)

    with Phase("fiber sampler path"), tempfile.TemporaryDirectory() as tmp:
        sampler_model = DiffusionModel(fiber_cfg, device=dev)
        sampler_model.model.init_parameters(torch.Generator(device=dev).manual_seed(SEED))
        meta = write_checkpoint(Path(tmp) / "ckpt", fiber_cfg, sampler_model, z_table)
        del sampler_model
        counts = sampler_path(Path(tmp) / "ckpt", Path(tmp) / "out", meta, z_table, card,
                              {"fiber_conv": L})
        records["fiber_conv"]["launches_sampler"] = counts["fiber_conv"]

    with Phase("fiber training"):
        training_reference(dataclasses.replace(fiber_train_cfg, layer_scale=1.0), z_table,
                           SEED + 2, FIBER_LOSS_REL_TOL)
        _, counts = step_time(model, batch, noise, "fuse_fiber",
                              {"fiber_conv": L, "fiber_conv_bwd": L},
                              L * (fiber_fwd["ms"] + fiber_bwd["ms"]))
        for name in ("fiber_conv", "fiber_conv_bwd"):
            records[name]["launches"] = counts[name]
        del model, noise
        torch.cuda.empty_cache()

    # ---------------- the bfloat16 compute path ----------------
    bf16_cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    bf16_train_cfg = dataclasses.replace(train_cfg, compute_dtype="bfloat16")
    bf16 = dict(tol=BF16_KERNEL_REL_TOL, peak=BF16_FLOP_PER_S)
    served = ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")

    with Phase("bf16 kernels"):
        model = DiffusionModel(bf16_cfg, device=dev)
        model.model.init_parameters(torch.Generator(device=dev).manual_seed(SEED))
        noise = draw_sampler_noise(torch.Generator(device=dev).manual_seed(SEED), 1, BATCH, ATOMS,
                                   cfg.num_atomic_states, "monoclinic", False, dev)
        with torch.inference_mode():
            inputs = first_step_inputs(model, noise)
            with capturing() as args:
                model.predict_scores(*inputs)
            serve_conv, serve_h1, _ = forward_kernel_records(
                args, f"bf16 serving {BATCH}x{ATOMS}", "_bf16", **bf16)
            fwd_ms = cuda_ms(lambda: model.predict_scores(*inputs), runs=10)
            print(f"bf16 forward at {BATCH}x{ATOMS}: {fwd_ms:.4f} ms (CUDA events, 10 runs), of "
                  f"which {L} x spatial_conv_bf16 + basis_h1_bf16 = "
                  f"{L * serve_conv['ms'] + serve_h1['ms']:.4f} ms")
            del args, inputs, model

        batch = batch_to_device(pack_dense_batch(dataset, chunk, bucket), dev)
        model = DiffusionModel(bf16_train_cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(SEED), batch)
        noise = draw_loss_noise(torch.Generator(device=dev).manual_seed(SEED), *batch.atom_types.shape,
                                train_cfg.num_atomic_states, train_cfg.num_timesteps, True, dev)
        with capturing() as args:
            model.loss(batch, noise)[0].backward()
        with torch.no_grad():
            conv16, h116, n_valid = forward_kernel_records(
                args, f"bf16 training {TRAIN_BATCH}x{bucket}", "_bf16", **bf16)
            bwd16 = backward_kernel_records(args, n_valid, "_bf16", **bf16)
        conv16["serve"] = {k: serve_conv[k] for k in served}
        h116["serve"] = {k: serve_h1[k] for k in served}
        for record in (conv16, h116, *bwd16):
            records[record["name"]] = record
        del args
        model.model.zero_grad(set_to_none=True)

    with Phase("bf16 training reference"):
        ref_cfg = dataclasses.replace(bf16_train_cfg, layer_scale=1.0)
        training_reference(ref_cfg, z_table, SEED + 2, BF16_LOSS_REL_TOL, BF16_GRAD_REL_TOL)
        print("-- with fuse_convnext (#9/#10 on the card)")
        training_reference(ref_cfg, z_table, SEED + 2, BF16_LOSS_REL_TOL, BF16_GRAD_REL_TOL,
                           fuse_convnext=True)

    with Phase("bf16 training path"), tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "ckpt"
        counts = training_path(ckpt, ["--compute_dtype", "bfloat16"], default_step, card)
        for name in default_step:
            records[name + "_bf16"]["launches"] = counts[name]
        kernels_ms = sum(records[k + "_bf16"]["ms"] * n for k, n in default_step.items())
        step_time(model, batch, noise, "bf16", default_step, kernels_ms)
        del model, noise
        torch.cuda.empty_cache()

        with Phase("bf16 sampler path"):
            meta = json.loads((ckpt / "meta.json").read_text())
            if meta["config"]["compute_dtype"] != "bfloat16":
                raise RuntimeError("the bf16 training run's meta.json lost its compute_dtype")
            counts = sampler_path(ckpt, Path(tmp) / "out", meta, z_table, card,
                                  {"spatial_conv": L, "basis_h1": 1}, tag="best")
            for name in ("spatial_conv", "basis_h1"):
                records[name + "_bf16"]["launches_sampler"] = counts[name]

    # ---------------- the fused ConvNext MLP (fuse_convnext, bfloat16) ----------------
    with Phase("convnext kernels"):
        # layer scale 1 (not the init's 1e-6): with gamma ~ 1e-6, gamma * m is
        # below half a bf16 ulp of res, so out would equal res whatever the MLP
        # computed and no check below could see it
        model = DiffusionModel(dataclasses.replace(bf16_cfg, layer_scale=1.0), device=dev)
        model.model = fused_convnext_backbone(model)
        model.model.init_parameters(torch.Generator(device=dev).manual_seed(SEED))
        noise = draw_sampler_noise(torch.Generator(device=dev).manual_seed(SEED), 1, BATCH, ATOMS,
                                   cfg.num_atomic_states, "monoclinic", False, dev)
        with torch.inference_mode():
            inputs = first_step_inputs(model, noise)
            with capturing() as args:
                model.predict_scores(*inputs)
            [serve_cn] = convnext_records(args, f"convnext serving {BATCH}x{ATOMS}", **bf16)
            fwd_ms = cuda_ms(lambda: model.predict_scores(*inputs), runs=10)
            print(f"fuse_convnext bf16 forward at {BATCH}x{ATOMS}: {fwd_ms:.4f} ms (CUDA events, "
                  f"10 runs), of which {L} x convnext_mlp = {L * serve_cn['ms']:.4f} ms")
            del args, inputs, model

        model = DiffusionModel(dataclasses.replace(bf16_train_cfg, layer_scale=1.0), device=dev)
        model.model = fused_convnext_backbone(model)
        model.init(torch.Generator(device=dev).manual_seed(SEED), batch)
        noise = draw_loss_noise(torch.Generator(device=dev).manual_seed(SEED), *batch.atom_types.shape,
                                train_cfg.num_atomic_states, train_cfg.num_timesteps, True, dev)
        with capturing() as args:
            model.loss(batch, noise)[0].backward()
        with torch.no_grad():
            cn_fwd, cn_bwd = convnext_records(args, f"convnext training {TRAIN_BATCH}x{bucket}",
                                              **bf16)
            print("-- the float32 instantiation on the same values")
            f32_args = {k: tuple(t.float() if torch.is_tensor(t) else t for t in v)
                        for k, v in args.items() if k.startswith("convnext")}
            cn_fwd32, cn_bwd32 = convnext_records(
                f32_args, f"convnext float32 {TRAIN_BATCH}x{bucket}", KERNEL_REL_TOL,
                FP32_FLOP_PER_S)
        cn_fwd["serve"] = {k: serve_cn[k] for k in served}
        cn_fwd["float32"] = {k: cn_fwd32[k] for k in served}
        cn_bwd["float32"] = {k: cn_bwd32[k] for k in served}
        records.update(convnext_mlp=cn_fwd, convnext_mlp_bwd=cn_bwd)
        del args
        model.model.zero_grad(set_to_none=True)

    with Phase("fuse_convnext path"):
        want_cn_step = {"convnext_mlp": L, "convnext_mlp_bwd": L, "spatial_conv": L,
                        "spatial_conv_bwd": L, "basis_h1": 1, "basis_mlp_bwd": 1}
        kernels_ms = L * (cn_fwd["ms"] + cn_bwd["ms"]) + sum(
            records[k + "_bf16"]["ms"] * n for k, n in default_step.items())
        _, counts = step_time(model, batch, noise, "fuse_convnext bf16", want_cn_step, kernels_ms)
        for name in ("convnext_mlp", "convnext_mlp_bwd"):
            records[name]["launches"] = counts[name]
        del model, batch, noise
        torch.cuda.empty_cache()

        # the sampler through DiffusionModel.sample (generate reads its
        # backbone from meta.json, which has no fuse_convnext, as in the JAX
        # package): CRYSTALS crystals in batches of BATCH x ATOMS, STEPS steps
        sampler = DiffusionModel(bf16_cfg, device=dev)
        sampler.model = fused_convnext_backbone(sampler)
        sampler.model.init_parameters(torch.Generator(device=dev).manual_seed(SEED))
        bounds = generate.length_bounds_from_meta({"length_stats": {"min": 3.0, "max": 8.0}})
        gen = torch.Generator(device=dev).manual_seed(SEED)
        reset_launch_counts()
        t0 = time.perf_counter()
        results = []
        for _ in range(CRYSTALS // BATCH):
            out = sampler.sample(BATCH, ATOMS, generator=gen, sample_steps=STEPS,
                                 length_bounds=bounds)
            results.append(from_dense_batch(out, z_table))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        forwards = (CRYSTALS // BATCH) * (len(strided_levels(cfg.num_timesteps, STEPS)) - 1)
        want = {name: 0 for name in counts}
        want.update(convnext_mlp=L * forwards, spatial_conv=L * forwards, basis_h1=forwards)
        print(f"forwards {forwards}: launches {counts}")
        if counts != want:
            raise RuntimeError(f"the fuse_convnext sampler launched {counts}, not {want}")
        crystal_checks(concat_results(results), z_table, CRYSTALS, ATOMS, bounds)
        records["convnext_mlp"]["launches_sampler"] = counts["convnext_mlp"]
        print(f"fuse_convnext sampler: {CRYSTALS} crystals in {wall:.2f} s wall, first batch "
              f"included ({CRYSTALS / wall * 60:.0f} crystals/min on {card})")
        del sampler

    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
