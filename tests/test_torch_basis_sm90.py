"""The #8 / #7 kernels on Hopper's wgmma and TMA (bfloat16:
``arreau_tpu_torch/csrc/basis_sm90.cuh``; float32, 3xTF32 on tf32 wgmma:
``csrc/basis_f32_sm90.cuh``), on the CPU: the wrapper's host-side plan
(``kernels/basis_h1.sm90_plan``) as a pure function in both types, and numpy
emulations of #7's bfloat16 chain and of #8's and #7's float32 chains in the
kernels' order and rounding points, held against the plain versions
(``basis_h1_plain`` / ``basis_mlp_bwd_plain``) and against the JAX package's
Pallas kernels ``_h1_fwd`` / ``_multi_bwd`` in interpret mode.

The bfloat16 emulation follows the kernels step by step: the features formed
in float32 and rounded to bfloat16; every product summed in float32 a k16
product step at a time (the wgmma steps; inside a step in float64, which a
tensor core's exact products and float32 sums approach to within float32
rounding); h1_pre, h1, gelu'(h1_pre), h2_pre, gelu'(h2_pre), dpre2 and
dpre1 rounded to bfloat16 where ``rows_kernel`` rounds them; the cotangents
summed in float32 in their order; the weight gradients split over the rows
(``per_split`` rows a split, given by the test), each split's float32
partial summed over 64-row panels, and the partials added in split order
(``sum_splits_kernel``).

The float32 emulation follows ``basis_f32_sm90.cuh``: the features formed in
float32 as ``(x_a * x_b) * x_c``; every product 3xTF32 in k8 steps (tf32
halves rounded as ``cvt.rna.tf32``, ``mma.cuh:to_tf32``; a_small b_big +
a_big b_small + a_big b_big a step, summed in float64 inside the step and
added to the float32 sum); h1_pre + b1 after the product; dpre2 = (the
cotangents summed in their order) * gelu'(gelu(h1_pre) @ W2 + b2); dpre1 =
(dpre2 @ W2^T) * gelu'(h1_pre); the weight gradients over splits of
``per_split`` rows added in split order, nothing rounded between.

Tolerances, each of an output's largest magnitude: bfloat16 against the
plain version 1e-4 (both round at the same points and sum in float32 in
other orders; a value next to a bfloat16 rounding boundary may round the
other way, one ulp of 2^-8, and carry into a sum over the 300 rows; the
emulation came within 5e-7); against the Pallas kernel 2e-2 (the JAX kernel
evaluates GELU and its derivative on bfloat16 arrays step by step, the port
in float32 rounded once, and it returns the weight gradients rounded to
bfloat16: the plain version differs from it by the same amounts, up to
1.05e-2 on these inputs, where ``tests/test_torch_bf16.py`` holds the two
within 1e-2 on 240 rows). Float32 against both 1e-4, the card's gate
(``chip_smoke.KERNEL_REL_TOL``): 3xTF32 keeps ~2^-22 of each product, and
the sums run in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.ops.pallas_basis import _h1_fwd, _multi_bwd, poly_selection_matrices
from arreau_tpu_torch.kernels.basis_h1 import (
    SM90_BASIS,
    SM90_HIDDEN,
    SMEM_BUDGET,
    basis_h1_plain,
    kernel_plan,
    sm90_plan,
)
from arreau_tpu_torch.kernels.basis_mlp import basis_mlp_bwd_plain

PLAIN_REL_TOL = 1e-4
PALLAS_REL_TOL = 2e-2
_GELU_C0 = np.float32(0.7978845608028654)
_GELU_C1 = np.float32(0.044715)


# ---------------- the tile plan ----------------


def test_sm90_plan_at_the_training_shape():
    """The training cell (B'=32, O=16, E=1024: 524288 rows; F=258, H=200,
    D=256): H in the 208 class, D in the 256 class, the weights' K padded to
    whole 128-byte panels (64 bfloat16 or 32 float32 elements), 128 splits of
    4096 rows in both types, bfloat16 #8's rows written by TMA. Float32 keeps
    the weights' copies at the width class's rows (the kernels split them into
    tf32 halves), its row-major scratch rows H and D rounded up to 4, and two
    ring slots in every kernel (both warpgroups' A panels and B split in
    halves, ~84 or 96 KB a slot)."""
    plan = sm90_plan(32 * 16 * 1024, 258, 200, 256)
    assert plan == {"nh": 208, "kw1": 320, "tma_store": True, "w1t": 200 * 320, "nd": 256,
                    "kw2": 256, "kw3": 256, "ld": 524288, "splits": 128, "per_split": 4096,
                    "w2t": 256 * 256, "w2c": 200 * 256}
    f32 = sm90_plan(32 * 16 * 1024, 258, 200, 256, torch.float32)
    assert f32 == {"nh": 208, "kw1": 288, "tma_store": True, "w1t": 208 * 288,
                   "h_stages": 2, "h_smem": 173056, "nd": 256, "kw2": 224, "kw3": 256,
                   "ld": 524288, "splits": 128, "per_split": 4096, "w2t": 256 * 224,
                   "w2c": 208 * 256, "hp": 200, "dp": 256, "d_stages": 2, "d_smem": 197632}


# (rows, F, H, D): the training, serving and flagship cells, N-body, MNIST,
# the card tests' ragged shapes, and widths at the classes' edges
PLAN_SHAPES = [(524288, 258, 200, 256), (131072, 258, 200, 256), (102400, 258, 200, 256),
               (40000, 14, 128, 256), (576000, 14, 64, 128), (102, 6, 33, 37),
               (600, 30, 70, 20), (34, 258, 70, 64), (600, 155, 33, 37), (1, 1, 1, 1),
               (65, 584, 256, 256), (129, 258, 208, 129), (4097, 64, 65, 128),
               (300, 258, 20, 12)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,F,H,D", PLAN_SHAPES)
def test_sm90_plan_covers_every_shape(dtype, rows, F, H, D):
    """What the kernels rely on: one accumulator holds all of H and of D (a
    width class, a multiple of 16 up to 256); the weights' K-major copies have
    whole K-panels and rows of 128-byte multiples (TMA addresses them), and as
    many elements as the kernels read (float32: the width class's rows); the
    transposed bfloat16 scratch rows are whole 64-row panels, float32's
    row-major scratch rows 16-byte multiples; float32's kernels fit their
    shared memory with 2 to 8 ring slots; the splits cover
    the rows in whole 64-row panels, none empty and none reaching into the
    next, at most 256; bfloat16 #8's rows go by TMA exactly where their 2H
    bytes are a multiple of 16; and the kernels are given these very values
    (the ``BasisPlan`` the wrappers pass, which the launches check)."""
    p = sm90_plan(rows, F, H, D, dtype)
    f32 = dtype == torch.float32
    pk = 32 if f32 else 64
    assert p["nh"] in SM90_HIDDEN and H <= p["nh"] and p["nh"] % 16 == 0
    assert p["nd"] in SM90_BASIS and D <= p["nd"] and p["nd"] % 16 == 0
    assert SM90_HIDDEN.index(p["nh"]) == 0 or H > SM90_HIDDEN[SM90_HIDDEN.index(p["nh"]) - 1]
    for k, n in (("kw1", F), ("kw2", H), ("kw3", D)):
        assert p[k] % pk == 0 and n <= p[k] < n + pk and p[k] * (4 if f32 else 2) % 128 == 0
    for k, kw, n, nb in (("w1t", "kw1", H, "nh"), ("w2t", "kw2", D, "nd"), ("w2c", "kw3", H, "nh")):
        assert p[k] == (p[nb] if f32 else n) * p[kw]
    assert p["ld"] % 64 == 0 and rows <= p["ld"] < rows + 64
    if f32:
        assert p["hp"] % 4 == 0 and H <= p["hp"] < H + 4 and p["dp"] % 4 == 0 and D <= p["dp"] < D + 4
        for stages, smem, n in (("h_stages", "h_smem", "nh"), ("d_stages", "d_smem", "nd")):
            assert 2 <= p[stages] <= 8 and p[smem] <= SMEM_BUDGET
            assert p[smem] == 1024 + p[stages] * (4 * 8192 + 2 * p[n] * 128)
    assert p["per_split"] % 64 == 0
    assert p["splits"] * p["per_split"] >= rows > (p["splits"] - 1) * p["per_split"]
    assert p["splits"] <= 256
    assert p["tma_store"] == (2 * H % 16 == 0)
    plan = kernel_plan(rows, F, H, D, dtype)
    assert {name: getattr(plan, name) for name, _ in plan._fields_} == {
        name: int(p.get(name, 0)) for name, _ in plan._fields_}


@pytest.mark.parametrize("rows,F,H,splits,per_split", [
    (524288, 258, 200, 128, 4096), (131072, 258, 200, 128, 1024), (102400, 258, 200, 124, 832),
    (40000, 14, 128, 209, 192), (576000, 14, 64, 250, 2304), (300, 258, 20, 5, 64)])
def test_sm90_plan_splits_fill_the_card(rows, F, H, splits, per_split):
    """The weight gradients' splits, one rule for both types and both
    products: ~4096 rows a split at the training shape (128 splits, as
    before), and where that would leave fewer than ~256 blocks of the
    smaller product (one 128-row block of H + 1 or F + 1 a split at the
    N-body and MNIST shapes: 10 and 141 splits by rows alone), up to 256
    splits of whole 64-row panels."""
    for dtype in (torch.bfloat16, torch.float32):
        p = sm90_plan(rows, F, H, 256, dtype)
        assert (p["splits"], p["per_split"]) == (splits, per_split)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,D", [(257, 128), (64, 257)])
def test_sm90_plan_refuses_widths_past_one_accumulator(dtype, H, D):
    """H or D above 256 (wgmma's widest N) has no width class: the plan, and
    so the wrappers on the card, raise in both types."""
    with pytest.raises(ValueError, match="<= 256"):
        sm90_plan(1000, 258, H, D, dtype)


# ---------------- the build ----------------


SM90_SOURCES = ("basis_h1_sm90.cu", "basis_mlp_bwd_sm90.cu", "basis_rows128_sm90.cu",
                "basis_rows256_sm90.cu", "wgmma_product.cu", "basis_h1_f32_sm90.cu",
                "basis_rows_f32_sm90.cu", "basis_dw_f32_sm90.cu")


@pytest.mark.parametrize("edited", ["wgmma.cuh", "basis_sm90.cuh", "basis_f32_sm90.cuh",
                                    *SM90_SOURCES])
def test_build_takes_the_sm90_sources_and_hashes_their_headers(edited, tmp_path, monkeypatch):
    """The build compiles the wgmma sources (one nvcc process each, so that
    rows_kernel's and the float32 passes' instantiations compile in
    parallel), and the float32 #8 and #7 sources of the mma.sync tile
    products are gone; an edit of any of
    them or of their headers changes the source hash, so a stale library is
    rebuilt."""
    import shutil

    from arreau_tpu_torch.kernels import build

    names = {p.name for p in build._sources()}
    assert set(SM90_SOURCES) <= names and not {"basis_h1.cu", "basis_mlp_bwd.cu"} & names
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._source_hash()
    (csrc / edited).write_text((csrc / edited).read_text() + "\n")
    assert build._source_hash() != before


# ---------------- #7's chain, emulated ----------------


def _bf16(a):
    """float32 values rounded to bfloat16 (round to nearest even), kept as
    float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _steps(a, b, step=16):
    """a [M, K] @ b [K, N] summed in float32 one k16 step at a time."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], step):
        acc = (acc + a[:, k:k + step].astype(np.float64) @ b[k:k + step].astype(np.float64)
               ).astype(np.float32)
    return acc


def _gelu_and_deriv(x):
    x = x.astype(np.float32)
    t = np.tanh(_GELU_C0 * (x + _GELU_C1 * x * x * x)).astype(np.float32)
    value = np.float32(0.5) * x * (np.float32(1) + t)
    deriv = (np.float32(0.5) * (np.float32(1) + t) + np.float32(0.5) * x * (np.float32(1) - t * t)
             * _GELU_C0 * (np.float32(1) + np.float32(3) * _GELU_C1 * x * x))
    return value.astype(np.float32), deriv.astype(np.float32)


def _poly(attrT, degree):
    """[rows, F] features of lane-major attrT [B', O, d, E] in
    polynomial_features' order, (x_i * x_j) * x_k in float32, rounded to bfloat16."""
    Bp, O, d, E = attrT.shape
    x = attrT.transpose(0, 1, 3, 2).reshape(-1, d).astype(np.float32)
    parts = [x]
    if degree >= 2:
        parts.append((x[:, :, None] * x[:, None, :]).reshape(-1, d * d))
    if degree >= 3:
        parts.append(((x[:, :, None] * x[:, None, :])[:, :, :, None]
                      * x[:, None, None, :]).reshape(-1, d ** 3))
    return _bf16(np.concatenate(parts, axis=1))


def emulate_sm90_bwd(attrT, w1, b1, w2, b2, degree, gs, per_split):
    """(dw1, db1, dw2, db2) as the bfloat16 kernels compute them (see the
    module docstring), every input float32 holding bfloat16 values."""
    D = w2.shape[1]
    poly = _poly(attrT, degree)
    rows = poly.shape[0]
    h1_pre = _bf16(_steps(poly, w1) + b1)
    h1, dg1 = (_bf16(v) for v in _gelu_and_deriv(h1_pre))
    h2_pre = _bf16(_steps(h1, w2) + b2)
    g = gs[0].reshape(rows, D).astype(np.float32)
    for gi in gs[1:]:
        g = (g + gi.reshape(rows, D)).astype(np.float32)
    dpre2 = _bf16(g * _bf16(_gelu_and_deriv(h2_pre)[1]))
    dpre1 = _bf16(_steps(dpre2, w2.T) * dg1)
    ones = np.ones((rows, 1), np.float32)

    def split_k(a, b):
        """sum over the rows of a^T b: per split, 64-row panels in k16 steps."""
        total = None
        for k0 in range(0, rows, per_split):
            part = _steps(a[k0:k0 + per_split].T, b[k0:k0 + per_split])
            total = part if total is None else (total + part).astype(np.float32)
        return total

    dw1_ext = split_k(np.concatenate([poly, ones], axis=1), dpre1)
    dw2_ext = split_k(np.concatenate([h1, ones], axis=1), dpre2)
    return dw1_ext[:-1], dw1_ext[-1], dw2_ext[:-1], dw2_ext[-1]


def _rel(got, want):
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert scale > 0
    return np.abs(np.asarray(got, np.float32) - want).max() / scale


def _chain_case(degree, n_g):
    """(emulated, plain, Pallas) (dw1, db1, dw2, db2) of
    test_emulated_sm90_chain_matches_plain_and_pallas's case, as float32
    numpy arrays."""
    rng = np.random.default_rng(40 + degree + n_g)
    Bp, O, d, E, H, D = 2, 3, 6, 50, 20, 12
    F = sum(d**i for i in range(1, degree + 1))
    attrT = _bf16(rng.normal(size=(Bp, O, d, E)))
    w1, b1 = _bf16(rng.normal(size=(F, H)) * 0.1), _bf16(rng.normal(size=(H,)) * 0.3)
    w2, b2 = _bf16(rng.normal(size=(H, D)) * 0.3), _bf16(rng.normal(size=(D,)) * 0.3)
    gs = [_bf16(rng.normal(size=(Bp, O, E, D))) for _ in range(n_g)]
    got = emulate_sm90_bwd(attrT, w1, b1, w2, b2, degree, gs, per_split=128)

    def t16(a):
        return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)

    plain = basis_mlp_bwd_plain(t16(attrT), t16(w1), t16(b1), t16(w2), t16(b2), degree,
                                [t16(g) for g in gs])
    j = [jnp.asarray(a, jnp.bfloat16) for a in (attrT, w1, b1, w2, b2)]
    pallas = _multi_bwd(*j, poly_selection_matrices(d, degree),
                        [jnp.asarray(g, jnp.bfloat16) for g in gs])
    return ([np.asarray(a, np.float32) for a in got], [p.numpy() for p in plain],
            [np.asarray(q.astype(jnp.float32)) for q in pallas])


# runs _chain_case in a fresh interpreter (argv: degree, n_g, the .npz to write),
# with JAX's float64 on and one torch thread, as a test session without
# other tests before it
_FRESH = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[4])
import test_torch_basis_sm90 as t
got, plain, pallas = t._chain_case(int(sys.argv[1]), int(sys.argv[2]))
np.savez(sys.argv[3], *got, *plain, *pallas)
"""


@pytest.mark.parametrize("degree,n_g", [(3, 3), (2, 1), (3, 5)])
def test_emulated_sm90_chain_matches_plain_and_pallas(degree, n_g, tmp_path):
    """#7's bfloat16 chain, emulated over 300 edge rows (d = 6: F = 258 or
    42; H = 20, D = 12; three splits of 128 rows), against basis_mlp_bwd_plain
    and against _multi_bwd in Pallas interpret mode, at the tolerances above.
    The three are computed in a fresh interpreter (``_FRESH``), so that no
    state another test left in this process (thread pools, JAX's float64
    switch, allocations) reaches their roundings."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    out = tmp_path / "chain.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(tests.parent), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _FRESH, str(degree), str(n_g), str(out), str(tests)],
                   check=True, env=env, timeout=300)
    with np.load(out) as f:
        arrays = [f[f"arr_{i}"] for i in range(12)]
    got, plain, pallas = arrays[:4], arrays[4:8], arrays[8:]
    for name, a, p, q in zip(("dw1", "db1", "dw2", "db2"), got, plain, pallas):
        assert a.shape == p.shape, name
        assert _rel(a, p) <= PLAIN_REL_TOL, name
        assert _rel(a, q) <= PALLAS_REL_TOL, name


# ---------------- #8's and #7's float32 chains, emulated ----------------


def _tf32(v):
    """cvt.rna.tf32.f32 on the bits (mma.cuh:to_tf32)."""
    bits = (np.asarray(v, np.float32).view(np.uint32).astype(np.uint64) + 0x1000) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32)


def _steps_3xtf32(a, b):
    """a [M, K] @ b [K, N] as tf32 wgmma adds it in 3xTF32: one k8 step at a
    time, a_small b_big + a_big b_small + a_big b_big (in float64 inside the
    step) added to the float32 sum."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ab, bb = _tf32(a), _tf32(b)
    asml, bsml = _tf32(a - ab), _tf32(b - bb)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        ks = slice(k, k + 8)
        part = (asml[:, ks].astype(np.float64) @ bb[ks].astype(np.float64)
                + ab[:, ks].astype(np.float64) @ bsml[ks].astype(np.float64)
                + ab[:, ks].astype(np.float64) @ bb[ks].astype(np.float64))
        acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _poly_f32(attrT, degree):
    """[rows, F] features in float32, (x_i * x_j) * x_k, nothing rounded."""
    d = attrT.shape[2]
    x = attrT.transpose(0, 1, 3, 2).reshape(-1, d).astype(np.float32)
    parts = [x]
    if degree >= 2:
        parts.append((x[:, :, None] * x[:, None, :]).reshape(-1, d * d))
    if degree >= 3:
        parts.append(((x[:, :, None] * x[:, None, :])[:, :, :, None]
                      * x[:, None, None, :]).reshape(-1, d ** 3))
    return np.concatenate(parts, axis=1)


def emulate_f32_h1(attrT, w1, b1, degree):
    """#8 in float32 (f32_h1_kernel): poly @ W1 in 3xTF32 k8 steps, then + b1."""
    return (_steps_3xtf32(_poly_f32(attrT, degree), w1) + b1).astype(np.float32)


def emulate_f32_bwd(attrT, w1, b1, w2, b2, degree, gs, per_split):
    """(dw1, db1, dw2, db2) as #7's five float32 passes compute them (see the
    module docstring)."""
    D = w2.shape[1]
    poly = _poly_f32(attrT, degree)
    rows = poly.shape[0]
    h1_pre = emulate_f32_h1(attrT, w1, b1, degree)
    h1 = _gelu_and_deriv(h1_pre)[0]
    g = gs[0].reshape(rows, D).astype(np.float32)
    for gi in gs[1:]:
        g = (g + gi.reshape(rows, D)).astype(np.float32)
    h2_pre = (_steps_3xtf32(h1, w2) + b2).astype(np.float32)
    dpre2 = (g * _gelu_and_deriv(h2_pre)[1]).astype(np.float32)
    dpre1 = (_steps_3xtf32(dpre2, w2.T) * _gelu_and_deriv(h1_pre)[1]).astype(np.float32)
    ones = np.ones((rows, 1), np.float32)

    def split_k(a, b):
        """sum over the rows of a^T b: each split's partial in k8 steps over its
        rows, the partials added in split order."""
        total = np.zeros((a.shape[1], b.shape[1]), np.float32)
        for k0 in range(0, rows, per_split):
            total = (total + _steps_3xtf32(a[k0:k0 + per_split].T, b[k0:k0 + per_split])
                     ).astype(np.float32)
        return total

    dw1_ext = split_k(np.concatenate([poly, ones], axis=1), dpre1)
    dw2_ext = split_k(np.concatenate([h1, ones], axis=1), dpre2)
    return dw1_ext[:-1], dw1_ext[-1], dw2_ext[:-1], dw2_ext[-1]


F32_REL_TOL = 1e-4


@pytest.mark.parametrize("degree,n_g", [(3, 3), (2, 1), (1, 5), (3, 1)])
def test_emulated_f32_chains_match_plain_and_pallas(degree, n_g):
    """#8's and #7's float32 chains, emulated over 300 edge rows (d = 6: F =
    258, 42 or 6; H = 20, D = 12; three splits of 128 rows; one to five
    cotangents), against basis_h1_plain / basis_mlp_bwd_plain and against
    _h1_fwd / _multi_bwd in Pallas interpret mode, within F32_REL_TOL of
    each output's scale."""
    rng = np.random.default_rng(60 + degree + n_g)
    Bp, O, d, E, H, D = 2, 3, 6, 50, 20, 12
    F = sum(d**i for i in range(1, degree + 1))
    f32 = np.float32
    attrT = rng.normal(size=(Bp, O, d, E)).astype(f32)
    w1, b1 = (rng.normal(size=(F, H)) * 0.1).astype(f32), (rng.normal(size=(H,)) * 0.3).astype(f32)
    w2, b2 = (rng.normal(size=(H, D)) * 0.3).astype(f32), (rng.normal(size=(D,)) * 0.3).astype(f32)
    gs = [rng.normal(size=(Bp, O, E, D)).astype(f32) for _ in range(n_g)]
    h1 = emulate_f32_h1(attrT, w1, b1, degree)
    got = emulate_f32_bwd(attrT, w1, b1, w2, b2, degree, gs, per_split=128)

    t = [torch.tensor(a) for a in (attrT, w1, b1, w2, b2)]
    plain_h1 = basis_h1_plain(*t[:3], degree).reshape(-1, H).numpy()
    plain = basis_mlp_bwd_plain(*t, degree, [torch.tensor(g) for g in gs])
    j = [jnp.asarray(a) for a in (attrT, w1, b1, w2, b2)]
    sels = poly_selection_matrices(d, degree)
    pallas_h1 = np.asarray(_h1_fwd(j[0], j[1], j[2], sels)).reshape(-1, H)
    pallas = _multi_bwd(*j, sels, [jnp.asarray(g) for g in gs])
    assert _rel(h1, plain_h1) <= F32_REL_TOL
    assert _rel(h1, pallas_h1) <= F32_REL_TOL
    for name, a, p, q in zip(("dw1", "db1", "dw2", "db2"), got, plain, pallas):
        assert a.shape == tuple(p.shape), name
        assert _rel(a, p.numpy()) <= F32_REL_TOL, name
        assert _rel(a, np.asarray(q)) <= F32_REL_TOL, name
