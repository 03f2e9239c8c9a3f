"""The bfloat16 #8 / #7 kernels on Hopper's wgmma and TMA
(``arreau_tpu_torch/csrc/basis_sm90.cuh``), on the CPU: the wrapper's
host-side tile plan (``kernels/basis_h1.sm90_plan``) as a pure function, and
a numpy emulation of #7's chain in the kernels' order and rounding points
held against the plain version (``basis_mlp_bwd_plain``) and against the
JAX package's Pallas kernel ``_multi_bwd`` in interpret mode.

The emulation follows the kernels step by step: the features formed in
float32 and rounded to bfloat16; every product summed in float32 a k16
product step at a time (the wgmma steps; inside a step in float64, which a
tensor core's exact products and float32 sums approach to within float32
rounding); h1_pre, h1, gelu'(h1_pre), h2_pre, gelu'(h2_pre), dpre2 and
dpre1 rounded to bfloat16 where ``rows_kernel`` rounds them; the cotangents
summed in float32 in their order; the weight gradients split over the rows
as the plan splits them, each split's float32 partial summed over 64-row
panels, and the partials added in split order (``sum_splits_kernel``).

Tolerances, each of an output's largest magnitude: against the plain
version 1e-4 (both round at the same points and sum in float32 in other
orders; a value next to a bfloat16 rounding boundary may round the other
way, one ulp of 2^-8, and carry into a sum over the 300 rows; the
emulation came within 5e-7); against the Pallas kernel 2e-2 (the JAX kernel
evaluates GELU and its derivative on bfloat16 arrays step by step, the port
in float32 rounded once, and it returns the weight gradients rounded to
bfloat16: the plain version differs from it by the same amounts, up to
1.05e-2 on these inputs, where ``tests/test_torch_bf16.py`` holds the two
within 1e-2 on 240 rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.ops.pallas_basis import _multi_bwd, poly_selection_matrices
from arreau_tpu_torch.kernels.basis_h1 import SM90_BASIS, SM90_HIDDEN, sm90_plan
from arreau_tpu_torch.kernels.basis_mlp import basis_mlp_bwd_plain

PLAIN_REL_TOL = 1e-4
PALLAS_REL_TOL = 2e-2
_GELU_C0 = np.float32(0.7978845608028654)
_GELU_C1 = np.float32(0.044715)


# ---------------- the tile plan ----------------


def test_sm90_plan_at_the_training_shape():
    """The training cell (B'=32, O=16, E=1024: 524288 rows; F=258, H=200,
    D=256): H in the 208 class, D in the 256 class, the weights' K padded to
    whole 64-element panels, 128 splits of 4096 rows, #8's rows written by TMA."""
    plan = sm90_plan(32 * 16 * 1024, 258, 200, 256)
    assert plan == {"nh": 208, "kw1": 320, "tma_store": True, "nd": 256, "kw2": 256,
                    "kw3": 256, "ld": 524288, "splits": 128, "per_split": 4096}


# (rows, F, H, D): the training, serving and flagship cells, N-body, MNIST,
# the card tests' ragged shapes, and widths at the classes' edges
PLAN_SHAPES = [(524288, 258, 200, 256), (131072, 258, 200, 256), (102400, 258, 200, 256),
               (40000, 14, 128, 256), (576000, 14, 64, 128), (102, 6, 33, 37),
               (600, 30, 70, 20), (34, 258, 70, 64), (600, 155, 33, 37), (1, 1, 1, 1),
               (65, 584, 256, 256), (129, 258, 208, 129), (4097, 64, 65, 128),
               (300, 258, 20, 12)]


@pytest.mark.parametrize("rows,F,H,D", PLAN_SHAPES)
def test_sm90_plan_covers_every_shape(rows, F, H, D):
    """What the kernels rely on: one accumulator holds all of H and of D (a
    width class, a multiple of 16 up to 256); the weights' K-major copies have
    whole 64-element panels and rows of 128-byte multiples (TMA addresses
    them); the transposed scratch rows are whole panels too; the splits cover
    the rows in whole 64-row panels, none empty and none reaching into the
    next; #8's rows go by TMA exactly where their 2H bytes are a multiple of 16."""
    p = sm90_plan(rows, F, H, D)
    assert p["nh"] in SM90_HIDDEN and H <= p["nh"] and p["nh"] % 16 == 0
    assert p["nd"] in SM90_BASIS and D <= p["nd"] and p["nd"] % 16 == 0
    assert SM90_HIDDEN.index(p["nh"]) == 0 or H > SM90_HIDDEN[SM90_HIDDEN.index(p["nh"]) - 1]
    for k, n in (("kw1", F), ("kw2", H), ("kw3", D)):
        assert p[k] % 64 == 0 and n <= p[k] < n + 64 and 2 * p[k] % 128 == 0
    assert p["ld"] % 64 == 0 and rows <= p["ld"] < rows + 64
    assert p["per_split"] % 64 == 0
    assert p["splits"] * p["per_split"] >= rows > (p["splits"] - 1) * p["per_split"]
    assert p["splits"] <= 256
    assert p["tma_store"] == (2 * H % 16 == 0)


@pytest.mark.parametrize("H,D", [(257, 128), (64, 257)])
def test_sm90_plan_refuses_widths_past_one_accumulator(H, D):
    """H or D above 256 (wgmma's widest N) has no width class: the plan, and
    so the bfloat16 wrappers on the card, raise."""
    with pytest.raises(ValueError, match="<= 256"):
        sm90_plan(1000, 258, H, D)


# ---------------- the build ----------------


SM90_SOURCES = ("basis_h1_sm90.cu", "basis_mlp_bwd_sm90.cu", "basis_rows128_sm90.cu",
                "basis_rows256_sm90.cu", "wgmma_product.cu")


@pytest.mark.parametrize("edited", ["wgmma.cuh", "basis_sm90.cuh", *SM90_SOURCES])
def test_build_takes_the_sm90_sources_and_hashes_their_headers(edited, tmp_path, monkeypatch):
    """The build compiles the wgmma sources (one nvcc process each, so that
    rows_kernel's instantiations compile in parallel), and an edit of any of
    them or of their headers changes the source hash, so a stale library is
    rebuilt."""
    import shutil

    from arreau_tpu_torch.kernels import build

    assert set(SM90_SOURCES) <= {p.name for p in build._sources()}
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


def emulate_sm90_bwd(attrT, w1, b1, w2, b2, degree, gs, rows_per_split):
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
    plan = sm90_plan(rows, poly.shape[1], w1.shape[1], D, rows_per_split=rows_per_split)
    ones = np.ones((rows, 1), np.float32)

    def split_k(a, b):
        """sum over the rows of a^T b: per split, 64-row panels in k16 steps."""
        total = None
        for s in range(plan["splits"]):
            k0, k1 = s * plan["per_split"], min(rows, (s + 1) * plan["per_split"])
            part = _steps(a[k0:k1].T, b[k0:k1])
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


@pytest.mark.parametrize("degree,n_g", [(3, 3), (2, 1), (3, 5)])
def test_emulated_sm90_chain_matches_plain_and_pallas(degree, n_g):
    """#7's bfloat16 chain, emulated over 300 edge rows (d = 6: F = 258 or
    42; H = 20, D = 12; three splits of 128 rows), against basis_mlp_bwd_plain
    and against _multi_bwd in Pallas interpret mode, at the tolerances above."""
    rng = np.random.default_rng(40 + degree + n_g)
    Bp, O, d, E, H, D = 2, 3, 6, 50, 20, 12
    F = sum(d**i for i in range(1, degree + 1))
    attrT = _bf16(rng.normal(size=(Bp, O, d, E)))
    w1, b1 = _bf16(rng.normal(size=(F, H)) * 0.1), _bf16(rng.normal(size=(H,)) * 0.3)
    w2, b2 = _bf16(rng.normal(size=(H, D)) * 0.3), _bf16(rng.normal(size=(D,)) * 0.3)
    gs = [_bf16(rng.normal(size=(Bp, O, E, D))) for _ in range(n_g)]
    got = emulate_sm90_bwd(attrT, w1, b1, w2, b2, degree, gs, rows_per_split=128)

    def t16(a):
        return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)

    plain = basis_mlp_bwd_plain(t16(attrT), t16(w1), t16(b1), t16(w2), t16(b2), degree,
                                [t16(g) for g in gs])
    j = [jnp.asarray(a, jnp.bfloat16) for a in (attrT, w1, b1, w2, b2)]
    pallas = _multi_bwd(*j, poly_selection_matrices(d, degree),
                        [jnp.asarray(g, jnp.bfloat16) for g in gs])
    for name, a, p, q in zip(("dw1", "db1", "dw2", "db2"), got, plain, pallas):
        assert a.shape == tuple(p.shape), name
        assert _rel(a, p.numpy()) <= PLAIN_REL_TOL, name
        assert _rel(a, q.astype(jnp.float32)) <= PALLAS_REL_TOL, name
