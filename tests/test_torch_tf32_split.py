"""The float32 backward of the spatial conv (#4, ``csrc/spatial_conv_bwd.cu``)
runs its products on the tensor cores as 3xTF32: each operand splits into
``big = cvt.rna.tf32(v)`` and ``small = cvt.rna.tf32(v - big)``, and every
product sums ``small*big + big*small + big*big`` in float32. The card cannot
be asked here, so this file emulates that arithmetic in numpy, on the
kernel's own algorithm (the edge cotangent ``gxw``, dbasis = gxw W^T, dW =
basis^T gxw, the per-edge kernel basis W and its dx terms ``dxc``, and dx as
each sender's terms summed in ascending e, in the order the wrapper builds
with :func:`sender_order`), and holds each output within 1e-5 of the float64
plain version's scale: ten times inside the 1e-4 that the card's checks
allow the kernel (``chip_smoke.KERNEL_REL_TOL``). It also holds that order:
stable, and every live edge in it once.

It also prints, without asserting, what 1-pass TF32 (``cvt.rna`` of each
operand, one product) gives on the same inputs: the open question of
whether the float32 path could take the JAX kernel's own 1-pass precision.

The same holds for the basis MLP's float32 algorithm, whose products run as
3xTF32 too: #8 (h1_pre = poly @ W1 + b1, the bias added after the product)
and #7's five products (h1 recomputed, here with its ones column in a padded
scratch row, dpre2 from the summed cotangents, dW2|db2 and dW1|db1 as
split-K products whose per-split partials are added in split order, dpre1
between them), each output within 1e-5 of the float64 plain version's
scale. (The kernels' own order on tf32 wgmma, ``csrc/basis_f32_sm90.cuh``,
is emulated in ``tests/test_torch_basis_sm90.py``.)

And for the forward convs, whose per-edge kernels run as 3xTF32 too: #3
(``csrc/spatial_conv.cu`` through ``csrc/conv_fwd.cuh``: each neighbour
slot's D-deep product basis rows @ W, folded into the output with the
float32 window and the sender's features in ascending k, empty slots
skipped) and #1 (``csrc/fiber_conv.cu``: the same fold without a window
into the float32 ``x_sp``, then the fiber mixing summed over o in ascending
order), each output within 1e-5 of the float64 plain version's scale, at a
small ragged shape and at the canonical width cut to one super-crystal.

And for the fused ConvNext MLP, whose float32 products of width C or W run
as 3xTF32 too: #9 (``csrc/convnext_mlp.cu``: pre1 = yl @ W1 over the
channels zero-padded to the row block's width, h = gelu(pre1 + b1), m = the
sum over the hidden chunks of h @ W2, out and the float32 readout summed in
channel order) and #10 (``csrc/convnext_mlp_bwd.cu``: g_total with g_r @
Wr^T summed in readout order, dh = dm @ W2^T, dyln = dpre1 @ W1^T, the
LayerNorm VJP from each row's two sums, [dW2; db2] and [dW1; db1] as
split-K products with a ones column whose per-split partials are added in
split order, [dWr; dbr] and the column sums as per-row-block partials added
in the fixed order of ``sum_blocks_kernel``), every output within 1e-5 of
the float64 plain versions' scale, at a ragged shape and at the canonical
width cut to a few hundred rows.

And for the fused basis MLP, whose products run as 3xTF32 in float32 too:
#5 (``csrc/fused_basis_mlp.cu``: h = gelu(poly @ W1) into a scratch, then
gelu(h @ W2)) and #6 (``csrc/fused_basis_mlp_bwd.cu``: #7's chain without
biases, one cotangent, dh rounded before its product with gelu'(h_pre),
dW2 and dW1 as split-K products whose per-split partials are added in split
order), every output within 1e-5 of the float64 plain versions' scale; and
the same algorithm in bfloat16 (exact products summed in float32, rounded
at the kernels' points) against the bfloat16 plain versions.
"""

import numpy as np
import pytest
import torch

from arreau_tpu_torch.kernels.basis_h1 import basis_h1_plain, poly_features_t
from arreau_tpu_torch.kernels.basis_mlp import basis_mlp_bwd_plain
from arreau_tpu_torch.kernels.build import row_splits
from arreau_tpu_torch.kernels.convnext_mlp import (
    MIN_ROW_BLOCK,
    convnext_mlp_bwd_plain,
    convnext_mlp_plain,
    padded_hidden,
)
from arreau_tpu_torch.kernels.fiber_conv import fiber_conv_plain
from arreau_tpu_torch.kernels.fused_basis_mlp import (
    fused_basis_mlp_bwd_plain,
    fused_basis_mlp_plain,
)
from arreau_tpu_torch.models.blocks import polynomial_features
from arreau_tpu_torch.kernels.spatial_conv import (
    sender_order,
    spatial_conv_bwd_plain,
    spatial_conv_plain,
)

SPLIT_REL_TOL = 1e-5
BF16_REL_TOL = 1e-2  # the card's checks of a bfloat16 kernel (chip_smoke.BF16_KERNEL_REL_TOL)


def tf32_rna(a):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (the low 13 bits cleared)."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    big = tf32_rna(a)
    return big, tf32_rna(a - big)


def mm_3xtf32(a, b, depth=8):
    """a @ b as the tensor cores compute it in 3xTF32: per 8-deep step,
    acc += a_small b_big, then a_big b_small, then a_big b_big, each a
    float32 sum of exact products."""
    (ab, as_), (bb, bs) = split(a), split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], depth):
        s = slice(k, k + depth)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            acc += x[:, s] @ y[s]
    return acc


def mm_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def emulated_bwd(basis, w, x, src, win, g, mm):
    """(dbasis, dw, dx) by the kernel's algorithm in float32 numpy, its
    products by ``mm``; dx as each sender's run of dx terms, summed in the
    wrapper's order in float32."""
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    live = (src >= 0) & (src < TA)
    idx = np.where(live, src, 0)
    xj = np.take_along_axis(x, idx[:, None, :, None], axis=2)  # [B', O, E, C]
    g_e = g[:, :, np.arange(E) % TA]  # row e = k*TA + t holds g[t]
    win_e = win[:, None, :, None]
    gxw = np.where(live[:, None, :, None], g_e * xj * win_e, np.float32(0)).astype(np.float32)
    dbasis = mm(gxw.reshape(-1, C), np.ascontiguousarray(w.T)).reshape(Bp, O, E, D)
    dw = mm(np.ascontiguousarray(basis.reshape(-1, D).T), gxw.reshape(-1, C))
    kern = mm(basis.reshape(-1, D), w).reshape(Bp, O, E, C)
    dxc = np.where(live[:, None, :, None], kern * win_e * g_e, np.float32(0)).astype(np.float32)
    order, offsets = (t.numpy() for t in sender_order(torch.tensor(src), TA))
    dx = np.zeros_like(x)
    for b in range(Bp):
        for s in range(TA):
            for e in order[b, offsets[b, s]:offsets[b, s + 1]]:
                dx[b, :, s] += dxc[b, :, e]  # float32, one term at a time
    return dbasis, dw, dx


@pytest.fixture(scope="module")
def case():
    """Seeded inputs at a small size (K*TA = 64 edges, D = 24, C = 20) with
    empty and out-of-range slots; the float64 plain version's outputs; the
    3xTF32 and 1-pass TF32 emulations."""
    rng = np.random.default_rng(0)
    Bp, O, K, TA, D, C = 2, 3, 4, 16, 24, 20
    E = K * TA
    src = rng.integers(0, TA, size=(Bp, E))
    src[rng.random((Bp, E)) < 0.3] = -1
    src[rng.random((Bp, E)) < 0.05] = TA + 2
    f32 = np.float32
    args = (rng.normal(size=(Bp, O, E, D)).astype(f32), (rng.normal(size=(D, C)) * 0.1).astype(f32),
            rng.normal(size=(Bp, O, TA, C)).astype(f32), src.astype(np.int32),
            rng.random((Bp, E)).astype(f32), rng.normal(size=(Bp, O, TA, C)).astype(f32))
    t = [torch.tensor(a, dtype=torch.float64 if a.dtype == f32 else torch.int32) for a in args]
    t[4] = t[4].double()
    want = [v.numpy() for v in spatial_conv_bwd_plain(*t)]
    split3 = emulated_bwd(*args, mm_3xtf32)
    one_pass = emulated_bwd(*args, mm_1xtf32)
    return want, split3, one_pass


def test_tf32_rna_rounds_ten_bits_ties_away():
    ulp = 2.0**-10
    v = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4, 3.0, 0.0],
                 dtype=np.float32)
    np.testing.assert_array_equal(tf32_rna(v), np.array([1 + ulp, -(1 + ulp), 1, 1 + ulp, 3, 0],
                                                        dtype=np.float32))
    big, small = split(np.float32(1 + 2.0**-15 + 2.0**-20))
    assert big == np.float32(1) and small == np.float32(2.0**-15 + 2.0**-20)


@pytest.mark.parametrize("i,name", [(0, "dbasis"), (1, "dw"), (2, "dx")])
def test_3xtf32_products_keep_float32_precision(case, i, name):
    want, split3, one_pass = case
    scale = np.abs(want[i]).max()
    rel3 = np.abs(split3[i] - want[i]).max() / scale
    rel1 = np.abs(one_pass[i] - want[i]).max() / scale
    print(f"{name}: 3xTF32 {rel3:.3e}, 1-pass TF32 {rel1:.3e} of the float64 scale")
    assert rel3 <= SPLIT_REL_TOL, rel3


@pytest.mark.parametrize("seed,TA,E", [(0, 16, 64), (1, 12, 96), (2, 17, 17), (3, 128, 1024)])
def test_sender_order_is_stable_and_lists_every_live_edge_once(seed, TA, E):
    """The order dx sums in: for each row, the live edges (0 <= src < TA)
    grouped by sender in ascending e, each once, offsets marking every run
    and the start of the empty slots; with -1 and out-of-range slots."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, TA, size=(3, E))
    src[rng.random((3, E)) < 0.2] = -1
    src[rng.random((3, E)) < 0.05] = TA + 1
    order, offsets = sender_order(torch.tensor(src, dtype=torch.int32), TA)
    assert order.dtype == offsets.dtype == torch.int32
    assert tuple(order.shape) == (3, E) and tuple(offsets.shape) == (3, TA + 1)
    for b in range(3):
        row, off = order[b].numpy(), offsets[b].numpy()
        assert off[0] == 0 and np.all(np.diff(off) >= 0)
        assert sorted(row.tolist()) == list(range(E))  # a permutation: each edge once
        for s in range(TA):
            run = row[off[s]:off[s + 1]]
            np.testing.assert_array_equal(run, np.flatnonzero(src[b] == s))  # ascending e
        live = (src[b] >= 0) & (src[b] < TA)
        assert off[TA] == live.sum()
        assert not live[row[off[TA]:]].any()  # the empty slots come last


def gelu_and_deriv(x):
    """Tanh-approximation GELU and its derivative in float32, as the
    kernels' epilogues evaluate them."""
    f32 = np.float32
    t = np.tanh(f32(0.7978845608028654) * (x + f32(0.044715) * x * x * x)).astype(f32)
    value = f32(0.5) * x * (f32(1) + t)
    deriv = (f32(0.5) * (f32(1) + t)
             + f32(0.5) * x * (f32(1) - t * t) * f32(0.7978845608028654)
             * (f32(1) + f32(3 * 0.044715) * x * x))
    return value.astype(f32), deriv.astype(f32)


def emulated_basis_kernels(attrT, w1, b1, w2, b2, degree, gs, mm, rows_per_block):
    """(h1_pre, dw1, db1, dw2, db2) by #8's and #7's algorithm in float32
    numpy, products by ``mm``: the features formed in float32; h1_pre =
    poly @ W1, then + b1; #7's scratch row [gelu(h1_pre) | 1 | 0 ...] of
    ``padded_hidden(H)`` elements; dpre2 = (sum of the cotangents, in
    order) * gelu'(h1 @ W2 + b2); dW2|db2 = [h1 | 1]^T dpre2 and dW1|db1 =
    [poly | 1]^T dpre1 over each split of ``row_splits(rows,
    rows_per_block)`` rows, the partials added in split order."""
    f32 = np.float32
    F_, H = w1.shape
    D = w2.shape[1]
    poly = poly_features_t(torch.tensor(attrT), degree).reshape(-1, F_).numpy()
    h1_pre = mm(poly, w1) + b1
    rows = poly.shape[0]
    h1, dg1 = gelu_and_deriv(h1_pre)
    scratch = np.zeros((rows, padded_hidden(H)), f32)
    scratch[:, :H], scratch[:, H] = h1, 1
    g = gs[0].reshape(rows, D)
    for gi in gs[1:]:
        g = g + gi.reshape(rows, D)
    dpre2 = g * gelu_and_deriv(mm(scratch[:, :H], w2) + b2)[1]
    dpre1 = mm(dpre2, np.ascontiguousarray(w2.T)) * dg1
    poly_ext = np.concatenate([poly, np.ones((rows, 1), f32)], axis=1)
    splits, per = row_splits(rows, rows_per_block)
    dw2_ext = np.zeros((H + 1, D), f32)
    dw1_ext = np.zeros((F_ + 1, H), f32)
    for s in range(splits):
        r = slice(s * per, min(rows, (s + 1) * per))
        dw2_ext += mm(np.ascontiguousarray(scratch[r, :H + 1].T), dpre2[r])
        dw1_ext += mm(np.ascontiguousarray(poly_ext[r].T), dpre1[r])
    return h1_pre.astype(f32), dw1_ext[:F_], dw1_ext[F_], dw2_ext[:H], dw2_ext[H]


@pytest.fixture(scope="module")
def basis_case():
    """Seeded inputs at a small size (B'=2, O=3, E=40: 240 rows in four
    splits; d=6, degree 3, F=258, H=24, D=20; three cotangents); the float64
    plain versions' outputs; the 3xTF32 and 1-pass TF32 emulations."""
    rng = np.random.default_rng(5)
    f32 = np.float32
    Bp, O, d, E, H, D, degree = 2, 3, 6, 40, 24, 20, 3
    F_ = d + d * d + d ** 3
    args = (rng.normal(size=(Bp, O, d, E)).astype(f32),
            (rng.normal(size=(F_, H)) * 0.1).astype(f32), rng.normal(size=H).astype(f32),
            (rng.normal(size=(H, D)) * 0.1).astype(f32), rng.normal(size=D).astype(f32))
    gs = [rng.normal(size=(Bp, O, E, D)).astype(f32) for _ in range(3)]
    t = [torch.tensor(a, dtype=torch.float64) for a in args]
    want = (basis_h1_plain(*t[:3], degree).reshape(-1, H).numpy(),
            *(v.numpy() for v in basis_mlp_bwd_plain(*t, degree,
                                                     [torch.tensor(g, dtype=torch.float64)
                                                      for g in gs])))
    split3 = emulated_basis_kernels(*args, degree, gs, mm_3xtf32, 64)
    one_pass = emulated_basis_kernels(*args, degree, gs, mm_1xtf32, 64)
    return want, split3, one_pass


@pytest.mark.parametrize("i,name", [(0, "h1_pre"), (1, "dw1"), (2, "db1"), (3, "dw2"),
                                    (4, "db2")])
def test_3xtf32_basis_products_keep_float32_precision(basis_case, i, name):
    want, split3, one_pass = basis_case
    scale = np.abs(want[i]).max()
    rel3 = np.abs(split3[i] - want[i]).max() / scale
    rel1 = np.abs(one_pass[i] - want[i]).max() / scale
    print(f"{name}: 3xTF32 {rel3:.3e}, 1-pass TF32 {rel1:.3e} of the float64 scale")
    assert rel3 <= SPLIT_REL_TOL, rel3


@pytest.mark.parametrize("H,Hg", [(1, 8), (7, 8), (8, 16), (33, 40), (70, 72), (200, 208),
                                  (256, 264)])
def test_padded_hidden_keeps_a_ones_column_and_aligned_rows(H, Hg):
    """A scratch row of the H units and the ones column (#10's, and this
    file's basis emulation's), rounded up to 8 elements (16 bytes in
    bfloat16, 32 in float32)."""
    assert padded_hidden(H) == Hg


def emulated_conv_fwd(basis, w, x, src, win, mm):
    """The forward conv as ``csrc/conv_fwd.cuh`` computes it, in float32
    numpy: slot k's product (basis rows k*TA .. k*TA + TA) @ W by ``mm``,
    then out += win * acc * x[src] for the live slots, in ascending k;
    ``win`` None weighs every slot 1 (#1's spatial conv)."""
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    out = np.zeros(x.shape, np.float32)
    for b in range(Bp):
        for k in range(E // TA):
            rows = slice(k * TA, (k + 1) * TA)
            acc = mm(basis[b, :, rows].reshape(-1, D), w).reshape(O, TA, C)
            s = src[b, rows]
            live = (s >= 0) & (s < TA)
            wv = np.ones(TA, np.float32) if win is None else win[b, rows]
            xj = x[b][:, np.where(live, s, 0)]  # [O, TA, C]
            out[b] += np.where(live[None, :, None], wv[None, :, None] * acc * xj, np.float32(0))
    return out


def emulated_fiber_fwd(basis, w, x, src, fk, mm):
    """(y, x_sp) as #1 computes them: the windowless fold into float32
    x_sp, then y[p] = sum over o of Kf[o, p] * x_sp[o], ascending o."""
    x_sp = emulated_conv_fwd(basis, w, x, src, None, mm)
    y = np.zeros((x.shape[0], fk.shape[1], *x.shape[2:]), np.float32)
    for o in range(fk.shape[0]):
        y += fk[o][None, :, None, :] * x_sp[:, o][:, None]
    return y, x_sp


@pytest.fixture(scope="module", params=[(2, 3, 5, 3, 17, 37, 70), (1, 16, 16, 8, 128, 256, 200)],
                ids=["ragged", "canonical"])
def conv_case(request):
    """Seeded inputs (B', O, P, K, TA, D, C: a ragged shape, and the canonical
    width cut to one super-crystal) with -1 and out-of-range slots; the
    float64 plain versions' outputs (#3 out, #1 y and x_sp); the 3xTF32 and
    1-pass TF32 emulations."""
    Bp, O, P, K, TA, D, C = request.param
    rng = np.random.default_rng(11)
    E = K * TA
    f32 = np.float32
    src = rng.integers(0, TA, size=(Bp, E))
    src[rng.random((Bp, E)) < 0.1] = -1
    src[rng.random((Bp, E)) < 0.03] = TA + 2
    src = src.astype(np.int32)
    basis = rng.normal(size=(Bp, O, E, D)).astype(f32)
    w = (rng.normal(size=(D, C)) * 0.1).astype(f32)
    x = rng.normal(size=(Bp, O, TA, C)).astype(f32)
    win = rng.random((Bp, E)).astype(f32)
    fk = (rng.normal(size=(O, P, C)) * 0.3 / O).astype(f32)
    t = [torch.tensor(a, dtype=torch.float64) for a in (basis, w, x)]
    ts = torch.tensor(src)
    want = (spatial_conv_plain(*t, ts, torch.tensor(win, dtype=torch.float64)).numpy(),
            *(v.numpy() for v in fiber_conv_plain(*t, ts, torch.tensor(fk, dtype=torch.float64),
                                                  save_x_sp=True)))
    emulated = {}
    for name, mm in (("3xTF32", mm_3xtf32), ("1-pass TF32", mm_1xtf32)):
        emulated[name] = (emulated_conv_fwd(basis, w, x, src, win, mm),
                          *emulated_fiber_fwd(basis, w, x, src, fk, mm))
    return want, emulated


@pytest.mark.parametrize("i,name", [(0, "spatial_conv out"), (1, "fiber_conv y"),
                                    (2, "fiber_conv x_sp")])
def test_3xtf32_forward_convs_keep_float32_precision(conv_case, i, name):
    want, emulated = conv_case
    scale = np.abs(want[i]).max()
    rel = {k: np.abs(v[i] - want[i]).max() / scale for k, v in emulated.items()}
    print(f"{name}: " + ", ".join(f"{k} {r:.3e}" for k, r in rel.items())
          + " of the float64 scale")
    assert rel["3xTF32"] <= SPLIT_REL_TOL, rel


def emulated_convnext(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, g_out, g_r, mm,
                      rows_per_split):
    """#9's (out, r) and #10's (dxc, dres, dln_s, dln_b, dw1, db1, dw2, db2,
    dgamma, dwr, dbr) by the kernels' float32 algorithm in numpy, their
    products of width C or W by ``mm``: LayerNorm with the fast variance;
    pre1 and dh over the channels zero-padded to 208 (the model's row-block
    width); m and dyln summed chunk after chunk of 32 hidden units (float32's
    chunk), in order; the readout and g_r @ Wr^T on the CUDA cores in order;
    [dW2; db2] = [h | 1]^T dm and [dW1; db1] = [yl | 1]^T dpre1 over each
    split of ``rows_per_split`` rows, added in split order; [dWr; dbr] and
    the column sums over each row block of MIN_ROW_BLOCK rows (float32's
    row block), added as :func:`sum_blocks`."""
    f32 = np.float32
    M, C = xc.shape
    W, R = w1.shape[1], wr.shape[1]
    CN, WC = 208, 32

    def pad(a, axis):  # zero-padded to the row block's width CN
        width = [(0, 0), (0, 0)]
        width[axis] = (0, CN - a.shape[axis])
        return np.pad(a, width)

    mu = xc.mean(axis=1, dtype=f32, keepdims=True)
    var = np.maximum((xc * xc).mean(axis=1, dtype=f32, keepdims=True) - mu * mu, f32(0))
    rstd = (f32(1) / np.sqrt(var + f32(1e-5))).astype(f32)
    xhat = (xc - mu) * rstd
    yl = xhat * ln_s + ln_b
    pre1 = mm(pad(yl, 1), pad(w1, 0)) + b1
    h, dgelu = gelu_and_deriv(pre1)
    m = np.zeros((M, C), f32)
    for w0 in range(0, W, WC):
        m += mm(h[:, w0:w0 + WC], w2[w0:w0 + WC])
    m = m + b2
    out = res + gamma * m
    r = np.zeros((M, R), f32)
    for c in range(C):
        r += out[:, c:c + 1] * wr[c]
    r += br
    gr = np.zeros((M, C), f32)
    for q in range(R):
        gr += g_r[:, q:q + 1] * wr[:, q]
    g = g_out + gr
    dm = g * gamma
    dpre1 = mm(pad(dm, 1), pad(w2, 1).T.copy()) * dgelu
    dyln = np.zeros((M, CN), f32)
    for w0 in range(0, W, WC):
        dyln += mm(dpre1[:, w0:w0 + WC], pad(w1[:, w0:w0 + WC], 0).T.copy())
    dyln = dyln[:, :C]
    dxhat = dyln * ln_s
    s1 = dxhat.sum(axis=1, dtype=f32, keepdims=True)
    s2 = (dxhat * xhat).sum(axis=1, dtype=f32, keepdims=True)
    dxc = rstd * (dxhat - s1 / f32(C) - xhat * (s2 / f32(C)))
    ones = np.ones((M, 1), f32)
    h_ext, yl_ext, out_ext = (np.concatenate([v, ones], axis=1) for v in (h, yl, out))
    dw2_ext = np.zeros((W + 1, C), f32)
    dw1_ext = np.zeros((C + 1, W), f32)
    for k0 in range(0, M, rows_per_split):
        rows = slice(k0, k0 + rows_per_split)
        dw2_ext += mm(h_ext[rows].T.copy(), dm[rows])
        dw1_ext += mm(yl_ext[rows].T.copy(), dpre1[rows])
    dwr_parts, col_parts = [], []
    for r0 in range(0, M, MIN_ROW_BLOCK):
        part = np.zeros((C + 1, R), f32)
        for i in range(r0, min(M, r0 + MIN_ROW_BLOCK)):  # the block's rows in order
            part += out_ext[i][:, None] * g_r[i]
        dwr_parts.append(part)
        rows = slice(r0, r0 + MIN_ROW_BLOCK)
        col_parts.append(np.stack([(g * m)[rows].sum(axis=0, dtype=f32),
                                   (dyln * xhat)[rows].sum(axis=0, dtype=f32),
                                   dyln[rows].sum(axis=0, dtype=f32)]))
    dwr_ext, cols = sum_blocks(dwr_parts), sum_blocks(col_parts)
    return ((out, r), (dxc, g, cols[1], cols[2], dw1_ext[:C], dw1_ext[C], dw2_ext[:W],
                       dw2_ext[W], cols[0], dwr_ext[:C], dwr_ext[C]))


def sum_blocks(parts, warps=8):
    """The row blocks' partials added as ``sum_blocks_kernel`` adds them:
    each of ``warps`` sums every ``warps``-th block in ascending order, then
    the warps' sums in warp order, in float32."""
    warp_sums = [np.zeros_like(parts[0]) for _ in range(warps)]
    for b, part in enumerate(parts):
        warp_sums[b % warps] += part
    total = np.zeros_like(parts[0])
    for v in warp_sums:
        total += v
    return total


@pytest.fixture(scope="module", params=[(201, 70, 150, 5), (300, 200, 800, 19)],
                ids=["ragged", "canonical"])
def convnext_case(request):
    """Seeded inputs (rows not a multiple of the row blocks; C, W, R: a
    ragged shape, and the canonical width), the float64 plain versions'
    outputs and the 3xTF32 and 1-pass TF32 emulations."""
    M, C, W, R = request.param
    rng = np.random.default_rng(17)
    f32 = np.float32

    def t(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(f32)

    args = (t(M, C, scale=2.0, shift=0.5), t(M, C), t(C, scale=0.1, shift=1.0), t(C, scale=0.1),
            t(C, W, scale=0.1), t(W, scale=0.1), t(W, C, scale=0.05), t(C, scale=0.1),
            t(C, scale=0.5, shift=1.0), t(C, R, scale=0.1), t(R, scale=0.1), t(M, C), t(M, R))
    t64 = [torch.tensor(a, dtype=torch.float64) for a in args]
    want = ([v.numpy() for v in convnext_mlp_plain(*t64[:11])],
            [v.numpy() for v in convnext_mlp_bwd_plain(*t64)])
    per_split = row_splits(M, 64)[1]
    emulated = {name: emulated_convnext(*args, mm, per_split)
                for name, mm in (("3xTF32", mm_3xtf32), ("1-pass TF32", mm_1xtf32))}
    return want, emulated


CONVNEXT_OUTPUTS = [(0, 0, "out"), (0, 1, "r")] + [
    (1, i, name) for i, name in enumerate(("dxc", "dres", "dln_s", "dln_b", "dw1", "db1", "dw2",
                                           "db2", "dgamma", "dwr", "dbr"))]


@pytest.mark.parametrize("d,i,name", CONVNEXT_OUTPUTS)
def test_3xtf32_convnext_keeps_float32_precision(convnext_case, d, i, name):
    want, emulated = convnext_case
    scale = np.abs(want[d][i]).max()
    rel = {k: np.abs(v[d][i] - want[d][i]).max() / scale for k, v in emulated.items()}
    print(f"{name}: " + ", ".join(f"{k} {r:.3e}" for k, r in rel.items())
          + " of the float64 scale")
    assert rel["3xTF32"] <= SPLIT_REL_TOL, rel


def bf16_rne(a):
    """float32 rounded to bfloat16 (8 mantissa bits, to nearest even) and
    back, as ``round_to<bf16>`` and PyTorch's conversion round."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def mm_bf16(a, b, depth=16):
    """a @ b of bfloat16-valued operands as the tensor cores compute it: per
    16-deep step, exact products added to a float32 sum."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], depth):
        acc += a[:, k:k + depth] @ b[k:k + depth]
    return acc


def emulated_fused_basis(attr, w1, w2, degree, g, mm, rnd, rows_per_block):
    """(basis, dw1, dw2) by #5's and #6's algorithm in float32 numpy,
    products by ``mm``, ``rnd`` the rounding to the compute type: the
    features formed in float32 and rounded; #5's h = rnd(gelu(rnd(poly @
    W1))) into its scratch, basis = rnd(gelu(rnd(h @ W2))); #6 recomputes
    the forward, db_pre = rnd(g * rnd(gelu'(b_pre))), dh = rnd(db_pre @
    W2^T) (the rounding #7 does not have), dh_pre = rnd(dh * rnd(gelu'(h_pre))),
    and dW2 = h^T db_pre and dW1 = poly^T dh_pre over each split of
    ``row_splits(rows, rows_per_block)`` rows, the partials added in split
    order (no bias rows)."""
    f32 = np.float32
    F_, H = w1.shape
    D = w2.shape[1]
    poly = rnd(polynomial_features(torch.tensor(attr), degree).reshape(-1, F_).numpy())
    h_pre = rnd(mm(poly, w1))
    h, dg1 = (rnd(v) for v in gelu_and_deriv(h_pre))
    b_pre = rnd(mm(h, w2))
    basis, dg2 = (rnd(v) for v in gelu_and_deriv(b_pre))
    rows = poly.shape[0]
    db_pre = rnd(g.reshape(rows, D) * dg2)
    dh_pre = rnd(rnd(mm(db_pre, np.ascontiguousarray(w2.T))) * dg1)
    splits, per = row_splits(rows, rows_per_block)
    dw1, dw2 = np.zeros((F_, H), f32), np.zeros((H, D), f32)
    for s in range(splits):
        r = slice(s * per, min(rows, (s + 1) * per))
        dw2 += mm(np.ascontiguousarray(h[r].T), db_pre[r])
        dw1 += mm(np.ascontiguousarray(poly[r].T), dh_pre[r])
    return basis.reshape(*attr.shape[:3], D), dw1, dw2


FUSED_OUTPUTS = [(0, "basis"), (1, "dw1"), (2, "dw2")]


@pytest.fixture(scope="module", params=[(2, 3, 40, 6, 24, 20, 3), (1, 2, 100, 6, 200, 256, 3),
                                        (2, 1, 70, 3, 200, 256, 2)],
                ids=["small", "canonical", "d3"])
def fused_case(request):
    """Seeded inputs (B', O, E, d, H, D, degree: 240 rows in four splits,
    the canonical width cut to 200 rows in four, and d = 3 at degree 2),
    the float64 plain versions' outputs and the 3xTF32 and 1-pass TF32
    emulations; the bfloat16 plain versions' outputs on the inputs rounded
    to bfloat16, and the bfloat16 emulation."""
    Bp, O, E, d, H, D, degree = request.param
    rng = np.random.default_rng(23)
    f32 = np.float32
    F_ = sum(d**i for i in range(1, degree + 1))
    args = (rng.normal(size=(Bp, O, E, d)).astype(f32),
            (rng.normal(size=(F_, H)) * 0.2).astype(f32),
            (rng.normal(size=(H, D)) * 0.2).astype(f32))
    g = rng.normal(size=(Bp, O, E, D)).astype(f32)

    def plain(arrays, dtype):
        t = [torch.tensor(a).to(dtype) for a in arrays]
        outs = (fused_basis_mlp_plain(*t[:3], degree),
                *fused_basis_mlp_bwd_plain(*t[:3], degree, t[3]))
        return [v.double().numpy() for v in outs]

    want = plain((*args, g), torch.float64)
    per_split = row_splits(Bp * O * E, 64)[1]
    emulated = {name: emulated_fused_basis(*args, degree, g, mm, lambda v: v, per_split)
                for name, mm in (("3xTF32", mm_3xtf32), ("1-pass TF32", mm_1xtf32))}
    args16 = [bf16_rne(a) for a in (*args, g)]
    want16 = plain(args16, torch.bfloat16)
    emulated16 = emulated_fused_basis(*args16[:3], degree, args16[3], mm_bf16, bf16_rne, per_split)
    return want, emulated, want16, emulated16


@pytest.mark.parametrize("i,name", FUSED_OUTPUTS)
def test_3xtf32_fused_basis_keeps_float32_precision(fused_case, i, name):
    """#5's and #6's float32 arithmetic (3xTF32 products, split-K partials
    in split order) within SPLIT_REL_TOL of the float64 plain versions'
    scale."""
    want, emulated, _, _ = fused_case
    scale = np.abs(want[i]).max()
    rel = {k: np.abs(v[i] - want[i]).max() / scale for k, v in emulated.items()}
    print(f"{name}: " + ", ".join(f"{k} {r:.3e}" for k, r in rel.items())
          + " of the float64 scale")
    assert rel["3xTF32"] <= SPLIT_REL_TOL, rel


@pytest.mark.parametrize("i,name", FUSED_OUTPUTS)
def test_bf16_fused_basis_rounds_where_the_plain_version_rounds(fused_case, i, name):
    """#5's and #6's bfloat16 arithmetic (exact products summed in float32,
    rounded at the kernels' points, dh included) against the bfloat16 plain
    versions: within the card's bfloat16 tolerance, 1e-2 of each output's
    scale (a value next to a rounding boundary may round the other way).
    That tolerance does not tell dh's rounding apart: without it dw1 lands
    at ~2e-3-4e-3 of its scale, with it at ~2e-4."""
    _, _, want16, emulated16 = fused_case
    scale = np.abs(want16[i]).max()
    rel = np.abs(emulated16[i] - want16[i]).max() / scale
    print(f"{name}: bfloat16 emulation {rel:.3e} of the bfloat16 plain version's scale")
    assert rel <= BF16_REL_TOL, rel


def test_bf16_rne_matches_torch():
    rng = np.random.default_rng(3)
    scales = 10.0 ** rng.integers(-8, 8, 1000)
    v = np.concatenate([(rng.normal(size=1000) * scales).astype(np.float32),
                        np.float32([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 0.0])])
    want = torch.tensor(v).bfloat16().float().numpy()
    np.testing.assert_array_equal(bf16_rne(v), want)
