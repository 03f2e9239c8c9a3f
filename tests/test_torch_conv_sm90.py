"""#3 (spatial_conv) and #4 (spatial_conv_bwd) on Hopper's wgmma and TMA
(``arreau_tpu_torch/csrc/conv_sm90.cuh``), on the CPU: the wrapper's
host-side tile plan (``kernels/spatial_conv.conv_sm90_plan``) as a pure
function at every shape the port hands the kernels, and a numpy emulation of
the two kernels in their order and rounding points, held against the plain
versions (``spatial_conv_plain`` / ``spatial_conv_bwd_plain``) and against the
JAX package's Pallas kernels ``_fwd_spatial`` / ``_bwd_spatial`` in
interpret mode, with the window cotangent on and off.

The emulation follows the kernels: every product summed in float32 a wgmma
step at a time (k16 in bfloat16, k8 in float32; inside a step in float64,
which a tensor core's exact products and float32 sums approach to within
float32 rounding), float32 as 3xTF32 on tf32 halves rounded as
``cvt.rna.tf32`` (``mma.cuh:to_tf32``); a slot tile's per-edge kernel folded
into the output as ``(win * acc) * x`` in ascending k and rounded once to
the element type; gxw = ``round_T((g * x) * win)``; dbasis = gxw @ W^T
rounded once; dW
split over the edge rows in 64-row panels (``per_split`` of the plan), each
split's float32 partial summed, and the partials added in split order; the
dx terms ``round_T((acc * win) * g)`` summed per sender in ascending e; dwin
summed per row in each warpgroup half of the columns (NB = the plan's nc) as
a thread's ascending column pairs, then the quad's four lanes as ``(l0 + l1)
+ (l2 + l3)``, then over o and the two halves in ascending order.

Tolerances, each of an output's largest magnitude: float32 against the plain
version and against the Pallas kernel 1e-5 (3xTF32 keeps ~2^-22 of each
product; the sums run in other orders), dW and dwin 1e-4 (sums over every
edge row); bfloat16 1e-2 (the plain version rounds at the same points, so a
value next to a rounding boundary may round the other way, one ulp of 2^-8;
the Pallas kernel also rounds dW to bfloat16 and sums dx as a one-hot
product: 2e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.ops.pallas_conv import _bwd_spatial, _fwd_spatial
from arreau_tpu_torch.kernels.spatial_conv import (
    SM90_CONV_HALF,
    SM90_DW_WIDTH,
    SMEM_BUDGET,
    _kernel_plan,
    conv_sm90_plan,
    spatial_conv_bwd_plain,
    spatial_conv_plain,
)


# ---------------- the tile plan ----------------


def test_conv_plan_at_the_training_shape():
    """The training cell (B'=32, O=16, K=8, TA=128, D=256, C=200): C in two
    halves of 112, D in two of 128, dW's C in 208; bfloat16 keeps W^T resident
    beside eight 8 KB panels, float32 streams W's tf32 halves through two
    slots, each beside the warpgroups' staging tiles; float32 dW stages two
    32-row panels of both operands' tf32 halves; 128 splits of 4096 edge
    rows in both types."""
    bf = conv_sm90_plan(32, 16, 8, 128, 256, 200, torch.bfloat16)
    assert bf == {"nc": 112, "nd": 128, "nw": 208, "kd": 256, "kc": 256, "cg": 200,
                  "wt": 57344, "wk": 65536, "tma": True, "stages": 8, "smem": 211968,
                  "dbasis_stages": 8, "dbasis_smem": 216064, "dw_stages": 4, "dw_smem": 197632,
                  "splits": 128, "per_split": 4096}
    f32 = conv_sm90_plan(32, 16, 8, 128, 256, 200, torch.float32)
    assert (f32["kd"], f32["kc"], f32["stages"], f32["smem"]) == (256, 224, 2, 207872)
    assert (f32["dbasis_stages"], f32["dbasis_smem"]) == (2, 199680)
    assert (f32["wt"], f32["wk"]) == (2 * 224 * 256, 2 * 256 * 224)
    assert (f32["nw"], f32["dw_stages"], f32["dw_smem"]) == (208, 2, 173056)
    assert (f32["splits"], f32["per_split"]) == (128, 4096)


# (B', O, K, TA, D, C): the training, serving and flagship cells, N-body,
# MNIST, the card tests' ragged shapes, and widths at the classes' edges
PLAN_SHAPES = [(32, 16, 8, 128, 256, 200), (8, 16, 8, 128, 256, 200), (10, 16, 8, 80, 256, 200),
               (4, 16, 5, 125, 256, 128), (96, 10, 8, 75, 128, 64), (2, 3, 4, 40, 37, 70),
               (2, 16, 8, 12, 256, 200), (1, 2, 1, 17, 24, 8), (2, 5, 3, 30, 40, 130),
               (2, 16, 8, 120, 256, 200), (1, 1, 1, 1, 1, 1), (3, 2, 2, 64, 256, 256),
               (1, 1, 33, 65, 129, 225), (1, 1, 2, 64, 256, 224), (5000, 16, 1, 1, 8, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bp,O,K,TA,D,C", PLAN_SHAPES)
def test_conv_plan_covers_every_shape(dtype, Bp, O, K, TA, D, C):
    """What the kernels rely on: each warpgroup's half of C (and of D) in one
    accumulator of a width class (a multiple of 16 up to 128), dW's C in one
    of up to 256; the weight copies' rows whole K-panels of 128 bytes (TMA
    addresses them) and as many elements as the kernels read; every kernel's
    shared memory within the budget with at least two ring slots, and the
    kernels given these very values (the ``ConvPlan`` the wrappers pass,
    whose layouts the launches check against them); the splits
    covering the edge rows in whole 64-row panels, none empty; TMA reading
    the basis rows exactly where they are 16-byte multiples. Float32 takes C
    up to 224: above, W's tf32 halves leave no room for two ring slots
    beside the staging tiles, and the plan raises."""
    if dtype == torch.float32 and C > 224:
        with pytest.raises(ValueError, match="up to 224"):
            conv_sm90_plan(Bp, O, K, TA, D, C, dtype)
        return
    p = conv_sm90_plan(Bp, O, K, TA, D, C, dtype)
    size = 4 if dtype == torch.float32 else 2
    pk, planes = 128 // size, 2 if dtype == torch.float32 else 1
    for key, n in (("nc", C), ("nd", D)):
        assert p[key] in SM90_CONV_HALF and n <= 2 * p[key]
        i = SM90_CONV_HALF.index(p[key])
        assert i == 0 or n > 2 * SM90_CONV_HALF[i - 1]
    assert p["nw"] in SM90_DW_WIDTH and C <= p["nw"]
    for key, n in (("kd", D), ("kc", C)):
        assert p[key] % pk == 0 and n <= p[key] < n + pk and p[key] * size % 128 == 0
    assert p["cg"] % 8 == 0 and C <= p["cg"] < C + 8
    assert p["wt"] == planes * 2 * p["nc"] * p["kd"] and p["wk"] == planes * 2 * p["nd"] * p["kc"]
    assert p["tma"] == (D * size % 16 == 0)
    for stages, smem in (("stages", "smem"), ("dbasis_stages", "dbasis_smem"),
                         ("dw_stages", "dw_smem")):
        assert 2 <= p[stages] <= 8 and p[smem] <= SMEM_BUDGET, (stages, p)
    rows = Bp * O * K * TA
    assert p["per_split"] % 64 == 0 and p["splits"] <= 256
    kernel_plan = _kernel_plan(Bp, O, K, TA, D, C, dtype)  # what the launches are given
    assert {name: getattr(kernel_plan, name) for name, _ in kernel_plan._fields_} == {
        name: p[name] for name, _ in kernel_plan._fields_}
    assert (p["splits"] - 1) * p["per_split"] < rows <= p["splits"] * p["per_split"]


@pytest.mark.parametrize("C,D", [(257, 16), (16, 257)])
def test_conv_plan_refuses_widths_past_one_accumulator(C, D):
    with pytest.raises(ValueError, match="up to 256"):
        conv_sm90_plan(1, 1, 1, 8, D, C, torch.bfloat16)


# ---------------- the kernels' arithmetic, emulated ----------------


def _f32(v):
    return np.asarray(v, dtype=np.float32)


def _round(v, bf16):
    """float32 values rounded to the element type and back (nearest even)."""
    v = _f32(v)
    if not bf16:
        return v
    return torch.from_numpy(v).to(torch.bfloat16).float().numpy()


def _tf32(v):
    """cvt.rna.tf32.f32 on the bits (mma.cuh:to_tf32)."""
    bits = (_f32(v).view(np.uint32).astype(np.uint64) + 0x1000) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32)


def _product(a, b, bf16):
    """a [R, K] @ b [K, N] as the wgmma steps add it: float32 sums a step of
    16 (bfloat16) or 8 (float32, 3xTF32 on big and small halves) at a time."""
    step = 16 if bf16 else 8
    if not bf16:
        ab, bb = _tf32(a), _tf32(b)
        asml, bsml = _tf32(_f32(a) - ab), _tf32(_f32(b) - bb)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], step):
        ks = slice(k0, k0 + step)
        if bf16:
            part = a[:, ks].astype(np.float64) @ b[ks].astype(np.float64)
        else:
            part = (asml[:, ks].astype(np.float64) @ bb[ks].astype(np.float64)
                    + ab[:, ks].astype(np.float64) @ bsml[ks].astype(np.float64)
                    + ab[:, ks].astype(np.float64) @ bb[ks].astype(np.float64))
        acc = _f32(acc.astype(np.float64) + part)
    return acc


def emulate_fwd(basis, w, x, src, win, bf16):
    """#3 (csrc/spatial_conv_sm90.cu): per bo, each slot's per-edge kernel
    folded into the output in ascending k, rounded once."""
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2:]
    out = np.zeros((Bp, O, TA, C), np.float32)
    for b in range(Bp):
        for o in range(O):
            res = np.zeros((TA, C), np.float32)
            for k in range(E // TA):
                e = slice(k * TA, (k + 1) * TA)
                acc = _product(basis[b, o, e], w, bf16)
                s = src[b, e]
                live = (s >= 0) & (s < TA)
                xs = np.where(live[:, None], x[b, o, np.where(live, s, 0)], 0)
                term = _f32(_f32(win[b, e][:, None] * acc) * xs)
                res = np.where(live[:, None], _f32(res + term), res)
            out[b, o] = _round(res, bf16)
    return out


def emulate_bwd(basis, w, x, src, win, g, bf16, nc, per_split, window_grad):
    """#4 (csrc/spatial_conv_bwd_sm90.cu, conv_kern_sm90.cu): gxw built and
    rounded, dbasis = gxw @ W^T rounded once, dW over split partials added in
    split order, dx terms rounded and summed per sender in ascending e, dwin
    per warpgroup half and quad (see the module docstring)."""
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2:]
    rows = Bp * O * E
    live = (src >= 0) & (src < TA)                      # [B', E]
    sidx = np.where(live, src, 0)
    g_e = np.tile(g, (1, 1, E // TA, 1))                # row e = k*TA + t holds g[t]
    xj = np.stack([x[b][:, sidx[b]] for b in range(Bp)])  # [B', O, E, C]
    gx = np.where(live[:, None, :, None], _f32(g_e * xj), 0)
    gxw = _round(_f32(gx * win[:, None, :, None]), bf16)
    dbasis = _round(_product(gxw.reshape(rows, C), w.T, bf16), bf16).reshape(basis.shape)
    # dW on wgmma: k16 steps over the rows in bfloat16, k8 steps of 3xTF32 in
    # float32; each split's partial, then the partials in order
    bt, gt = basis.reshape(rows, D).T, gxw.reshape(rows, C)
    dw = np.zeros((D, C), np.float32)
    for r0 in range(0, rows, per_split):
        dw = _f32(dw + _product(bt[:, r0:r0 + per_split], gt[r0:r0 + per_split], bf16))
    kern = _product(basis.reshape(rows, D), w, bf16).reshape(Bp, O, E, C)
    dxc = np.where(live[:, None, :, None],
                   _round(_f32(_f32(kern * win[:, None, :, None]) * g_e), bf16), 0)
    dx = np.zeros((Bp, O, TA, C), np.float32)
    for b in range(Bp):
        for e in np.argsort(np.where(live[b], src[b], TA), kind="stable"):
            if live[b, e]:
                dx[b, :, src[b, e]] = _f32(dx[b, :, src[b, e]] + dxc[b, :, e])
    out = (dbasis, dw, _round(dx, bf16))
    if not window_grad:
        return out
    # per row and warpgroup half h (columns h*nc ..): lane q of a quad adds
    # its pairs c = h*nc + 8j + 2q, +1 in ascending j; then (l0 + l1) + (l2 + l3)
    term = _f32(kern * gx)                                # [B', O, E, C], 0 where empty
    cols = np.zeros((Bp, O, E, 2 * nc), np.float32)
    cols[..., :C] = term
    halves = []
    for h in range(2):
        lanes = []
        for q in range(4):
            s = np.zeros((Bp, O, E), np.float32)
            for j in range(nc // 8):
                c = h * nc + 8 * j + 2 * q
                s = _f32(s + _f32(cols[..., c] + cols[..., c + 1]))
            lanes.append(s)
        halves.append(_f32(_f32(lanes[0] + lanes[1]) + _f32(lanes[2] + lanes[3])))
    dwin = np.zeros((Bp, E), np.float32)
    for o in range(O):
        for h in range(2):
            dwin = _f32(dwin + halves[h][:, o])
    return (*out, np.where(live, dwin, 0))


def _inputs(seed, Bp, O, K, TA, D, C, bf16):
    rng = np.random.default_rng(seed)
    E = K * TA
    src = rng.integers(0, TA, size=(Bp, E))
    src[rng.random((Bp, E)) < 0.3] = -1
    src[rng.random((Bp, E)) < 0.05] = TA + 2  # outside [0, TA): an empty slot too
    win = _f32(rng.random((Bp, E)))
    win[:, ::7] = 0.0
    vals = [rng.normal(size=(Bp, O, E, D)), rng.normal(size=(D, C)) * 0.1,
            rng.normal(size=(Bp, O, TA, C)), rng.normal(size=(Bp, O, TA, C))]
    basis, w, x, g = (_round(v, bf16) for v in vals)
    return basis, w, x, src.astype(np.int32), win, g


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _torch(args, bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    basis, w, x, src, win, g = args
    return (torch.from_numpy(basis).to(dt), torch.from_numpy(w).to(dt), torch.from_numpy(x).to(dt),
            torch.from_numpy(src), torch.from_numpy(win), torch.from_numpy(g).to(dt))


def _jax(args, bf16):
    """The Pallas kernels' inputs: the one-hot gather matrix and the [B', E, 1] window."""
    basis, w, x, src, win, g = args
    Bp, E = src.shape
    TA = x.shape[2]
    sel = np.zeros((Bp, E, TA), np.float32)
    b, e = np.nonzero((src >= 0) & (src < TA))
    sel[b, e, src[b, e]] = 1.0
    dt = jnp.bfloat16 if bf16 else jnp.float32
    return (jnp.asarray(basis, dt), jnp.asarray(w, dt), jnp.asarray(x, dt), jnp.asarray(sel, dt),
            jnp.asarray(win[..., None]), jnp.asarray(g, dt))


# (B', O, K, TA, D, C): a slot tile clipped at TA = 20 and two tiles at TA =
# 70; D and C ragged (37 / 70) and whole panels (64 / 40)
EMU_SHAPES = [(2, 3, 3, 20, 37, 70), (1, 2, 2, 70, 64, 40)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("Bp,O,K,TA,D,C", EMU_SHAPES)
def test_emulated_forward_matches_plain_and_pallas(bf16, Bp, O, K, TA, D, C):
    args = _inputs(Bp + K + TA + D, Bp, O, K, TA, D, C, bf16)
    basis, w, x, src, win, _ = args
    got = emulate_fwd(basis, w, x, src, win, bf16)
    plain = spatial_conv_plain(*_torch(args, bf16)[:5]).float().numpy()
    rel = 1e-2 if bf16 else 1e-5
    _close(got, plain, rel)
    jb, jw, jx, sel, jwin, _ = _jax(args, bf16)
    with jax.enable_x64(False):
        want = _fwd_spatial(jb, jw, jx, sel, jwin, jb.dtype)
    _close(got, np.asarray(want, np.float32), rel)


@pytest.mark.parametrize("window_grad", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("Bp,O,K,TA,D,C", EMU_SHAPES)
def test_emulated_backward_matches_plain_and_pallas(window_grad, bf16, Bp, O, K, TA, D, C):
    args = _inputs(2 * Bp + K + TA + D, Bp, O, K, TA, D, C, bf16)
    dtype = torch.bfloat16 if bf16 else torch.float32
    plan = conv_sm90_plan(Bp, O, K, TA, D, C, dtype)
    got = emulate_bwd(*args, bf16, plan["nc"], plan["per_split"], window_grad)
    plain = spatial_conv_bwd_plain(*_torch(args, bf16), window_grad)
    assert len(got) == len(plain) == (4 if window_grad else 3)
    for i, (a, b) in enumerate(zip(got, plain)):
        _close(a, b.float().numpy(), 1e-2 if bf16 and i != 3 else (1e-4 if i in (1, 3) else 1e-5))
    jb, jw, jx, sel, jwin, jg = _jax(args, bf16)
    with jax.enable_x64(False):
        want = _bwd_spatial(jb, jw, jx, sel, jwin, jg, want_dwin=window_grad)
    if window_grad:
        want = (*want[:3], want[3][..., 0])
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, np.asarray(b, np.float32), 2e-2 if bf16 and i != 3 else
               (1e-4 if i in (1, 3) else 1e-5))
