"""The bfloat16 #9 / #10 kernels on Hopper's wgmma and TMA
(``arreau_tpu_torch/csrc/convnext_sm90.cuh``), on the CPU: the wrappers'
host-side plan (``kernels/convnext_mlp.sm90_plan``) as a pure function, and
numpy emulations of both bfloat16 chains in the kernels' order and rounding
points, held against the plain versions (``convnext_mlp_plain`` /
``convnext_mlp_bwd_plain``) and against the JAX package's Pallas kernels
``_fwd`` / ``_bwd`` in interpret mode.

The emulation follows the kernels step by step: LayerNorm in float32 (each
lane's channels summed in order, then the warp's butterfly; the fast
variance, eps 1e-5), yl rounded to bfloat16; pre1 = yl @ W1 summed in float32
a k16 product step at a time (the wgmma steps; inside a step in float64,
which a tensor core's exact products and float32 sums approach to within
float32 rounding), pre1 + b1 and gelu(pre1) rounded; m summed over the
hidden chunks' k16 steps in order, m + b2, gamma, gamma * m and out rounded;
the readout in float32 over the channels in order. The backward: g_total =
g_out + (g_r @ Wr^T summed over the readout columns in order); dm =
round(g_total * gamma); dh = dm @ W2^T in k16 steps over the channels,
rounded, times gelu'(pre1), rounded (dpre1); dyln over the hidden chunks'
k16 steps; the LayerNorm VJP in float32; the column sums over each 64-row
tile of g_total * m, dyln * xhat and dyln (eight warps, every eighth row in
order, then the warps in order), added as ``sum_blocks_kernel`` adds them;
[dW2; db2] = [h | 1]^T dm
and [dW1; db1] = [yl | 1]^T dpre1 over each split of ``per_split`` rows in
k16 steps of rows, the splits added in order; [dWr; dbr] = [out | 1]^T g_r
over each split of ``r_per_split`` rows in order, the splits added in order.

Tolerances, each of an output's largest magnitude: against the plain version
1e-2 (both round at the same points and sum in float32 in other orders, so a
value next to a bfloat16 rounding boundary may round the other way, one ulp
of 2^-8, and carry through the chain: the card's gate
``chip_smoke.BF16_KERNEL_REL_TOL`` and ``tests/test_torch_cuda.py``'s); against
the Pallas kernel 2e-2 (the JAX kernel evaluates GELU and its derivative on
bfloat16 arrays step by step where the port evaluates them in float32 and
rounds once; ``tests/test_torch_convnext_mlp.py`` holds the plain version
within 1e-2 of it on other inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.ops.pallas_convnext import _bwd, _fwd
from arreau_tpu_torch.kernels.convnext_mlp import (
    MAX_C,
    MAX_R,
    ROWS_STATIC,
    SM90_WIDTHS,
    SMEM_LIMIT,
    convnext_mlp_bwd_plain,
    convnext_mlp_plain,
    kernel_plan,
    padded_hidden,
    sm90_plan,
)

PLAIN_REL_TOL = 1e-2
PALLAS_REL_TOL = 2e-2
_GELU_C0 = np.float32(0.7978845608028654)
_GELU_C1 = np.float32(0.044715)
f32 = np.float32


# ---------------- the plan ----------------


def test_sm90_plan_at_the_training_shape():
    """The training cell's #9/#10 (256 crystals x 16 atoms, 16 orientations:
    65536 rows; C = 200, W = 800, R = 19): C in the 208 class, 13 hidden
    chunks, two 58 KB ring slots beside the two warpgroups' 32 KB tiles
    (185344 bytes), the weight gradients in 37 splits of 1792 rows (7 blocks
    of [dW2; db2] each: 259 blocks) through four 48 KB slots, [dWr; dbr] in
    256 splits of 256 rows."""
    plan = sm90_plan(65536, 200, 800, 19)
    assert plan == {"cn": 208, "nch": 13, "kw": 832, "slot": 59392, "smem": 185344, "cg": 208,
                    "wg": 808, "cp": 200, "wp": 800, "n1": 208, "dw_stages": 4,
                    "dw_smem": 197632, "splits": 37, "per_split": 1792, "r_splits": 256,
                    "r_per_split": 256, "copies": 2 * (800 * 256 + 200 * 832),
                    "pre1s": 512 * 2 * 13 * 64 * 64, "colpart": 1024 * 600,
                    "partial": 37 * 201 * 800}


@pytest.mark.parametrize("R", [0, 19, 64])
@pytest.mark.parametrize("W", [32, 800, 1000, 1024])
@pytest.mark.parametrize("C", [8, 200, 208, 256])
@pytest.mark.parametrize("M", [1, 300, 65536])
def test_sm90_plan_covers_every_shape(M, C, W, R):
    """What the kernels rely on: one accumulator holds all C columns (a width
    class, a multiple of 16 up to 256); the chunks cover W; the row kernels'
    shared memory (dynamic and static) and the weight gradients' fit a
    block's 227 KB, with 2 to 8 ring slots; the scratch rows are 16-byte
    multiples (TMA reads them) holding a ones column where a weight gradient
    needs one; the splits cover the rows in whole 64-row panels, none empty,
    at most 256; the scratch holds every tile's and split's values; and the
    kernels are given these very values (``kernel_plan``, which the launches
    check)."""
    p = sm90_plan(M, C, W, R)
    assert p["cn"] in SM90_WIDTHS and C <= p["cn"] and p["cn"] % 16 == 0
    assert SM90_WIDTHS.index(p["cn"]) == 0 or C > SM90_WIDTHS[0]
    assert p["nch"] * 64 == p["kw"] and W <= p["kw"] < W + 64
    assert p["slot"] == 4 * 64 * 128 + p["cn"] * 128 and p["slot"] % 1024 == 0
    assert p["smem"] == 1024 + 2 * 4 * 64 * 128 + 2 * p["slot"]
    assert p["smem"] + ROWS_STATIC <= SMEM_LIMIT
    assert 2 <= p["dw_stages"] <= 8 and p["dw_smem"] == 1024 + p["dw_stages"] * 6 * 64 * 128
    assert p["dw_smem"] + 2 * 8 * 8 <= SMEM_LIMIT
    assert (p["cg"], p["wg"]) == (padded_hidden(C), padded_hidden(W))
    assert p["cg"] > C and p["wg"] > W
    for k, n in (("cg", C + 1), ("wg", W + 1), ("cp", C), ("wp", W)):
        assert p[k] % 8 == 0 and n <= p[k] < n + 8, k
    for splits, per in ((p["splits"], p["per_split"]), (p["r_splits"], p["r_per_split"])):
        assert per % 64 == 0 and 1 <= splits <= 256
        assert (splits - 1) * per < M <= splits * per
    tiles = -(-M // 128)
    assert p["copies"] == 2 * (W * 256 + C * p["kw"])
    assert p["pre1s"] == 2 * tiles * p["nch"] * 64 * 64
    assert p["colpart"] == -(-M // 64) * 3 * C
    assert p["partial"] >= p["splits"] * max((W + 1) * C, (C + 1) * W)
    assert p["partial"] >= p["r_splits"] * (C + 1) * R
    assert p["n1"] % 16 == 0 and p["n1"] <= 256
    k = kernel_plan(M, C, W, R)
    assert {name: getattr(k, name) for name, _ in k._fields_} == {
        name: p[name] for name, _ in k._fields_}


@pytest.mark.parametrize("C,R", [(MAX_C + 1, 0), (200, MAX_R + 1), (0, 0)])
def test_sm90_plan_refuses_what_the_kernels_do_not_take(C, R):
    """C above 256 (wgmma's widest N, one accumulator) or more readout
    columns than the backward's wrapper takes: the plan, and so the wrappers
    on the card, raise."""
    with pytest.raises(ValueError, match="bfloat16 kernels take"):
        sm90_plan(100, C, 64, R)


# ---------------- the build ----------------


SM90_SOURCES = ("convnext_mlp_sm90.cu", "convnext_mlp_bwd_sm90.cu")


@pytest.mark.parametrize("edited", ["convnext_sm90.cuh", "wgmma.cuh", *SM90_SOURCES])
def test_build_takes_the_convnext_sm90_sources_and_hashes_their_headers(edited, tmp_path,
                                                                       monkeypatch):
    """The build compiles the bfloat16 #9 and #10 sources, one nvcc process
    each, beside float32's ``convnext_mlp.cu`` and ``convnext_mlp_bwd.cu``;
    an edit of either or of their headers changes the source hash, so a
    stale library is rebuilt."""
    import shutil

    from arreau_tpu_torch.kernels import build

    names = {p.name for p in build._sources()}
    assert set(SM90_SOURCES) | {"convnext_mlp.cu", "convnext_mlp_bwd.cu"} <= names
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._source_hash()
    (csrc / edited).write_text((csrc / edited).read_text() + "\n")
    assert build._source_hash() != before


# ---------------- both chains, emulated ----------------


def _bf16(a):
    """float32 values rounded to bfloat16 (round to nearest even), kept as
    float32."""
    u = np.asarray(a, f32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(f32)


def _steps(a, b, step=16):
    """a [M, K] @ b [K, N] summed in float32 one k16 step at a time."""
    acc = np.zeros((a.shape[0], b.shape[1]), f32)
    for k in range(0, a.shape[1], step):
        acc = (acc + a[:, k:k + step].astype(np.float64) @ b[k:k + step].astype(np.float64)
               ).astype(f32)
    return acc


def _gelu_and_deriv(x):
    x = x.astype(f32)
    t = np.tanh(_GELU_C0 * (x + _GELU_C1 * x * x * x)).astype(f32)
    value = f32(0.5) * x * (f32(1) + t)
    deriv = (f32(0.5) * (f32(1) + t) + f32(0.5) * x * (f32(1) - t * t)
             * _GELU_C0 * (f32(1) + f32(3) * _GELU_C1 * x * x))
    return value.astype(f32), deriv.astype(f32)


def _layer_norm(xc, ln_s, ln_b):
    """(yl rounded, xhat, mean, 1/std) as the kernels' LayerNorm: each lane's
    channels c = lane + 32k summed in order, then the butterfly over 32 lanes."""
    M, C = xc.shape
    x = np.zeros((M, 256), f32)
    x[:, :C] = xc
    lanes = x.reshape(M, 8, 32)
    s, q = np.zeros((M, 32), f32), np.zeros((M, 32), f32)
    for k in range(8):
        s, q = s + lanes[:, k], q + lanes[:, k] * lanes[:, k]
    for off in (16, 8, 4, 2, 1):
        perm = np.arange(32) ^ off
        s, q = s + s[:, perm], q + q[:, perm]
    mu = s[:, :1] / f32(C)
    rstd = (f32(1) / np.sqrt(np.maximum(q[:, :1] / f32(C) - mu * mu, f32(0)) + f32(1e-5))
            ).astype(f32)
    xhat = (xc - mu) * rstd
    return _bf16(xhat * ln_s + ln_b), xhat, mu, rstd


def _forward(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma):
    yl, xhat, mu, rstd = _layer_norm(xc, ln_s, ln_b)
    pre1 = _bf16(_steps(yl, w1) + b1)
    h = _bf16(_gelu_and_deriv(pre1)[0])
    m = _bf16(_steps(h, w2) + b2)  # the chunks' k16 steps, in order
    out = _bf16(res + _bf16(_bf16(gamma) * m))
    return dict(yl=yl, xhat=xhat, rstd=rstd, pre1=pre1, h=h, m=m, out=out)


def emulate_sm90_fwd(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br):
    """(out, r) as the bfloat16 #9 computes them (see the module docstring),
    every input float32 holding its type's values."""
    out = _forward(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma)["out"]
    r = np.zeros((out.shape[0], wr.shape[1]), f32)
    for c in range(out.shape[1]):
        r = r + out[:, c:c + 1] * wr[c]
    return out, r + br


def _tile_column_sums(v, groups):
    """The column sums of v [M, C] over each 64-row tile as cnx_post_kernel
    forms them (``groups`` row groups, rows g, g + groups, ... of each summed
    in order, then the groups in order), then added over the tiles as
    sum_blocks_kernel adds them (eight warps each over every eighth tile in
    order, then the warps in order)."""
    M, C = v.shape
    tiles = -(-M // 64)
    x = np.zeros((tiles * 64, C), f32)
    x[:M] = v
    p = x.reshape(tiles, 64 // groups, groups, C)
    group_sums = []
    for g in range(groups):
        acc = np.zeros((tiles, C), f32)
        for k in range(64 // groups):
            acc = acc + p[:, k, g]
        group_sums.append(acc)
    parts = group_sums[0]
    for acc in group_sums[1:]:
        parts = parts + acc
    sums = [np.zeros(C, f32) for _ in range(8)]
    for b in range(tiles):
        sums[b % 8] = sums[b % 8] + parts[b]
    total = np.zeros(C, f32)
    for acc in sums:
        total = total + acc
    return total


def _split_rows(a, b, per_split, steps=True):
    """sum over the rows of a^T b, a split of per_split rows at a time (k16
    steps of rows, or each row in order), the splits added in order."""
    total = None
    for k0 in range(0, a.shape[0], per_split):
        sa, sb = a[k0:k0 + per_split], b[k0:k0 + per_split]
        if steps:
            part = _steps(sa.T, sb)
        else:
            part = np.zeros((a.shape[1], b.shape[1]), f32)
            for i in range(sa.shape[0]):
                part = part + sa[i][:, None] * sb[i]
        total = part if total is None else (total + part).astype(f32)
    return total


def emulate_sm90_bwd(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, g_out, g_r, plan):
    """(dxc, dres, dln_s, dln_b, dw1, db1, dw2, db2, dgamma, dwr, dbr) as the
    bfloat16 #10 computes them (see the module docstring), with ``plan``'s
    splits."""
    M, C = xc.shape
    W = w1.shape[1]
    f = _forward(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma)
    gr = np.zeros((M, C), f32)
    for q in range(wr.shape[1]):
        gr = gr + g_r[:, q:q + 1] * wr[:, q]
    g = g_out + gr
    dm = _bf16(g * gamma)
    dh = _bf16(_steps(dm, w2.T))
    dpre1 = _bf16(dh * _gelu_and_deriv(f["pre1"])[1])
    dyln = _steps(dpre1, w1.T)
    xhat, rstd = f["xhat"], f["rstd"]
    dxhat = dyln * ln_s
    s1 = dxhat.sum(axis=1, dtype=f32, keepdims=True)
    s2 = (dxhat * xhat).sum(axis=1, dtype=f32, keepdims=True)
    dxc = rstd * (dxhat - s1 / f32(C) - xhat * (s2 / f32(C)))
    ones = np.ones((M, 1), f32)
    dw1_ext = _split_rows(np.concatenate([f["yl"], ones], 1), dpre1, plan["per_split"])
    dw2_ext = _split_rows(np.concatenate([f["h"], ones], 1), dm, plan["per_split"])
    dwr_ext = _split_rows(np.concatenate([f["out"], ones], 1), g_r, plan["r_per_split"],
                          steps=False)
    return (dxc, _bf16(g), _tile_column_sums(dyln * xhat, 8), _tile_column_sums(dyln, 8),
            dw1_ext[:C], dw1_ext[C], dw2_ext[:W], dw2_ext[W], _tile_column_sums(g * f["m"], 8),
            dwr_ext[:C], dwr_ext[C])


def _inputs(seed, Bp, O, TA, C, W, R):
    """(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, g_out, g_r) as
    numpy float32 [B', O, TA, *] tensors, the bfloat16 ones rounded: the
    card tests' scales (tests/test_torch_cuda.py:_convnext_args)."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0, bf=False):
        v = (rng.normal(size=shape) * scale + shift).astype(f32)
        return _bf16(v) if bf else v

    return (t(Bp, O, TA, C, scale=2.0, shift=0.5), t(Bp, O, TA, C, bf=True),
            t(C, scale=0.1, shift=1.0), t(C, scale=0.1), t(C, W, scale=0.1, bf=True),
            t(W, scale=0.1, bf=True), t(W, C, scale=0.05, bf=True), t(C, scale=0.1, bf=True),
            t(C, scale=0.5, shift=1.0), t(C, R, scale=0.1), t(R, scale=0.1),
            t(Bp, O, TA, C, bf=True), t(Bp, O, TA, R))


def _rel(got, want):
    want = np.asarray(want, f32)
    scale = np.abs(want).max()
    assert scale > 0
    return np.abs(np.asarray(got, f32) - want).max() / scale


def _torch(args):
    """The inputs as the port's wrappers take them: res, w1, b1, w2, b2 and
    g_out in bfloat16."""
    t = [torch.tensor(a) for a in args]
    for i in (1, 4, 5, 6, 7, 11):
        t[i] = t[i].to(torch.bfloat16)
    return t


def _jax(args):
    """The JAX kernels' inputs: res, w1, b1, w2, b2 and g_out in bfloat16."""
    return [jnp.asarray(a, jnp.bfloat16) if i in (1, 4, 5, 6, 7, 11) else jnp.asarray(a)
            for i, a in enumerate(args)]


# (B', O, TA, C, W, R): a ragged case (rows, C and W off every tile, chunk
# and panel; C off the 16-channel k16 step) and one at the model's ratios
CASES = [(2, 3, 41, 24, 100, 5), (1, 4, 64, 40, 160, 3)]


@pytest.mark.parametrize("case", CASES, ids=["ragged", "model_ratio"])
def test_emulated_sm90_forward_matches_plain_and_pallas(case):
    """#9's bfloat16 chain, emulated, against convnext_mlp_plain and against
    the Pallas _fwd in interpret mode, at the tolerances above."""
    Bp, O, TA, C, W, R = case
    args = _inputs(11, *case)
    rows = [a.reshape(-1, a.shape[-1]) if a.ndim == 4 else a for a in args]
    out, r = emulate_sm90_fwd(*rows[:11])
    p_out, p_r = convnext_mlp_plain(*_torch(args)[:11])
    with jax.enable_x64(False):
        j_out, j_r = _fwd(*_jax(args)[:11], jnp.bfloat16)
    for name, got, plain, pallas in (("out", out, p_out, j_out), ("r", r, p_r, j_r)):
        plain = plain.float().numpy().reshape(got.shape)
        pallas = np.asarray(jnp.asarray(pallas, jnp.float32)).reshape(got.shape)
        assert _rel(got, plain) <= PLAIN_REL_TOL, name
        assert _rel(got, pallas) <= PALLAS_REL_TOL, name


@pytest.mark.parametrize("case", CASES, ids=["ragged", "model_ratio"])
def test_emulated_sm90_backward_matches_plain_and_pallas(case):
    """#10's bfloat16 chain, emulated with the plan's splits, against
    convnext_mlp_bwd_plain and against the Pallas _bwd in interpret mode, all
    eleven gradients, at the tolerances above."""
    Bp, O, TA, C, W, R = case
    args = _inputs(12, *case)
    rows = [a.reshape(-1, a.shape[-1]) if a.ndim == 4 else a for a in args]
    plan = sm90_plan(Bp * O * TA, C, W, R)
    got = emulate_sm90_bwd(*rows, plan)
    plain = convnext_mlp_bwd_plain(*_torch(args))
    j = _jax(args)
    with jax.enable_x64(False):
        grads = _bwd(*j[:11], jnp.bfloat16, j[11], j[12])
    pallas = [grads[k] for k in ("dxc", "dres", "dlns", "dlnb", "dw1", "db1", "dw2", "db2", "dg",
                                 "dwr", "dbr")]
    names = ("dxc", "dres", "dln_s", "dln_b", "dw1", "db1", "dw2", "db2", "dgamma", "dwr", "dbr")
    for name, a, p, q in zip(names, got, plain, pallas):
        p = p.float().numpy().reshape(a.shape)
        q = np.asarray(jnp.asarray(q, jnp.float32)).reshape(a.shape)
        assert _rel(a, p) <= PLAIN_REL_TOL, name
        assert _rel(a, q) <= PALLAS_REL_TOL, name
