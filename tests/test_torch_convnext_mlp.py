"""The port's fused ConvNext MLP (kernels #9/#10, ``kernels/convnext_mlp.py``)
against the JAX package on the CPU: the Pallas ``fused_convnext_mlp`` in
interpret mode (as ``tests/test_pallas_conv.py`` runs it) and the port's
plain versions (what its wrappers run on CPU tensors), forward and all
eleven gradients, in float32 and in bfloat16, with and without the
readout, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.ops.pallas_convnext import fused_convnext_mlp as j_fused_convnext_mlp
from arreau_tpu_torch.kernels.convnext_mlp import (
    convnext_mlp,
    convnext_mlp_bwd,
    convnext_mlp_bwd_plain,
    convnext_mlp_plain,
    fused_convnext_mlp,
)

# float32: the JAX package's own bounds for this kernel
# (tests/test_pallas_conv.py:test_fused_convnext_mlp_matches_flax_oracle)
F32_FWD_TOL = dict(rtol=2e-5, atol=2e-5)
F32_GRAD_TOL = dict(rtol=3e-4, atol=3e-4)
# bfloat16: both sides sum in float32 and round at the same points, but a
# value next to a rounding boundary may round the other way (one bf16 ulp,
# 2^-8 relative) and carry into what follows; each output is held to 1e-2
# of its largest magnitude
BF16_REL_TOL = 1e-2
NAMES = ("xc", "res", "ln_s", "ln_b", "w1", "b1", "w2", "b2", "gamma", "wr", "br")


def _inputs(cdt, seed=0, Bp=2, O=3, TA=8, C=12, W=48, R=5):
    """(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, g_out, g_r) as
    numpy float32, with the compute-type ones already rounded to ``cdt``;
    the layer scale is of order 1 so the MLP weighs in ``out``."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    def rounded(a):
        return np.asarray(jnp.asarray(a, cdt).astype(jnp.float32))

    xc = f(Bp, O, TA, C, scale=2.0, shift=0.5)
    res = rounded(f(Bp, O, TA, C))
    w1, b1 = rounded(f(C, W, scale=0.3)), rounded(f(W, scale=0.1))
    w2, b2 = rounded(f(W, C, scale=0.2)), rounded(f(C, scale=0.1))
    g_out = rounded(f(Bp, O, TA, C))
    return (xc, res, f(C, scale=0.1, shift=1.0), f(C, scale=0.1), w1, b1, w2, b2,
            f(C, scale=0.5, shift=1.0), f(C, R, scale=0.3), f(R, scale=0.1), g_out,
            f(Bp, O, TA, R))


def _jax(args, cdt, readout):
    """out, r and the eleven cotangents of the JAX Pallas kernel."""
    xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, g_out, g_r = args
    cast = [jnp.asarray(a, cdt) if i in (1, 4, 5, 6, 7) else jnp.asarray(a)
            for i, a in enumerate(args[:11])]
    if not readout:
        cast[9] = cast[10] = None

    def fn(*a):
        return j_fused_convnext_mlp(*a, cdt)

    (out, r), vjp = jax.vjp(fn, *cast)
    cot = (jnp.asarray(g_out, cdt), jnp.asarray(g_r) if readout else None)
    grads = vjp(cot)
    as_np = lambda v: None if v is None else np.asarray(jnp.asarray(v, jnp.float32))  # noqa: E731
    return as_np(out), as_np(r), [as_np(g) for g in grads]


def _port(args, tdt, readout):
    t = [torch.tensor(a) for a in args]
    for i in (1, 4, 5, 6, 7, 11):
        t[i] = t[i].to(tdt)
    wr, br, g_r = (t[9], t[10], t[12]) if readout else (None, None, None)
    out, r = convnext_mlp_plain(*t[:9], wr, br)
    grads = convnext_mlp_bwd_plain(*t[:9], wr, br, t[11], g_r)
    as_np = lambda v: None if v is None else v.float().numpy()  # noqa: E731
    return as_np(out), as_np(r), [as_np(g) for g in grads]


@pytest.mark.parametrize("readout", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_pallas_kernel(dtype, readout):
    """convnext_mlp_plain and convnext_mlp_bwd_plain against the Pallas
    fused_convnext_mlp and its custom VJP (interpret mode): out, r and the
    cotangents of all eleven inputs."""
    cdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    args = _inputs(cdt, seed=1 if readout else 2)
    want_out, want_r, want_g = _jax(args, cdt, readout)
    got_out, got_r, got_g = _port(args, tdt, readout)
    assert (got_r is None) == (want_r is None) == (not readout)
    pairs = [("out", got_out, want_out), ("r", got_r, want_r)]
    pairs += [(f"d{n}", g, w) for n, g, w in zip(NAMES, got_g, want_g)]
    for i, (name, got, want) in enumerate(pairs):
        if want is None:
            assert got is None, name
            continue
        assert got.shape == want.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **(F32_FWD_TOL if i < 2 else F32_GRAD_TOL),
                                       err_msg=name)
        else:
            scale = np.abs(want).max()
            assert scale > 0, name
            assert np.abs(got - want).max() <= BF16_REL_TOL * scale, (
                name, np.abs(got - want).max(), scale)


@pytest.mark.parametrize("readout", [True, False])
def test_plain_backward_matches_autograd_of_plain_forward(readout):
    """convnext_mlp_bwd_plain is the VJP of convnext_mlp_plain: float64 (the
    rounding points are then the identity), exact up to summation order."""
    args = [torch.tensor(a, dtype=torch.float64) for a in _inputs(jnp.float32, seed=3)]
    leaves = [a.clone().requires_grad_() for a in args[:11]]
    if not readout:
        leaves = leaves[:9]
    out, r = convnext_mlp_plain(*leaves, *([None, None] if not readout else []))
    outs, cots = [out], [args[11]]
    if readout:
        outs.append(r)
        cots.append(args[12])
    want = torch.autograd.grad(outs, leaves, cots)
    got = convnext_mlp_bwd_plain(*args[:9], *(args[9:11] if readout else (None, None)),
                                 args[11], args[12] if readout else None)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12, err_msg=name)
    if not readout:
        assert got[9] is None and got[10] is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_function_routes_every_cotangent(dtype):
    """The autograd Function on CPU tensors: its forward is the plain
    forward, and each input's gradient is the plain backward's, in that
    input's type (bfloat16 weights get bfloat16 gradients, as the JAX VJP's
    ``.astype``)."""
    args = [torch.tensor(a) for a in _inputs(jnp.bfloat16, seed=4)]
    for i in (1, 4, 5, 6, 7, 11):
        args[i] = args[i].to(dtype)
    leaves = [a.clone().requires_grad_() for a in args[:11]]
    out, r = fused_convnext_mlp(*leaves)
    want_out, want_r = convnext_mlp_plain(*args[:11])
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(r, want_r, rtol=0, atol=0)
    torch.autograd.backward([out, r], [args[11], args[12]])
    want = convnext_mlp_bwd_plain(*args[:11], args[11], args[12])
    for name, leaf, g in zip(NAMES, leaves, want):
        assert leaf.grad.dtype == leaf.dtype, name
        torch.testing.assert_close(leaf.grad, g.to(leaf.dtype), rtol=0, atol=0, msg=name)
    out_nr, r_nr = fused_convnext_mlp(*leaves[:9])
    assert r_nr is None
    torch.testing.assert_close(out_nr, out, rtol=0, atol=0)


def test_wrappers_check_their_inputs():
    args = [torch.tensor(a) for a in _inputs(jnp.float32, seed=5)]
    xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, g_out, g_r = args
    base = [xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br]

    def with_(i, value):
        return base[:i] + [value] + base[i + 1:]

    with pytest.raises(TypeError, match="compute type"):
        convnext_mlp(*with_(1, res.half()))
    with pytest.raises(TypeError, match="w1 must be"):
        convnext_mlp(*with_(4, w1.bfloat16()))
    with pytest.raises(TypeError, match="xc must be float32"):
        convnext_mlp(*with_(0, xc.bfloat16()))
    with pytest.raises(TypeError, match="gamma must be float32"):
        convnext_mlp(*with_(8, gamma.double()))
    with pytest.raises(ValueError, match="w2 must be"):
        convnext_mlp(*with_(6, w2[:-1]))
    with pytest.raises(ValueError, match="both wr and br"):
        convnext_mlp(*base[:10], None)
    with pytest.raises(ValueError, match="g_out must be"):
        convnext_mlp_bwd(*base, g_out.bfloat16(), g_r)
    with pytest.raises(ValueError, match="g_r must be given"):
        convnext_mlp_bwd(*base[:9], None, None, g_out, g_r)
    with pytest.raises(ValueError, match="g_r must be float32"):
        convnext_mlp_bwd(*base, g_out, g_r[..., :-1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        convnext_mlp(*(t.to("meta") for t in base))


def test_build_compiles_and_hashes_both_convnext_sources(tmp_path, monkeypatch):
    """The build takes csrc/convnext_mlp.cu and csrc/convnext_mlp_bwd.cu
    among its twenty-one sources, and an edit of either, or of their shared
    header, changes the source hash, so a stale library is rebuilt."""
    import shutil

    from arreau_tpu_torch.kernels import build

    names = {p.name for p in build._sources()}
    assert {"convnext_mlp.cu", "convnext_mlp_bwd.cu"} <= names
    assert len(names) == 21
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._source_hash()
    for name in ("convnext_mlp.cu", "convnext_mlp_bwd.cu", "convnext_rows.cuh", "dtype.cuh"):
        (csrc / name).write_text((csrc / name).read_text() + "\n")
        after = build._source_hash()
        assert after != before, name
        before = after
