"""The port's fused basis MLP (kernels #5/#6, ``kernels/fused_basis_mlp.py``,
reached through ``BasisMLP(fused=True)``) against the JAX package on the
CPU: the plain versions behind the port's autograd Function against the
Pallas ``fused_basis_mlp`` in interpret mode (as ``tests/test_pallas_conv.py``
runs it), forward and weight gradients, in float32 and bfloat16; the
port's ``BasisMLP(fused=True)`` against the JAX ``BasisMLP(fused=True)`` on
the same parameter tree; and the cases where both packages take the plain
chain instead. Inputs are made with numpy and fed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.models.blocks import BasisMLP as JBasisMLP
from arreau_tpu.ops.pallas_basis import fused_basis_mlp as j_fused_basis_mlp
from arreau_tpu_torch.interop.from_jax import basis_mlp_params_from_jax
from arreau_tpu_torch.kernels import fused_basis_mlp as fbm
from arreau_tpu_torch.kernels.fused_basis_mlp import (
    fused_basis_mlp,
    fused_basis_mlp_bwd,
    fused_basis_mlp_bwd_plain,
    fused_basis_mlp_fn,
    fused_basis_mlp_plain,
)
from arreau_tpu_torch.models import blocks
from arreau_tpu_torch.models.blocks import BasisMLP

# float32: the JAX package's own tolerances for this kernel
# (tests/test_pallas_conv.py:test_fused_basis_mlp_matches_flax_oracle):
# values 2e-5, weight gradients 3e-4
F32_FWD_TOL = dict(rtol=2e-5, atol=2e-5)
F32_GRAD_TOL = dict(rtol=3e-4, atol=3e-4)
# bfloat16: both packages sum in float32 and round at the same points, but
# a value next to a rounding boundary may round the other way (one bf16
# ulp, 2^-8) and carry, and the JAX kernel evaluates GELU and its derivative
# in bfloat16 step by step where the port evaluates them in float32 and
# rounds once (ROADMAP Queue C 3): values within 1e-2 of their largest
# magnitude. Each weight gradient sums a few hundred rows, each through
# three bfloat16 roundings of the cotangent chain (db_pre, dh, dh_pre), too
# few for the flips to average out: within 2e-2 of its largest entry
# (measured: up to 1.5e-2 between the packages at these shapes; the JAX
# package's own bfloat16 gradients lay up to 1.8e-2 from the float64
# gradient of the same bfloat16 inputs)
BF16_REL_TOL = 1e-2
BF16_GRAD_REL_TOL = 2e-2
Bp, O, E, H, D = 2, 3, 40, 20, 12


def _rel(got, want):
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert scale > 0
    return np.abs(np.asarray(got, np.float32) - want).max() / scale


def _inputs(degree, d=6, seed=0):
    rng = np.random.default_rng(seed + degree)
    F = sum(d**i for i in range(1, degree + 1))
    return (rng.normal(size=(Bp, O, E, d)), rng.normal(size=(F, H)) * 0.3,
            rng.normal(size=(H, D)) * 0.3, rng.normal(size=(Bp, O, E, D)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("degree", [1, 2, 3])
def test_plain_versions_match_jax_fused_basis_mlp(degree, dtype):
    """The basis and the weight gradients of the port's Function (#5/#6,
    plain versions on CPU tensors) against jax.vjp of the Pallas
    fused_basis_mlp, on the same inputs in the same type; both give the
    attributes a zero cotangent."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    attr, w1, w2, g = (jnp.asarray(a, jdt) for a in _inputs(degree))
    want, vjp = jax.vjp(lambda *a: j_fused_basis_mlp(*a, degree, jdt), attr, w1, w2)
    want_grads = vjp(g)
    leaves = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(tdt).requires_grad_()
              for a in (attr, w1, w2)]
    got = fused_basis_mlp_fn(*leaves, degree)
    got.backward(torch.tensor(np.asarray(g.astype(jnp.float32))).to(tdt))
    assert got.dtype == tdt
    assert float(jnp.abs(want_grads[0]).max()) == 0.0
    assert leaves[0].grad.abs().max().item() == 0.0
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, **F32_FWD_TOL)
    else:
        assert _rel(got.detach().float().numpy(), want) <= BF16_REL_TOL
    for name, leaf, ref in zip(("w1", "w2"), leaves[1:], want_grads[1:]):
        assert leaf.grad.dtype == tdt, name
        ref = np.asarray(ref.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(leaf.grad.numpy(), ref, **F32_GRAD_TOL, err_msg=name)
        else:
            assert _rel(leaf.grad.float().numpy(), ref) <= BF16_GRAD_REL_TOL, name


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_plain_backward_is_vjp_of_plain_forward(degree):
    """fused_basis_mlp_bwd_plain is the weight VJP of fused_basis_mlp_plain
    (float64, where every rounding is the identity: exact up to summation
    order)."""
    attr, w1, w2, g = (torch.tensor(a, dtype=torch.float64) for a in _inputs(degree, d=4))
    leaves = [w1.clone().requires_grad_(), w2.clone().requires_grad_()]
    want = torch.autograd.grad(fused_basis_mlp_plain(attr, *leaves, degree), leaves, g)
    got = fused_basis_mlp_bwd_plain(attr, w1, w2, degree, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)


def _jax_module(dtype, **kw):
    return JBasisMLP(H, D, 3, dtype=None if dtype == "float32" else jnp.bfloat16, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_module_matches_jax_fused_module(dtype):
    """The port's BasisMLP(fused=True, use_bias=False), loaded from a JAX
    BasisMLP(fused=True) parameter tree by basis_mlp_params_from_jax,
    against that module's apply and jax.grad of a sum of squares: values
    and weight gradients, the output in the compute type."""
    attr = _inputs(3)[0]
    jmod = _jax_module(dtype, use_bias=False, fused=True)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(attr, jnp.float32))
    assert set(params["params"]) == {"dense_in", "dense_out"}

    def loss(p):
        return (jmod.apply(p, jnp.asarray(attr, jnp.float32)).astype(jnp.float32) ** 2).sum()

    want = jmod.apply(params, jnp.asarray(attr, jnp.float32))
    want_grads = jax.grad(loss)(params)["params"]
    module = BasisMLP(6, H, D, 3, use_bias=False, fused=True)
    basis_mlp_params_from_jax(module, jax.tree.map(np.asarray, params))
    cdt = None if dtype == "float32" else torch.bfloat16
    got = module(torch.tensor(attr, dtype=torch.float32), cdt)
    assert got.dtype == getattr(torch, dtype) and want.dtype == getattr(jnp, dtype)
    (got.float() ** 2).sum().backward()
    pairs = [(got.detach(), want)] + [
        (getattr(module, name).weight.grad.t(), want_grads[name]["kernel"])
        for name in ("dense_in", "dense_out")]
    for i, (a, b) in enumerate(pairs):
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), b, **(F32_GRAD_TOL if i else F32_FWD_TOL))
        else:
            assert _rel(a.float().numpy(), b) <= (BF16_GRAD_REL_TOL if i else BF16_REL_TOL), i


@pytest.mark.parametrize("case", ["bias", "out_bias", "3d_attr"])
def test_fused_module_takes_plain_chain_where_jax_does(case, monkeypatch):
    """BasisMLP(fused=True) with a bias on either layer, or a 3-D attr, runs
    the plain chain in both packages (the JAX condition at
    arreau_tpu/models/blocks.py:193-194): the fused Function is not called
    and the output is the JAX module's."""
    attr = _inputs(3)[0]
    kw = dict(bias=dict(use_bias=True), out_bias=dict(use_bias=False, out_bias=True),
              **{"3d_attr": dict(use_bias=False)})[case]
    if case == "3d_attr":
        attr = attr.reshape(Bp * O, E, 6)
    jmod = _jax_module("float32", fused=True, **kw)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(attr, jnp.float32)))
    want = np.asarray(jmod.apply(params, jnp.asarray(attr, jnp.float32)))

    def fail(*args):
        raise AssertionError("the fused Function ran")

    monkeypatch.setattr(blocks, "fused_basis_mlp_fn", fail)
    module = BasisMLP(6, H, D, 3, fused=True, **kw)
    basis_mlp_params_from_jax(module, params)
    with torch.no_grad():
        got = module(torch.tensor(attr, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, **F32_FWD_TOL)


def test_wrappers_check_their_inputs():
    attr, w1, w2 = torch.zeros((1, 2, 8, 3)), torch.zeros((39, 5)), torch.zeros((5, 4))
    assert fused_basis_mlp(attr, w1, w2, 3).shape == (1, 2, 8, 4)
    with pytest.raises(ValueError, match="degree 1..3"):
        fused_basis_mlp(attr, w1, w2, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_basis_mlp(attr, w1, w2, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_basis_mlp(attr.half(), w1.half(), w2.half(), 3)
    with pytest.raises(TypeError, match="like attr"):
        fused_basis_mlp(attr, w1.bfloat16(), w2, 3)
    with pytest.raises(ValueError, match="g must be"):
        fused_basis_mlp_bwd(attr, w1, w2, 3, torch.zeros((1, 2, 8, 5)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_basis_mlp(*(t.to("meta") for t in (attr, w1, w2)), 3)
    # a CPU tensor runs the plain version, and counts no launch
    before = (fused_basis_mlp.launches, fused_basis_mlp_bwd.launches)
    fused_basis_mlp_bwd(attr, w1, w2, 3, torch.zeros((1, 2, 8, 4)))
    assert (fbm.fused_basis_mlp.launches, fbm.fused_basis_mlp_bwd.launches) == before


def test_build_compiles_and_hashes_both_fused_basis_sources(tmp_path, monkeypatch):
    """The build takes csrc/fused_basis_mlp.cu and csrc/fused_basis_mlp_bwd.cu,
    and an edit of either changes the source hash, so a stale library is
    rebuilt."""
    import shutil

    from arreau_tpu_torch.kernels import build

    names = ("fused_basis_mlp.cu", "fused_basis_mlp_bwd.cu")
    assert set(names) <= {p.name for p in build._sources()}
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._source_hash()
    for name in names:
        (csrc / name).write_text((csrc / name).read_text() + "\n")
        after = build._source_hash()
        assert after != before, name
        before = after
