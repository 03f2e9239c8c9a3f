"""The port's fused fiber conv (kernels #1/#2, ``kernels/fiber_conv.py``)
against the JAX package on the CPU: the Pallas ``fused_fiber_conv`` in
interpret mode (as ``tests/test_pallas_conv.py`` runs it), the plain
``reference_fiber_conv``, and the port's ``fused_fiber_conv`` (its plain
versions on CPU tensors), forward and gradients, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.ops.pallas_conv import fused_fiber_conv as j_fused_fiber_conv
from arreau_tpu.ops.pallas_conv import make_gather_matrix, reference_fiber_conv
from arreau_tpu_torch.kernels.fiber_conv import (
    fiber_conv,
    fiber_conv_bwd,
    fiber_conv_bwd_plain,
    fiber_conv_plain,
    fused_fiber_conv,
)
from arreau_tpu_torch.models.ponita import tile_senders

# the JAX package's own tolerances for this kernel (tests/test_pallas_conv.py):
# float32 forward 1e-5, gradients 1e-4
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _data(B=4, A=6, K=4, O=4, D=16, C=32, P=None, seed=0):
    """Standard layouts, float32: basis [B, A, K, O, D], w [D, C], x [B, A,
    O, C], src/mask [B, A, K] (about 30% empty slots), fk [O, P, C]."""
    rng = np.random.default_rng(seed)
    P = P or O
    f32 = np.float32
    return (rng.normal(size=(B, A, K, O, D)).astype(f32),
            (rng.normal(size=(D, C)) * 0.1).astype(f32),
            rng.normal(size=(B, A, O, C)).astype(f32),
            rng.integers(0, A, size=(B, A, K)).astype(np.int32),
            rng.random((B, A, K)) > 0.3,
            (rng.normal(size=(O, P, C)) * 0.3).astype(f32))


def _kernel_layout(basis, x, tile):
    B, A, K, O, D = basis.shape
    Bp = B // tile
    basis_om = basis.reshape(Bp, tile, A, K, O, D).transpose(0, 4, 3, 1, 2, 5)
    x_om = x.reshape(Bp, tile, A, O, -1).transpose(0, 3, 1, 2, 4)
    return (np.ascontiguousarray(basis_om.reshape(Bp, O, K * tile * A, D)),
            np.ascontiguousarray(x_om.reshape(Bp, O, tile * A, x.shape[-1])))


def _standard_layout(y, B, A, tile):
    """[B', P, TA, C] -> [B, A, P, C]."""
    Bp, P, TA, C = y.shape
    return y.reshape(Bp, P, tile, A, C).transpose(0, 2, 3, 1, 4).reshape(B, A, P, C)


def _jax_fused(basis, w, x, src, mask, fk, tile):
    B, A = basis.shape[:2]
    basis_om, x_om = _kernel_layout(basis, x, tile)
    sel = make_gather_matrix(jnp.asarray(src), jnp.asarray(mask), dtype=jnp.float32,
                             crystals_per_tile=tile)
    y = j_fused_fiber_conv(jnp.asarray(basis_om), jnp.asarray(w), jnp.asarray(x_om), sel,
                           jnp.asarray(fk))
    return _standard_layout(np.asarray(y), B, A, tile)


def _port_args(basis, w, x, src, mask, fk, tile, requires_grad=False):
    basis_om, x_om = _kernel_layout(basis, x, tile)
    leaves = [torch.tensor(a, requires_grad=requires_grad) for a in (basis_om, w, x_om, fk)]
    src_t = tile_senders(torch.tensor(src), torch.tensor(mask), tile)
    return leaves, src_t


@pytest.mark.parametrize("tile", [1, 2, 4])
def test_forward_matches_jax_pallas_and_reference(tile):
    """TA = 6 * tile atoms: 6, 12, 24 (none a multiple of 8), empty slots."""
    basis, w, x, src, mask, fk = _data()
    B, A = basis.shape[:2]
    want_ref = np.asarray(reference_fiber_conv(*map(jnp.asarray, (basis, w, x, src, mask, fk))))
    want_pallas = _jax_fused(basis, w, x, src, mask, fk, tile)
    (b, w_, x_, fk_), src_t = _port_args(basis, w, x, src, mask, fk, tile)
    with torch.no_grad():
        got = _standard_layout(fused_fiber_conv(b, w_, x_, src_t, fk_).numpy(), B, A, tile)
    np.testing.assert_allclose(got, want_pallas, **FWD_TOL)
    np.testing.assert_allclose(got, want_ref, **FWD_TOL)


def test_output_orientations_may_differ_from_input_orientations():
    """Kf [O, P, C] with P != O, as the JAX kernel allows."""
    basis, w, x, src, mask, fk = _data(O=3, P=5, seed=2)
    B, A = basis.shape[:2]
    want = np.asarray(reference_fiber_conv(*map(jnp.asarray, (basis, w, x, src, mask, fk))))
    (b, w_, x_, fk_), src_t = _port_args(basis, w, x, src, mask, fk, 2)
    got = _standard_layout(fiber_conv(b, w_, x_, src_t, fk_).numpy(), B, A, 2)
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("tile", [1, 2])
def test_gradients_match_jax_pallas(tile):
    """torch.autograd through the port's Function (backward = fiber_conv_bwd)
    against jax.grad through the Pallas custom VJP, for basis, w, x and Kf."""
    basis, w, x, src, mask, fk = _data(seed=1)
    basis_om, x_om = _kernel_layout(basis, x, tile)
    sel = make_gather_matrix(jnp.asarray(src), jnp.asarray(mask), dtype=jnp.float32,
                             crystals_per_tile=tile)

    def loss_j(b, w_, x_, fk_):
        return (j_fused_fiber_conv(b, w_, x_, sel, fk_) ** 2).sum()

    want = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (basis_om, w, x_om, fk)))
    leaves, src_t = _port_args(basis, w, x, src, mask, fk, tile, requires_grad=True)
    (fused_fiber_conv(leaves[0], leaves[1], leaves[2], src_t, leaves[3]) ** 2).sum().backward()
    for name, leaf, ref in zip(("basis", "w", "x", "fiber_kernel"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=name)


def test_plain_backward_matches_autograd_of_plain_forward():
    """fiber_conv_bwd_plain, given the spatial conv the forward saved, is the
    VJP of fiber_conv_plain (float64, exact up to summation order), with
    out-of-range senders as empty slots."""
    rng = np.random.default_rng(3)
    Bp, O, P, K, TA, D, C = 2, 3, 5, 3, 7, 6, 9
    f64 = torch.float64
    basis, w, x, fk, g = (torch.tensor(rng.normal(size=s), dtype=f64) for s in
                          ((Bp, O, K * TA, D), (D, C), (Bp, O, TA, C), (O, P, C), (Bp, P, TA, C)))
    src = torch.tensor(rng.integers(-1, TA + 2, size=(Bp, K * TA)), dtype=torch.int32)
    leaves = [t.clone().requires_grad_() for t in (basis, w, x, fk)]
    y = fiber_conv_plain(leaves[0], leaves[1], leaves[2], src, leaves[3])
    want = torch.autograd.grad(y, leaves, g)
    y_saved, x_sp = fiber_conv_plain(basis, w, x, src, fk, save_x_sp=True)
    np.testing.assert_array_equal(y_saved.numpy(), y.detach().numpy())
    got = fiber_conv_bwd_plain(basis, w, x, src, fk, g, x_sp)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)


def test_wrappers_check_their_inputs():
    x = torch.zeros((1, 2, 4, 8))
    basis, w = torch.zeros((1, 2, 8, 3)), torch.zeros((3, 8))
    fk, src = torch.zeros((2, 2, 8)), torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="src"):
        fiber_conv(basis, w, x, src.long(), fk)
    with pytest.raises(ValueError, match="fiber_kernel"):
        fiber_conv(basis, w, x, src, torch.zeros((3, 2, 8)))
    with pytest.raises(ValueError, match="g must be"):
        fiber_conv_bwd(basis, w, x, src, fk, torch.zeros((1, 3, 4, 8)), x)
    with pytest.raises(ValueError, match="x_sp must be"):
        fiber_conv_bwd(basis, w, x, src, fk, torch.zeros((1, 2, 4, 8)), x[:, :1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        fiber_conv(*(t.to("meta") for t in (basis, w, x, src, fk)))


def test_build_compiles_and_hashes_both_fiber_sources(tmp_path, monkeypatch):
    """The build takes csrc/fiber_conv.cu and csrc/fiber_conv_bwd.cu,
    and an edit of either changes the source hash, so a stale library is
    rebuilt."""
    import shutil

    from arreau_tpu_torch.kernels import build

    assert {"fiber_conv.cu", "fiber_conv_bwd.cu"} <= {p.name for p in build._sources()}
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._source_hash()
    for name in ("fiber_conv.cu", "fiber_conv_bwd.cu"):
        (csrc / name).write_text((csrc / name).read_text() + "\n")
        after = build._source_hash()
        assert after != before, name
        before = after
