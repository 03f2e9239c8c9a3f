"""The PyTorch port's training-side ops against the JAX package on the CPU:
forward noising (VE under PBC, VP, D3PM), the D3PM loss, lattice codecs and
rotations, the synthetic data and the bucketed loader, and the plain
backward versions of the CUDA kernels against autograd.

Random numbers come from the same ``jax.random`` keys the JAX functions
draw from, handed to the port as tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from arreau_tpu.data.crystal import BucketedLoader as JLoader
from arreau_tpu.data.crystal import pack_dense_batch as j_pack
from arreau_tpu.data.crystal import random_split as j_random_split
from arreau_tpu.data.synthetic import make_synthetic_batch as j_make_batch
from arreau_tpu.data.synthetic import synthetic_packed as j_synthetic_packed
from arreau_tpu.diffusion import d3pm as jd3pm
from arreau_tpu.diffusion.ve import make_ve_schedule as j_ve_schedule
from arreau_tpu.diffusion.ve import ve_forward_pbc as j_ve_forward_pbc
from arreau_tpu.diffusion.vp import make_vp_schedule as j_vp_schedule
from arreau_tpu.diffusion.vp import vp_forward as j_vp_forward
from arreau_tpu.ops import lattice as jlattice
from arreau_tpu.ops.pbc import min_distance_pbc as j_min_distance_pbc
from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import rotate_batch as j_rotate_batch
from arreau_tpu_torch.data.crystal import BucketedLoader, pack_dense_batch, random_split
from arreau_tpu_torch.data.synthetic import make_synthetic_batch, synthetic_packed
from arreau_tpu_torch.data.atoms import synthetic_z_table
from arreau_tpu_torch.diffusion.d3pm import d3pm_loss, d3pm_sample_xt, make_d3pm_tables
from arreau_tpu_torch.diffusion.ve import make_ve_schedule, ve_forward_pbc
from arreau_tpu_torch.diffusion.vp import make_vp_schedule, vp_forward
from arreau_tpu_torch.kernels.basis_h1 import basis_h1_plain
from arreau_tpu_torch.kernels.basis_mlp import basis_mlp_bwd_plain, basis_mlp_multi
from arreau_tpu_torch.kernels.spatial_conv import (
    fused_spatial_conv,
    spatial_conv_bwd_plain,
    spatial_conv_plain,
)
from arreau_tpu_torch.ops.lattice import encode_angles, matrix_to_params, rotations_from_normals
from arreau_tpu_torch.ops.pbc import min_distance_pbc
from arreau_tpu_torch.tasks.diffusion import CrystalBatch, rotate_batch

Z_TABLE = synthetic_z_table()
T = 50
# float32 elementwise chains (a few roundings apart between XLA and torch)
F32 = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x)


def _host_batch(B=6, A=5, seed=0):
    return j_make_batch(np.random.default_rng(seed), Z_TABLE, B, A)


# ---------------- geometry and forward noising ----------------


def test_min_distance_pbc_matches_jax():
    rng = np.random.default_rng(0)
    host = _host_batch()
    cart1 = rng.normal(size=host.frac_x.shape).astype(np.float32) * 4
    cart2 = rng.normal(size=host.frac_x.shape).astype(np.float32) * 4
    want = j_min_distance_pbc(jnp.asarray(cart1), jnp.asarray(cart2), jnp.asarray(host.lattice))
    got = min_distance_pbc(torch.tensor(cart1), torch.tensor(cart2), torch.tensor(host.lattice))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **F32)


def test_lattice_codecs_match_jax():
    host = _host_batch()
    lengths, angles = matrix_to_params(torch.tensor(host.lattice))
    j_lengths, j_angles = jlattice.matrix_to_params(jnp.asarray(host.lattice))
    np.testing.assert_allclose(lengths.numpy(), _np(j_lengths), **F32)
    np.testing.assert_allclose(angles.numpy(), _np(j_angles), **F32)
    np.testing.assert_allclose(encode_angles(angles).numpy(),
                               _np(jlattice.encode_angles(j_angles)), **F32)


@pytest.mark.parametrize("seed", [0, 1])
def test_ve_forward_pbc_matches_jax(seed):
    """The noisy coordinates and the min-image target, with the normals the
    JAX function draws from its key."""
    host = _host_batch(seed=seed)
    key = jax.random.PRNGKey(seed)
    t = np.random.default_rng(seed).integers(1, T + 1, size=host.frac_x.shape[0])
    want = j_ve_forward_pbc(j_ve_schedule(T, 0.001, 1.0), key, jnp.asarray(host.frac_x),
                            jnp.asarray(t), jnp.asarray(host.lattice))
    eps = jax.random.normal(key, host.frac_x.shape, dtype=jnp.float32)
    got = ve_forward_pbc(make_ve_schedule(T, 0.001, 1.0), torch.tensor(_np(eps)),
                         torch.tensor(host.frac_x), torch.tensor(t), torch.tensor(host.lattice))
    for g, w in zip(got, want):
        # wrapped into [0, 1): a value within rounding of 1 may wrap to 0 on one side
        d = np.abs(g.numpy() - _np(w))
        np.testing.assert_array_less(np.minimum(d, 1.0 - d), 1e-5)


def test_vp_forward_matches_jax():
    rng = np.random.default_rng(2)
    h0 = rng.normal(size=(7, 6)).astype(np.float32)
    t = rng.integers(1, T + 1, size=7)
    key = jax.random.PRNGKey(3)
    want = j_vp_forward(j_vp_schedule(T, power=2, clipmax=0.999), key, jnp.asarray(h0), jnp.asarray(t))
    eps = jax.random.normal(key, h0.shape, dtype=jnp.float32)
    got = vp_forward(make_vp_schedule(T, power=2, clipmax=0.999), torch.tensor(_np(eps)),
                     torch.tensor(h0), torch.tensor(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **F32)


@pytest.mark.parametrize("mask_prob", [0.02, 0.2])
def test_d3pm_sample_xt_matches_jax(mask_prob):
    """Exact: the same gumbel-argmax over the same float32 tables."""
    host = _host_batch(B=16, A=8, seed=4)
    C = len(Z_TABLE)
    t = np.random.default_rng(5).integers(1, T + 1, size=host.atom_types.shape)
    key = jax.random.PRNGKey(6)
    jt = jd3pm.make_d3pm_tables(T, C, "mask", mask_prob=mask_prob)
    want = jd3pm.d3pm_sample_xt(jt, key, jnp.asarray(host.atom_types), jnp.asarray(t))
    u = jax.random.uniform(key, (*host.atom_types.shape, C), dtype=jnp.float32, minval=0.0, maxval=1.0)
    got = d3pm_sample_xt(make_d3pm_tables(T, C, mask_prob), torch.tensor(_np(u)),
                         torch.tensor(host.atom_types).long(), torch.tensor(t))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_d3pm_loss_matches_jax():
    """Hybrid VB-KL + cross-entropy over real atoms, at every t (t = 1
    takes the x0 logits as the posterior)."""
    rng = np.random.default_rng(7)
    host = _host_batch(B=10, A=6, seed=8)
    C = len(Z_TABLE)
    t = rng.integers(1, 4, size=host.atom_types.shape)
    t[0] = 1
    xt = rng.integers(0, C, size=host.atom_types.shape)
    logits = (rng.normal(size=(*host.atom_types.shape, C)) * 2).astype(np.float32)
    want = jd3pm.d3pm_loss(jd3pm.make_d3pm_tables(T, C, "mask"), jnp.asarray(host.atom_types),
                           jnp.asarray(logits), jnp.asarray(xt), jnp.asarray(t),
                           jnp.asarray(host.atom_mask))
    got = d3pm_loss(make_d3pm_tables(T, C), torch.tensor(host.atom_types).long(),
                    torch.tensor(logits), torch.tensor(xt), torch.tensor(t),
                    torch.tensor(host.atom_mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_rotate_batch_matches_jax():
    """The same quaternion normals the JAX function draws (float64 there,
    float32 here: 1e-6)."""
    host = _host_batch()
    key = jax.random.PRNGKey(9)
    want = j_rotate_batch(key, JBatch(*map(jnp.asarray, host)))
    normals = jax.random.normal(key, (host.lattice.shape[0], 4))
    batch = CrystalBatch(*(torch.as_tensor(np.asarray(a)) for a in host))
    got = rotate_batch(rotations_from_normals(torch.tensor(_np(normals), dtype=torch.float32)), batch)
    np.testing.assert_allclose(got.lattice.numpy(), _np(want.lattice), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got.frac_x.numpy(), host.frac_x)


# ---------------- data ----------------


def test_synthetic_data_equals_jax():
    """numpy on both sides: the same arrays for a seed."""
    want = j_synthetic_packed(120, seed=3)
    got = synthetic_packed(120, seed=3)
    for name in ("atomic_numbers", "frac_coords", "offsets", "lattices"):
        np.testing.assert_array_equal(getattr(got.packed, name), getattr(want.packed, name))
    np.testing.assert_array_equal(got.type_indices, want.type_indices)
    assert got.z_table.zs == want.z_table.zs
    for g, w in zip(make_synthetic_batch(np.random.default_rng(1), Z_TABLE, 5, 7),
                    j_make_batch(np.random.default_rng(1), Z_TABLE, 5, 7)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("batch_multiple,drop", [(1, False), (4, True)])
def test_bucketed_loader_equals_jax(batch_multiple, drop):
    """Two epochs of the same batches in the same order: chunk indices
    (with the -1 padding sentinels) and the collated arrays."""
    ds, jds = synthetic_packed(300, seed=5), j_synthetic_packed(300, seed=5)
    splits = random_split(len(ds), [0.7, 0.15, 0.15], 5)
    for a, b in zip(splits, j_random_split(len(jds), [0.7, 0.15, 0.15], 5)):
        np.testing.assert_array_equal(a, b)
    kw = dict(node_budget=12 * 16, seed=11, batch_multiple=batch_multiple, drop_remainder=drop)
    port, ref = BucketedLoader(ds, splits[0], **kw), JLoader(jds, splits[0], **kw)
    assert port.num_batches() == ref.num_batches()
    for _ in range(2):
        got, want = port.chunks(), ref._global_chunks()
        assert len(got) == len(want) > 0
        for (gb, gi), (wb, wi) in zip(got, want):
            assert gb == wb
            np.testing.assert_array_equal(gi, wi)
            for g, w in zip(pack_dense_batch(ds, gi, gb), j_pack(jds, wi, wb)):
                np.testing.assert_array_equal(g, w)


# ---------------- plain backward versions of the kernels ----------------


def test_spatial_conv_bwd_plain_matches_autograd():
    """float64, so the two differ only by summation order (1e-12)."""
    rng = np.random.default_rng(12)
    Bp, O, K, TA, D, C = 2, 3, 4, 10, 7, 5
    E = K * TA
    src = rng.integers(-1, TA + 2, size=(Bp, E)).astype(np.int32)
    basis, w, x = (torch.tensor(rng.normal(size=s), requires_grad=True)
                   for s in ((Bp, O, E, D), (D, C), (Bp, O, TA, C)))
    win = torch.tensor(rng.random((Bp, E)))
    g = torch.tensor(rng.normal(size=(Bp, O, TA, C)))
    want = torch.autograd.grad(spatial_conv_plain(basis, w, x, torch.tensor(src), win), (basis, w, x), g)
    got = spatial_conv_bwd_plain(basis.detach(), w.detach(), x.detach(), torch.tensor(src), win, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("degree,n_g", [(3, 3), (2, 1)])
def test_basis_mlp_bwd_plain_matches_autograd(degree, n_g):
    """float64 against autograd of the plain forward summed over its
    consumers (1e-12)."""
    rng = np.random.default_rng(13)
    Bp, O, d, E, H, D = 2, 3, 4, 11, 6, 5
    Fdim = sum(d**i for i in range(1, degree + 1))
    attrT = torch.tensor(rng.normal(size=(Bp, O, d, E)))
    w1, b1, w2, b2 = (torch.tensor(rng.normal(size=s) * 0.3, requires_grad=True)
                      for s in ((Fdim, H), (H,), (H, D), (D,)))
    h1 = F.gelu(basis_h1_plain(attrT, w1, b1, degree), approximate="tanh")
    basis = F.gelu(h1 @ w2 + b2, approximate="tanh")
    gs = [torch.tensor(rng.normal(size=basis.shape)) for _ in range(n_g)]
    want = torch.autograd.grad(basis, (w1, b1, w2, b2), sum(gs))
    got = basis_mlp_bwd_plain(attrT, w1.detach(), b1.detach(), w2.detach(), b2.detach(), degree, gs)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)


def test_autograd_functions_route_cotangents():
    """On CPU tensors the Functions run the plain versions: gradients equal
    autograd through the plain forwards, the basis MLP's consumers each get
    theirs, and the positions-only inputs get none."""
    rng = np.random.default_rng(14)
    Bp, O, K, TA, d, H, D, C = 1, 2, 3, 6, 3, 5, 4, 3
    E = K * TA
    attrT = torch.tensor(rng.normal(size=(Bp, O, d, E)), dtype=torch.float32, requires_grad=True)
    w1, b1, w2, b2 = (torch.tensor(rng.normal(size=s) * 0.3, dtype=torch.float32, requires_grad=True)
                      for s in ((d + d * d, H), (H,), (H, D), (D,)))
    w, x = (torch.tensor(rng.normal(size=s), dtype=torch.float32, requires_grad=True)
            for s in ((D, C), (Bp, O, TA, C)))
    src = torch.tensor(rng.integers(-1, TA, size=(Bp, E)), dtype=torch.int32)
    win = torch.tensor(rng.random((Bp, E)), dtype=torch.float32, requires_grad=True)
    params = (w1, b1, w2, b2, w, x)

    bases = basis_mlp_multi(attrT, w1, b1, w2, b2, 2, 2)
    got_loss = sum((fused_spatial_conv(b, w, x, src, win) * (i + 1)).sum() for i, b in enumerate(bases))
    got = torch.autograd.grad(got_loss, params, retain_graph=True)
    assert torch.autograd.grad(got_loss, (attrT, win), allow_unused=True) == (None, None)
    basis = F.gelu(F.gelu(basis_h1_plain(attrT, w1, b1, 2), approximate="tanh") @ w2 + b2,
                   approximate="tanh")
    want_loss = sum((spatial_conv_plain(basis, w, x, src, win) * (i + 1)).sum() for i in range(2))
    want = torch.autograd.grad(want_loss, params)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
