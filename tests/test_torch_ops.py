"""The PyTorch port's ops, schedules and kernels' plain versions against the
JAX package on the CPU. Inputs come from ``np.random.default_rng`` and go
through both packages; every random draw the JAX functions make from a key
is drawn in the test and handed to the port. Each tolerance is stated with
its reason."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.data.synthetic import make_synthetic_batch, synthetic_z_table
from arreau_tpu.diffusion import d3pm as jd3pm
from arreau_tpu.diffusion import ve as jve
from arreau_tpu.diffusion import vp as jvp
from arreau_tpu.ops import lattice as jlat
from arreau_tpu.ops.fourier import gaussian_fourier_features as j_fourier
from arreau_tpu.ops.fourier import make_fourier_weights
from arreau_tpu.ops.grids import cached_grid_s2 as j_grid
from arreau_tpu.ops.pallas_basis import _h1
from arreau_tpu.ops.pallas_conv import fused_spatial_conv, make_gather_matrix
from arreau_tpu.ops.pbc import pbc_neighbor_list as j_pbc
from arreau_tpu.ops.windowing import polynomial_cutoff as j_cutoff
from arreau_tpu_torch.diffusion import d3pm as td3pm
from arreau_tpu_torch.diffusion import ve as tve
from arreau_tpu_torch.diffusion import vp as tvp
from arreau_tpu_torch.kernels.basis_h1 import basis_h1, basis_h1_plain
from arreau_tpu_torch.kernels.spatial_conv import spatial_conv, spatial_conv_plain
from arreau_tpu_torch.models.blocks import gelu
from arreau_tpu_torch.models.ponita import tile_senders
from arreau_tpu_torch.ops import lattice as tlat
from arreau_tpu_torch.ops.fourier import default_fourier_weights, gaussian_fourier_features
from arreau_tpu_torch.ops.grids import (
    _repulsion_energy,
    cached_grid_s2,
    euclid_to_spherical,
    geodesic_distance_s2,
    spherical_to_euclid,
    uniform_grid_s2,
)
from arreau_tpu_torch.ops.pbc import pbc_neighbor_list
from arreau_tpu_torch.ops.prng import prng_key
from arreau_tpu_torch.ops.windowing import polynomial_cutoff

# float32 elementwise math in two libraries: a few ulps apart
F32_ELEMENTWISE = dict(rtol=1e-5, atol=1e-6)
# float32 sums in another order (matmuls over up to a few hundred terms)
F32_SUMS = dict(rtol=1e-4, atol=1e-5)

# The JAX package's Fourier frequencies for seed 1234 in float32 mode, as
# the port carried them before it drew them itself
# fmt: off
FOURIER_W_SEED_1234 = [
    17.649625778198242, 13.808996200561523, -5.418918132781982, 16.435932159423828,
    -17.17728614807129, 5.269970417022705, 12.13134479522705, -4.809208393096924,
    -5.932690143585205, 9.379473686218262, 14.142539978027344, -20.535463333129883,
    4.335996627807617, 28.368101119995117, -19.76193618774414, -29.899629592895508,
    -1.8110772371292114, 1.9699349403381348, 2.2411656379699707, 11.698942184448242,
    31.981868743896484, 0.5024392604827881, 6.7659406661987305, 7.638636589050293,
    0.6557573080062866, -19.148454666137695, 12.527305603027344, 22.05316925048828,
    -3.3436496257781982, 4.077895164489746, 9.722626686096191, 24.921707153320312,
]
# fmt: on


def t32(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def j32(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


def _lengths_angles(rng, n=16):
    lengths = rng.uniform(3.0, 8.0, size=(n, 3))
    angles = np.deg2rad(rng.uniform(60.0, 120.0, size=(n, 3)))
    return lengths, angles


# ---------------- lattice ----------------


def test_lattice_from_params_matches_jax():
    lengths, angles = _lengths_angles(np.random.default_rng(0))
    want = jlat.lattice_from_params(j32(lengths), j32(angles))
    got = tlat.lattice_from_params(t32(lengths), t32(angles))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_ELEMENTWISE)


def test_angle_codec_and_coordinates_match_jax():
    rng = np.random.default_rng(1)
    lengths, angles = _lengths_angles(rng)
    lat = np.asarray(jlat.lattice_from_params(j32(lengths), j32(angles)))
    frac = rng.uniform(size=(16, 5, 3)).astype(np.float32)
    cart = tlat.frac_to_cart(t32(frac), t32(lat))
    np.testing.assert_allclose(
        cart.numpy(), np.asarray(jlat.frac_to_cart(j32(frac), j32(lat))), **F32_ELEMENTWISE
    )
    back = tlat.cart_to_frac(cart, t32(lat)).numpy()
    want = np.asarray(jlat.cart_to_frac(jnp.asarray(cart.numpy()), j32(lat)))
    d = np.abs(back - want)
    # compared on the circle: a coordinate at 0 may wrap to 1 - ulp in the other package
    assert np.minimum(d, 1 - d).max() < 1e-5
    d = np.abs(back - frac)
    # round trip through the pseudo-inverse, damped by 100 float32 eps of the Gram scale
    assert np.minimum(d, 1 - d).max() < 1e-4
    enc = np.asarray(jlat.encode_angles(j32(angles)))
    np.testing.assert_allclose(tlat.decode_angles(t32(enc)).numpy(),
                               np.asarray(jlat.decode_angles(j32(enc))), **F32_ELEMENTWISE)


@pytest.mark.parametrize(
    "lattice_type",
    ["cubic", "tetragonal", "orthorhombic", "hexagonal", "monoclinic", "triclinic", "rhombohedral"],
)
def test_bravais_angle_families(lattice_type):
    """The JAX package's angles from the same key (JAX's float32 draws,
    without ``enable_x64``): bit for bit, in the families' ranges."""
    key = prng_key(0)
    got = tlat.sample_bravais_angles(key, lattice_type, 256)
    with jax.enable_x64(False):
        want = np.asarray(jlat.sample_bravais_angles(jax.random.PRNGKey(0), lattice_type, 256))
    assert got.shape == (256, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    deg = np.rad2deg(got.numpy().astype(np.float64))
    if lattice_type == "monoclinic":
        np.testing.assert_allclose(deg[:, [0, 2]], 90.0, rtol=1e-6)
        assert deg[:, 1].min() >= 90.0 - 1e-4 and deg[:, 1].max() <= 180.0 + 1e-4
    elif lattice_type in ("triclinic", "rhombohedral"):
        assert deg.min() >= 60.0 - 1e-4 and deg.max() <= 120.0 + 1e-4
        if lattice_type == "rhombohedral":
            assert np.all(deg[:, 0] == deg[:, 1]) and np.all(deg[:, 1] == deg[:, 2])
    with pytest.raises(ValueError):
        tlat.sample_bravais_angles(key, "pentagonal", 2)


# ---------------- grids, Fourier features, window ----------------


@pytest.mark.parametrize("n", [4, 8, 16])
def test_carried_grid_equals_jax_grid(n):
    """The carried constants are the JAX grid, bit for bit."""
    np.testing.assert_array_equal(cached_grid_s2(n), j_grid(n))


def test_grid_of_unsupported_size_raises():
    """A size with no carried grid (12) raises nothing: it gets
    ``uniform_grid_s2`` on the JAX package's seed-0 key (held against the
    JAX package's grid in ``tests/test_torch_prng.py``)."""
    grid = cached_grid_s2(12)
    assert grid.shape == (12, 3) and grid.dtype == np.float64
    np.testing.assert_allclose(np.linalg.norm(grid, axis=-1), 1.0, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(grid, uniform_grid_s2(12, prng_key(0, x64=True)).numpy())


def _jax_grid_draws(n, steps=100, seed=0):
    """The normals ``arreau_tpu.ops.grids.uniform_grid_s2`` draws under
    x64 from ``PRNGKey(seed)``: the starting points, then one ``[n, 2]``
    draw a step from the split chain of the noise key."""
    init_key, nkey = jax.random.split(jax.random.PRNGKey(seed))
    init = jax.random.normal(init_key, (n, 3))
    noise = []
    for _ in range(steps):
        nkey, sub = jax.random.split(nkey)
        noise.append(jax.random.normal(sub, (n, 2)))
    return torch.tensor(np.asarray(init)), torch.tensor(np.stack(noise))


@pytest.mark.parametrize("n", [4, 12, 16])
def test_uniform_grid_s2_with_jax_draws_is_jax_grid(n):
    """The same 100 SGD steps in float64 (gradient from autograd against
    ``jax.grad``), on JAX's draws: JAX's grid within 1e-9."""
    from arreau_tpu.ops.grids import uniform_grid_s2 as j_uniform_grid_s2

    with jax.enable_x64(True):
        want = np.asarray(j_uniform_grid_s2(n, jax.random.PRNGKey(0)))
        init, noise = _jax_grid_draws(n)
    assert want.dtype == np.float64
    got = uniform_grid_s2(n, init=init, noise=noise)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    if n in (4, 16):
        np.testing.assert_allclose(got.numpy(), j_grid(n), rtol=0, atol=1e-9)


def test_seeded_grid_repulsion_energy_near_jax():
    """The port's seeded grid of 12 points is the JAX package's: their
    repulsion energies agree within 1e-12 relative, and each package's
    energy function gives the same value on the port's grid."""
    from arreau_tpu.ops.grids import _repulsion_energy as j_energy
    from arreau_tpu.ops.grids import euclid_to_spherical as j_e2s

    with jax.enable_x64(True):
        want = float(j_energy(j_e2s(jnp.asarray(j_grid(12))), 12))
        got_jax = float(j_energy(j_e2s(jnp.asarray(cached_grid_s2(12))), 12))
    got = float(_repulsion_energy(euclid_to_spherical(torch.tensor(cached_grid_s2(12))), 12))
    assert got == pytest.approx(got_jax, rel=1e-12)
    assert got == pytest.approx(want, rel=1e-12)


def test_spherical_helpers_match_jax():
    from arreau_tpu.ops import grids as jg

    rng = np.random.default_rng(11)
    x = rng.normal(size=(7, 3))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    sph = rng.uniform(-3, 3, size=(7, 2))
    with jax.enable_x64(True):
        pairs = [(euclid_to_spherical(torch.tensor(x)), jg.euclid_to_spherical(jnp.asarray(x))),
                 (spherical_to_euclid(torch.tensor(sph)), jg.spherical_to_euclid(jnp.asarray(sph))),
                 (geodesic_distance_s2(torch.tensor(x[:, None]), torch.tensor(x[None])),
                  jg.geodesic_distance_s2(jnp.asarray(x[:, None]), jnp.asarray(x[None]))),
                 (_repulsion_energy(torch.tensor(sph), 7), jg._repulsion_energy(jnp.asarray(sph), 7))]
        for a, b in pairs:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)


# ---------------- VP steps and lattice utilities in float64 ----------------

F64_TOL = dict(rtol=1e-12, atol=1e-12)


def test_vp_eps_steps_match_jax():
    """``vp_reverse_step`` (its noise injected: JAX's draw from the key)
    and ``vp_reverse_without_noise`` on a float64 schedule, t = 1 and 0
    (noise gated off) included."""
    with jax.enable_x64(True):
        jsched = jvp.make_vp_schedule(50, dtype=jnp.float64)
        sched = tvp.VPSchedule(*(torch.tensor(np.asarray(a)) for a in jsched))
        rng = np.random.default_rng(12)
        ht, eps = rng.normal(size=(6, 3)), rng.normal(size=(6, 3))
        t = np.array([0, 1, 2, 17, 49, 50])
        key = jax.random.PRNGKey(5)
        want = jvp.vp_reverse_step(jsched, key, jnp.asarray(ht), jnp.asarray(eps), jnp.asarray(t))
        z = jax.random.normal(key, ht.shape, dtype=jnp.float64)
        want_mean = jvp.vp_reverse_without_noise(jsched, jnp.asarray(ht), jnp.asarray(eps),
                                                 jnp.asarray(t))
    args = (torch.tensor(ht), torch.tensor(eps), torch.tensor(t))
    got = tvp.vp_reverse_step(sched, torch.tensor(np.asarray(z)), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)
    np.testing.assert_allclose(tvp.vp_reverse_without_noise(sched, *args).numpy(),
                               np.asarray(want_mean), **F64_TOL)
    np.testing.assert_array_equal(got.numpy()[:2], np.asarray(want_mean)[:2])


@pytest.mark.parametrize("name", [
    "abs_cap", "cart_to_frac_without_mod", "symmetrize_matrix", "polar_decomposition",
    "symmetric_matrix_to_vector", "vector_to_symmetric_matrix", "volume", "wrapped_angle_mse",
    "cubic_score", "vector_length_mse_loss", "angle_bound_loss"])
def test_lattice_utilities_match_jax(name):
    rng = np.random.default_rng(13)
    mats = rng.normal(size=(5, 3, 3)) + 3 * np.eye(3)
    args = {
        "abs_cap": (rng.normal(size=(4, 3)) * 2,),
        "cart_to_frac_without_mod": (rng.normal(size=(5, 4, 3)) * 5, mats),
        "symmetrize_matrix": (mats,),
        "polar_decomposition": (mats,),
        "symmetric_matrix_to_vector": (mats + mats.transpose(0, 2, 1),),
        "vector_to_symmetric_matrix": (rng.normal(size=(5, 6)),),
        "volume": (mats,),
        "wrapped_angle_mse": (rng.uniform(-10, 10, (5, 3)), rng.uniform(-10, 10, (5, 3))),
        "cubic_score": (rng.uniform(1, 9, (5, 3)),),
        "vector_length_mse_loss": (mats, mats + 0.3 * rng.normal(size=(5, 3, 3))),
        "angle_bound_loss": (rng.uniform(30, 150, (5, 3)),),
    }[name]
    with jax.enable_x64(True):
        want = getattr(jlat, name)(*map(jnp.asarray, args))
    got = getattr(tlat, name)(*map(torch.tensor, args))
    for a, b in zip(*((got, want) if isinstance(want, tuple) else ((got,), (want,)))):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F64_TOL)


def test_carried_fourier_weights_equal_jax_default_draw():
    """The frequencies the port carried for the default seed are the JAX
    package's float32-mode draw, and the port's own draw gives them, bit for
    bit (the tests run JAX in x64 mode, where the same key draws other
    numbers). Another seed draws JAX's numbers too, where it raised before."""
    with jax.enable_x64(False):
        want = np.asarray(make_fourier_weights(jax.random.PRNGKey(1234), 32, 16.0))
        want7 = np.asarray(make_fourier_weights(jax.random.PRNGKey(7), 32, 16.0))
    np.testing.assert_array_equal(np.float32(FOURIER_W_SEED_1234), want)
    np.testing.assert_array_equal(default_fourier_weights(1234, 32).numpy(), want)
    np.testing.assert_array_equal(default_fourier_weights(7, 32).numpy(), want7)


def test_gaussian_fourier_features_match_jax():
    rng = np.random.default_rng(2)
    w = rng.normal(size=32) * 16.0
    x = rng.uniform(0.0, 0.05, size=(10, 1))  # the VP betas it embeds
    got = gaussian_fourier_features(t32(x), t32(w))
    want = j_fourier(j32(x), j32(w))
    # sin/cos of arguments up to ~10 rad: float32 argument rounding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_polynomial_cutoff_matches_jax():
    x = np.random.default_rng(3).uniform(0.0, 6.0, size=(7, 9))
    # near the cutoff the polynomial cancels terms of size up to 48: absolute float32 error
    np.testing.assert_allclose(
        polynomial_cutoff(t32(x), 5.0).numpy(), np.asarray(j_cutoff(j32(x), 5.0)), rtol=1e-5, atol=1e-5
    )


# ---------------- PBC neighbor list ----------------


def _slots(nl, b, a):
    """{(sender, image): (dist, direction)} of atom a's live slots."""
    src, image, mask, dist, direction = (np.asarray(x) for x in nl)
    return {(int(src[b, a, k]), int(image[b, a, k])): (float(dist[b, a, k]), direction[b, a, k])
            for k in range(src.shape[-1]) if mask[b, a, k]}


@pytest.mark.parametrize("max_select_elems", [1 << 22, 2000])
def test_pbc_neighbor_list_matches_jax(max_select_elems):
    """Every atom keeps the same K nearest (sender, image) pairs, with the
    same distance and direction to float32 rounding of a few-angstrom vector.
    Only a tie at the K-th distance may be broken the other way: two images
    at the same distance (an atom's own images at +a and -a are one) differ
    by an ulp in the two packages' expansions, and torch.topk orders ties
    freely. The small ``max_select_elems`` runs the port's chunked selection."""
    host = make_synthetic_batch(np.random.default_rng(4), synthetic_z_table(), 6, 10)
    cart = np.einsum("bni,bij->bnj", host.frac_x, host.lattice).astype(np.float32)
    want = j_pbc(j32(cart), j32(host.lattice), jnp.asarray(host.atom_mask), 5.0, 8)
    got = pbc_neighbor_list(t32(cart), t32(host.lattice), torch.as_tensor(host.atom_mask), 5.0, 8,
                            max_select_elems=max_select_elems)
    want = [np.asarray(x) for x in (want.src, want.image, want.mask, want.dist, want.direction)]
    got = [x.numpy() for x in (got.src, got.image, got.mask, got.dist, got.direction)]
    assert got[2].sum() > 100  # the batch has real graphs
    for b in range(host.atom_mask.shape[0]):
        for a in range(host.atom_mask.shape[1]):
            w, g = _slots(want, b, a), _slots(got, b, a)
            assert len(w) == len(g)
            for edge in w.keys() & g.keys():
                assert abs(w[edge][0] - g[edge][0]) < 1e-5
                np.testing.assert_allclose(g[edge][1], w[edge][1], atol=1e-5)
            kth = max((d for d, _ in w.values()), default=0.0)
            for edge in w.keys() ^ g.keys():
                assert abs((w.get(edge) or g.get(edge))[0] - kth) < 1e-5, (b, a, edge)
    mask = got[2]
    assert np.all(got[3][~mask] == 0) and np.all(got[4][~mask] == 0)


# ---------------- schedules, with the JAX draws injected ----------------


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, dtype=jnp.float32))


def test_ve_steps_match_jax():
    rng = np.random.default_rng(5)
    js = jve.make_ve_schedule(100, 0.001, 1.0)
    ts = tve.make_ve_schedule(100, 0.001, 1.0)
    np.testing.assert_allclose(ts.sigmas.numpy(), np.asarray(js.sigmas), **F32_ELEMENTWISE)
    frac = rng.uniform(size=(4, 6, 3)).astype(np.float32)
    eps = (rng.normal(size=(4, 6, 3)) * 0.1).astype(np.float32)
    t = np.array([99, 50, 2, 1])
    s = np.array([80, 0, 1, 0])
    key = jax.random.PRNGKey(3)
    z = _normal(key, frac.shape)
    cases = [
        (jve.ve_reverse_step(js, key, j32(frac), j32(eps), jnp.asarray(t)),
         tve.ve_reverse_step(ts, t32(z), t32(frac), t32(eps), torch.as_tensor(t))),
        (jve.ve_ddim_step(js, key, j32(frac), j32(eps), jnp.asarray(t), jnp.asarray(s), 0.7),
         tve.ve_ddim_step(ts, t32(z), t32(frac), t32(eps), torch.as_tensor(t), torch.as_tensor(s), 0.7)),
    ]
    for want, got in cases:
        d = np.abs(got.numpy() - np.asarray(want))
        assert np.minimum(d, 1 - d).max() < 1e-5  # on the circle: mod 1 may wrap either way


def test_vp_steps_match_jax():
    rng = np.random.default_rng(6)
    js = jvp.make_vp_schedule(100, power=2, clipmax=0.999)
    ts = tvp.make_vp_schedule(100, power=2, clipmax=0.999)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    xt = rng.normal(size=(4, 3)).astype(np.float32)
    x0 = rng.normal(size=(4, 3)).astype(np.float32)
    t = np.array([99, 50, 2, 1])
    s = np.array([80, 0, 1, 0])
    key = jax.random.PRNGKey(4)
    z = _normal(key, xt.shape)
    cases = [
        (jvp.vp_reverse_given_x0(js, key, j32(xt), j32(x0), jnp.asarray(t)),
         tvp.vp_reverse_given_x0(ts, t32(z), t32(xt), t32(x0), torch.as_tensor(t))),
        (jvp.vp_ddim_step_given_x0(js, key, j32(xt), j32(x0), jnp.asarray(t), jnp.asarray(s), 0.5),
         tvp.vp_ddim_step_given_x0(ts, t32(z), t32(xt), t32(x0), torch.as_tensor(t),
                                   torch.as_tensor(s), 0.5)),
    ]
    for want, got in cases:
        # near t = T the cosine schedule divides by 1 - abar ~ 1e-8: a few float32 ulps grow
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_d3pm_tables_and_steps_match_jax():
    rng = np.random.default_rng(7)
    T, C = 50, 9
    jt = jd3pm.make_d3pm_tables(T, C, "mask")
    tt = td3pm.make_d3pm_tables(T, C)
    np.testing.assert_array_equal(tt.q_mats.numpy(), np.asarray(jt.q_mats))
    np.testing.assert_array_equal(tt.q_one_step_transposed.numpy(), np.asarray(jt.q_one_step_transposed))
    ts = np.array([0, 10, 30, 49])
    np.testing.assert_array_equal(
        td3pm.make_strided_transitions(T, C, ts).numpy(),
        np.asarray(jd3pm.make_strided_transitions(T, C, ts)),
    )
    xt = rng.integers(0, C, size=(4, 6))
    xt[:, :3] = C - 1
    logits = rng.normal(size=(4, 6, C)).astype(np.float32) * 3.0
    t = np.broadcast_to(np.array([40, 20, 2, 1])[:, None], (4, 6))
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (4, 6, C), dtype=jnp.float32, minval=0.0, maxval=1.0))
    for temp in (1.0, 0.0):
        want = jd3pm.d3pm_reverse_step(jt, key, jnp.asarray(xt), j32(logits), jnp.asarray(t), temp)
        got = td3pm.d3pm_reverse_step(tt, t32(u), torch.as_tensor(xt), t32(logits),
                                      torch.tensor(t), temp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        q = td3pm.make_strided_transitions(T, C, ts)
        sj = np.broadcast_to(np.array([30, 10, 0, 0])[:, None], (4, 6))
        want = jd3pm.d3pm_strided_reverse_step(
            jt, jd3pm.make_strided_transitions(T, C, ts)[1], key, jnp.asarray(xt), j32(logits),
            jnp.asarray(sj), temp,
        )
        got = td3pm.d3pm_strided_reverse_step(tt, q[1], t32(u), torch.as_tensor(xt), t32(logits),
                                              torch.tensor(sj), temp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------- the kernels' plain versions against the Pallas kernels ----------------


def _conv_inputs(B=6, A=5, K=4, O=3, D=16, C=24, tile=3, seed=8):
    rng = np.random.default_rng(seed)
    Bp, TA = B // tile, tile * A
    E = K * TA
    src = rng.integers(0, A, size=(B, A, K))
    mask = rng.random((B, A, K)) > 0.3
    return dict(
        basis=rng.normal(size=(Bp, O, E, D)).astype(np.float32),
        w=(rng.normal(size=(D, C)) * 0.2).astype(np.float32),
        x=rng.normal(size=(Bp, O, TA, C)).astype(np.float32),
        win=rng.uniform(size=(Bp, E)).astype(np.float32),
        src=src, mask=mask, tile=tile,
    )


def test_tile_senders_is_the_index_form_of_the_gather_matrix():
    d = _conv_inputs()
    sel = np.asarray(make_gather_matrix(jnp.asarray(d["src"]), jnp.asarray(d["mask"]),
                                        dtype=jnp.float32, crystals_per_tile=d["tile"]))
    local = tile_senders(torch.as_tensor(d["src"]), torch.as_tensor(d["mask"]), d["tile"]).numpy()
    assert local.dtype == np.int32 and local.shape == sel.shape[:2]
    onehot = np.zeros_like(sel)
    b, e = np.nonzero(local >= 0)
    onehot[b, e, local[b, e]] = 1.0
    np.testing.assert_array_equal(onehot, sel)


def test_spatial_conv_plain_matches_pallas_kernel():
    """The plain version of kernel #3 against ``fused_spatial_conv`` in
    Pallas interpret mode, on the same super-crystal inputs."""
    d = _conv_inputs()
    sel = make_gather_matrix(jnp.asarray(d["src"]), jnp.asarray(d["mask"]), dtype=jnp.float32,
                             crystals_per_tile=d["tile"])
    want = fused_spatial_conv(j32(d["basis"]), j32(d["w"]), j32(d["x"]), sel, j32(d["win"])[..., None])
    src = tile_senders(torch.as_tensor(d["src"]), torch.as_tensor(d["mask"]), d["tile"])
    args = (t32(d["basis"]), t32(d["w"]), t32(d["x"]), src, t32(d["win"]))
    np.testing.assert_allclose(spatial_conv_plain(*args).numpy(), np.asarray(want), **F32_SUMS)
    before = spatial_conv.launches
    np.testing.assert_array_equal(spatial_conv(*args).numpy(), spatial_conv_plain(*args).numpy())
    assert spatial_conv.launches == before  # CPU tensors run the plain version, no launch


@pytest.mark.parametrize("degree", [2, 3])
def test_basis_h1_plain_matches_pallas_kernel(degree):
    """The plain version of kernel #8 (+ GELU) against ``_h1`` with the
    Pallas kernel forced, in interpret mode."""
    rng = np.random.default_rng(9)
    Bp, O, d, E, H = 2, 3, 6, 40, 20
    F = sum(d**i for i in range(1, degree + 1))
    attrT = rng.normal(size=(Bp, O, d, E)).astype(np.float32)
    w1 = (rng.normal(size=(F, H)) * 0.1).astype(np.float32)
    b1 = rng.normal(size=(H,)).astype(np.float32)
    want = _h1(j32(attrT), j32(w1), j32(b1), degree, force_kernel=True)
    got = gelu(basis_h1_plain(t32(attrT), t32(w1), t32(b1), degree))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_SUMS)
    before = basis_h1.launches
    np.testing.assert_array_equal(
        basis_h1(t32(attrT), t32(w1), t32(b1), degree).numpy(),
        basis_h1_plain(t32(attrT), t32(w1), t32(b1), degree).numpy(),
    )
    assert basis_h1.launches == before


def test_kernel_wrappers_check_their_inputs():
    d = _conv_inputs()
    src = tile_senders(torch.as_tensor(d["src"]), torch.as_tensor(d["mask"]), d["tile"])
    args = [t32(d["basis"]), t32(d["w"]), t32(d["x"]), src, t32(d["win"])]
    with pytest.raises(TypeError, match="src must be int32"):
        spatial_conv(*args[:3], src.long(), args[4])
    with pytest.raises(TypeError, match="basis must be float32"):
        spatial_conv(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="shape mismatch"):
        spatial_conv(args[0], args[1][:-1], *args[2:])
    with pytest.raises(ValueError, match="shape mismatch"):
        basis_h1(torch.zeros(1, 1, 6, 8), torch.zeros(10, 4), torch.zeros(4), 3)
    with pytest.raises(ValueError, match="degree 1..3"):
        basis_h1(torch.zeros(1, 1, 2, 8), torch.zeros(30, 4), torch.zeros(4), 4)
