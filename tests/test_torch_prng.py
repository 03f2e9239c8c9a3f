"""The port's copy of ``jax.random`` (``arreau_tpu_torch/ops/prng.py``)
against JAX 0.9.0 on the CPU, and the two constants it draws: the Fourier
frequencies of any seed and the S^2 grid of any size."""

import jax
import numpy as np
import pytest

from arreau_tpu.ops.fourier import make_fourier_weights
from arreau_tpu.ops.grids import cached_grid_s2 as j_cached_grid_s2
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.ops.fourier import default_fourier_weights
from arreau_tpu_torch.ops.grids import cached_grid_s2, uniform_grid_s2

SEEDS = [0, 1, 7, 1234, 2**31 - 1, 2**40 + 5, -3]
# XLA's erf_inv evaluated in numpy: its log1p and its float32 log are
# copies too, but a float32 normal can still sit 3 ulp from JAX's (about 1
# in 20 000; measured 1.9e-7 relative at most) and a float64 one 3 ulp
# (measured 4.5e-16)
NORMAL_RTOL = {np.float32: 1e-6, np.float64: 1e-13}
# the S^2 grid's 100 SGD steps amplify last-bit differences of the gradient
# (autograd against jax.grad, on the same draws) by up to 1e5: 1.45e-9 at
# most at 4-32 points, the largest at 8
GRID_ATOL = 2e-9
# the sizes whose seed-0 grid the port carries as the JAX package's digits
CARRIED_GRIDS = (4, 8, 16)


def _jax_key(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("x64", [False, True])
def test_keys_and_splits_equal_jax(x64):
    """``PRNGKey`` (a seed as 32 bits, or 64 under ``enable_x64``) and
    ``split`` into 2, 3 and 5, and a chain of splits: bit for bit."""
    with jax.enable_x64(x64):
        for seed in SEEDS:
            key = prng.prng_key(seed, x64)
            np.testing.assert_array_equal(key, _jax_key(seed))
            for n in (2, 3, 5):
                np.testing.assert_array_equal(prng.split(key, n),
                                              np.asarray(jax.random.split(jax.random.PRNGKey(seed), n)))
        key, jkey = prng.prng_key(9, x64), jax.random.PRNGKey(9)
        for _ in range(20):
            key, _ = prng.split(key)
            jkey, _ = jax.random.split(jkey)
        np.testing.assert_array_equal(key, np.asarray(jkey))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_uniforms_equal_and_normals_match_jax(dtype):
    """``uniform`` on JAX's normal interval bit for bit and ``normal``
    within ``NORMAL_RTOL`` relative, 37 000 draws from each of three keys;
    float64 under ``enable_x64``, as the grid draws them."""
    x64 = dtype == np.float64
    lo = np.nextafter(dtype(-1), dtype(0))
    worst = 0.0
    with jax.enable_x64(x64):
        for seed in (0, 1234, 99):
            key, jkey = prng.prng_key(seed, x64), jax.random.PRNGKey(seed)
            u = prng.uniform(key, (1000, 37), dtype, lo, 1.0)
            assert u.dtype == dtype
            np.testing.assert_array_equal(u, np.asarray(jax.random.uniform(jkey, (1000, 37), dtype,
                                                                           lo, 1.0)))
            got = prng.normal(key, (1000, 37), dtype)
            want = np.asarray(jax.random.normal(jkey, (1000, 37), dtype))
            assert got.dtype == want.dtype == dtype
            worst = max(worst, float(np.max(np.abs(got - want) / np.abs(want))))
    print(f"{dtype.__name__} normals: largest relative error {worst:.3e}")
    assert worst <= NORMAL_RTOL[dtype]


@pytest.mark.parametrize("seed", [0, 1, 7, 1234, 2**31 - 1])
def test_fourier_weights_match_jax(seed):
    """``default_fourier_weights(seed, 32)`` against the JAX package's
    ``make_fourier_weights(PRNGKey(seed), 32, 16.0)`` in its float32 mode:
    within 1e-6 relative (measured: bit for bit at these seeds)."""
    with jax.enable_x64(False):
        want = np.asarray(make_fourier_weights(jax.random.PRNGKey(seed), 32, 16.0))
    got = default_fourier_weights(seed, 32).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [4, 6, 8, 12, 16, 20, 32])
def test_cached_grid_matches_jax(n):
    """The port's drawn grid (``uniform_grid_s2`` on the seed-0 key) against
    the JAX package's ``cached_grid_s2(n)`` (float64 under ``enable_x64``,
    as it computes it), within ``GRID_ATOL``; ``cached_grid_s2(n)`` is the
    JAX grid bit for bit where carried, else the drawn grid, a fresh copy
    each call."""
    with jax.enable_x64(True):
        want = j_cached_grid_s2(n)
    drawn = uniform_grid_s2(n, prng.prng_key(0, x64=True)).numpy()
    print(f"n = {n}: drawn grid within {np.abs(drawn - want).max():.3e} of JAX's")
    np.testing.assert_allclose(drawn, want, rtol=0, atol=GRID_ATOL)
    got = cached_grid_s2(n)
    assert got.shape == (n, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want if n in CARRIED_GRIDS else drawn)
    got[:] = 0
    assert np.abs(cached_grid_s2(n)).max() > 0
