"""The port's copy of ``jax.random`` (``arreau_tpu_torch/ops/prng.py``)
and the threefry kernel's plain version (``kernels/threefry.py``) against
JAX 0.9.0 on the CPU, Flax 0.12.3's key of each parameter, and the two
constants the port draws: the Fourier frequencies of any seed and the S^2
grid of any size."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from arreau_tpu.ops.fourier import make_fourier_weights
from arreau_tpu.ops.grids import cached_grid_s2 as j_cached_grid_s2
from arreau_tpu_torch.kernels import threefry
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


# the seeds the port's own streams are held at
STREAM_SEEDS = [0, 1, 12345]
# bounds the diffusion paths draw with (uniforms on [0, 1), Bravais angles,
# SO(2) angles) and a negative interval
BOUNDS = [(0.0, 1.0), (90.0, 180.0), (60.0, 120.0), (0.0, 2 * np.pi), (-3.5, 2.25)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (prng.BF16, jnp.bfloat16, torch.bfloat16)}
# normals: XLA's erf_inv copied, float32 multiply-adds fused as on the CPU;
# a float32 normal differs from JAX's by at most 3 ulp (measured: 1), a
# truncated normal too (measured: 2)
NORMAL_ULP = 3


def _ulp_gap(a, b) -> int:
    """Largest distance in float32 units in the last place."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _jax_key(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("x64", [False, True])
def test_keys_and_splits_equal_jax(x64):
    """``PRNGKey`` (a seed as 32 bits, or 64 under ``enable_x64``) and
    ``split`` into 2, 3, 5, 16 and 17 (each side of ``split``'s switch from
    Python integers to numpy), and a chain of splits: bit for bit."""
    with jax.enable_x64(x64):
        for seed in SEEDS:
            key = prng.prng_key(seed, x64)
            np.testing.assert_array_equal(key, _jax_key(seed))
            for n in (2, 3, 5, 16, 17):
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


@pytest.mark.parametrize("seed", STREAM_SEEDS)
def test_split_fold_in_and_bits_equal_jax(seed):
    """``split``, ``fold_in`` (small, large and SHA-derived data) and 8/32
    bits, in numpy and through the plain threefry (one row per key), bit
    for bit."""
    with jax.enable_x64(False):
        key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
        keys = prng.split(key, 7)
        np.testing.assert_array_equal(keys, np.asarray(jax.random.split(jkey, 7)))
        for data in (0, 5, 2**31 + 3, 4022531661):
            np.testing.assert_array_equal(
                prng.fold_in(key, data),
                np.asarray(jax.random.key_data(jax.random.fold_in(jkey, data))))
        plain = threefry.threefry(threefry.keys_tensor(keys, "cpu"), (33, 5), "bits").numpy()
        for k, row in zip(keys, plain):
            want = np.asarray(jax.random.bits(jnp.asarray(k), (33, 5), jnp.uint32))
            np.testing.assert_array_equal(prng.random_bits(k, 32, (33, 5)), want)
            np.testing.assert_array_equal(row, want)
            np.testing.assert_array_equal(prng.random_bits(k, 8, (33, 5)),
                                          np.asarray(jax.random.bits(jnp.asarray(k), (33, 5),
                                                                     jnp.uint8)))


@pytest.mark.parametrize("seed", STREAM_SEEDS)
def test_randint_equals_jax(seed):
    """``randint`` (int32 draws, the loss's timesteps and a wide span) in
    numpy and through the plain threefry, bit for bit."""
    with jax.enable_x64(False):
        for lo, hi in ((1, 1001), (1, 51), (-7, 100000)):
            want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (4096,), lo, hi))
            assert want.dtype == np.int32
            np.testing.assert_array_equal(prng.randint(prng.prng_key(seed), (4096,), lo, hi),
                                          want)
            np.testing.assert_array_equal(
                threefry.randint(prng.prng_key(seed), (4096,), lo, hi, "cpu").numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed", STREAM_SEEDS)
def test_uniforms_with_bounds_and_normals_equal_jax(seed, dtype):
    """``uniform`` with bounds bit for bit and ``normal`` within
    ``NORMAL_ULP`` (bfloat16: bit for bit), in float32 and bfloat16, in
    numpy and through the plain threefry for five keys at once."""
    np_dt, j_dt, t_dt = DTYPES[dtype]
    keys = prng.split(prng.prng_key(seed), 5)
    keys_t = threefry.keys_tensor(keys, "cpu")
    shape = (64, 41)
    with jax.enable_x64(False):
        for lo, hi in BOUNDS:
            plain = threefry.threefry(keys_t, shape, "uniform", t_dt, lo, hi)
            assert plain.dtype == t_dt
            for k, row in zip(keys, plain.float().numpy()):
                want = np.asarray(jax.random.uniform(jnp.asarray(k), shape, j_dt, lo, hi))
                want = want.astype(np.float32)
                np.testing.assert_array_equal(prng.uniform(k, shape, np_dt, lo, hi), want)
                np.testing.assert_array_equal(row, want)
        plain = threefry.threefry(keys_t, shape, "normal", t_dt)
        for k, row in zip(keys, plain.float().numpy()):
            want = np.asarray(jax.random.normal(jnp.asarray(k), shape, j_dt)).astype(np.float32)
            got = prng.normal(k, shape, np_dt)
            np.testing.assert_array_equal(row, got)
            if dtype == "bfloat16":
                np.testing.assert_array_equal(got, want)
            else:
                assert _ulp_gap(got, want) <= NORMAL_ULP


@pytest.mark.parametrize("seed", STREAM_SEEDS)
def test_truncated_normal_and_erf_match_jax(seed):
    """XLA's float32 ``erf`` bit for bit on [-5, 5], ``truncated_normal``
    within ``NORMAL_ULP``, and Flax's ``lecun_normal`` and
    ``variance_scaling(1/sqrt(8), "fan_in", "truncated_normal")`` of a
    ``[40, 24]`` kernel within ``NORMAL_ULP``."""
    x = np.linspace(-5, 5, 20001, dtype=np.float32)
    with jax.enable_x64(False):
        np.testing.assert_array_equal(prng.erf(x), np.asarray(jax.lax.erf(jnp.asarray(x))))
        key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
        for lo, hi in ((-2.0, 2.0), (-1.0, 3.0)):
            want = np.asarray(jax.random.truncated_normal(jkey, lo, hi, (300, 11), jnp.float32))
            assert _ulp_gap(prng.truncated_normal(key, lo, hi, (300, 11)), want) <= NORMAL_ULP
        scale = 1.0 / jnp.sqrt(8.0)
        for init, s in ((nn.initializers.lecun_normal(), 1.0),
                        (nn.initializers.variance_scaling(scale, "fan_in", "truncated_normal"),
                         np.float32(1.0) / np.sqrt(np.float32(8.0)))):
            want = np.asarray(init(jkey, (40, 24), jnp.float32))
            assert _ulp_gap(prng.variance_scaling(key, (40, 24), s, 40), want) <= NORMAL_ULP


class _Inner(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = nn.Dense(3, name="dense")(x)
        return x + self.param("extra", nn.initializers.normal(), (3,))


class _Outer(nn.Module):
    @nn.compact
    def __call__(self, x):
        a = self.param("a", nn.initializers.normal(), (2,))
        x = _Inner(name="inner_0")(x) + _Inner(name="inner_1")(x)
        return x * self.param("b", nn.initializers.normal(), (3,)) + a.sum()


@pytest.mark.parametrize("seed", STREAM_SEEDS)
def test_flax_param_keys_equal_flax(seed):
    """``flax_param_key(key, path, counter)``: each parameter of a nested
    module drawn as ``normal(flax_param_key(...))`` equals Flax's
    ``model.init`` (the counters of a scope count its ``self.param`` calls
    in order; child scopes count their own)."""
    with jax.enable_x64(False):
        params = _Outer().init(jax.random.PRNGKey(seed), jnp.ones((1, 4)))["params"]
    key = prng.prng_key(seed)
    for path, counter, leaf in ((("",), 1, params["a"]), (("",), 2, params["b"]),
                                (("inner_0",), 1, params["inner_0"]["extra"]),
                                (("inner_1",), 1, params["inner_1"]["extra"])):
        scope = tuple(p for p in path if p)
        got = prng.normal(prng.flax_param_key(key, scope, counter), leaf.shape) * np.float32(1e-2)
        assert _ulp_gap(got, leaf) <= NORMAL_ULP, (path, counter)
    for name in ("inner_0", "inner_1"):
        k = prng.flax_param_key(key, (name, "dense"), 1)
        want = np.asarray(params[name]["dense"]["kernel"])
        assert _ulp_gap(prng.variance_scaling(k, (4, 3), 1.0, 4), want) <= NORMAL_ULP


# jax.random.permutation's sizes: no round (0, 1), one (2 to 1625), two
# (1626 on: the N-body CLI's 3000 systems); at 100000 the seeds' sort keys
# tie (seed 0: once in round 1; seed 1: three times, then twice), so the
# stable order shows
PERMUTATION_SIZES = [0, 1, 2, 1625, 1626, 3000, 10000, 100000]


@pytest.mark.parametrize("n", PERMUTATION_SIZES)
def test_permutation_equals_jax(n):
    """``prng.permutation`` is ``jax.random.permutation(key, n)`` bit for
    bit, and so is the threefry module's (its plain version on the CPU)."""
    want_rounds = 0 if n <= 1 else 1 if n <= 1625 else 2
    assert prng.permutation_rounds(n) == want_rounds
    ties = 0
    for seed in STREAM_SEEDS:
        key = _jax_key(seed)
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        got = prng.permutation(key, n)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(threefry.permutation(key, n, "cpu").numpy(), want)
        for _ in range(want_rounds):
            key, sub = prng.split(key)
            ties += n - len(np.unique(prng.random_bits(sub, 32, (n,))))
    if n == 100000:
        assert ties > 0


@pytest.mark.parametrize("shape", [(7, 5), (1000, 5), (3, 4, 2)])
@pytest.mark.parametrize("p", [0.5, 0.1])
def test_bernoulli_equals_jax(shape, p):
    """``prng.bernoulli`` and the threefry module's are JAX's
    ``bernoulli(key, p, shape)`` for a float32 ``p`` (a Python float
    without ``enable_x64``, as the N-body simulator's) bit for bit."""
    for seed in STREAM_SEEDS:
        key = _jax_key(seed)
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), jnp.float32(p), shape))
        np.testing.assert_array_equal(prng.bernoulli(key, p, shape), want)
        np.testing.assert_array_equal(threefry.bernoulli(key, p, shape, "cpu").numpy(), want)
