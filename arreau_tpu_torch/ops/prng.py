"""``jax.random``'s default generator in numpy: ``PRNGKey``, ``split``,
``fold_in``, ``random_bits``, ``uniform``, ``normal``, ``randint``,
``bernoulli``, ``permutation`` and ``truncated_normal`` as JAX 0.9.0
computes them with its defaults (the
threefry2x32 hash, ``jax_threefry_partitionable`` on), and Flax 0.12.3's key
of each parameter in ``model.init``.

It is the port's random source wherever the JAX package draws from a key:
the host-side key chains of every training CLI, the sampler, the loss and
the exploration tools, the N-body dataset's simulator, the shuffles of the
N-body CLI's default chain, the parameters ``model.init`` draws, and
the constants the JAX package draws when it builds a model (the S^2 grid
``ops/grids.py:cached_grid_s2``, within 2e-9, see there, and the Fourier
frequencies ``ops/fourier.py``). The bulk draws on the card go through the
threefry kernel (``kernels/threefry.py``), which computes the same numbers.

The JAX sources it follows (``jax/_src``):

- ``prng.py:802`` ``threefry_seed``: the key of a seed is ``[seed >> 32,
  seed & 0xFFFFFFFF]`` as uint32;
- ``prng.py:1092`` ``threefry_2x32`` and ``:883`` its lowering: 20 rounds
  in five groups of four, a key injection after each group;
- ``prng.py:1143-1170`` split, its partitionable form: the hash of the
  counter pair ``(hi, lo)`` of each flat index ``i < n``, the two output
  words being the new key; ``:1163-1169`` fold_in: the hash of the counter
  pair ``(0, data)``;
- ``prng.py:1184-1200`` random bits, partitionable: the hash of the flat
  index's counter pair; 32 bits are the two words XORed, 64 bits the first
  word above the second, 8 and 16 bits the low bits of the XOR;
- ``random.py:435`` ``_uniform``: the top mantissa bits under the exponent
  of 1.0, minus 1, scaled to ``[lo, hi)`` and clamped below at ``lo``
  (bfloat16 takes 8 random bits, ``nmant < 8``); XLA on the CPU fuses the
  float32 ``floats * (hi - lo) + lo`` into one multiply-add, and rounds
  every bfloat16 operation to bfloat16;
- ``random.py:1075`` ``_bernoulli``: ``uniform(key, shape, p's type) <
  p`` in its default mode ``'low'``;
- ``random.py:700-727`` ``permutation`` of an integer, ``_shuffle`` of
  ``arange(n)``: ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each ``key,
  subkey = split(key)`` and a stable ``sort_key_val`` on
  ``random_bits(subkey, 32, (n,))``;
- ``random.py:581`` ``_randint``: two 32-bit draws from ``split(key)``,
  each reduced modulo the span and combined through ``2^32 mod span``;
- ``random.py:867`` ``_normal_real``: ``sqrt(2) erfinv(u)`` with ``u``
  uniform on ``[nextafter(-1, 0), 1)``; in bfloat16 the ``erf_inv`` is
  evaluated in float32 and rounded, and so is the product;
- ``random.py:1005`` ``_truncated_normal``: a uniform on ``[erf(lo /
  sqrt 2), erf(hi / sqrt 2))`` through ``sqrt(2) erfinv``, clipped inside
  ``(lo, hi)``; ``nn/initializers.py:334`` ``variance_scaling`` scales it
  by ``sqrt(scale / fan_in) / .87962566103423978``.

And Flax's (``flax/core/scope.py``): ``:736`` ``make_rng`` counts the calls
of each scope (every ``self.param`` is one, in creation order), ``:622``
``push`` appends a child's name to the key's suffix, and ``:110``
``_fold_in_static`` folds the first four bytes of the SHA-1 of the suffix
(names as UTF-8, the counter as its big-endian bytes) into the model's key.

Keys, bits, uniforms and integers are JAX's bit for bit. The inverse error
function is XLA's own, evaluated here in the draw's type: ``chlo.erf_inv``'s
polynomial in ``w = -log1p(-u^2)`` (Giles' coefficients, two pieces in
float32, three in float64), with XLA's ``log1p`` (Cephes' rational
approximation, or ``log(1 + x)`` through Cephes' ``logf`` in float32) and
every float32 multiply-add rounded once, as XLA fuses them; ``erf`` is XLA's
float32 rational approximation on ``[-3.7439, 3.7439]``. Measured on JAX
0.9.0's CPU build: float32 normals equal JAX's but for about 1 in 20 000,
by at most 3 ulp; float64 normals by at most 3 ulp (4.5e-16 relative). A
correctly rounded ``erfinv`` (``torch.special.erfinv``) is further off near
``|u| = 1``: 86 ulp (5.7e-6 relative) in float32 and 555 ulp (4.4e-13) in
float64. ``tests/test_torch_prng.py`` holds the bounds.

bfloat16 results are float32 arrays that hold bfloat16 values (numpy has
no bfloat16): ``torch.tensor(x).to(torch.bfloat16)`` is exact.
"""

from __future__ import annotations

import hashlib

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's erf_inv coefficients, highest power first: float32 for w < 5 and
# w >= 5; float64 for w < 6.25, w < 16 and w >= 16
# fmt: off
_ERFINV_F32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
_ERFINV_F64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
     1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
     2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
     4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
     0.24015818242558961693, 1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
     1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
     6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
     -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
     -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
     -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
     1.0103004648645343977, 4.8499064014085844221),
)
# XLA's log1p: Cephes' rational approximation below sqrt(2) - 1 in
# magnitude, else log(1 + x), in float32 with XLA's log (Cephes' logf)
_LOG1P_NUM = (4.5270000862445199635e-5, 4.9854102823193375972e-1, 6.5787325942061044846e0,
              2.9911919328553073277e1, 6.0949667980987787057e1, 5.7112963590585538103e1,
              2.0039553499201281259e1)
_LOG1P_DEN = (1.0, 1.5062909083469192198e1, 8.3047565967967209469e1, 2.2176239823732856465e2,
              3.0909872225312059774e2, 2.1642788614495947685e2, 6.0118660497603843919e1)
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
           1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
           3.3333331174e-1)
# XLA's float32 erf: x p(x^2) / q(x^2) on |x| <= 3.7439211627767994
# (erfinv(1 - 2^-24)), p and q highest power first
_ERF_P = (0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
          0.18520832239976145, 1.128379143519084)
_ERF_Q = (-1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
          0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0)
_ERF_CLAMP = 3.7439211627767994
# fmt: on
# the standard deviation of a standard normal truncated to (-2, 2)
# (jax/_src/nn/initializers.py:353)
TRUNCATED_STD = 0.87962566103423978
BF16 = "bfloat16"


def prng_key(seed: int, x64: bool = False) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: uint32 ``[2]``, the seed's high and
    low 32 bits, a negative seed in two's complement. JAX takes the seed as
    a 64-bit integer under ``jax.enable_x64`` (``x64``), else as its low
    32 bits with the high word 0."""
    s = int(seed) & (0xFFFFFFFFFFFFFFFF if x64 else 0xFFFFFFFF)
    return np.array([s >> 32, s & 0xFFFFFFFF], dtype=np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """The threefry2x32 hash of the counter words ``(x0, x1)`` (uint32,
    one shape) under ``key``: two uint32 arrays of that shape."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(group + 1) % 3]
        x1 = x1 + ks[(group + 2) % 3] + np.uint32(group + 1)
    return x0, x1


def _counters(n: int) -> tuple:
    """The counter pair of each flat index below ``n``: its high and low
    32 bits."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _threefry2x32_ints(k0: int, k1: int, x0: int, x1: int) -> tuple:
    """:func:`threefry2x32` of one counter pair in Python integers (the key
    chains' small splits, several times faster than numpy on arrays of a
    few elements)."""
    m = 0xFFFFFFFF
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + k0) & m, (x1 + k1) & m
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & m
            x1 = (((x1 << r) & m) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & m
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & m
    return x0, x1


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: uint32 ``[n, 2]``; a few keys (the
    per-step chains' splits into 2 to 5) in Python integers, which numpy's
    per-call cost would outweigh, more in numpy."""
    if n <= 16:
        k0, k1 = int(key[0]), int(key[1])
        return np.array([_threefry2x32_ints(k0, k1, i >> 32, i & 0xFFFFFFFF) for i in range(n)],
                        dtype=np.uint32).reshape(n, 2)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, *_counters(n))
    return np.stack([b0, b1], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    ``(0, data)``, ``data`` as uint32."""
    return np.array(_threefry2x32_ints(int(key[0]), int(key[1]), 0, int(data) & 0xFFFFFFFF),
                    dtype=np.uint32)


def random_bits(key: np.ndarray, bit_width: int, shape: tuple) -> np.ndarray:
    """JAX's random bits of ``bit_width`` (32 or 64) and ``shape``."""
    n = int(np.prod(shape, dtype=np.int64))
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, *_counters(n))
    if bit_width == 32:
        bits = b0 ^ b1
    elif bit_width == 64:
        bits = (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
    elif bit_width in (8, 16):
        bits = (b0 ^ b1).astype({8: np.uint8, 16: np.uint16}[bit_width])
    else:
        raise ValueError(f"bit_width must be 8, 16, 32 or 64, got {bit_width}")
    return bits.reshape(shape)


def round_bf16(x) -> np.ndarray:
    """float32 ``x`` rounded to the nearest bfloat16 (ties to even), as a
    float32 array (finite values)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        bits = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1)))
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def uniform(key: np.ndarray, shape: tuple, dtype=np.float32, minval=0.0,
            maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` for
    float32, float64 and ``"bfloat16"`` (:data:`BF16`), in that type's
    arithmetic as XLA computes it on the CPU (module docstring)."""
    if dtype == BF16:
        bits = random_bits(key, 8, tuple(shape)).astype(np.uint32)
        floats = ((bits >> np.uint32(1)) | np.uint32(0x3F80)) << np.uint32(16)
        floats = floats.view(np.float32) - np.float32(1.0)  # exact
        lo, hi = round_bf16(minval), round_bf16(maxval)
        scaled = round_bf16(round_bf16(floats * round_bf16(hi - lo)) + lo)
        return np.maximum(lo, scaled)
    dtype = np.dtype(dtype)
    finfo = np.finfo(dtype)
    nbits, nmant = finfo.bits, finfo.nmant
    uint = {32: np.uint32, 64: np.uint64}[nbits]
    bits = random_bits(key, nbits, tuple(shape))
    one = np.array(1.0, dtype).view(uint)
    floats = ((bits >> uint(nbits - nmant)) | one).view(dtype) - dtype.type(1.0)
    lo, hi = dtype.type(minval), dtype.type(maxval)
    if dtype == np.float32:
        return np.maximum(lo, _fma32(floats, hi - lo, lo))
    return np.maximum(lo, floats * (hi - lo) + lo)


def normal(key: np.ndarray, shape: tuple, dtype=np.float32) -> np.ndarray:
    """``jax.random.normal(key, shape, dtype)`` for float32, float64 and
    ``"bfloat16"``: ``sqrt(2) erfinv(u)``, ``u`` uniform on
    ``[nextafter(-1, 0), 1)``."""
    if dtype == BF16:
        u = uniform(key, shape, BF16, -0.99609375, 1.0)  # nextafter(-1, 0) in bfloat16
        return round_bf16(round_bf16(erfinv(u)) * round_bf16(np.sqrt(2)))
    dtype = np.dtype(dtype)
    lo = np.nextafter(dtype.type(-1.0), dtype.type(0.0))
    u = uniform(key, shape, dtype, lo, 1.0)
    return dtype.type(np.sqrt(2)) * erfinv(u)


def randint(key: np.ndarray, shape: tuple, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 (JAX's
    default without ``enable_x64``): int64 values in ``[minval, maxval)``."""
    k1, k2 = split(key)
    return randint_from_bits(random_bits(k1, 32, tuple(shape)),
                             random_bits(k2, 32, tuple(shape)), minval, maxval)


def randint_from_bits(higher, lower, minval: int, maxval: int):
    """``_randint``'s reduction of two uint32 draws (numpy arrays or int64
    tensors holding uint32) to ``[minval, maxval)``, in int64 (uint32
    arithmetic wraps as JAX's for spans below 2^31)."""
    if isinstance(higher, np.ndarray):
        higher, lower = higher.astype(np.int64), lower.astype(np.int64)
    span = max(int(maxval) - int(minval), 1)
    multiplier = ((2**16 % span) ** 2 % 2**32) % span  # the square wraps in uint32
    offset = ((higher % span) * multiplier) % 2**32 + lower % span
    return (offset % 2**32) % span + int(minval)


def bernoulli(key: np.ndarray, p: float, shape: tuple) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` in its default mode
    (``'low'``) for a float32 ``p`` (a Python float without
    ``enable_x64``): ``uniform(key, shape) < p``, booleans."""
    return uniform(key, shape, np.float32) < np.float32(p)


def permutation_rounds(n: int) -> int:
    """The sorting rounds of ``jax.random.permutation`` of ``n`` elements:
    ``ceil(3 ln n / ln(2^32 - 1))``, 0 for n <= 1, 1 up to 1625, 2 from
    1626 to ~2.6e6."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: ``arange(n)`` (int64 here, int32
    in JAX) shuffled by :func:`permutation_rounds` stable sorts, each on
    fresh 32-bit keys: ``key, subkey = split(key)``, then the elements in
    the order of ``random_bits(subkey, 32, (n,))``, ties in their current
    order."""
    x = np.arange(n, dtype=np.int64)
    for _ in range(permutation_rounds(n)):
        key, subkey = split(key)
        x = x[np.argsort(random_bits(subkey, 32, (n,)), kind="stable")]
    return x


def erf(x) -> np.ndarray:
    """XLA's float32 ``erf`` (module docstring)."""
    f = np.float32
    x = np.clip(np.asarray(x, f), f(-_ERF_CLAMP), f(_ERF_CLAMP))
    x2 = x * x
    return (x * _horner(_ERF_P, x2)) / _horner(_ERF_Q, x2)


def truncated_normal(key: np.ndarray, lower: float, upper: float, shape: tuple) -> np.ndarray:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in float32."""
    f = np.float32
    sqrt2 = f(np.sqrt(2))
    lo, hi = f(lower), f(upper)
    u = uniform(key, shape, np.float32, erf(lo / sqrt2), erf(hi / sqrt2))
    out = sqrt2 * erfinv(u)
    return np.clip(out, np.nextafter(lo, f(np.inf)), np.nextafter(hi, f(-np.inf)))


def variance_scaling(key: np.ndarray, shape: tuple, scale, fan_in: int) -> np.ndarray:
    """Flax's ``variance_scaling(scale, "fan_in", "truncated_normal")``
    (``lecun_normal`` at ``scale`` 1) of a float32 parameter: the
    variance ``scale / fan_in`` and the standard deviation in float32."""
    f = np.float32
    variance = f(np.float32(scale) / f(fan_in)) if isinstance(scale, np.float32) \
        else f(float(scale) / float(fan_in))
    stddev = np.sqrt(variance) / f(TRUNCATED_STD)
    return truncated_normal(key, -2.0, 2.0, shape) * stddev


def flax_param_key(key: np.ndarray, path: tuple, counter: int) -> np.ndarray:
    """The key Flax hands the initializer of a parameter in ``model.init(key,
    ...)``: ``path`` the names of the modules from the root down to the
    parameter's scope, ``counter`` the parameter's place among that scope's
    ``make_rng`` calls (1 for the first ``self.param``)."""
    m = hashlib.sha1()
    for x in (*path, int(counter)):
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a b + c`` rounded once. The product of two float32 is
    exact in float64; rounding the float64 sum to float32 is a second
    rounding, wrong only where the sum fell on the midpoint of two float32
    (its 29 low mantissa bits 1000...0): there the sum's own rounding error
    (Knuth's two-sum) says which way the exact value lies."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    s = p + np.asarray(c, np.float64)
    mid = (s.view(np.int64) & ((1 << 29) - 1)) == (1 << 28)
    if np.any(mid):
        pm, cm = np.broadcast_to(p, s.shape)[mid], np.broadcast_to(c, s.shape)[mid]
        sm = s[mid]
        bb = sm - pm
        e = (pm - (sm - bb)) + (cm - bb)
        s = s.copy()
        s[mid] = np.where(e != 0, np.nextafter(sm, np.where(e > 0, np.inf, -np.inf)), sm)
    return s.astype(np.float32)


def _horner(coefficients, w: np.ndarray) -> np.ndarray:
    """The polynomial at ``w`` in ``w``'s type, a float32 step as a fused
    multiply-add."""
    p = np.full_like(w, coefficients[0])
    for c in coefficients[1:]:
        p = _fma32(p, w, np.float32(c)) if w.dtype == np.float32 else w.dtype.type(c) + p * w
    return p


def _log_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 log of positive normal ``x``: the exponent split off,
    the mantissa in [sqrt(1/2), sqrt(2)) through Cephes' polynomial."""
    f = np.float32
    bits = x.view(np.int32)
    m = ((bits & ~0x7F800000) | f(0.5).view(np.int32)).view(f)
    e = f(1) + ((bits >> 23) - 0x7F).astype(f)
    low = m < f(0.707106781186547524)
    t = (m - f(1)) + np.where(low, m, f(0))
    e = e - np.where(low, f(1), f(0))
    x2 = t * t
    x3 = x2 * t
    p = _LOGF_P
    y = _fma32(_fma32(t, p[0], p[1]), t, p[2])
    y1 = _fma32(_fma32(t, p[3], p[4]), t, p[5])
    y2 = _fma32(_fma32(t, p[6], p[7]), t, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2) * x3
    y = y + f(-2.12194440e-4) * e
    t = t - f(0.5) * x2
    return (t + y) + f(0.693359375) * e


def _by_case(cases, x: np.ndarray) -> np.ndarray:
    """``fn(x)`` where ``mask``, for each ``(mask, fn)`` of ``cases`` (the
    masks disjoint and covering ``x``): each branch evaluated on its own
    elements only."""
    out = np.empty_like(x)
    for mask, fn in cases:
        if np.any(mask):
            out[mask] = fn(x[mask])
    return out


def _log1p_small(x: np.ndarray) -> np.ndarray:
    f = x.dtype.type
    x2 = x * x
    r = _horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)
    return x + (f(-0.5) * x2 + (x * x2) * r)


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's log1p of float32 or float64 ``x`` in (-1, 0]."""
    x = np.asarray(x)
    f = x.dtype.type
    small = np.abs(x) < f(0.41421356237309504880)

    def large(v):
        one_plus = np.maximum(v + f(1), f(1e-30))
        return _log_f32(one_plus) if v.dtype == np.float32 else np.log(one_plus)

    return _by_case(((small, _log1p_small), (~small, large)), x)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's ``erf_inv`` of float32 or float64 ``x`` on ``[-1, 1]``, in
    ``x``'s type (module docstring)."""
    x = np.asarray(x)
    f = x.dtype.type
    w = -_log1p(x * -x)
    if x.dtype == np.float32:
        lt5 = w < f(5)
        p = _by_case(((lt5, lambda v: _horner(_ERFINV_F32[0], v - f(2.5))),
                      (~lt5, lambda v: _horner(_ERFINV_F32[1], np.sqrt(v) - f(3)))), w)
    else:
        lt625, lt16 = w < 6.25, w < 16
        p = _by_case(((lt625, lambda v: _horner(_ERFINV_F64[0], v - 3.125)),
                      (~lt625 & lt16, lambda v: _horner(_ERFINV_F64[1], np.sqrt(v) - 3.25)),
                      (~lt16, lambda v: _horner(_ERFINV_F64[2], np.sqrt(v) - 5.0))), w)
    return np.where(np.abs(x) == 1, x * f(np.inf), p * x)
