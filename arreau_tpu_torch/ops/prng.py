"""``jax.random``'s default generator in numpy: ``PRNGKey``, ``split`` and
``normal`` as JAX 0.9.0 computes them with its defaults (the threefry2x32
hash, ``jax_threefry_partitionable`` on).

It exists so that the constants the JAX package draws from a key when it
builds a model come out the same in the port: the S^2 orientation grid
(``ops/grids.py``, ``cached_grid_s2``; within 2e-9, see there) and the
Fourier frequencies of the time embedding (``ops/fourier.py``). It is not a random source for
training or sampling: that noise is drawn from a ``torch.Generator``.

The JAX sources it follows (``jax/_src``):

- ``prng.py:802`` ``threefry_seed``: the key of a seed is ``[seed >> 32,
  seed & 0xFFFFFFFF]`` as uint32;
- ``prng.py:1092`` ``threefry_2x32`` and ``:883`` its lowering: 20 rounds
  in five groups of four, a key injection after each group;
- ``prng.py:1143-1170`` split, its partitionable form: the hash of the
  counter pair ``(hi, lo)`` of each flat index ``i < n``, the two output
  words being the new key;
- ``prng.py:1172-1200`` random bits, partitionable: the hash of the flat
  index's counter pair; 32 bits are the two words XORed, 64 bits the first
  word above the second;
- ``random.py:435`` ``_uniform``: the top mantissa bits under the exponent
  of 1.0, minus 1, scaled to ``[lo, hi)`` and clamped below at ``lo``;
- ``random.py:867`` ``_normal_real``: ``sqrt(2) erfinv(u)`` with ``u``
  uniform on ``[nextafter(-1, 0), 1)``.

Keys, bits and uniforms are JAX's bit for bit. The inverse error function
is XLA's own, evaluated here in the draw's type: ``chlo.erf_inv``'s
polynomial in ``w = -log1p(-u^2)`` (Giles' coefficients, two pieces in
float32, three in float64), with XLA's ``log1p`` (Cephes' rational
approximation, or ``log(1 + x)`` through Cephes' ``logf`` in float32) and
every float32 multiply-add rounded once, as XLA fuses them. Measured on
JAX 0.9.0's CPU build: float32 normals equal JAX's but for about 1 in
20 000, by at most 3 ulp; float64 normals by at most 3 ulp (4.5e-16
relative). A correctly rounded ``erfinv`` (``torch.special.erfinv``) is
further off near ``|u| = 1``: 86 ulp (5.7e-6 relative) in float32 and 555
ulp (4.4e-13) in float64. ``tests/test_torch_prng.py`` holds the bounds.
"""

from __future__ import annotations

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
# fmt: on


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


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: uint32 ``[n, 2]``."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, *_counters(n))
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, bit_width: int, shape: tuple) -> np.ndarray:
    """JAX's random bits of ``bit_width`` (32 or 64) and ``shape``."""
    n = int(np.prod(shape, dtype=np.int64))
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, *_counters(n))
    if bit_width == 32:
        bits = b0 ^ b1
    elif bit_width == 64:
        bits = (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
    else:
        raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")
    return bits.reshape(shape)


def uniform(key: np.ndarray, shape: tuple, dtype=np.float32, minval=0.0,
            maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` for float32
    and float64, in that type's arithmetic."""
    dtype = np.dtype(dtype)
    finfo = np.finfo(dtype)
    nbits, nmant = finfo.bits, finfo.nmant
    uint = {32: np.uint32, 64: np.uint64}[nbits]
    bits = random_bits(key, nbits, tuple(shape))
    one = np.array(1.0, dtype).view(uint)
    floats = ((bits >> uint(nbits - nmant)) | one).view(dtype) - dtype.type(1.0)
    lo, hi = dtype.type(minval), dtype.type(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def normal(key: np.ndarray, shape: tuple, dtype=np.float32) -> np.ndarray:
    """``jax.random.normal(key, shape, dtype)`` for float32 and float64:
    ``sqrt(2) erfinv(u)``, ``u`` uniform on ``[nextafter(-1, 0), 1)``."""
    dtype = np.dtype(dtype)
    lo = np.nextafter(dtype.type(-1.0), dtype.type(0.0))
    u = uniform(key, shape, dtype, lo, 1.0)
    return dtype.type(np.sqrt(2)) * erfinv(u)


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a b + c`` rounded once: the product of two float32 is
    exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


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


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's log1p of float32 or float64 ``x`` in (-1, 0]."""
    f = x.dtype.type
    x2 = x * x
    r = _horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)
    small = x + (f(-0.5) * x2 + (x * x2) * r)
    one_plus = np.maximum(x + f(1), f(1e-30))
    large = _log_f32(one_plus) if x.dtype == np.float32 else np.log(one_plus)
    return np.where(np.abs(x) < f(0.41421356237309504880), small, large)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's ``erf_inv`` of float32 or float64 ``x`` on ``[-1, 1]``, in
    ``x``'s type (module docstring)."""
    f = x.dtype.type
    w = -_log1p(x * -x)
    if x.dtype == np.float32:
        lt5 = w < f(5)
        w = np.where(lt5, w - f(2.5), np.sqrt(w) - f(3))
        p = np.where(lt5, _horner(_ERFINV_F32[0], w), _horner(_ERFINV_F32[1], w))
    else:
        lt625, lt16 = w < 6.25, w < 16
        w = np.where(lt625, w - 3.125, np.sqrt(w) - np.where(lt16, 3.25, 5.0))
        p = np.where(lt625, _horner(_ERFINV_F64[0], w),
                     np.where(lt16, _horner(_ERFINV_F64[1], w), _horner(_ERFINV_F64[2], w)))
    return np.where(np.abs(x) == 1, x * f(np.inf), p * x)
