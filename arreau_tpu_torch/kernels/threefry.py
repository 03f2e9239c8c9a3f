"""JAX's random draws for many keys at once: the hand-written CUDA kernel
``csrc/threefry.cu`` and its plain PyTorch version.

:func:`threefry` returns ``[K, *shape]`` draws, row ``k`` being what
``jax.random.bits`` / ``uniform`` / ``normal`` give for ``keys[k]`` and
``shape`` (``ops/prng.py`` computes the same in numpy, and says which JAX
sources it follows). One launch draws a field for every key: the sampler
draws each per-step field of its whole chain with one launch (its keys
``[S, 2]`` come from the host-side chain ``key, k_lat, k_pos, k_type,
k_ang = split(key, 5)``), the training loss each of its fields with one.

It replaces no Pallas kernel: the JAX package draws through XLA's
threefry, and the port draws here so that one seed gives JAX's numbers.
No library generator (``torch.randn``, Philox, cuRAND) gives them. On the
H100 the kernel is bound by its output write (see the source).

Keys are uint32 ``[K, 2]`` (numpy, or an int32 or int64 tensor holding
the bits). :func:`threefry` runs :func:`threefry_plain` for keys on the CPU
(threefry on int64 tensors masked to 32 bits, the float arithmetic of
``ops/prng.py``) and the kernel for keys on a CUDA device, never falling
back. Bits come back as int64 holding uint32, uniforms and normals as
float32 or bfloat16; the plain version also draws float64 (``prng.py``'s
float64 arithmetic), which the kernel does not.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from arreau_tpu_torch.ops import prng

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = (_P, _L, _L, _I, _I, _F, _F, _P, _P)
MODES = {"bits": 0, "uniform": 1, "normal": 2}
DTYPES = (torch.float32, torch.bfloat16)  # the float types the kernel draws
_MASK = 0xFFFFFFFF


def keys_tensor(keys, device) -> torch.Tensor:
    """uint32 keys ``[..., 2]`` (numpy) as a contiguous int32 ``[K, 2]``
    tensor on ``device`` (the same bits). To a CUDA device the copy is
    asynchronous, from pinned memory: the host does not wait for the work
    queued before it."""
    k = torch.from_numpy(np.ascontiguousarray(
        np.asarray(keys, dtype=np.uint32).reshape(-1, 2)).view(np.int32))
    device = torch.device(device)
    if device.type == "cuda":
        return k.pin_memory().to(device, non_blocking=True)
    return k.to(device)


def _bounds(dtype, minval: float, maxval: float) -> tuple[float, float]:
    """(lo, hi - lo) in the draw's type, as ``_uniform`` rounds them."""
    if dtype == torch.bfloat16:
        lo, hi = prng.round_bf16(minval), prng.round_bf16(maxval)
        return float(lo), float(prng.round_bf16(hi - lo))
    lo, hi = np.float32(minval), np.float32(maxval)
    return float(lo), float(hi - lo)


# ---------------- plain version ----------------


def _threefry_plain_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[K, n]`` int64 holding the 32 random bits of each key and index."""
    k = keys.to(torch.int64) & _MASK
    k0, k1 = k[:, 0:1], k[:, 1:2]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    x0 = ((i >> 32) + ks[0]) & _MASK
    x1 = ((i & _MASK) + ks[1]) & _MASK
    for group in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[group % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _MASK
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _MASK
    return x0 ^ x1


def _fma32(a, b, c) -> torch.Tensor:
    """float32 ``a b + c`` rounded once (``prng._fma32`` in torch)."""
    p = torch.as_tensor(a, dtype=torch.float64) * torch.as_tensor(b, dtype=torch.float64)
    c = torch.as_tensor(c, dtype=torch.float64, device=p.device)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    fix = ((s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)) & (e != 0)
    inf = torch.full_like(s, float("inf"))
    s = torch.where(fix, torch.nextafter(s, torch.where(e > 0, inf, -inf)), s)
    return s.to(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _horner(coefficients, w: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(w, coefficients[0])
    for c in coefficients[1:]:
        p = _fma32(p, w, np.float32(c))
    return p


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """``prng._log_f32``: XLA's float32 log of positive normal ``x``."""
    bits = x.view(torch.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    e = 1.0 + ((bits >> 23) - 0x7F).to(torch.float32)
    low = m < np.float32(0.707106781186547524)
    t = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - torch.where(low, 1.0, 0.0)
    x2 = t * t
    x3 = x2 * t
    p = [np.float32(c) for c in prng._LOGF_P]
    y = _fma32(_fma32(t, p[0], p[1]), t, p[2])
    y1 = _fma32(_fma32(t, p[3], p[4]), t, p[5])
    y2 = _fma32(_fma32(t, p[6], p[7]), t, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2) * x3
    y = y + np.float32(-2.12194440e-4) * e
    t = t - 0.5 * x2
    return (t + y) + np.float32(0.693359375) * e


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """``prng.erfinv`` in float32: XLA's ``erf_inv``."""
    y = x * -x
    y2 = y * y
    r = _horner(prng._LOG1P_NUM, y) / _horner(prng._LOG1P_DEN, y)
    small = y + (-0.5 * y2 + (y * y2) * r)
    large = _log_f32(torch.clamp(y + 1.0, min=np.float32(1e-30)))
    w = -torch.where(y.abs() < np.float32(0.41421356237309504880), small, large)
    lt5 = w < 5.0
    p = torch.where(lt5, _horner(prng._ERFINV_F32[0], w - 2.5),
                    _horner(prng._ERFINV_F32[1], torch.sqrt(w) - 3.0))
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def _uniform_plain(bits: torch.Tensor, dtype, lo: float, span: float) -> torch.Tensor:
    """``prng.uniform``'s arithmetic on plain bits (float32 result; for
    bfloat16 it holds bfloat16 values)."""
    if dtype == torch.bfloat16:
        f = ((((bits & 0xFF) >> 1) | 0x3F80) << 16).to(torch.int32).view(torch.float32) - 1.0
        return torch.clamp(_bf16(_bf16(f * span) + lo), min=lo)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(_fma32(f, np.float32(span), np.float32(lo)), min=lo)


def threefry_plain(keys: torch.Tensor, shape: tuple, mode: str = "bits",
                   dtype=torch.float32, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of :func:`threefry` on the keys' device."""
    n = int(np.prod(shape, dtype=np.int64))
    K = keys.shape[0]
    if mode != "bits" and dtype == torch.float64:
        draw = prng.uniform if mode == "uniform" else prng.normal
        args = (np.float64, minval, maxval) if mode == "uniform" else (np.float64,)
        host = keys.cpu().numpy().view(np.uint32).reshape(-1, 2) if keys.dtype == torch.int32 \
            else keys.cpu().numpy().astype(np.uint32).reshape(-1, 2)
        out = np.stack([draw(k, tuple(shape), *args) for k in host]) if K else \
            np.zeros((0, *shape))
        return torch.from_numpy(out.reshape(K, *shape)).to(keys.device)
    bits = _threefry_plain_bits(keys, n)
    if mode == "bits":
        return bits.reshape(K, *shape)
    if mode == "uniform":
        out = _uniform_plain(bits, dtype, *_bounds(dtype, minval, maxval))
    else:
        bf16 = dtype == torch.bfloat16
        lo = -0.99609375 if bf16 else float(np.nextafter(np.float32(-1), np.float32(0)))
        e = _erfinv_f32(_uniform_plain(bits, dtype, *_bounds(dtype, lo, 1.0)))
        out = (_bf16(_bf16(e) * np.float32(1.4140625)) if bf16
               else np.float32(np.sqrt(2)) * e)
    return out.to(dtype).reshape(K, *shape)


# ---------------- the kernel ----------------


def _check(keys, shape, mode, dtype):
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"threefry expects keys [K, 2], got {tuple(keys.shape)}")
    if keys.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"keys must be int32 or int64 holding uint32, got {keys.dtype}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if any(int(s) < 0 for s in shape):
        raise ValueError(f"negative shape {tuple(shape)}")


def threefry(keys: torch.Tensor, shape: tuple, mode: str = "bits", dtype=torch.float32,
             minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``[K, *shape]``: for each key of ``keys [K, 2]`` JAX's ``bits``
    (int64 holding uint32), ``uniform`` on ``[minval, maxval)`` or
    ``normal`` draws of ``shape`` in ``dtype``, on the keys' device."""
    shape = tuple(int(s) for s in shape)
    _check(keys, shape, mode, dtype)
    if keys.device.type == "cpu":
        return threefry_plain(keys, shape, mode, dtype, minval, maxval)
    if keys.device.type != "cuda":
        raise ValueError(f"threefry runs on cuda or cpu, not {keys.device}")
    if mode != "bits" and dtype not in DTYPES:
        raise TypeError(f"threefry's CUDA kernel draws float32 or bfloat16, not {dtype}")
    from arreau_tpu_torch.kernels.build import check, kernel_function

    K, n = keys.shape[0], int(np.prod(shape, dtype=np.int64))
    k = keys.contiguous()
    if keys.dtype == torch.int64:  # the same 32 bits as int32
        k = keys & _MASK
        k = torch.where(k >= 2**31, k - 2**32, k).to(torch.int32).contiguous()
    out_dtype = torch.int32 if mode == "bits" else dtype
    out = torch.empty((K, *shape), dtype=out_dtype, device=keys.device)
    lo, span = _bounds(dtype, minval, maxval) if mode == "uniform" else (0.0, 0.0)
    fn = kernel_function("arreau_threefry", _ARGTYPES)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = fn(k.data_ptr(), K, n, MODES[mode], int(dtype == torch.bfloat16), lo, span,
             out.data_ptr(), stream)
    check("arreau_threefry", err)
    threefry.launches += 1
    if mode == "bits":
        return out.to(torch.int64) & _MASK
    return out


threefry.launches = 0


# ---------------- draws from host keys ----------------


def draw(keys, shape: tuple, mode: str, device, dtype=torch.float32, minval: float = 0.0,
         maxval: float = 1.0) -> torch.Tensor:
    """:func:`threefry` for uint32 ``keys [..., 2]`` (numpy) on ``device``:
    ``[*keys.shape[:-1], *shape]``."""
    lead = np.asarray(keys).shape[:-1]
    out = threefry(keys_tensor(keys, device), shape, mode, dtype, minval, maxval)
    return out.reshape(tuple(lead) + tuple(shape))


def normal(key, shape: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` on ``device``."""
    return draw(key, shape, "normal", device, dtype)


def uniform(key, shape: tuple, device, dtype=torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` on ``device``."""
    return draw(key, shape, "uniform", device, dtype, minval, maxval)


def randint(key, shape: tuple, minval: int, maxval: int, device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 draws) on
    ``device`` as int64: one launch for the two bit fields of
    ``split(key)``."""
    bits = draw(prng.split(np.asarray(key, np.uint32)), shape, "bits", device)
    return prng.randint_from_bits(bits[0], bits[1], minval, maxval)
