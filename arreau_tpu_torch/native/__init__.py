"""Host code in C++: the dense-batch collator of the crystal loader;
counterpart of ``arreau_tpu/native/``.

``collate.cc`` is compiled by ``g++`` at its first use into
``build/arreau_tpu_torch/libcollate.so`` under the repository root (the
kernels' build directory, git-ignored), rebuilt when the source's hash
changes, and bound with ``ctypes``. A failed build raises: unlike the JAX
package's module there is no silent numpy fallback. The numpy
``data.crystal.collate_dense`` is the plain version the tests hold this one
against, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "collate.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "arreau_tpu_torch"
LIB_PATH = BUILD_DIR / "libcollate.so"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, _P, _P, _P, _P, _P]
_ENTRY = {np.dtype(np.float32): "arreau_collate_dense_f32",
          np.dtype(np.float64): "arreau_collate_dense_f64"}


def build_library() -> None:
    """Compile ``collate.cc`` unless the library matches the source's hash;
    raises where ``g++`` fails."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()
    stamp = BUILD_DIR / "libcollate.sha256"
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libcollate.{os.getpid()}.so"
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    tmp_stamp = stamp.with_suffix(f".{os.getpid()}")
    tmp_stamp.write_text(digest)
    os.replace(tmp_stamp, stamp)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    build_library()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def collate_dense(type_indices, frac_coords, offsets, lattices, idx, max_atoms: int,
                  dtype=np.float32):
    """The numpy ``collate_dense``'s arrays ``(frac, types, lattice,
    num_atoms, mask)`` from the C++ loop: ``dtype`` float32 or float64, an
    index of -1 a padding example; a crystal with more than ``max_atoms``
    atoms raises."""
    dtype = np.dtype(dtype)
    if dtype not in _ENTRY:
        raise ValueError(f"collate_dense: dtype {dtype} (float32 or float64)")
    type_indices = np.ascontiguousarray(type_indices, np.int64)
    frac_coords = np.ascontiguousarray(frac_coords, np.float64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lattices = np.ascontiguousarray(lattices, np.float64)
    idx = np.ascontiguousarray(idx, np.int64)
    B = len(idx)
    frac = np.empty((B, max_atoms, 3), dtype)
    types = np.empty((B, max_atoms), np.int32)
    lattice = np.empty((B, 3, 3), dtype)
    num_atoms = np.empty((B,), np.int32)
    mask = np.empty((B, max_atoms), np.bool_)  # one byte each, written as 0/1
    arrays = (type_indices, frac_coords, offsets, lattices, idx)
    outputs = (frac, types, lattice, num_atoms, mask)
    rc = getattr(library(), _ENTRY[dtype])(*(a.ctypes.data for a in arrays), B, max_atoms,
                                           *(a.ctypes.data for a in outputs))
    if rc != 0:
        ci = int(idx[rc - 1])
        n = int(offsets[ci + 1] - offsets[ci])
        raise ValueError(f"crystal {ci} has {n} atoms, more than the bucket's {max_atoms}")
    return frac, types, lattice, num_atoms, mask
