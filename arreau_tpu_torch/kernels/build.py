"""Build the port's CUDA kernels with plain ``nvcc`` calls and bind them
with ``ctypes``.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` into an object by its
own ``nvcc -c`` call, all started together, and the objects are linked
into one shared library with a plain C interface,
``build/arreau_tpu_torch/libkernels.so`` under the repository root
(``build/`` is git-ignored). The library is rebuilt only when the hash of
the sources and flags changes. Each C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises on a non-zero
code. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "arreau_tpu_torch"
LIB_PATH = BUILD_DIR / "libkernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


def build_library() -> float:
    """Build ``libkernels.so`` unless an up-to-date one exists; returns the
    wall seconds spent in ``nvcc`` (0.0 when the cached build was current).
    The sources compile concurrently, one process each; a failure or a
    timeout stops every compile still running."""
    digest = _source_hash()
    stamp = BUILD_DIR / "libkernels.sha256"
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    cmds = [[nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objects)]
    t0 = time.perf_counter()
    running = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)) for cmd in cmds]
    try:
        for cmd, proc in running:
            _, err = proc.communicate(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
        tmp = BUILD_DIR / f"libkernels.{tag}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    finally:
        for _, p in running:
            if p.poll() is None:
                p.kill()
                p.wait()
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    return seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    build_library()
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.arreau_cuda_error_string.argtypes = [ctypes.c_int]
    lib.arreau_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def kernel_function(name: str, argtypes: tuple):
    """C entry point ``name`` with explicit ``argtypes`` and an int return."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def row_splits(rows: int, rows_per_block: int = 4096, max_splits: int = 256) -> tuple[int, int]:
    """(splits, rows per split) for a split-K weight gradient over ``rows``
    rows: about ``rows_per_block`` rows per block, at most ``max_splits``
    partial tiles to add in the second pass."""
    splits = max(1, min(max_splits, -(-rows // rows_per_block)))
    per = -(-rows // splits)
    return -(-rows // per), per


def check(name: str, err: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = library().arreau_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
