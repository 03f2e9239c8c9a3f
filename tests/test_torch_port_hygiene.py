"""The PyTorch port stands alone: no module of ``arreau_tpu_torch``, and
not ``chip_smoke.py`` or ``compare_builds.py``, imports JAX, flax, orbax,
optax, h5py or the JAX package, and the port's entry point never falls back
to the CPU on its own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "arreau_tpu_torch"
FORBIDDEN = ("jax", "flax", "orbax", "optax", "h5py", "arreau_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "compare_builds.py"]


def _module_name(path: Path) -> str:
    rel = path.relative_to(ROOT).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_forbidden(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_every_module_imports_with_jax_and_h5py_unavailable():
    """In a fresh interpreter where importing any forbidden package fails,
    every module of the port, chip_smoke and compare_builds (without running
    them) imports."""
    modules = [_module_name(p) for p in SOURCES]
    blocked = ", ".join(f"{name!r}: None" for name in FORBIDDEN)
    code = (
        "import sys, importlib\n"
        f"sys.modules.update({{{blocked}}})\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_generate_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the CUDA path runs instead of raising")
    from arreau_tpu_torch.cli import generate

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(["--device", "cuda", "--num_crystals", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(["--num_crystals", "1"])  # cuda is the default device
