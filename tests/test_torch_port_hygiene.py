"""The PyTorch port stands alone: no module of ``arreau_tpu_torch``, and
not ``chip_smoke.py`` or ``compare_builds.py``, imports JAX, flax, orbax,
optax, h5py, the JAX package, the checkpoint converter or the JAX readout
witness, and the port's entry points never fall back
to the CPU on their own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "arreau_tpu_torch"
# convert_jax_checkpoint.py and jax_tpu_readout.py import the JAX package: they
# stand beside the port
FORBIDDEN = ("jax", "flax", "orbax", "optax", "h5py", "arreau_tpu", "convert_jax_checkpoint",
             "jax_tpu_readout")
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


def test_process_results_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the CUDA path runs instead of raising")
    from arreau_tpu_torch.cli import process_results

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        process_results.main(["--in_path", "crystals.h5"])  # cuda is the default device


def test_hdf5_modules_are_covered_and_no_hdf5_refusal_is_left():
    """The HDF5 subset and the prep are port modules the import rules above
    cover (so neither imports h5py), and no port module refuses an HDF5
    path any more."""
    covered = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in p.parents}
    assert {"data/hdf5.py", "data/prep.py"} <= covered
    for path in SOURCES:
        text = path.read_text()
        assert "HDF5_NOT_PORTED" not in text, path.name
        assert "h5py" not in [n.split(".")[0] for n in _imported_names(text)], path.name


def _imported_names(text: str) -> list:
    names = []
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


# the modules the crystal-diffusion paths run (generate, the exported
# sampler, train_diffusion): they draw every random number from a JAX key
DIFFUSION_PATHS = ("tasks/diffusion.py", "diffusion/d3pm.py", "diffusion/ve.py", "diffusion/vp.py",
                   "cli/generate.py", "cli/train_diffusion.py", "inference/export.py",
                   "train/loop.py", "ops/lattice.py", "ops/grids.py", "ops/rotations.py",
                   "ops/prng.py", "kernels/threefry.py", "models/ponita.py", "models/blocks.py",
                   "interop/from_jax.py")
TORCH_RANDOM = {"Generator", "randn", "rand", "randint", "randn_like", "rand_like",
                "randint_like", "randperm", "normal", "bernoulli", "multinomial"}


@pytest.mark.parametrize("rel", DIFFUSION_PATHS)
def test_diffusion_paths_draw_no_torch_random_numbers(rel):
    """No ``torch.Generator``, no torch random function and no
    ``generator=`` argument on the diffusion paths: their draws are
    JAX's, from keys (``ops/prng.py``, ``kernels/threefry.py``)."""
    tree = ast.parse((PORT / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            assert not (node.value.id == "torch" and node.attr in TORCH_RANDOM), \
                f"{rel}:{node.lineno} uses torch.{node.attr}"
        if isinstance(node, ast.keyword):
            assert node.arg != "generator", f"{rel}:{node.lineno} passes generator="
        if isinstance(node, ast.ImportFrom) and node.module == "torch":
            assert not {a.name for a in node.names} & TORCH_RANDOM, f"{rel}:{node.lineno}"
