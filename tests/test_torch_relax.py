"""The port's soft-sphere relaxation (``inference/relax.py``) and the
process_results CLI against the JAX package's, on the CPU: the same
crystals, float32, the same gradient steps. The MACE relaxation against the
JAX package's on small stand-ins for ``ase`` and ``mace`` (put into
``sys.modules``): an ``Atoms``, a calculator whose energy and forces are a
fixed function of the positions, and a steepest-descent ``BFGS``."""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.cli import process_results as j_process_results
from arreau_tpu.inference import relax as j_relax
from arreau_tpu.inference.io import SampleResult as JResult
from arreau_tpu.inference.io import load_sample_results as j_load
from arreau_tpu.inference.io import save_sample_results as j_save
from arreau_tpu_torch.cli import process_results
from arreau_tpu_torch.data.synthetic import random_lattices
from arreau_tpu_torch.inference import relax
from arreau_tpu_torch.inference.io import SampleResult, load_sample_results, save_sample_results

# float32 positions after 50 steps of the same gradient: the two packages
# sum the pair energies in other orders (~1e-7 relative a step)
FRAC_TOL = 1e-5
ENERGY_REL_TOL = 1e-5


def dense_batch(seed=0, B=6, A=5):
    """Crystals of 2..A atoms in cells packed tight enough that every one
    overlaps at sigma 1.5 (lengths U(1.2, 3.2) angstrom), coordinates
    outside [0, 1) too."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(2, A + 1, size=B)
    counts[0] = A
    mask = np.arange(A)[None, :] < counts[:, None]
    frac = rng.uniform(-0.5, 1.5, size=(B, A, 3)).astype(np.float32)
    return frac, (0.4 * random_lattices(rng, B)).astype(np.float32), mask


def circle_dist(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % 1.0
    return np.minimum(d, 1.0 - d)


def test_soft_sphere_energy_matches_jax():
    frac, lattice, mask = dense_batch(1)
    got = relax._soft_sphere_energy(torch.tensor(frac), torch.tensor(lattice), torch.tensor(mask))
    want = j_relax._soft_sphere_energy(jnp.asarray(frac), jnp.asarray(lattice), jnp.asarray(mask))
    want = np.asarray(want)
    assert want.min() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=ENERGY_REL_TOL, atol=0)


def test_relax_soft_sphere_matches_jax():
    """6 crystals x 5 atoms, 50 steps: coordinates within 1e-5 on the
    circle, the energy history within 1e-5 of its scale, and the energy
    falls."""
    frac, lattice, mask = dense_batch(0)
    got = relax.relax_soft_sphere(torch.tensor(frac), torch.tensor(lattice), torch.tensor(mask),
                                  steps=50)
    want = j_relax.relax_soft_sphere(jnp.asarray(frac), jnp.asarray(lattice), jnp.asarray(mask),
                                     steps=50)
    assert got.frac_x.shape == frac.shape and got.energy_history.shape == (6, 50)
    assert circle_dist(got.frac_x.numpy(), want.frac_x)[mask].max() <= FRAC_TOL
    hist = np.asarray(want.energy_history)
    scale = np.abs(hist).max()
    assert np.abs(got.energy_history.numpy() - hist).max() <= ENERGY_REL_TOL * scale
    np.testing.assert_array_equal(got.energy.numpy(), got.energy_history[:, -1].numpy())
    assert (got.energy < got.energy_history[:, 0]).all()
    assert bool(((got.frac_x >= 0) & (got.frac_x < 1)).all())


class _StubAtoms:
    """``ase.Atoms`` as ``relax_with_mace`` uses it: cartesian positions
    from scaled ones and the cell, back to scaled ones."""

    def __init__(self, numbers, scaled_positions, cell, pbc):
        assert tuple(pbc) == (True, True, True)
        self.numbers = np.asarray(numbers)
        self.cell = np.asarray(cell, np.float64)
        self.positions = np.asarray(scaled_positions, np.float64) @ self.cell
        self.calc = None

    def get_scaled_positions(self):
        return (self.positions @ np.linalg.inv(self.cell)) % 1.0

    def get_forces(self):
        return self.calc.forces(self)

    def get_potential_energy(self):
        return self.calc.energy(self)


class _StubCalculator:
    """Energy ``sum_i k_Z |r_i - c|^2`` about the cell's centre ``c``
    (``k_Z`` from the atomic number), its forces ``-2 k_Z (r_i - c)``."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def _k(self, atoms):
        return (1.0 + 0.01 * atoms.numbers)[:, None]

    def energy(self, atoms):
        d = atoms.positions - 0.5 * atoms.cell.sum(0)
        return float((self._k(atoms) * d**2).sum())

    def forces(self, atoms):
        return -2.0 * self._k(atoms) * (atoms.positions - 0.5 * atoms.cell.sum(0))


class _StubBFGS:
    """Steepest descent at step 0.1 until the largest force is below
    ``fmax``, at most ``steps`` steps."""

    def __init__(self, atoms, logfile=None):
        assert logfile is None
        self.atoms = atoms

    def run(self, fmax, steps):
        for _ in range(steps):
            f = self.atoms.get_forces()
            if np.linalg.norm(f, axis=1).max() < fmax:
                break
            self.atoms.positions = self.atoms.positions + 0.1 * f


@pytest.fixture
def stub_mace(monkeypatch):
    """Stand-in ``ase``, ``ase.optimize``, ``mace`` and ``mace.calculators``
    modules; returns the list of calculators made."""
    made = []

    def calculator(**kwargs):
        made.append(_StubCalculator(**kwargs))
        return made[-1]

    modules = {
        "ase": types.SimpleNamespace(Atoms=_StubAtoms),
        "ase.optimize": types.SimpleNamespace(BFGS=_StubBFGS),
        "mace": types.SimpleNamespace(),
        "mace.calculators": types.SimpleNamespace(
            mace_mp=lambda device: calculator(device=device),
            MACECalculator=lambda model_paths, device: calculator(model_paths=model_paths,
                                                                  device=device)),
    }
    for name, module in modules.items():
        monkeypatch.setitem(sys.modules, name, module)
    return made


def _j_result(result):
    return JResult(*(getattr(result, k) for k in (
        "frac_x", "atomic_numbers", "lattice", "idx_start", "num_atoms")))


@pytest.mark.parametrize("model_path", [None, "local.model"])
def test_relax_with_mace_matches_jax(stub_mace, model_path):
    """The same crystals through both packages' ``relax_with_mace`` on the
    stand-in modules: the same calculator arguments, relaxed coordinates
    and energies equal, lattices, numbers and counts kept."""
    result = _flat_result()
    got, energies = relax.relax_with_mace(result, model_path=model_path, fmax=0.01,
                                          max_steps=30)
    want, j_energies = j_relax.relax_with_mace(_j_result(result), model_path=model_path,
                                               fmax=0.01, max_steps=30)
    assert [c.kwargs for c in stub_mace] == [
        {"device": "cpu"} if model_path is None else
        {"model_paths": model_path, "device": "cpu"}] * 2
    np.testing.assert_array_equal(got.frac_x, want.frac_x)
    np.testing.assert_array_equal(energies, j_energies)
    for name in ("atomic_numbers", "lattice", "idx_start", "num_atoms"):
        np.testing.assert_array_equal(getattr(got, name), getattr(result, name), err_msg=name)
    assert energies.shape == (5,) and not np.array_equal(got.frac_x, result.frac_x % 1.0)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_relax_with_mace_without_the_packages_raises(package, monkeypatch):
    """Where ``ase`` does not import, both packages raise the same
    ``ImportError``."""
    monkeypatch.setitem(sys.modules, "ase", None)
    fn = relax.relax_with_mace if package == "port" else j_relax.relax_with_mace
    with pytest.raises(ImportError, match="needs the `mace-torch` and `ase` packages"):
        fn(_flat_result())


def _flat_result(seed=2):
    frac, lattice, mask = dense_batch(seed, B=5, A=4)
    counts = mask.sum(1)
    zs = np.random.default_rng(seed).choice([1, 6, 8, 14], size=int(counts.sum()))
    idx_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return SampleResult(frac[mask].astype(np.float64), zs, lattice.astype(np.float64), idx_start,
                        counts.astype(np.int64))


def test_process_results_matches_jax(tmp_path, capsys):
    """``process_results --device cpu`` on the port's ``crystals.h5``
    against the JAX CLI on the same crystals in its own ``crystals.h5``
    (another directory): the relaxed file holds
    the same crystals, coordinates within 1e-5 on the circle; the energy
    line is printed as the JAX CLI prints it."""
    result = _flat_result()
    (tmp_path / "jax").mkdir()
    save_sample_results(str(tmp_path / "crystals.h5"), result)
    j_save(str(tmp_path / "jax" / "crystals.h5"), JResult(*(getattr(result, k) for k in (
        "frac_x", "atomic_numbers", "lattice", "idx_start", "num_atoms"))))
    out = process_results.main(["--in_path", str(tmp_path / "crystals.h5"), "--device", "cpu",
                                "--steps", "40"])
    printed = capsys.readouterr().out
    j_process_results.main(["--in_path", str(tmp_path / "jax" / "crystals.h5"), "--steps", "40"])
    j_printed = capsys.readouterr().out
    saved = load_sample_results(str(tmp_path / "crystals_relaxed.h5"))
    want = j_load(str(tmp_path / "jax" / "crystals_relaxed.h5"))
    assert j_load(str(tmp_path / "crystals_relaxed.h5")).frac_x.tobytes() == saved.frac_x.tobytes()
    for name in ("atomic_numbers", "lattice", "idx_start", "num_atoms"):
        np.testing.assert_array_equal(getattr(saved, name), getattr(want, name), err_msg=name)
        np.testing.assert_array_equal(getattr(out, name), getattr(want, name), err_msg=name)
    assert saved.frac_x.dtype == want.frac_x.dtype == np.float64
    assert circle_dist(saved.frac_x, want.frac_x).max() <= FRAC_TOL
    line = [s for s in printed.splitlines() if s.startswith("relaxed 5 crystals: mean energy")]
    j_line = [s for s in j_printed.splitlines() if s.startswith("relaxed 5 crystals")]
    assert len(line) == len(j_line) == 1
    e0, e1 = (float(x) for x in line[0].split("energy ")[1].split(" -> "))
    j_e0, j_e1 = (float(x) for x in j_line[0].split("energy ")[1].split(" -> "))
    assert e1 < e0 and abs(e0 - j_e0) <= 1e-4 and abs(e1 - j_e1) <= 1e-4


def test_process_results_use_mace_matches_jax(stub_mace, tmp_path, capsys):
    """``process_results --use_mace`` in both packages on the stand-in
    modules: the same relaxed ``crystals_relaxed.h5`` and the same energy
    line."""
    result = _flat_result()
    (tmp_path / "jax").mkdir()
    save_sample_results(str(tmp_path / "crystals.h5"), result)
    j_save(str(tmp_path / "jax" / "crystals.h5"), _j_result(result))
    flags = ["--use_mace", "true", "--steps", "25", "--fmax", "0.02"]
    process_results.main(["--in_path", str(tmp_path / "crystals.h5"), "--device", "cpu",
                          *flags])
    printed = capsys.readouterr().out
    j_process_results.main(["--in_path", str(tmp_path / "jax" / "crystals.h5"), *flags])
    j_printed = capsys.readouterr().out
    saved = load_sample_results(str(tmp_path / "crystals_relaxed.h5"))
    want = j_load(str(tmp_path / "jax" / "crystals_relaxed.h5"))
    for name in ("frac_x", "atomic_numbers", "lattice", "idx_start", "num_atoms"):
        np.testing.assert_array_equal(getattr(saved, name), getattr(want, name), err_msg=name)
    line = [s for s in printed.splitlines() if s.startswith("MACE-relaxed 5 crystals")]
    assert line and line == [s for s in j_printed.splitlines()
                             if s.startswith("MACE-relaxed 5 crystals")]
