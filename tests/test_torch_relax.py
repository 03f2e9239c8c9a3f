"""The port's soft-sphere relaxation (``inference/relax.py``) and the
process_results CLI against the JAX package's, on the CPU: the same
crystals, float32, the same gradient steps."""

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


def test_relax_with_mace_is_not_ported():
    with pytest.raises(NotImplementedError, match="mace"):
        relax.relax_with_mace(None)


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


@pytest.mark.parametrize("flag", [["--use_mace", "true"]])
def test_process_results_unported_flags_raise(flag, tmp_path):
    save_sample_results(str(tmp_path / "crystals.npz"), _flat_result())
    with pytest.raises(NotImplementedError, match=flag[0]):
        process_results.main(["--in_path", str(tmp_path / "crystals.npz"), "--device", "cpu",
                              *flag])
