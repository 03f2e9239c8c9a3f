"""Synthetic crystals for training runs without a dataset on disk;
counterpart of ``arreau_tpu/data/synthetic.py`` (numpy only, so a seed
gives the same arrays in both packages).

Random crystals with the Alexandria dataset's shape statistics (about 10
atoms per crystal, lengths U(3, 8) angstrom, angles U(75, 105) degrees) and
atom types tied to the fractional z coordinate, so the type channel has a
learnable signal.
"""

from __future__ import annotations

import numpy as np

from arreau_tpu_torch.data.atoms import AtomicNumberTable, synthetic_z_table
from arreau_tpu_torch.data.crystal import CrystalDataset, PackedCrystals
from arreau_tpu_torch.tasks.diffusion import CrystalBatch


def random_lattices(rng: np.random.Generator, n: int) -> np.ndarray:
    """``[n, 3, 3]`` lattices in the pymatgen orientation: lengths U(3, 8)
    angstrom, angles U(75, 105) degrees."""
    lengths = rng.uniform(3.0, 8.0, size=(n, 3))
    angles = np.deg2rad(rng.uniform(75.0, 105.0, size=(n, 3)))
    cos_a, cos_b, cos_g = np.cos(angles).T
    sin_a, sin_b = np.sin(angles[:, 0]), np.sin(angles[:, 1])
    gamma_star = np.arccos(np.clip((cos_a * cos_b - cos_g) / (sin_a * sin_b), -1, 1))
    a, b, c = lengths.T
    zeros = np.zeros(n)
    va = np.stack([a * sin_b, zeros, a * cos_b], -1)
    vb = np.stack([-b * sin_a * np.cos(gamma_star), b * sin_a * np.sin(gamma_star), b * cos_a], -1)
    vc = np.stack([zeros, zeros, c], -1)
    return np.stack([va, vb, vc], axis=1)


def _geometry_types(frac: np.ndarray, num_real: int) -> np.ndarray:
    return np.minimum((frac[..., 2] * num_real).astype(np.int64), num_real - 1)


def make_synthetic_batch(rng: np.random.Generator, z_table: AtomicNumberTable, batch_size: int,
                         max_atoms: int, min_atoms: int = 2, dtype=np.float32) -> CrystalBatch:
    """A random dense batch of numpy arrays with variable atom counts."""
    B, A = batch_size, max_atoms
    lattice = random_lattices(rng, B)
    frac = rng.uniform(size=(B, A, 3))
    num_atoms = rng.integers(min_atoms, A + 1, size=(B,))
    atom_mask = np.arange(A)[None, :] < num_atoms[:, None]
    types = np.where(atom_mask, _geometry_types(frac, len(z_table) - 1), 0)
    return CrystalBatch(frac_x=frac.astype(dtype), atom_types=types.astype(np.int32),
                        lattice=lattice.astype(dtype), num_atoms=num_atoms.astype(np.int32),
                        atom_mask=atom_mask)


def synthetic_packed(n: int, seed: int = 0, max_atoms: int = 24, min_atoms: int = 2) -> CrystalDataset:
    """A dataset of ``n`` random crystals of ``min_atoms..max_atoms`` atoms."""
    rng = np.random.default_rng(seed)
    z_table = synthetic_z_table()
    counts = rng.integers(min_atoms, max_atoms + 1, size=n).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    frac = rng.uniform(size=(int(offsets[-1]), 3))
    packed = PackedCrystals(
        atomic_numbers=np.asarray(z_table.indices_to_zs(_geometry_types(frac, len(z_table) - 1))),
        frac_coords=frac,
        offsets=offsets,
        lattices=random_lattices(rng, n),
    )
    return CrystalDataset(packed=packed, z_table=z_table)
