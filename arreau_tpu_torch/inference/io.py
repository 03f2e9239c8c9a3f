"""Generated-crystal result container and its file; counterpart of
``arreau_tpu/inference/io.py``.

Results are written as the JAX package (and the reference) writes them:
``crystals.h5``, the five datasets under a ``crystals`` group, through
``data/hdf5.py`` (no ``h5py``). The ``crystals.npz`` files of earlier
versions of the port are still read, by their suffix.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from arreau_tpu_torch.data.hdf5 import read_datasets, write_datasets

FIELDS = ("frac_x", "atomic_numbers", "lattice", "idx_start", "num_atoms")


@dataclass
class SampleResult:
    frac_x: Optional[np.ndarray] = None  # [total_atoms, 3]
    atomic_numbers: Optional[np.ndarray] = None  # [total_atoms]
    lattice: Optional[np.ndarray] = None  # [num_crystals, 3, 3]
    idx_start: Optional[np.ndarray] = None  # [num_crystals]
    num_atoms: Optional[np.ndarray] = None  # [num_crystals]

    def crystal(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(frac coords, atomic numbers, lattice) of crystal i."""
        s = int(self.idx_start[i])
        e = s + int(self.num_atoms[i])
        return self.frac_x[s:e], self.atomic_numbers[s:e], self.lattice[i]

    @property
    def num_crystals(self) -> int:
        return len(self.num_atoms)


def from_dense_batch(batch, z_table) -> SampleResult:
    """Flatten a dense sampled ``CrystalBatch`` (torch tensors on any
    device) into a host-side ``SampleResult``."""
    frac = batch.frac_x.detach().cpu().numpy().astype(np.float64)
    types = batch.atom_types.detach().cpu().numpy()
    mask = batch.atom_mask.detach().cpu().numpy()
    lattice = batch.lattice.detach().cpu().numpy().astype(np.float64)
    num_atoms = batch.num_atoms.detach().cpu().numpy()
    frac_list, z_list = [], []
    for b in range(frac.shape[0]):
        m = mask[b]
        frac_list.append(frac[b][m])
        z_list.append(z_table.indices_to_zs(types[b][m]))
    idx_start = np.concatenate([[0], np.cumsum(num_atoms)[:-1]])
    return SampleResult(
        frac_x=np.concatenate(frac_list),
        atomic_numbers=np.concatenate(z_list),
        lattice=lattice,
        idx_start=idx_start.astype(np.int64),
        num_atoms=num_atoms.astype(np.int64),
    )


def concat_results(results: list[SampleResult]) -> SampleResult:
    num_atoms = np.concatenate([r.num_atoms for r in results])
    idx_start = np.concatenate([[0], np.cumsum(num_atoms)[:-1]])
    return SampleResult(
        np.concatenate([r.frac_x for r in results]),
        np.concatenate([r.atomic_numbers for r in results]),
        np.concatenate([r.lattice for r in results]),
        idx_start.astype(np.int64),
        num_atoms,
    )


def save_sample_results(path: str, result: SampleResult) -> None:
    """Write the reference layout: the datasets under a ``crystals`` group."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_datasets(path, {f"crystals/{name}": getattr(result, name) for name in FIELDS})


def load_sample_results(path: str) -> SampleResult:
    """Read the grouped layout or flat root datasets (or, by its suffix, an
    ``.npz`` of an earlier version of the port)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return SampleResult(**{name: data[name] for name in FIELDS})
    data, _ = read_datasets(path)
    prefix = "crystals/" if any(key.startswith("crystals/") for key in data) else ""
    return SampleResult(**{name: data[prefix + name] for name in FIELDS})
