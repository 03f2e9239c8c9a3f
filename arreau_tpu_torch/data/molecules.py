"""Molecular datasets: QM9 (the raw gdb9 ``.xyz`` directory), revised MD17
(npz), and synthetic molecules for runs without those files; a numpy copy
of ``arreau_tpu/data/molecules.py`` (the port imports nothing of the JAX
package), with the same arrays from the same files and the same draws
from the same seed.

The synthetic molecules carry a smooth geometric target, a soft pair
potential, and its analytic forces, so that the QM9 and MD17 tasks can
learn without the real datasets.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from arreau_tpu_torch.data.atoms import symbol_to_z

QM9_TARGETS = [
    "mu", "alpha", "homo", "lumo", "gap", "r2", "zpve", "U0", "U", "H", "G", "Cv",
]
QM9_ELEMENTS = [1, 6, 7, 8, 9]  # H C N O F
QM9_MAX_ATOMS = 29


class MoleculeExamples(NamedTuple):
    """Dense molecule batch store.

    pos: [S, A, 3]; one_hot: [S, A, F]; mask: [S, A]; y: [S] target;
    forces: [S, A, 3] or None (MD17); energies == y for MD17.
    """

    pos: np.ndarray
    one_hot: np.ndarray
    mask: np.ndarray
    y: np.ndarray
    forces: np.ndarray | None = None

    def __len__(self):
        return len(self.pos)


def _one_hot_z(zs: np.ndarray, elements: list[int]) -> np.ndarray:
    lut = {z: i for i, z in enumerate(elements)}
    out = np.zeros((len(zs), len(elements)), np.float32)
    for i, z in enumerate(zs):
        out[i, lut[int(z)]] = 1.0
    return out


def load_qm9_xyz_dir(root: str, target: str = "alpha", max_atoms: int = QM9_MAX_ATOMS,
                     limit: int | None = None) -> MoleculeExamples:
    """Parse the standard gdb9 xyz directory (one file per molecule; line 2
    carries the 15 scalar properties following the 'gdb NNN' tag)."""
    t_idx = QM9_TARGETS.index(target)
    files = sorted(f for f in os.listdir(root) if f.endswith(".xyz"))
    if limit:
        files = files[:limit]
    S = len(files)
    pos = np.zeros((S, max_atoms, 3), np.float32)
    oh = np.zeros((S, max_atoms, len(QM9_ELEMENTS)), np.float32)
    mask = np.zeros((S, max_atoms), bool)
    y = np.zeros(S, np.float64)
    for s, fname in enumerate(files):
        with open(os.path.join(root, fname)) as f:
            lines = f.read().replace("*^", "e").splitlines()
        n = int(lines[0])
        props = lines[1].split()
        y[s] = float(props[2 + 3 + t_idx])  # skip tag,id + A,B,C rotational consts
        zs, xyz = [], []
        for line in lines[2 : 2 + n]:
            parts = line.split()
            zs.append(symbol_to_z(parts[0]))
            xyz.append([float(v) for v in parts[1:4]])
        pos[s, :n] = xyz
        oh[s, :n] = _one_hot_z(np.asarray(zs), QM9_ELEMENTS)
        mask[s, :n] = True
    return MoleculeExamples(pos=pos, one_hot=oh, mask=mask, y=y)


def load_rmd17_npz(path: str, limit: int | None = None) -> MoleculeExamples:
    """Load a revised-MD17 npz (keys: coords [S,A,3], energies [S],
    forces [S,A,3], nuclear_charges [A])."""
    data = np.load(path)
    coords = data["coords"][:limit]
    energies = data["energies"][:limit]
    forces = data["forces"][:limit]
    zs = data["nuclear_charges"]
    S, A, _ = coords.shape
    elements = sorted(set(int(z) for z in zs))
    oh = np.broadcast_to(_one_hot_z(zs, elements)[None], (S, A, len(elements))).copy()
    mask = np.ones((S, A), bool)
    return MoleculeExamples(
        pos=coords.astype(np.float32),
        one_hot=oh.astype(np.float32),
        mask=mask,
        y=energies.astype(np.float64),
        forces=forces.astype(np.float32),
    )


def synthetic_molecules(
    num: int, seed: int = 0, max_atoms: int = 12, min_atoms: int = 4,
    with_forces: bool = False,
) -> MoleculeExamples:
    """Random molecules with a smooth geometric target: a soft pair potential
    E = sum_ij c_i c_j exp(-r_ij) (and its analytic forces), so models can
    demonstrably learn offline."""
    rng = np.random.default_rng(seed)
    S, A = num, max_atoms
    pos = rng.normal(scale=1.5, size=(S, A, 3)).astype(np.float32)
    n_el = len(QM9_ELEMENTS)
    kinds = rng.integers(0, n_el, size=(S, A))
    counts = rng.integers(min_atoms, A + 1, size=S)
    mask = np.arange(A)[None, :] < counts[:, None]
    oh = np.eye(n_el, dtype=np.float32)[kinds] * mask[..., None]
    coeff = (kinds + 1.0) * mask

    diff = pos[:, :, None, :] - pos[:, None, :, :]
    r = np.linalg.norm(diff, axis=-1)
    np.einsum("sii->si", r)[:] = np.inf
    pair = coeff[:, :, None] * coeff[:, None, :] * np.exp(-r)
    y = 0.5 * pair.sum(axis=(1, 2))

    forces = None
    if with_forces:
        # F_i = -dE/dr_i = sum_j c_i c_j exp(-r_ij) * (r_i - r_j)/r_ij
        with np.errstate(invalid="ignore"):
            f = (pair / r)[..., None] * diff
        forces = np.nan_to_num(f).sum(axis=2).astype(np.float32)
        forces = forces * mask[..., None]
    return MoleculeExamples(
        pos=pos * mask[..., None], one_hot=oh, mask=mask,
        y=y.astype(np.float64), forces=forces,
    )


def dimenet_split(n: int, n_train: int = 110000, n_valid: int = 10000, seed: int = 42):
    """The DimeNet QM9 split convention (the reference QM9 training script),
    scaled down proportionally when the dataset is smaller."""
    rs = np.random.RandomState(seed=seed)
    perm = rs.permutation(np.arange(n))
    if n < n_train + n_valid + 1:
        n_train = int(n * 0.8)
        n_valid = int(n * 0.1)
    return perm[:n_train], perm[n_train : n_train + n_valid], perm[n_train + n_valid :]
