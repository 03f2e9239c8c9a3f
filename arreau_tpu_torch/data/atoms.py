"""Atomic number table: ordered set of observed Zs plus the absorbing MASK
class, with index<->Z<->symbol converters (numpy only).

Counterpart of ``arreau_tpu/data/atoms.py`` and of the z-table helpers of
``arreau_tpu/data/synthetic.py``; a copy, so the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

MASK_ATOMIC_NUMBER = 2001

# fmt: off
ELEMENT_SYMBOLS = [
    "X",  # placeholder for Z=0
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]
# fmt: on
_SYMBOL_TO_Z = {s: z for z, s in enumerate(ELEMENT_SYMBOLS)}

# H Li C N O Al Si Fe: the synthetic training distribution's elements
DEFAULT_ZS = [1, 3, 6, 7, 8, 13, 14, 26]


def symbol_to_z(symbol: str) -> int:
    return _SYMBOL_TO_Z[symbol]


def z_to_symbol(z: int) -> str:
    if z == MASK_ATOMIC_NUMBER:
        return "MASK"
    return ELEMENT_SYMBOLS[z]


class AtomicNumberTable:
    """Sorted atomic numbers (MASK last by value 2001) with O(1) converters."""

    def __init__(self, zs: Sequence[int]):
        self.zs = list(zs)
        self._z_to_index = {z: i for i, z in enumerate(self.zs)}

    def __len__(self) -> int:
        return len(self.zs)

    def __repr__(self) -> str:
        return f"AtomicNumberTable({tuple(self.zs)})"

    def z_to_index(self, z: int) -> int:
        return self._z_to_index[z]

    @property
    def mask_index(self) -> int:
        return self._z_to_index[MASK_ATOMIC_NUMBER]

    def zs_to_indices(self, atomic_numbers: np.ndarray) -> np.ndarray:
        lut = np.full(max(self.zs) + 1, -1, dtype=np.int64)
        for i, z in enumerate(self.zs):
            lut[z] = i
        out = lut[np.asarray(atomic_numbers, dtype=np.int64)]
        if (out < 0).any():
            bad = np.asarray(atomic_numbers)[out < 0]
            raise KeyError(f"atomic numbers not in table: {np.unique(bad)}")
        return out

    def indices_to_zs(self, indices: np.ndarray) -> np.ndarray:
        return np.asarray(self.zs, dtype=np.int64)[np.asarray(indices, dtype=np.int64)]

    def symbols_to_indices(self, symbols: Iterable[str]) -> np.ndarray:
        return np.asarray([self.z_to_index(symbol_to_z(s)) for s in symbols])


def table_from_zs(*z_sets: Iterable[int]) -> AtomicNumberTable:
    """Union of observed Zs + MASK, sorted."""
    union: set[int] = set()
    for zs in z_sets:
        union.update(int(z) for z in zs)
    union.add(MASK_ATOMIC_NUMBER)
    return AtomicNumberTable(sorted(union))


def synthetic_z_table(zs=None) -> AtomicNumberTable:
    return table_from_zs(zs if zs is not None else DEFAULT_ZS)
