"""Voronoi solid-angle bond prediction under periodic boundary conditions;
counterpart of ``arreau_tpu/inference/bonds.py`` (a copy, numpy and scipy).

The core CrystalNN signal, Voronoi facet SOLID ANGLES as neighbor weights
(O'Keeffe coordination), computed with scipy's Voronoi tessellation over a
3x3x3 supercell.

For each atom, every Voronoi facet shared with another atom contributes a
candidate bond weighted by the solid angle the facet subtends from the atom
(Van Oosterom-Strackee), normalized by the largest facet weight; candidates
above ``weight_tol`` and inside ``distance_factor x`` covalent-radius-sum
are bonds. Host-side numpy/scipy.
"""

from __future__ import annotations

import numpy as np

# covalent radii (angstrom) of ``arreau_tpu/inference/visualize.py``, for the bonds
# and the renders (``inference/visualize.py``); fallback 1.4
_COVALENT_RADII = {
    1: 0.31, 3: 1.28, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 11: 1.66, 12: 1.41,
    13: 1.21, 14: 1.11, 15: 1.07, 16: 1.05, 17: 1.02, 19: 2.03, 20: 1.76,
    22: 1.60, 26: 1.32, 28: 1.24, 29: 1.32, 30: 1.22,
}

_OFFSETS = np.array(
    [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=np.float64,
)


def _solid_angle(center: np.ndarray, verts: np.ndarray) -> float:
    """Solid angle subtended at ``center`` by the polygon ``verts`` (fan
    triangulation, Van Oosterom-Strackee per triangle)."""
    v = verts - center
    total = 0.0
    for i in range(1, len(v) - 1):
        a, b, c = v[0], v[i], v[i + 1]
        na, nb, nc = (np.linalg.norm(x) for x in (a, b, c))
        num = abs(np.dot(a, np.cross(b, c)))
        den = (
            na * nb * nc
            + np.dot(a, b) * nc
            + np.dot(a, c) * nb
            + np.dot(b, c) * na
        )
        total += 2.0 * abs(np.arctan2(num, den))
    return total


def predict_bonds_voronoi(
    frac: np.ndarray,
    lattice: np.ndarray,
    atomic_numbers: np.ndarray | None = None,
    weight_tol: float = 0.3,
    distance_factor: float = 1.6,
) -> list[tuple[int, int]]:
    """Bond pairs ``(i, j)``, i < j, by PBC Voronoi solid-angle weights.

    frac: ``[N, 3]`` fractional coordinates; lattice ``[3, 3]`` row-vector
    cell. ``weight_tol``: keep neighbors whose normalized solid-angle weight
    exceeds this fraction of the atom's largest facet. ``distance_factor``:
    reject facet neighbors beyond this multiple of the covalent-radius sum
    (CrystalNN's distance cutoffs, simplified); pass ``atomic_numbers=None``
    to skip the distance screen.

    Semantics notes: bonds are UNIQUE base-cell pairs — an atom bonded to
    several periodic images of the same neighbor counts once, so per-atom
    degrees undercount coordination in cells only 1-2 atoms wide (a 2x2x2
    simple-cubic grid reads degree 3, not 6); self-image facets (i == j)
    are never emitted as bonds but DO participate in the per-atom weight
    normalization — they are part of the coordination environment.
    """
    from scipy.spatial import Voronoi

    frac = np.asarray(frac, np.float64) % 1.0
    lattice = np.asarray(lattice, np.float64)
    n = len(frac)
    if n == 0:
        return []

    # 3x3x3 supercell; image m of atom i lives at index m*n + i
    frac_images = (frac[None, :, :] + _OFFSETS[:, None, :]).reshape(-1, 3)
    cart = frac_images @ lattice
    center_base = 13 * n  # offset (0,0,0) block

    if n == 1:
        # Voronoi of a pure lattice: bond only if the cell is tiny (self
        # bonds across images are not representable in the bond list)
        return []

    vor = Voronoi(cart)

    weights: dict[tuple[int, int], float] = {}
    for (p, q), ridge in zip(vor.ridge_points, vor.ridge_vertices):
        # only ridges involving a central-cell atom
        for a, b in ((p, q), (q, p)):
            if center_base <= a < center_base + n:
                i = a - center_base
                j = b % n
                if -1 in ridge:
                    continue  # unbounded facet (outer supercell boundary)
                verts = vor.vertices[ridge]
                w = _solid_angle(cart[a], verts)
                key = (i, j) if i <= j else (j, i)
                # keep the strongest facet per pair (images may repeat)
                weights[key] = max(weights.get(key, 0.0), w)

    bonds = []
    # normalize per atom: collect each atom's max weight
    max_w = np.zeros(n)
    for (i, j), w in weights.items():
        max_w[i] = max(max_w[i], w)
        max_w[j] = max(max_w[j], w)
    # minimum-image distances for the distance screen
    for (i, j), w in sorted(weights.items()):
        if i == j:
            continue
        denom = max(max_w[i], max_w[j], 1e-12)
        if w / denom < weight_tol:
            continue
        if atomic_numbers is not None:
            d_frac = frac[j] - frac[i]
            d_frac -= np.round(d_frac)
            d = float(np.linalg.norm(d_frac @ lattice))
            cutoff = distance_factor * (
                _COVALENT_RADII.get(int(atomic_numbers[i]), 1.4)
                + _COVALENT_RADII.get(int(atomic_numbers[j]), 1.4)
            )
            if d > cutoff:
                continue
        bonds.append((i, j))
    return bonds
