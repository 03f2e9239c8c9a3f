"""Crystal renders: 3D views with element colours, the unit-cell
parallelepiped, optional bonds, per-timestep PNGs and their GIF;
counterpart of ``arreau_tpu/inference/visualize.py`` (a copy, numpy,
matplotlib and PIL).

matplotlib (``Agg`` backend) and PIL are imported inside the functions
that use them; :func:`require_renderers` raises an ``ImportError`` naming
the package that is missing, so that a caller can check before any work.
Bonds come from the Voronoi solid-angle heuristic of
``inference/bonds.py``, or, where that fails on a degenerate cell, from
the covalent-radius sum (:func:`predict_bonds`), whose radii the two
modules share.
"""

from __future__ import annotations

import importlib
import os
from enum import Enum
from typing import Optional

import numpy as np

from arreau_tpu_torch.inference.bonds import _COVALENT_RADII, predict_bonds_voronoi


class VisualizationSetting(Enum):
    NONE = 0
    LAST = 1
    ALL = 2  # every 10 timesteps
    ALL_DETAILED = 3  # every timestep


# CPK-ish colours for common elements; fallback grey
_ELEMENT_COLORS = {
    1: "#FFFFFF", 3: "#CC80FF", 6: "#909090", 7: "#3050F8", 8: "#FF0D0D",
    9: "#90E050", 11: "#AB5CF2", 12: "#8AFF00", 13: "#BFA6A6", 14: "#F0C8A0",
    15: "#FF8000", 16: "#FFFF30", 17: "#1FF01F", 19: "#8F40D4", 20: "#3DFF00",
    22: "#BFC2C7", 26: "#E06633", 28: "#50D050", 29: "#C88033", 30: "#7D80B0",
}

_CELL_EDGES = [
    (0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
    (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7),
]


def require_renderers() -> None:
    """Raise an ``ImportError`` naming matplotlib or PIL (the package
    ``pillow``) where either does not import."""
    for module, package in (("matplotlib", "matplotlib"), ("PIL", "pillow")):
        try:
            importlib.import_module(module)
        except ImportError as e:
            raise ImportError(f"rendering crystals needs {package} ({module} does not import: "
                              f"{e})") from e


def _cell_corners(lattice: np.ndarray) -> np.ndarray:
    corners = []
    for i in range(8):
        coeff = np.array([i & 1, (i >> 1) & 1, (i >> 2) & 1], dtype=float)
        corners.append(coeff @ lattice)
    return np.stack(corners)


def predict_bonds(cart: np.ndarray, atomic_numbers: np.ndarray,
                  tolerance: float = 1.2) -> list[tuple[int, int]]:
    """Bond pairs closer than ``tolerance`` times their covalent-radius sum."""
    n = len(cart)
    bonds = []
    for i in range(n):
        for j in range(i + 1, n):
            cutoff = tolerance * (_COVALENT_RADII.get(int(atomic_numbers[i]), 1.4)
                                  + _COVALENT_RADII.get(int(atomic_numbers[j]), 1.4))
            if np.linalg.norm(cart[i] - cart[j]) <= cutoff:
                bonds.append((i, j))
    return bonds


def plot_crystal(frac_x: np.ndarray, atomic_numbers: np.ndarray, lattice: np.ndarray,
                 out_path: str, show_bonds: bool = False, title: Optional[str] = None) -> None:
    """Render one crystal (atoms and unit cell, optional bonds) to a PNG."""
    require_renderers()
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cart = np.asarray(frac_x) @ np.asarray(lattice)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")

    corners = _cell_corners(np.asarray(lattice))
    for a, b in _CELL_EDGES:
        ax.plot(*zip(corners[a], corners[b]), color="0.6", lw=0.8)

    colors = [_ELEMENT_COLORS.get(int(z), "#B0B0B0") for z in atomic_numbers]
    ax.scatter(cart[:, 0], cart[:, 1], cart[:, 2], c=colors, s=180, edgecolors="k",
               linewidths=0.5, depthshade=True)
    if show_bonds:
        try:
            bonds = predict_bonds_voronoi(np.asarray(frac_x), np.asarray(lattice),
                                          np.asarray(atomic_numbers))
        except Exception:  # degenerate cells: the covalent-radius heuristic, as the JAX package
            bonds = predict_bonds(cart, atomic_numbers)
        for i, j in bonds:
            ax.plot(*zip(cart[i], cart[j]), color="0.3", lw=1.5)
    if title:
        ax.set_title(title)
    ax.set_box_aspect((1, 1, 1))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_lattice(lattice: np.ndarray, out_path: str) -> None:
    """Render the unit cell alone."""
    plot_crystal(np.zeros((0, 3)), np.zeros(0, int), lattice, out_path)


def vis_crystal_during_sampling(z_table, atom_type_indices: np.ndarray, lattice: np.ndarray,
                                frac_x: np.ndarray, name: str, show_bonds: bool = False) -> None:
    """Render a sampler snapshot (z-table indices) to ``<name>.png``."""
    zs = z_table.indices_to_zs(np.asarray(atom_type_indices))
    plot_crystal(np.asarray(frac_x), zs, np.asarray(lattice), f"{name}.png", show_bonds)


def generate_gif(image_dir: str, out_path: str, prefix: str = "", duration_ms: int = 120) -> None:
    """Assemble the timestep PNGs under ``image_dir`` (sorted by the integer
    after the last underscore, descending, as the sampler walks) into a GIF."""
    require_renderers()
    from PIL import Image

    files = [f for f in os.listdir(image_dir)
             if f.endswith(".png") and f.startswith(prefix)
             and f.rsplit("_", 1)[-1][:-4].lstrip("-").isdigit()]
    files.sort(key=lambda f: -int(f.rsplit("_", 1)[-1][:-4]))
    if not files:
        raise FileNotFoundError(f"no timestep PNGs under {image_dir}")
    frames = [Image.open(os.path.join(image_dir, f)) for f in files]
    frames[0].save(out_path, save_all=True, append_images=frames[1:], duration=duration_ms,
                   loop=0)
