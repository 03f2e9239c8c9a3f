"""Dataset statistics: the numbers the reference derived its diffusion
constants from (average density, largest system, atom-count histogram,
lattice length and angle ranges); counterpart of
``arreau_tpu/exploration/dataset_stats.py``. Host code (numpy).

    python -m arreau_tpu_torch.exploration.dataset_stats [--data_dir DIR | --synthetic_size 2000]

``--data_dir`` reads every ``*.h5`` shard under it (``data/crystal.py:read_h5``).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from arreau_tpu_torch.data.crystal import CrystalDataset
from arreau_tpu_torch.data.synthetic import synthetic_packed


def compute_stats(packed) -> dict:
    num_atoms = packed.num_atoms
    volumes = np.abs(np.linalg.det(packed.lattices))
    densities = num_atoms / np.maximum(volumes, 1e-12)

    lengths = np.linalg.norm(packed.lattices, axis=-1)
    angles = np.zeros((len(packed), 3))
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        cos = np.sum(packed.lattices[:, j] * packed.lattices[:, k], axis=-1) / (
            lengths[:, j] * lengths[:, k]
        )
        angles[:, i] = np.degrees(np.arccos(np.clip(cos, -1, 1)))

    hist, edges = np.histogram(num_atoms, bins=[1, 2, 4, 8, 16, 32, 64, 128, 257])
    return {
        "num_crystals": len(packed),
        "total_atoms": int(num_atoms.sum()),
        "avg_density": float(densities.mean()),
        "avg_volume": float(volumes.mean()),
        "largest_system": int(num_atoms.max()),
        "mean_atoms": float(num_atoms.mean()),
        "atom_histogram": {f"{edges[i]}-{edges[i+1]-1}": int(hist[i]) for i in range(len(hist))},
        "length_range": (float(lengths.min()), float(lengths.max())),
        "angle_range_deg": (float(angles.min()), float(angles.max())),
        "unique_elements": sorted(int(z) for z in np.unique(packed.atomic_numbers)),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", type=str, default=None)
    ap.add_argument("--synthetic_size", type=int, default=2000)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.data_dir:
        ds = CrystalDataset(sorted(glob.glob(os.path.join(args.data_dir, "*.h5"))))
    else:
        ds = synthetic_packed(args.synthetic_size)
    stats = compute_stats(ds.packed)
    for k, v in stats.items():
        print(f"{k}: {v}")
    return stats


if __name__ == "__main__":
    main()
