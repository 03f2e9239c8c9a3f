"""Lattice EDA: length, angle, volume and density distributions of a crystal
dataset, their histograms and rendered example cells; counterpart of
``arreau_tpu/exploration/lattice_eda.py``.

The lattice parameters are computed on ``--device`` (default ``cuda``), in
float64, the rest on the host. The statistics are printed first; the
figure and the example cells need matplotlib and PIL, and where either does
not import they are skipped and the tool says so.

    python -m arreau_tpu_torch.exploration.lattice_eda [--dataset alexandria] [--out_dir out/eda]

Any ``--dataset`` but ``synthetic`` reads the Alexandria shards under
``--data_dir``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from arreau_tpu_torch.data.crystal import CrystalDataset, alexandria_shards
from arreau_tpu_torch.data.synthetic import synthetic_packed
from arreau_tpu_torch.exploration import open_device
from arreau_tpu_torch.inference.visualize import plot_lattice, require_renderers
from arreau_tpu_torch.ops.lattice import matrix_to_params


def lattice_stats(lattices: np.ndarray, offsets: np.ndarray, device) -> dict:
    """{name: per-crystal values}: the three lengths (angstrom) and angles
    (radians, as ``matrix_to_params`` gives them and the JAX tool prints
    them), the volume (A^3), the density (atoms / A^3) and the atom count."""
    lengths, angles = (a.cpu().numpy() for a in matrix_to_params(
        torch.as_tensor(lattices, dtype=torch.float64, device=device)))
    volumes = np.abs(np.linalg.det(lattices))
    natoms = np.diff(offsets)
    return {"length_a": lengths[:, 0], "length_b": lengths[:, 1], "length_c": lengths[:, 2],
            "alpha": angles[:, 0], "beta": angles[:, 1], "gamma": angles[:, 2],
            "volume": volumes, "density": natoms / volumes, "natoms": natoms}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data_dir", default="datasets/alexandria_hdf5")
    p.add_argument("--out_dir", default="out/eda")
    p.add_argument("--num_render", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns :func:`lattice_stats` of the dataset."""
    args = parse_args(argv)
    device = open_device(args.device)
    if args.dataset == "synthetic":
        packed = synthetic_packed(2000, seed=args.seed).packed
    else:
        packed = CrystalDataset(alexandria_shards(args.data_dir)).packed
    lat = np.asarray(packed.lattices)
    stats = lattice_stats(lat, packed.offsets, device)
    natoms, density = stats["natoms"], stats["density"]

    print(f"{len(lat)} crystals, {natoms.sum()} atoms "
          f"(atoms/crystal {natoms.mean():.1f}, max {natoms.max()})")
    for name in ("length_a", "length_b", "length_c", "alpha", "beta", "gamma", "volume",
                 "density"):  # density: atoms / A^3; the reference's average is 0.0554 on Alexandria
        x = stats[name]
        q = np.percentile(x, [1, 50, 99])
        print(f"{name:<10s} mean {x.mean():8.3f}  std {x.std():7.3f}  "
              f"p1 {q[0]:8.3f}  median {q[1]:8.3f}  p99 {q[2]:8.3f}")

    os.makedirs(args.out_dir, exist_ok=True)
    try:
        require_renderers()
    except ImportError as e:
        print(f"plots skipped: {e}")
        return stats
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lengths = np.stack([stats["length_a"], stats["length_b"], stats["length_c"]], -1)
    angles = np.stack([stats["alpha"], stats["beta"], stats["gamma"]], -1)
    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    axes[0, 0].hist(lengths.ravel(), bins=60)
    axes[0, 0].set_title("lattice lengths (A)")
    axes[0, 1].hist(angles.ravel(), bins=60)
    axes[0, 1].set_title("lattice angles (rad)")
    axes[1, 0].hist(natoms, bins=np.arange(natoms.min(), natoms.max() + 2))
    axes[1, 0].set_title("atoms per crystal")
    axes[1, 1].hist(density, bins=60)
    axes[1, 1].set_title("density (atoms/A^3)")
    fig.tight_layout()
    out = os.path.join(args.out_dir, "lattice_eda.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(f"wrote {out}")

    rng = np.random.default_rng(args.seed)
    for i, j in enumerate(rng.choice(len(lat), size=min(args.num_render, len(lat)),
                                     replace=False)):
        plot_lattice(lat[j], os.path.join(args.out_dir, f"example_cell_{i}.png"))
    print(f"rendered {args.num_render} example cells under {args.out_dir}")
    return stats


if __name__ == "__main__":
    main()
