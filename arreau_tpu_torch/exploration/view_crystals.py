"""Crystal viewers: render dataset samples or generated crystals to PNGs;
counterpart of ``arreau_tpu/exploration/view_crystals.py``. Host code: it
launches nothing on a card. The renders need matplotlib and PIL, checked
before any work (``inference/visualize.py:require_renderers``).

    python -m arreau_tpu_torch.exploration.view_crystals dataset [--dataset synthetic] \\
        [--data_dir datasets/alexandria_hdf5] [--num 50] [--out_dir out/alexandria_vis]
    python -m arreau_tpu_torch.exploration.view_crystals generated \\
        [--crystal_file out/crystals.h5] [--index 0] [--shift 0.3 0.6 0.2]

``dataset --dataset alexandria`` (the default) renders from the first
``--max_shards`` ``*.h5`` shards under ``--data_dir``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from arreau_tpu_torch.data.crystal import CrystalDataset
from arreau_tpu_torch.data.synthetic import synthetic_packed
from arreau_tpu_torch.inference.io import load_sample_results
from arreau_tpu_torch.inference.visualize import plot_crystal, require_renderers


def view_dataset(args) -> int:
    if args.dataset == "synthetic":
        packed = synthetic_packed(max(args.num, 64), seed=args.seed).packed
    else:
        paths = sorted(glob.glob(os.path.join(args.data_dir, "*.h5")))
        if not paths:
            raise SystemExit(f"no HDF5 shards under {args.data_dir}")
        packed = CrystalDataset(paths[: args.max_shards]).packed
    n = min(args.num, len(packed))
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(n):
        s, e = int(packed.offsets[i]), int(packed.offsets[i + 1])
        plot_crystal(
            packed.frac_coords[s:e],
            packed.atomic_numbers[s:e],
            packed.lattices[i],
            os.path.join(args.out_dir, f"{i}.png"),
            show_bonds=args.show_bonds,
            title=f"sample {i} ({e - s} atoms)",
        )
        print(f"sample {i} -> {args.out_dir}/{i}.png")
    return n


def view_generated(args) -> int:
    result = load_sample_results(args.crystal_file)
    indices = args.index if args.index else [0]
    os.makedirs(args.out_dir, exist_ok=True)
    for i in indices:
        frac_x, zs, lattice = result.crystal(i)
        frac_x = (frac_x + np.asarray(args.shift)) % 1.0  # optional recentring shift
        out = os.path.join(args.out_dir, f"generated_{i}.png")
        plot_crystal(frac_x, zs, lattice, out, show_bonds=args.show_bonds,
                     title=f"generated {i} ({len(zs)} atoms)")
        print(f"crystal {i}/{result.num_crystals} -> {out}")
    return len(indices)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="mode", required=True)

    d = sub.add_parser("dataset", help="render the first N dataset samples")
    d.add_argument("--dataset", default="alexandria", choices=["alexandria", "synthetic"])
    d.add_argument("--data_dir", default="datasets/alexandria_hdf5")
    d.add_argument("--max_shards", type=int, default=1)
    d.add_argument("--num", type=int, default=50)
    d.add_argument("--out_dir", default="out/alexandria_vis")
    d.add_argument("--show_bonds", action="store_true")
    d.add_argument("--seed", type=int, default=0)
    d.set_defaults(fn=view_dataset)

    g = sub.add_parser("generated", help="render crystals from the sampler's crystals.h5")
    g.add_argument("--crystal_file", default="out/crystals.h5")
    g.add_argument("--index", type=int, nargs="*", default=[0])
    g.add_argument("--shift", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    g.add_argument("--out_dir", default="out/crystal_vis")
    g.add_argument("--show_bonds", action="store_true")
    g.set_defaults(fn=view_generated)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    require_renderers()  # before any work: the card's machine has neither package
    return args.fn(args)


if __name__ == "__main__":
    main()
