"""Post-processing CLI for generated crystals; counterpart of
``arreau_tpu/cli/process_results.py``.

Loads ``crystals.h5`` (the generate CLI's file; an ``.npz`` of an earlier
version of the port also reads), relaxes every crystal at once with the
soft-sphere relaxation (``inference/relax.py``) on ``--device`` (default
``cuda``; it never falls back to the CPU) and writes
``crystals_relaxed.h5`` beside it (or ``--out_path``); ``--visualize``
renders the first four relaxed crystals to ``relaxed_{i}.png`` beside the
output file (matplotlib and PIL, checked before any work).

    python -m arreau_tpu_torch.cli.process_results --in_path out/crystals.h5
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from arreau_tpu_torch.cli.generate import parse_bool
from arreau_tpu_torch.inference.io import SampleResult, load_sample_results, save_sample_results
from arreau_tpu_torch.inference.relax import relax_soft_sphere


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Relax generated crystals")
    p.add_argument("--in_path", type=str, default="out/crystals.h5")
    p.add_argument("--out_path", type=str, default=None)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--sigma", type=float, default=1.5)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    p.add_argument("--visualize", type=parse_bool, default=False,
                   help="render the first four relaxed crystals (matplotlib, PIL)")
    p.add_argument("--use_mace", type=parse_bool, default=False,
                   help="not ported: needs the mace-torch and ase packages")
    return p.parse_args(argv)


def densify(result: SampleResult) -> tuple[np.ndarray, np.ndarray]:
    """(frac ``[B, A, 3]``, mask ``[B, A]``) with A the largest atom count."""
    B, A = result.num_crystals, int(result.num_atoms.max())
    frac = np.zeros((B, A, 3))
    mask = np.zeros((B, A), bool)
    for i in range(B):
        s, n = int(result.idx_start[i]), int(result.num_atoms[i])
        frac[i, :n] = result.frac_x[s : s + n]
        mask[i, :n] = True
    return frac, mask


def main(argv=None):
    args = parse_args(argv)
    if args.use_mace:
        raise NotImplementedError("--use_mace needs the mace-torch and ase packages, which the "
                                  "port does not carry")
    if args.visualize:
        from arreau_tpu_torch.inference.visualize import require_renderers

        require_renderers()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")

    result = load_sample_results(args.in_path)
    B = result.num_crystals
    frac, mask = densify(result)
    relaxed = relax_soft_sphere(
        torch.as_tensor(frac, dtype=torch.float32, device=device),
        torch.as_tensor(result.lattice, dtype=torch.float32, device=device),
        torch.as_tensor(mask, device=device),
        steps=args.steps,
        lr=args.lr,
        sigma=args.sigma,
    )
    e0 = relaxed.energy_history[:, 0].cpu().numpy()
    e1 = relaxed.energy.cpu().numpy()
    print(f"relaxed {B} crystals: mean energy {e0.mean():.4f} -> {e1.mean():.4f}")

    frac_out = relaxed.frac_x.cpu().numpy().astype(np.float64)
    out = SampleResult(
        frac_x=np.concatenate([frac_out[i][mask[i]] for i in range(B)]),
        atomic_numbers=result.atomic_numbers,
        lattice=result.lattice,
        idx_start=result.idx_start,
        num_atoms=result.num_atoms,
    )
    out_path = args.out_path or os.path.splitext(args.in_path)[0] + "_relaxed.h5"
    save_sample_results(out_path, out)
    print(f"saved {out_path}")

    if args.visualize:
        from arreau_tpu_torch.inference.visualize import plot_crystal

        out_dir = os.path.dirname(os.path.abspath(out_path))
        for i in range(min(B, 4)):
            f, zs, lat = out.crystal(i)
            plot_crystal(f, zs, lat, os.path.join(out_dir, f"relaxed_{i}.png"))
    return out


if __name__ == "__main__":
    main()
