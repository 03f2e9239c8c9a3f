"""VP-prior check of the lattice-length diffusion; counterpart of
``arreau_tpu/exploration/vp_prior_check.py``.

Pushes the dataset's z-scored lattice lengths through the VP forward chain
to t = T-1 and checks that the terminal marginal is N(0, 1), the sampler's
starting distribution (PASS: |mean| < 0.05 and |std - 1| < 0.05); then
decodes prior draws into lattice matrices with the monoclinic Bravais
angle prior (the sampler's start), renders a few and prints their volumes.
The VP math runs on ``--device`` (default ``cuda``). The renders need
matplotlib and PIL; where either does not import they are skipped, and the
tool says so, after the check.

    python -m arreau_tpu_torch.exploration.vp_prior_check [--out_dir out/eda]

Every random number comes from a :class:`VPPriorNoise`: drawn from keys
split off ``PRNGKey(--seed)`` (the JAX tool's own key chain is not followed
yet), or handed to :func:`main`. Any
``--dataset`` but ``synthetic`` reads the Alexandria shards under
``--data_dir``.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import numpy as np
import torch

from arreau_tpu_torch.data.crystal import CrystalDataset, alexandria_shards
from arreau_tpu_torch.data.synthetic import synthetic_packed
from arreau_tpu_torch.diffusion.vp import make_vp_schedule, vp_forward
from arreau_tpu_torch.exploration import open_device
from arreau_tpu_torch.inference.visualize import plot_lattice, require_renderers
from arreau_tpu_torch.kernels import threefry
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.ops.lattice import (
    lattice_from_params,
    matrix_to_params,
    sample_bravais_angles,
)

MARGINAL_TOL = 0.05


@dataclass
class VPPriorNoise:
    """Standard normals of the forward chain ``forward [N, 3]`` and of the
    prior draws ``prior [n, 3]``, and the monoclinic prior's angles ``angles
    [n, 3]`` (radians)."""

    forward: torch.Tensor
    prior: torch.Tensor
    angles: torch.Tensor


def draw_noise(key, num_lattices: int, num_render: int, device) -> VPPriorNoise:
    """The check's draws from the JAX key ``key``, one key split off it for
    each field."""
    k_forward, k_prior, k_angles = prng.split(np.asarray(key, np.uint32), 3)
    return VPPriorNoise(threefry.normal(k_forward, (num_lattices, 3), device),
                        threefry.normal(k_prior, (num_render, 3), device),
                        sample_bravais_angles(k_angles, "monoclinic", num_render, device))


def terminal_marginal(lattices: torch.Tensor, num_timesteps: int, noise: torch.Tensor):
    """(h_T ``[N, 3]``, mean and std of the lengths, abar at T-1): the
    z-scored lattice lengths of ``lattices [N, 3, 3]`` (float32) at
    t = T-1 of the VP forward chain, driven by ``noise [N, 3]``."""
    lengths, _ = matrix_to_params(lattices)
    # the model diffuses per-atom lengths; the check z-scores them so that
    # the terminal marginal's target is N(0, 1)
    mu, sd = lengths.mean(), lengths.std(correction=0)
    h0 = (lengths - mu) / sd
    sched = make_vp_schedule(num_timesteps, device=lattices.device)
    t = torch.full((h0.shape[0],), num_timesteps - 1, dtype=torch.long, device=lattices.device)
    h_T, _ = vp_forward(sched, noise, h0, t)
    return h_T, mu, sd, sched.alpha_bars[num_timesteps - 1]


def decode_prior(noise: VPPriorNoise, mu: torch.Tensor, sd: torch.Tensor) -> torch.Tensor:
    """Prior draws un-z-scored (at least 0.5 angstrom) with the prior's
    angles, as lattice matrices ``[n, 3, 3]``."""
    prior = torch.clamp(noise.prior * sd + mu, min=0.5)
    return lattice_from_params(prior, noise.angles)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", default="out/eda")
    p.add_argument("--num_timesteps", type=int, default=1000)
    p.add_argument("--num_render", type=int, default=30)
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data_dir", default="datasets/alexandria_hdf5")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    return p.parse_args(argv)


def main(argv=None, noise: VPPriorNoise | None = None) -> bool:
    """Returns whether the terminal marginal passed its check."""
    args = parse_args(argv)
    device = open_device(args.device)
    if args.dataset == "synthetic":
        packed = synthetic_packed(2000, seed=args.seed).packed
    else:
        packed = CrystalDataset(alexandria_shards(args.data_dir)).packed
    lattices = torch.as_tensor(packed.lattices, dtype=torch.float32, device=device)
    if noise is None:
        noise = draw_noise(prng.prng_key(args.seed), len(lattices), args.num_render, device)

    h_T, mu, sd, abar_T = terminal_marginal(lattices, args.num_timesteps, noise.forward)
    m, s = float(h_T.mean()), float(h_T.std(correction=0))
    print(f"terminal marginal at t={args.num_timesteps - 1}: "
          f"mean {m:+.4f} (want ~0), std {s:.4f} (want ~1), abar_T {float(abar_T):.2e}")
    ok = abs(m) < MARGINAL_TOL and abs(s - 1) < MARGINAL_TOL
    print("PASS" if ok else "FAIL: terminal marginal far from N(0,1)")

    os.makedirs(args.out_dir, exist_ok=True)
    mats = decode_prior(noise, mu, sd).cpu().numpy()
    try:
        require_renderers()
    except ImportError as e:
        print(f"render skipped: {e}")
    else:
        n = min(args.num_render, 6)
        for i in range(n):
            plot_lattice(mats[i], os.path.join(args.out_dir, f"vp_prior_lattice_{i}.png"))
        print(f"rendered {n} prior lattices under {args.out_dir}")

    vols = np.abs(np.linalg.det(mats.astype(np.float64)))
    print(f"prior-decoded volumes: mean {vols.mean():.1f} A^3, "
          f"range [{vols.min():.1f}, {vols.max():.1f}]")
    return ok


if __name__ == "__main__":
    main()
