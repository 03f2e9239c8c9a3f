"""Charged-particle N-body simulator and dataset; counterpart of
``arreau_tpu/data/nbody.py`` (Coulomb pair forces, leapfrog with dt 1e-3,
forces clamped at +-0.1/dt, initial speeds normalised, the reference's
saved-frame semantics and its npz schema).

A simulation is a draw of its initial state (:func:`draw_charged`) and a
deterministic integration of every trajectory at once on the tensors'
device (:func:`integrate_charged`): the initial half kick, then per step a
move and a kick, each sampled frame recording the position and the
velocity before that step's kick. JAX's threefry draws cannot be
reproduced, so the port's datasets are its own draw of the same
distribution; the integrator is the same function.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

DT = 1e-3
MAX_F = 0.1 / DT
SUFFIX = "_charged5_initvel1small"
FRAME_PAIRS = {"nbody": (6, 8), "nbody_small": (30, 40), "nbody_small_out_dist": (20, 30)}


class NBodyExamples(NamedTuple):
    """Dense layout of a split: the frame-pair positions, velocity and charges."""

    loc0: np.ndarray  # [S, n, 3] position at frame_0
    vel0: np.ndarray  # [S, n, 3] velocity at frame_0
    charges: np.ndarray  # [S, n]
    loc_end: np.ndarray  # [S, n, 3] position at frame_T

    def __len__(self):
        return len(self.loc0)


def pair_forces(loc: torch.Tensor, coupling: torch.Tensor) -> torch.Tensor:
    """Coulomb force on each particle, ``sum_j coupling[i,j] (r_i - r_j) /
    |r_ij|^3``, clamped elementwise at +-MAX_F; ``loc [S, n, 3]``."""
    diff = loc[..., :, None, :] - loc[..., None, :, :]  # [S, i, j, 3]
    dist_sqr = torch.sum(diff**2, dim=-1)
    eye = torch.eye(loc.shape[-2], dtype=torch.bool, device=loc.device)
    inv = torch.where(eye, 0.0, dist_sqr ** (-1.5))
    force = torch.sum((coupling * inv)[..., None] * diff, dim=-2)
    return torch.clamp(force, -MAX_F, MAX_F)


def draw_charged(generator: torch.Generator, num_sims: int, n_balls: int = 5,
                 loc_std: float = 1.0, vel_norm: float = 0.5, dtype=torch.float32):
    """Initial states (loc, vel ``[S, n, 3]``, charges ``[S, n]``) on the
    generator's device: charges +-1 with probability 1/2, normal positions
    times ``loc_std (n/5)^(1/3)``, normal velocities scaled to speed
    ``vel_norm``."""
    dev = generator.device
    loc_std = loc_std * (float(n_balls) / 5.0) ** (1.0 / 3.0)
    charges = torch.where(torch.rand((num_sims, n_balls), generator=generator, device=dev) < 0.5,
                          1.0, -1.0).to(dtype)
    loc = torch.randn((num_sims, n_balls, 3), generator=generator, dtype=dtype,
                      device=dev) * loc_std
    vel = torch.randn((num_sims, n_balls, 3), generator=generator, dtype=dtype, device=dev)
    vel = vel * vel_norm / torch.linalg.norm(vel, dim=-1, keepdim=True)
    return loc, vel, charges


@torch.no_grad()
def integrate_charged(loc: torch.Tensor, vel: torch.Tensor, charges: torch.Tensor,
                      T: int = 5000, sample_freq: int = 100,
                      interaction_strength: float = 1.0):
    """Integrate ``[S, n, 3]`` initial states for ``T`` steps; returns (loc,
    vel ``[S, T // sample_freq - 1, n, 3]``, edges ``[S, n, n]`` (the
    coupling), charges), one frame at the end of every ``sample_freq``
    steps, its velocity before that step's kick."""
    coupling = interaction_strength * charges[:, :, None] * charges[:, None, :]
    vel = vel + DT * pair_forces(loc, coupling)  # initial half kick
    locs, vels = [], []
    for _ in range(T // sample_freq - 1):
        for _ in range(sample_freq):
            loc = loc + DT * vel
            force = pair_forces(loc, coupling)
            vel = vel + DT * force
        locs.append(loc)
        vels.append(vel - DT * force)
    return torch.stack(locs, dim=1), torch.stack(vels, dim=1), coupling, charges


def simulate_charged(generator: torch.Generator, num_sims: int, n_balls: int = 5,
                     T: int = 5000, sample_freq: int = 100, loc_std: float = 1.0,
                     vel_norm: float = 0.5, interaction_strength: float = 1.0):
    """:func:`draw_charged` then :func:`integrate_charged`, as numpy arrays."""
    loc, vel, charges = draw_charged(generator, num_sims, n_balls, loc_std, vel_norm)
    out = integrate_charged(loc, vel, charges, T, sample_freq, interaction_strength)
    return tuple(t.cpu().numpy() for t in out)


def generate_nbody_npz(out_dir: str, num_train: int = 10000, num_valid: int = 2000,
                       num_test: int = 2000, n_balls: int = 5, T: int = 5000,
                       sample_freq: int = 100, seed: int = 43, suffix: str = SUFFIX,
                       device="cpu") -> None:
    """Write the reference npz schema (``loc_``/``vel_``/``edges_``/``charges_``
    per split; frames second, the coordinate axis before the particles),
    simulated on ``device`` from one generator seeded ``seed``."""
    os.makedirs(out_dir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(seed)
    for split, num in (("train", num_train), ("valid", num_valid), ("test", num_test)):
        loc, vel, edges, charges = simulate_charged(generator, num, n_balls, T, sample_freq)
        np.save(os.path.join(out_dir, f"loc_{split}{suffix}.npy"), loc.transpose(0, 1, 3, 2))
        np.save(os.path.join(out_dir, f"vel_{split}{suffix}.npy"), vel.transpose(0, 1, 3, 2))
        np.save(os.path.join(out_dir, f"edges_{split}{suffix}.npy"), edges)
        np.save(os.path.join(out_dir, f"charges_{split}{suffix}.npy"), charges[..., None])
        print(f"nbody {split}: {num} sims -> {out_dir}")


def load_nbody_split(data_dir: str, split: str, dataset_name: str = "nbody_small",
                     max_samples: Optional[int] = None, suffix: str = SUFFIX) -> NBodyExamples:
    """A split of the npz files in the dense task layout (``val`` reads ``valid``)."""
    name = "valid" if split == "val" else split
    loc = np.load(os.path.join(data_dir, f"loc_{name}{suffix}.npy"))
    vel = np.load(os.path.join(data_dir, f"vel_{name}{suffix}.npy"))
    charges = np.load(os.path.join(data_dir, f"charges_{name}{suffix}.npy"))
    if max_samples is not None:
        loc, vel, charges = loc[:max_samples], vel[:max_samples], charges[:max_samples]
    f0, fT = FRAME_PAIRS[dataset_name]
    return NBodyExamples(
        loc0=loc[:, f0].transpose(0, 2, 1),
        vel0=vel[:, f0].transpose(0, 2, 1),
        charges=charges[..., 0],
        loc_end=loc[:, fT].transpose(0, 2, 1),
    )


def load_or_generate(data_dir: str, split: str, num_train: int = 3000, seed: int = 43,
                     device="cpu", **kw) -> NBodyExamples:
    """Load the split, simulating the dataset on ``device`` first if it is
    absent (valid and test 1/5 of ``num_train`` each, at least 100)."""
    suffix = kw.get("suffix", SUFFIX)
    if not os.path.exists(os.path.join(data_dir, f"loc_train{suffix}.npy")):
        generate_nbody_npz(data_dir, num_train=num_train, num_valid=max(num_train // 5, 100),
                           num_test=max(num_train // 5, 100), seed=seed, device=device)
    return load_nbody_split(data_dir, split, **kw)
