"""Charged-particle N-body simulator and dataset; counterpart of
``arreau_tpu/data/nbody.py`` (Coulomb pair forces, leapfrog with dt 1e-3,
forces clamped at +-0.1/dt, initial speeds normalised, the reference's
saved-frame semantics and its npz schema).

A simulation is a draw of its initial state (:func:`draw_charged`) and a
deterministic integration of every trajectory at once on the tensors'
device (:func:`integrate_charged`): the initial half kick, then per step a
move and a kick, each sampled frame recording the position and the
velocity before that step's kick. The initial states are JAX's draws from
JAX's keys (``PRNGKey(seed)``, one split a data split), through the
threefry kernel on the card (``kernels/threefry.py``): the charges equal
JAX's, the positions and velocities within 3 ulp. The integration is the
same function in float32, but it sums the forces in another order than
XLA's, and over the thousands of leapfrog steps before the saved frames a
few charged systems come close enough for that rounding to grow: their
frames part from JAX's (PERF.md, the chaos finding).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from arreau_tpu_torch.kernels import threefry
from arreau_tpu_torch.ops import prng

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


def draw_charged(key, num_sims: int, n_balls: int = 5, loc_std: float = 1.0,
                 vel_norm: float = 0.5, device="cpu"):
    """Initial states (loc, vel ``[S, n, 3]``, charges ``[S, n]``, float32)
    on ``device``, as the JAX package's ``simulate_charged`` draws them from
    the JAX key ``key`` (uint32 ``[2]``): ``k_q, k_loc, k_vel = split(key,
    3)``; charges +1 where ``bernoulli(k_q, 0.5)``, else -1; positions
    ``normal(k_loc)`` times ``loc_std (n/5)^(1/3)``; velocities
    ``normal(k_vel)`` scaled to speed ``vel_norm``."""
    loc_std = loc_std * (float(n_balls) / 5.0) ** (1.0 / 3.0)
    k_q, k_loc, k_vel = prng.split(np.asarray(key, np.uint32), 3)
    charges = torch.where(threefry.bernoulli(k_q, 0.5, (num_sims, n_balls), device), 1.0, -1.0)
    loc = threefry.normal(k_loc, (num_sims, n_balls, 3), device) * loc_std
    vel = threefry.normal(k_vel, (num_sims, n_balls, 3), device)
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


def simulate_charged(key, num_sims: int, n_balls: int = 5, T: int = 5000,
                     sample_freq: int = 100, loc_std: float = 1.0, vel_norm: float = 0.5,
                     interaction_strength: float = 1.0, device="cpu"):
    """:func:`draw_charged` from the JAX key ``key`` on ``device``, then
    :func:`integrate_charged`, as numpy arrays."""
    loc, vel, charges = draw_charged(key, num_sims, n_balls, loc_std, vel_norm, device)
    out = integrate_charged(loc, vel, charges, T, sample_freq, interaction_strength)
    return tuple(t.cpu().numpy() for t in out)


def generate_nbody_npz(out_dir: str, num_train: int = 10000, num_valid: int = 2000,
                       num_test: int = 2000, n_balls: int = 5, T: int = 5000,
                       sample_freq: int = 100, seed: int = 43, suffix: str = SUFFIX,
                       device="cpu") -> None:
    """Write the reference npz schema (``loc_``/``vel_``/``edges_``/``charges_``
    per split; frames second, the coordinate axis before the particles),
    simulated on ``device`` from JAX's keys: ``key = PRNGKey(seed)``, then
    ``key, sub = split(key)`` a split (train, valid, test), each simulated
    from its ``sub``."""
    os.makedirs(out_dir, exist_ok=True)
    key = prng.prng_key(seed)
    for split, num in (("train", num_train), ("valid", num_valid), ("test", num_test)):
        key, sub = prng.split(key)
        loc, vel, edges, charges = simulate_charged(sub, num, n_balls, T, sample_freq,
                                                    device=device)
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
