"""Equivariance check: counterpart of
``arreau_tpu/exploration/verify_equivariance.py`` (the reference's
``eval-equivariance`` mode).

Train on one crystal and validate on the same crystal rotated 90 degrees
about z, at one pinned diffusion timestep for both: an SE(3)-equivariant
model gives the two the same loss. Then :func:`compare_components`
evaluates one checkpoint on the crystal and on its rotation, each loss
term averaged over the same ``n_noise`` noise draws. Everything computes on
``--device`` (default ``cuda``): on the card the training steps run kernels
#3, #8, #4 and #7, the comparison #3 and #8.

    python -m arreau_tpu_torch.exploration.verify_equivariance

The crystal is the first of the Alexandria take-10 shard
(``<data_dir>/alexandria_ps_000_take10.h5``) where it exists, else the
synthetic one the JAX tool takes.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

from arreau_tpu_torch.cli import generate
from arreau_tpu_torch.cli.train_diffusion import EVAL_EQUIVARIANCE_TIMESTEP
from arreau_tpu_torch.cli.train_diffusion import main as train_main
from arreau_tpu_torch.data.crystal import (
    CrystalDataset,
    PackedCrystals,
    pack_dense_batch,
    read_h5,
)
from arreau_tpu_torch.data.synthetic import synthetic_packed
from arreau_tpu_torch.exploration import open_device
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.tasks.diffusion import LossNoise, batch_to_device, draw_loss_noise

COMPONENTS = ("loss_coord", "loss_type", "loss_lattice", "loss_angle", "loss")
CKPT_DIR = "out/eval-equivariance-ckpt"


def _rotate_packed(packed: PackedCrystals, angle_deg: float = 90.0) -> PackedCrystals:
    """The crystals turned by ``angle_deg`` about z: the lattice rows rotate,
    the fractional coordinates (relative to them) stay."""
    theta = np.deg2rad(angle_deg)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return PackedCrystals(
        atomic_numbers=packed.atomic_numbers.copy(),
        frac_coords=packed.frac_coords.copy(),
        offsets=packed.offsets.copy(),
        lattices=packed.lattices @ rot.T,
    )


def build_equivariance_datasets(data_dir: str):
    """(dataset, splits, z-table, pinned timestep): crystal 0 is the
    original (train), crystal 1 its rotation (valid and test)."""
    take10 = os.path.join(data_dir, "alexandria_ps_000_take10.h5")
    if os.path.exists(take10):
        base = read_h5(take10)
        end = base.offsets[1]
        one = PackedCrystals(base.atomic_numbers[:end], base.frac_coords[:end],
                             base.offsets[:2], base.lattices[:1])
    else:
        one = synthetic_packed(1, seed=0, max_atoms=8, min_atoms=6).packed
    ds = CrystalDataset.from_packed(one.concat(_rotate_packed(one)))
    splits = {"train": np.array([0]), "valid": np.array([1]), "test": np.array([1])}
    return ds, splits, ds.z_table, EVAL_EQUIVARIANCE_TIMESTEP


def component_draws(model, batch, noises: list[LossNoise]) -> dict[str, torch.Tensor]:
    """Every loss term of ``model`` on ``batch`` under each noise draw:
    {term: ``[len(noises)]``} on the model's device."""
    with torch.no_grad():
        draws = [model.loss(batch, noise)[1] for noise in noises]
    return {k: torch.stack([m[k] for m in draws]) for k in draws[0]}


def compare_components(ckpt_dir: str, data_dir: str = "datasets/alexandria_hdf5",
                       timestep: int | None = None, n_noise: int = 64, device="cuda",
                       noises: list[LossNoise] | None = None):
    """(original, rotated): each loss term of ``ckpt_dir``'s ``best`` raw
    weights on the crystal and on its rotation at the pinned timestep,
    averaged over the same ``n_noise`` draws (``noises``, or drawn from
    keys split off ``PRNGKey(0)``, one a draw; the JAX tool's own key chain
    is not followed yet). The coordinate term is the one a rotation
    can change (the type loss cannot see it; the lattice head reads
    rotation-invariant lengths), so it carries the evidence. Prints the
    per-term table with the relative gaps."""
    timestep = EVAL_EQUIVARIANCE_TIMESTEP if timestep is None else timestep
    device = torch.device(device)
    model, _, _ = generate.load_model(ckpt_dir, "best", False, device)
    cfg = model.config
    # the pair is packed with its own z-table, not the checkpoint's: a copy
    # of the JAX tool, whose type indices are relabelled against a checkpoint
    # trained on another table (ROADMAP Queue C, "Copied quirk")
    ds, _, _, _ = build_equivariance_datasets(data_dir)
    max_atoms = int(ds.packed.num_atoms.max())
    if noises is None:
        noises = [draw_loss_noise(k, 1, max_atoms, cfg.num_atomic_states,
                                  cfg.num_timesteps, cfg.diffuse_angles, device, timestep)
                  for k in prng.split(prng.prng_key(0), n_noise)]
    n_noise = len(noises)

    def components(idx):
        batch = batch_to_device(pack_dense_batch(ds, np.array([idx]), max_atoms), device)
        return {k: float(v.mean()) for k, v in component_draws(model, batch, noises).items()}

    orig, rot = components(0), components(1)
    print(f"\nper-component equivariance check (timestep {timestep}, "
          f"{n_noise} shared noise draws):")
    print(f"{'component':<14s}{'original':>12s}{'rotated':>12s}{'rel gap':>10s}")
    for comp in COMPONENTS:
        a, b = orig.get(comp), rot.get(comp)
        if a is None:
            continue
        gap = abs(a - b) / max(abs(a), 1e-9)
        marker = "  <- rotation-sensitive term" if comp == "loss_coord" else ""
        print(f"{comp:<14s}{a:>12.4f}{b:>12.4f}{gap:>9.2%}{marker}")
    return orig, rot


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="train on one crystal, validate on its rotation")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    return p.parse_args(argv)


def main(argv=None):
    """The JAX tool's short training run (its train and valid losses track
    each other if and only if the model is equivariant), then the
    per-component comparison on its best checkpoint."""
    args = parse_args(argv)
    open_device(args.device)
    # a fresh run every time: an old scoreboard would outrank the new scores
    # and leave no best tag
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    train_main([
        "--dataset", "eval-equivariance",
        "--epochs", "40",
        "--val_interval", "10",
        "--num_timesteps", "300",
        "--batch_size", "4",
        "--hidden_dim", "32",
        "--basis_dim", "32",
        "--layers", "2",
        "--num_ori", "8",
        "--log", "False",
        "--checkpoint_dir", CKPT_DIR,
        "--device", args.device,
    ])
    return compare_components(CKPT_DIR, device=args.device)


if __name__ == "__main__":
    main()
