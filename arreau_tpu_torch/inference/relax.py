"""Structure relaxation of generated crystals; counterpart of
``arreau_tpu/inference/relax.py``.

- :func:`relax_soft_sphere`: gradient descent on the fractional coordinates
  (lattice fixed) under a smooth soft-sphere pair potential over the 27
  min-image offsets, every crystal of the batch at once, on the tensors'
  device. The JAX package's ``fori_loop`` is a plain loop here, its
  ``jax.grad`` ``torch.autograd.grad``.
- :func:`relax_with_mace`: the MACE force field with ASE's BFGS on each
  crystal, as the JAX package wrote it; it runs where the ``mace-torch``
  and ``ase`` packages import, and raises ``ImportError`` (the JAX
  package's message) where they do not.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from arreau_tpu_torch.ops.lattice import frac_to_cart
from arreau_tpu_torch.ops.pbc import SUPERCELLS


class RelaxResult(NamedTuple):
    frac_x: torch.Tensor  # [B, A, 3]
    energy: torch.Tensor  # [B] final potential energy
    energy_history: torch.Tensor  # [B, steps]


def _soft_sphere_energy(frac, lattice, mask, sigma=1.5, epsilon=1.0):
    """E = sum_pairs eps * (1 - r/sigma)^2 for r < sigma over min-image
    pairs, halved (each pair is seen from both atoms); ``[B]``."""
    cart = frac_to_cart(frac % 1.0, lattice)
    supercells = torch.as_tensor(SUPERCELLS, dtype=frac.dtype, device=frac.device)
    offsets = torch.einsum("ci,bij->bcj", supercells, lattice)
    # [B, i, j, 27, 3]
    diff = cart[:, :, None, None, :] - (cart[:, None, :, None, :] + offsets[:, None, None, :, :])
    dist = torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-12)
    pair_mask = mask[:, :, None, None] & mask[:, None, :, None]
    A = frac.shape[1]
    eye = torch.eye(A, dtype=torch.bool, device=frac.device)[None, :, :, None]
    centre = torch.zeros(27, dtype=torch.bool, device=frac.device)
    centre[13] = True
    pair_mask = pair_mask & ~(eye & centre[None, None, None, :])  # drop the self-image term only
    overlap = torch.clamp(1.0 - dist / sigma, min=0.0)
    return 0.5 * epsilon * torch.where(pair_mask, overlap**2, 0.0).sum(dim=(1, 2, 3))


def relax_soft_sphere(
    frac_x: torch.Tensor,
    lattice: torch.Tensor,
    atom_mask: torch.Tensor,
    steps: int = 200,
    lr: float = 0.02,
    sigma: float = 1.5,
) -> RelaxResult:
    """``steps`` gradient steps ``frac <- (frac - lr * dE/dfrac) mod 1`` on
    ``frac_x [B, A, 3]`` (``lattice [B, 3, 3]``, ``atom_mask [B, A]``), all
    crystals at once on their device; the energy after every step is kept
    in ``energy_history [B, steps]``."""
    frac = (frac_x % 1.0).detach()
    hist = torch.zeros((frac.shape[0], steps), dtype=frac.dtype, device=frac.device)
    for i in range(steps):
        with torch.enable_grad():
            leaf = frac.requires_grad_()
            (grad,) = torch.autograd.grad(
                _soft_sphere_energy(leaf, lattice, atom_mask, sigma).sum(), leaf)
        with torch.no_grad():
            frac = (frac - lr * grad) % 1.0
            hist[:, i] = _soft_sphere_energy(frac, lattice, atom_mask, sigma)
    return RelaxResult(frac_x=frac, energy=hist[:, -1], energy_history=hist)


def relax_with_mace(result, model_path=None, fmax: float = 0.05, max_steps: int = 100,
                    device: str = "cpu"):
    """MACE + ASE BFGS relaxation of a ``SampleResult``, the JAX package's
    ``relax_with_mace``: per crystal an ASE ``Atoms`` of its scaled
    positions (mod 1), its cell and full periodicity, the MACE calculator
    (the local ``model_path`` file, or the MACE-MP foundation model when
    None), BFGS to ``fmax`` in at most ``max_steps`` steps, the relaxed
    fractional coordinates written back with the lattice held. Returns
    ``(SampleResult, energies [num_crystals])``."""
    try:
        from ase import Atoms
        from ase.optimize import BFGS

        if model_path is None:
            from mace.calculators import mace_mp

            calculator = mace_mp(device=device)
        else:
            from mace.calculators import MACECalculator

            calculator = MACECalculator(model_paths=model_path, device=device)
    except ImportError as e:
        raise ImportError(
            "relax_with_mace needs the `mace-torch` and `ase` packages (the "
            "reference's MACE-MP relaxation path). Use relax_soft_sphere for "
            "the built-in TPU-native relaxation."
        ) from e

    from arreau_tpu_torch.inference.io import SampleResult

    new_frac = np.array(result.frac_x, dtype=np.float64, copy=True)
    energies = []
    for i in range(len(result.num_atoms)):
        s, n = int(result.idx_start[i]), int(result.num_atoms[i])
        system = Atoms(
            numbers=np.asarray(result.atomic_numbers[s : s + n]),
            scaled_positions=np.asarray(result.frac_x[s : s + n]) % 1.0,
            cell=np.asarray(result.lattice[i]),
            pbc=(True, True, True),
        )
        system.calc = calculator
        BFGS(system, logfile=None).run(fmax=fmax, steps=max_steps)
        new_frac[s : s + n] = system.get_scaled_positions()
        energies.append(float(system.get_potential_energy()))
    return SampleResult(
        frac_x=new_frac,
        atomic_numbers=np.array(result.atomic_numbers, copy=True),
        lattice=np.array(result.lattice, copy=True),
        idx_start=np.array(result.idx_start, copy=True),
        num_atoms=np.array(result.num_atoms, copy=True),
    ), np.asarray(energies)
