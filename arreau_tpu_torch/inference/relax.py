"""Structure relaxation of generated crystals; counterpart of
``arreau_tpu/inference/relax.py``.

- :func:`relax_soft_sphere`: gradient descent on the fractional coordinates
  (lattice fixed) under a smooth soft-sphere pair potential over the 27
  min-image offsets, every crystal of the batch at once, on the tensors'
  device. The JAX package's ``fori_loop`` is a plain loop here, its
  ``jax.grad`` ``torch.autograd.grad``.
- :func:`relax_with_mace`: the MACE force field with ASE's BFGS, which
  needs the ``mace-torch`` and ``ase`` packages; not ported.
"""

from __future__ import annotations

from typing import NamedTuple

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
    """The JAX package's MACE-MP + ASE BFGS relaxation
    (``arreau_tpu/inference/relax.py:relax_with_mace``): not ported."""
    raise NotImplementedError(
        "relax_with_mace needs the mace-torch and ase packages, which the port does not "
        "carry; use relax_soft_sphere"
    )
