"""Periodic-boundary geometry: min-image distances and the fixed-degree
radius graph over a dense crystal batch.

Counterpart of ``arreau_tpu/ops/pbc.py``. ``pbc_neighbor_list``: receiver-major
neighbor lists with exactly K slots per atom (masked), chosen among the
A*27 candidate (atom, image) pairs within the radius, nearest first.

``torch.topk`` may order ties differently from the JAX package's argmin
passes, so two packages agree on each atom's edge set, not on slot order.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

# 27 lattice-image offsets in {-1, 0, 1}^3, itertools.product order
SUPERCELLS = np.array(list(itertools.product((-1, 0, 1), repeat=3)), dtype=np.float64)
NUM_IMAGES = 27
SELF_EDGE_EPS_SQR = 1e-4
# cap on live candidate-distance elements; receivers are chunked beyond it
MAX_SELECT_ELEMS = 1 << 22


class NeighborList(NamedTuple):
    """src/image ``[B, A, K]`` int64, dist ``[B, A, K]``, direction
    ``[B, A, K, 3]`` (sender image minus receiver), mask ``[B, A, K]`` bool."""

    src: torch.Tensor
    image: torch.Tensor
    dist: torch.Tensor
    direction: torch.Tensor
    mask: torch.Tensor


def min_distance_pbc(cart1: torch.Tensor, cart2: torch.Tensor,
                     lattice: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(min-image squared distance ``[..., A]``, vector ``[..., A, 3]``)
    between paired atoms of ``cart1``/``cart2 [..., A, 3]``; the vector
    points from cart2's nearest image to cart1 (first minimum on ties)."""
    supercells = torch.as_tensor(SUPERCELLS, dtype=cart1.dtype, device=cart1.device)
    offsets = torch.einsum("ci,...ij->...cj", supercells, lattice)  # [..., 27, 3]
    diff = cart1[..., :, None, :] - (cart2[..., :, None, :] + offsets[..., None, :, :])
    dist_sqr = torch.sum(diff**2, dim=-1)
    min_idx = torch.argmin(dist_sqr, dim=-1, keepdim=True)
    min_sqr = torch.gather(dist_sqr, -1, min_idx)[..., 0]
    min_vec = torch.gather(diff, -2, min_idx[..., None].expand(*min_idx.shape, 3))[..., 0, :]
    return min_sqr, min_vec


def _select_chunk_size(B: int, A: int, max_elems: int) -> int:
    """Largest divisor Ac of A with B * Ac * A * 27 <= max_elems (min 1)."""
    per_receiver = B * A * NUM_IMAGES
    best = 1
    for ac in range(1, A + 1):
        if A % ac == 0 and ac * per_receiver <= max_elems:
            best = ac
    return best


def pbc_neighbor_list(
    cart: torch.Tensor,
    lattice: torch.Tensor,
    atom_mask: torch.Tensor,
    radius: float,
    max_neighbors: int,
    max_select_elems: int = MAX_SELECT_ELEMS,
) -> NeighborList:
    """Build the fixed-degree PBC radius graph.

    Phase 1 selects the K nearest candidates through the expansion
    ``|x - p|^2 = |x|^2 + |p|^2 - 2 x.p`` on per-crystal centred
    coordinates; phase 2 recomputes exact distances and directions for the
    selected slots and re-decides the radius and self-edge cuts on them.
    """
    B, A, _ = cart.shape
    dtype = cart.dtype
    supercells = torch.as_tensor(SUPERCELLS, dtype=dtype, device=cart.device)
    offsets = torch.einsum("ci,bij->bcj", supercells, lattice)  # [B, 27, 3]
    pos_images = (cart[:, :, None, :] + offsets[:, None, :, :]).reshape(B, A * NUM_IMAGES, 3)
    k = min(max_neighbors, A * NUM_IMAGES)
    big = torch.finfo(dtype).max
    r2 = radius * radius

    # ---- phase 1: selection (indices and mask only) ----
    center = cart.mean(dim=1, keepdim=True)
    sel_cart = cart - center
    sel_pos = pos_images - center
    pp = torch.sum(sel_pos**2, dim=-1)  # [B, A*27]
    cand_mask = atom_mask.repeat_interleave(NUM_IMAGES, dim=1)  # sender real

    def select(recv_cart, recv_mask):
        xx = torch.sum(recv_cart**2, dim=-1)
        dots = torch.einsum("bai,bni->ban", recv_cart, sel_pos)
        dist_sqr = xx[:, :, None] + pp[:, None, :] - 2.0 * dots
        valid = cand_mask[:, None, :] & recv_mask[:, :, None] & (dist_sqr <= r2)
        valid &= dist_sqr > SELF_EDGE_EPS_SQR  # no self edges
        cand = torch.where(valid, dist_sqr, torch.full_like(dist_sqr, big))
        vals, idx = torch.topk(cand, k, dim=-1, largest=False, sorted=True)
        return idx, vals < big

    ac = _select_chunk_size(B, A, max_select_elems)
    chunks = [
        select(sel_cart[:, i : i + ac], atom_mask[:, i : i + ac]) for i in range(0, A, ac)
    ]
    flat_idx = torch.cat([c[0] for c in chunks], dim=1)  # [B, A, K]
    mask = torch.cat([c[1] for c in chunks], dim=1)

    # ---- phase 2: exact dist/direction on the selected slots ----
    flat_sel = torch.where(mask, flat_idx, 0).reshape(B, A * k)
    gathered = torch.gather(pos_images, 1, flat_sel[..., None].expand(B, A * k, 3))
    direction = gathered.reshape(B, A, k, 3) - cart[:, :, None, :]
    dist_sqr_sel = torch.sum(direction**2, dim=-1)
    mask = mask & (dist_sqr_sel <= r2) & (dist_sqr_sel > SELF_EDGE_EPS_SQR)

    src = torch.where(mask, flat_idx // NUM_IMAGES, 0)
    image = torch.where(mask, flat_idx % NUM_IMAGES, 0)
    direction = torch.where(mask[..., None], direction, 0.0)
    dist = torch.sqrt(torch.sum(direction**2, dim=-1))
    return NeighborList(src=src, image=image, dist=dist, direction=direction, mask=mask)
