"""Fixed-degree radius graph over a dense batch of point clouds (no
periodic images); counterpart of ``arreau_tpu/ops/radius.py``.

Every node gets exactly K receiver-major neighbour slots, the K nearest
valid senders within the radius, with a slot mask: the same
:class:`~arreau_tpu_torch.ops.pbc.NeighborList` contract as the PBC
builder, so one backbone takes both. ``torch.topk`` may order senders at
equal distance differently from ``lax.top_k``, so the two packages agree
on each node's edge set where K reaches past every tie, not on slot order.
"""

from __future__ import annotations

import torch

from arreau_tpu_torch.ops.pbc import NeighborList


def radius_neighbor_list(pos: torch.Tensor, mask: torch.Tensor, radius: float,
                         max_neighbors: int, loop: bool = True) -> NeighborList:
    """``pos [B, N, D]`` (D = 2 or 3), ``mask [B, N]`` node validity; a
    large ``radius`` makes the graph fully connected, ``loop`` keeps
    self-edges. ``direction`` is sender minus receiver; empty slots have
    ``src`` 0, zero distance and direction."""
    B, N, _ = pos.shape
    diff = pos[:, None, :, :] - pos[:, :, None, :]  # [B, recv, src, D]
    dist_sqr = torch.sum(diff**2, dim=-1)

    valid = mask[:, None, :] & mask[:, :, None]
    valid = valid & (dist_sqr <= radius * radius)
    if not loop:
        valid = valid & ~torch.eye(N, dtype=torch.bool, device=pos.device)[None]

    big = torch.finfo(pos.dtype).max
    cand = torch.where(valid, dist_sqr, big)
    k = min(max_neighbors, N)
    topk_sqr, src = torch.topk(cand, k, dim=-1, largest=False, sorted=True)
    slot_mask = topk_sqr < big

    direction = torch.gather(diff, 2, src[..., None].expand(B, N, k, diff.shape[-1]))
    # double where: a finite sqrt gradient on empty slots
    safe_sqr = torch.where(slot_mask, torch.clamp(topk_sqr, min=0.0), 1.0)
    dist = torch.where(slot_mask, torch.sqrt(safe_sqr), 0.0)
    direction = torch.where(slot_mask[..., None], direction, 0.0)
    src = torch.where(slot_mask, src, 0)
    return NeighborList(src=src, image=torch.zeros_like(src), dist=dist, direction=direction,
                        mask=slot_mask)
