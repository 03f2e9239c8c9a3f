"""Lattice parameter codec and coordinate transforms.

Counterpart of ``arreau_tpu/ops/lattice.py``. A lattice is a row matrix
``L [..., 3, 3]`` whose rows are the basis vectors; cartesian = frac @ L.
Angles are in radians.
"""

from __future__ import annotations

import math

import torch


def encode_angles(angles: torch.Tensor) -> torch.Tensor:
    """3 angles -> their ``[sin || cos]`` encoding ``[..., 6]``."""
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def decode_angles(encoded: torch.Tensor) -> torch.Tensor:
    """3 angles from their ``[sin || cos]`` encoding ``[..., 6]``."""
    return torch.atan2(encoded[..., :3], encoded[..., 3:])


def lattice_from_params(lengths: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """(lengths, angles) -> lattice ``[..., 3, 3]`` in the pymatgen orientation:
    vector_c along +z, vector_a in the x-z plane."""
    a, b, c = lengths.unbind(-1)
    alpha, beta, gamma = angles.unbind(-1)
    cos_alpha, cos_beta, cos_gamma = torch.cos(alpha), torch.cos(beta), torch.cos(gamma)
    sin_alpha, sin_beta = torch.sin(alpha), torch.sin(beta)

    val = (cos_alpha * cos_beta - cos_gamma) / (sin_alpha * sin_beta)
    gamma_star = torch.arccos(torch.clamp(val, -1.0, 1.0))

    zeros = torch.zeros_like(a)
    vector_a = torch.stack([a * sin_beta, zeros, a * cos_beta], dim=-1)
    vector_b = torch.stack(
        [
            -b * sin_alpha * torch.cos(gamma_star),
            b * sin_alpha * torch.sin(gamma_star),
            b * cos_alpha,
        ],
        dim=-1,
    )
    vector_c = torch.stack([zeros, zeros, c], dim=-1)
    return torch.stack([vector_a, vector_b, vector_c], dim=-2)


def matrix_to_params(matrix: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Lattice ``[..., 3, 3]`` -> (lengths ``[..., 3]``, angles ``[..., 3]``);
    ``angles[i]`` is the angle between rows ``(i+1)%3`` and ``(i+2)%3``."""
    lengths = torch.sqrt(torch.sum(matrix**2, dim=-1))
    j, k = [1, 2, 0], [2, 0, 1]
    cos = torch.sum(matrix[..., j, :] * matrix[..., k, :], dim=-1) / (lengths[..., j] * lengths[..., k])
    return lengths, torch.arccos(torch.clamp(cos, -1.0, 1.0))


def frac_to_cart(frac: torch.Tensor, lattice: torch.Tensor) -> torch.Tensor:
    """``frac [..., N, 3]`` @ row-basis ``lattice [..., 3, 3]``."""
    return torch.einsum("...ni,...ij->...nj", frac, lattice)


def ridge_pinv_3x3(lattice: torch.Tensor, rel_eps: float = 100.0) -> torch.Tensor:
    """Damped closed-form pseudo-inverse ``L^T (L L^T + eps I)^-1`` of batched
    3x3 matrices (adjugate inverse, no SVD)."""
    g = torch.einsum("...ik,...jk->...ij", lattice, lattice)
    scale = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
    eps = torch.finfo(lattice.dtype).eps
    m = g + (rel_eps * eps * scale + eps) * torch.eye(3, dtype=lattice.dtype, device=lattice.device)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * C
    adj = torch.stack(
        [torch.stack([A, B, C], -1), torch.stack([B, D, E], -1), torch.stack([C, E, F], -1)],
        -2,
    )
    return torch.einsum("...ki,...kj->...ij", lattice, adj / det[..., None, None])


def cart_to_frac_without_mod(cart: torch.Tensor, lattice: torch.Tensor) -> torch.Tensor:
    """Cartesian -> fractional coordinates, not wrapped (the damped
    pseudo-inverse keeps a near-singular lattice finite)."""
    return torch.einsum("...ni,...ij->...nj", cart, ridge_pinv_3x3(lattice))


def cart_to_frac(cart: torch.Tensor, lattice: torch.Tensor) -> torch.Tensor:
    """Cartesian -> fractional coordinates wrapped into [0, 1)."""
    return cart_to_frac_without_mod(cart, lattice) % 1.0


def abs_cap(val: torch.Tensor, max_abs_val: float = 1.0) -> torch.Tensor:
    return torch.clamp(val, -max_abs_val, max_abs_val)


def symmetrize_matrix(matrix: torch.Tensor) -> torch.Tensor:
    return (matrix + matrix.transpose(-1, -2)) / 2


def polar_decomposition(matrix: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """SVD polar decomposition ``M = U P``: (rotation ``U``, symmetric
    positive semidefinite ``P``)."""
    u_svd, s, vt = torch.linalg.svd(matrix)
    p = vt.transpose(-1, -2) @ (s[..., :, None] * vt)
    return u_svd @ vt, symmetrize_matrix(p)


def symmetric_matrix_to_vector(matrix: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 symmetric matrix -> its upper-triangular 6-vector."""
    rows, cols = (0, 0, 0, 1, 1, 2), (0, 1, 2, 1, 2, 2)
    return matrix[..., rows, cols]


def vector_to_symmetric_matrix(vector: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`symmetric_matrix_to_vector`."""
    return vector[..., (0, 1, 2, 1, 3, 4, 2, 4, 5)].unflatten(-1, (3, 3))


def volume(matrix: torch.Tensor) -> torch.Tensor:
    return torch.abs(torch.linalg.det(matrix))


def wrapped_angle_mse(pred_angles: torch.Tensor, target_angles: torch.Tensor) -> torch.Tensor:
    """MSE on the circle (mod 2 pi), the reference's angle loss."""
    max_angle = 2 * math.pi
    diff = torch.clamp(torch.abs(pred_angles - target_angles) % max_angle, 0.0, max_angle)
    return torch.mean(torch.minimum(diff, max_angle - diff) ** 2)


def cubic_score(edge_lengths: torch.Tensor) -> torch.Tensor:
    """``1 - sum |l_i - mean| / mean``: how cube-like a cell's edge lengths are."""
    avg = torch.mean(edge_lengths, dim=-1, keepdim=True)
    return 1.0 - torch.sum(torch.abs(edge_lengths - avg), dim=-1) / avg[..., 0]


def vector_length_mse_loss(pred_matrices: torch.Tensor,
                           target_matrices: torch.Tensor) -> torch.Tensor:
    """MSE of the basis-vector lengths plus the wrapped angle MSE between
    two lattice batches."""
    pred_lengths, pred_angles = matrix_to_params(pred_matrices)
    target_lengths, target_angles = matrix_to_params(target_matrices)
    length_loss = torch.mean((pred_lengths - target_lengths) ** 2)
    return length_loss + wrapped_angle_mse(pred_angles, target_angles)


def angle_bound_loss(angles_deg: torch.Tensor, lower: float = 60.0, upper: float = 120.0,
                     weight: float = 0.1) -> torch.Tensor:
    """Quadratic penalty outside [lower, upper] degrees."""
    over = torch.clamp(angles_deg - upper, min=0.0)
    under = torch.clamp(angles_deg - lower, max=0.0)
    return torch.mean((weight * over) ** 2 + (weight * under) ** 2)


_BRAVAIS_FIXED = {
    "cubic": (90.0, 90.0, 90.0),
    "tetragonal": (90.0, 90.0, 90.0),
    "orthorhombic": (90.0, 90.0, 90.0),
    "hexagonal": (90.0, 90.0, 120.0),
}


def sample_bravais_angles(
    key,
    lattice_type: str,
    batch: int,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Lattice angles ``[batch, 3]`` in radians for one of the 7 Bravais
    families: the JAX package's ``sample_bravais_angles(key, lattice_type,
    batch)``, the same float32 draws from the JAX key ``key`` (uint32
    ``[2]``), on ``device`` (the threefry kernel on a CUDA device)."""
    from arreau_tpu_torch.kernels.threefry import uniform as jax_uniform

    def uniform(shape, lo, hi):
        return jax_uniform(key, shape, device, minval=lo, maxval=hi)

    if lattice_type in _BRAVAIS_FIXED:
        deg = torch.tensor(_BRAVAIS_FIXED[lattice_type], device=device)
        deg = deg.expand(batch, 3)
    elif lattice_type == "monoclinic":
        ninety = torch.full((batch,), 90.0, device=device)
        deg = torch.stack([ninety, uniform((batch,), 90.0, 180.0), ninety], dim=-1)
    elif lattice_type == "triclinic":
        deg = uniform((batch, 3), 60.0, 120.0)
    elif lattice_type == "rhombohedral":
        angle = uniform((batch,), 60.0, 120.0)
        deg = torch.stack([angle, angle, angle], dim=-1)
    else:
        raise ValueError(f"Invalid lattice type: {lattice_type}")
    return deg * (math.pi / 180.0)
