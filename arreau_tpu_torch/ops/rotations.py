"""SO(3) rotation toolbox: converters between quaternions, matrices and
ZYZ Euler angles, quaternion products, geodesic distances, interpolation
and random rotations; counterpart of ``arreau_tpu/ops/rotations.py``.

Quaternions are (w, x, y, z) unit quaternions; Euler angles are intrinsic
ZYZ (alpha, beta, gamma). Every function works on any leading shape, on
any device and in the input's floating type. The random draws take a
JAX key (``ops/grids.py``).
"""

from __future__ import annotations

import torch

from arreau_tpu_torch.ops.grids import (  # noqa: F401  (re-exported: one import for callers)
    quat_to_matrix,
    random_quat,
    random_so2_matrix,
    random_so3_matrix,
)

_EPS = 1e-9


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> unit quaternion ``[..., 4]``.

    Shepperd's method: the four candidate magnitudes, the other components'
    signs fixed from the largest one, chosen per element without a branch."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=0.0)) / 2

    qw = half_sqrt(1 + tr)
    qx = half_sqrt(1 + m00 - m11 - m22)
    qy = half_sqrt(1 - m00 + m11 - m22)
    qz = half_sqrt(1 - m00 - m11 + m22)
    case = torch.argmax(torch.stack([qw, qx, qy, qz], dim=-1), dim=-1)

    sign = torch.copysign
    quats = torch.stack(
        [
            torch.stack([qw, sign(qx, m21 - m12), sign(qy, m02 - m20), sign(qz, m10 - m01)], -1),
            torch.stack([sign(qw, m21 - m12), qx, sign(qy, m01 + m10), sign(qz, m02 + m20)], -1),
            torch.stack([sign(qw, m02 - m20), sign(qx, m01 + m10), qy, sign(qz, m12 + m21)], -1),
            torch.stack([sign(qw, m10 - m01), sign(qx, m02 + m20), sign(qy, m12 + m21), qz], -1),
        ],
        dim=-2,
    )  # [..., 4 cases, 4]
    idx = case[..., None, None].expand(*case.shape, 1, 4)
    q = torch.gather(quats, -2, idx)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def euler_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """Intrinsic ZYZ Euler angles ``[..., 3]`` (alpha, beta, gamma) -> matrix."""
    a, b, g = euler.unbind(-1)
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cg, sg = torch.cos(g), torch.sin(g)
    row0 = torch.stack([ca * cb * cg - sa * sg, -ca * cb * sg - sa * cg, ca * sb], -1)
    row1 = torch.stack([sa * cb * cg + ca * sg, -sa * cb * sg + ca * cg, sa * sb], -1)
    row2 = torch.stack([-sb * cg, sb * sg, cb], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_euler(m: torch.Tensor) -> torch.Tensor:
    """Matrix -> intrinsic ZYZ Euler angles (alpha, beta, gamma)."""
    beta = torch.arccos(torch.clamp(m[..., 2, 2], -1.0, 1.0))
    alpha = torch.arctan2(m[..., 1, 2], m[..., 0, 2])
    gamma = torch.arctan2(m[..., 2, 1], -m[..., 2, 0])
    return torch.stack([alpha, beta, gamma], dim=-1)


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    return matrix_to_euler(quat_to_matrix(q))


def euler_to_quat(euler: torch.Tensor) -> torch.Tensor:
    return matrix_to_quat(euler_to_matrix(euler))


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q1 q2``: the rotation ``q2`` then ``q1``."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def geodesic_distance_quat(q1: torch.Tensor, q2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Half the rotation angle between ``q1`` and ``q2``, from |<q1, q2>|
    (q and -q are one rotation)."""
    dot = torch.abs(torch.sum(q1 * q2, dim=-1))
    return torch.arccos(torch.clamp(dot, -1 + eps, 1 - eps))


def geodesic_distance_matrix(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Rotation angle of ``m1^T m2``."""
    rel = m1.transpose(-1, -2) @ m2
    tr = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1) / 2, -1.0, 1.0))


def slerp(q1: torch.Tensor, q2: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions along the
    shorter arc; nearly equal endpoints interpolate linearly."""
    t = torch.as_tensor(t, dtype=q1.dtype, device=q1.device)
    dot = torch.sum(q1 * q2, dim=-1, keepdim=True)
    q2 = torch.where(dot < 0, -q2, q2)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, 0.0, 1.0 - _EPS))
    sin_theta = torch.clamp(torch.sin(theta), min=_EPS)
    w1 = torch.sin((1 - t) * theta) / sin_theta
    w2 = torch.sin(t * theta) / sin_theta
    out = torch.where(dot > 1 - 1e-6, (1 - t) * q1 + t * q2, w1 * q1 + w2 * q2)
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def apply_rotation(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``[..., 3]`` by matrices ``[..., 3, 3]``."""
    return torch.einsum("...ij,...j->...i", m, v)
