"""Orientation grids on S^2 (repulsion-optimised), the uniform S^1 grid and
random rotations (SO(3), SO(2)) drawn from a ``torch.Generator``.

The JAX package computes its grid once per process by a repulsion
optimisation seeded from ``jax.random`` (``arreau_tpu/ops/grids.py``,
``cached_grid_s2``); torch cannot reproduce those draws. The seed-0 grids
of 4, 8 and 16 points (16 is the model default) are therefore copied here,
digit for digit. :func:`uniform_grid_s2` runs the same optimisation in
float64 on draws from a ``torch.Generator`` (or on injected draws: JAX's
give JAX's grid); ``cached_grid_s2`` takes it, seeded 0, for any other
size, which is then the port's own grid and not the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# SGD steps of the port's own grids: after the JAX package's 100 the
# 12-point energy still differs by 2.5% from one seed to the next; after
# 300 the seeds agree within 0.2% at 6-32 points
CACHED_GRID_STEPS = 300

# fmt: off
_GRIDS_S2 = {
    4: [
        [0.20478616018868961, -0.4670100195896972, 0.8602117589279997],
        [0.8407508246803733, 0.38923070644313057, -0.3763475892855615],
        [-0.3850397292765309, -0.6541735947529124, -0.6510002417869813],
        [-0.6605306347364284, 0.7319573174256686, 0.16714594234294206],
    ],
    8: [
        [-0.8915452948029848, -0.3832025248179102, -0.24145975293584188],
        [0.5318926654160766, -0.07539619792994695, -0.843448638515879],
        [-0.38632639171958794, 0.6089695535864987, -0.6927539259113468],
        [-0.6161634356701857, 0.5917553081787357, 0.519777140499082],
        [0.09749872825462073, -0.9786952995112793, -0.180691750512465],
        [0.9072616799747208, -0.21945870227438707, 0.35876750416598374],
        [-0.15302946142109405, -0.3879453829381102, 0.9088896323504702],
        [0.5050194689597127, 0.8460788340964183, 0.17060463787862074],
    ],
    16: [
        [0.4006294199402427, -0.6329283029822916, 0.662493646129758],
        [0.5516497778306692, -0.24553810382489588, -0.7971157771550178],
        [-0.17370183945999929, 0.13044972063158614, -0.9761201469877332],
        [-0.968186335997851, -0.2498923131564513, 0.013001946484066497],
        [0.6201803526468525, -0.7624215672975563, -0.1846339186345879],
        [-0.46826594098402363, -0.5544733176484048, 0.6879581008537642],
        [0.9523970693926637, -0.02875143353603063, 0.3035015276434192],
        [0.7991457287750594, 0.459490836170145, -0.3876006651906574],
        [0.055901505453849185, 0.8590473405431039, -0.5088346375727715],
        [-0.40833175327891086, 0.8796754301073386, 0.24379564583814725],
        [-0.45428867313025634, -0.5793626391587716, -0.6767279614531485],
        [0.23755491270204387, 0.17115813361760274, 0.9561760072014269],
        [-0.20002516813304927, -0.9797088635464866, -0.01266786492654096],
        [0.4583176158796917, 0.7959282947666888, 0.3955289023120136],
        [-0.6281552697518721, 0.26905713476055293, 0.7300884982777051],
        [-0.7870227395631912, 0.44145302274635956, -0.430945978190482],
    ],
}
# fmt: on


def spherical_to_euclid(g: torch.Tensor) -> torch.Tensor:
    """(beta, gamma) spherical coordinates ``[..., 2]`` -> unit vectors ``[..., 3]``."""
    beta, gamma = g[..., 0], g[..., 1]
    return torch.stack([torch.sin(beta) * torch.cos(gamma), torch.sin(beta) * torch.sin(gamma),
                        torch.cos(beta)], dim=-1)


def euclid_to_spherical(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.arccos(torch.clamp(x[..., 2], -1.0, 1.0)),
                        torch.arctan2(x[..., 1], x[..., 0])], dim=-1)


def geodesic_distance_s2(r1: torch.Tensor, r2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    return torch.arccos(torch.clamp(torch.sum(r1 * r2, dim=-1), -1 + eps, 1 - eps))


def _repulsion_energy(grid_sph: torch.Tensor, n: int) -> torch.Tensor:
    """Mean Coulomb energy (k = 2) over the distinct pairs of grid points,
    their geodesic distances in units of pi."""
    xyz = spherical_to_euclid(grid_sph)
    d = geodesic_distance_s2(xyz[:, None, :], xyz[None, :, :]) / math.pi
    off_diag = ~torch.eye(n, dtype=torch.bool, device=grid_sph.device)
    return torch.where(off_diag, d ** (-2.0), 0.0).sum() / (n * (n - 1))


def uniform_grid_s2(n: int, generator: torch.Generator | None = None, steps: int = 100,
                    step_size: float = 0.1, alpha: float = 0.001, *,
                    init: torch.Tensor | None = None,
                    noise: torch.Tensor | None = None) -> torch.Tensor:
    """Repulsion-minimised near-uniform grid of ``n`` points on S^2, ``[n,
    3]`` float64: normal starting points ``init [n, 3]`` projected onto the
    sphere, then ``steps`` SGD steps on :func:`_repulsion_energy` (its
    gradient from autograd) with the annealed gradient noise ``(steps - i)
    / steps * alpha * noise[i]`` (``noise [steps, n, 2]``), as the JAX
    package's. Draws not given come from ``generator`` (seeded 0 if none),
    ``init`` first."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    f64 = dict(dtype=torch.float64, device=generator.device)
    if init is None:
        init = torch.randn((n, 3), generator=generator, **f64)
    if noise is None:
        noise = torch.randn((steps, n, 2), generator=generator, **f64)
    init, noise = init.to(**f64), noise.to(**f64)
    grid = euclid_to_spherical(init / torch.linalg.norm(init, dim=-1, keepdim=True))
    for i in range(steps):
        grid = grid.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_repulsion_energy(grid, n), grid)
        grid = grid - step_size * (g + (steps - i) / steps * alpha * noise[i])
    return spherical_to_euclid(grid.detach())


def cached_grid_s2(n: int) -> np.ndarray:
    """The S^2 grid of ``n`` points, ``[n, 3]`` float64: the JAX package's
    seed-0 grid for 4, 8 and 16, else :func:`uniform_grid_s2` seeded 0 over
    ``CACHED_GRID_STEPS`` steps (the port's own grid, not the JAX
    package's)."""
    if n in _GRIDS_S2:
        return np.asarray(_GRIDS_S2[n], dtype=np.float64)
    return uniform_grid_s2(n, steps=CACHED_GRID_STEPS).numpy()


def uniform_grid_s1(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Exact uniform grid on the circle, ``[n, 2]`` (cos, sin) pairs at
    angles ``2 pi i / n``."""
    angles = torch.linspace(0.0, 2 * math.pi - 2 * math.pi / n, n, dtype=torch.float64)
    return torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1).to(dtype=dtype,
                                                                          device=device)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion ``[..., 4]`` (w, x, y, z) -> rotation matrix ``[..., 3, 3]``."""
    w, x, y, z = q.unbind(-1)
    rows = (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def random_so3_matrix(generator: torch.Generator, shape: tuple = (),
                      dtype=torch.float32) -> torch.Tensor:
    """Uniform random SO(3) matrices ``[*shape, 3, 3]`` from normalised
    normal quaternions drawn from ``generator`` (on its device)."""
    return quat_to_matrix(random_quat(generator, shape, dtype))


def random_so2_matrix(generator: torch.Generator, shape: tuple = (),
                      dtype=torch.float32) -> torch.Tensor:
    """Uniform random SO(2) matrices ``[*shape, 2, 2]``, the angle drawn
    from ``generator`` uniform on [0, 2 pi)."""
    theta = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    theta = theta * (2 * math.pi)
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def random_quat(generator: torch.Generator, shape: tuple = (), dtype=torch.float32) -> torch.Tensor:
    """Uniform random unit quaternions ``[*shape, 4]`` (w, x, y, z):
    normalised normals drawn from ``generator`` (on its device)."""
    q = torch.randn((*shape, 4), generator=generator, dtype=dtype, device=generator.device)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
