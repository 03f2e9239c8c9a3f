"""The port's rotation toolbox (``arreau_tpu_torch/ops/rotations.py``)
against the JAX package's (``arreau_tpu/ops/rotations.py``) on the CPU in
float64, function by function on the same numpy-seeded inputs, and the
properties the JAX package's own tests hold (``tests/test_grids.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.ops import rotations as jrot
from arreau_tpu_torch.ops import rotations as rot
from arreau_tpu_torch.ops.grids import random_quat, random_so3_matrix

# float64 on both sides, the same formulas: only the libraries' elementary
# functions (sqrt, arccos, arctan2) may differ, by an ulp or so
F64 = dict(rtol=1e-12, atol=1e-12)


def _quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _matrices(n, seed):
    return np.asarray(jrot.quat_to_matrix(jnp.asarray(_quats(n, seed))))


def _eulers(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-np.pi, np.pi, n), rng.uniform(0.05, np.pi - 0.05, n),
                     rng.uniform(-np.pi, np.pi, n)], -1)


def _special_matrices():
    """Rotations by pi (trace -1: every candidate of Shepperd's method but one
    is small), the identity, and quarter turns about each axis."""
    out = [np.eye(3)]
    for axis in np.eye(3):
        for angle in (np.pi / 2, np.pi, -np.pi / 2):
            q = np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])
            out.append(np.asarray(jrot.quat_to_matrix(jnp.asarray(q))))
    return np.stack(out)


CASES = {
    "quat_to_matrix": (lambda: (_quats(16, 0),)),
    "matrix_to_quat": (lambda: (np.concatenate([_matrices(32, 1), _special_matrices()]),)),
    "euler_to_matrix": (lambda: (_eulers(16, 2),)),
    "matrix_to_euler": (lambda: (_matrices(16, 3),)),
    "quat_to_euler": (lambda: (_quats(16, 4),)),
    "euler_to_quat": (lambda: (_eulers(16, 5),)),
    "quat_mul": (lambda: (_quats(16, 6), _quats(16, 7))),
    "quat_conj": (lambda: (_quats(16, 8),)),
    "geodesic_distance_quat": (lambda: (_quats(16, 9), _quats(16, 10))),
    "geodesic_distance_matrix": (lambda: (_matrices(16, 11), _matrices(16, 12))),
    "slerp": (lambda: (_quats(16, 13), _quats(16, 14),
                       np.random.default_rng(15).uniform(size=(16, 1)))),
    "apply_rotation": (lambda: (_matrices(16, 16), np.random.default_rng(17).normal(size=(16, 3)))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_jax_in_float64(name):
    args = CASES[name]()
    want = np.asarray(getattr(jrot, name)(*map(jnp.asarray, args)))
    got = getattr(rot, name)(*(torch.tensor(a) for a in args))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **F64)


def test_slerp_endpoints_and_near_identical_match_jax():
    """t = 0 and 1, and a pair closer than the linear-interpolation switch."""
    q1 = _quats(4, 20)
    q2 = q1 + 1e-8 * np.random.default_rng(21).normal(size=q1.shape)
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    for a, b in ((q1, _quats(4, 22)), (q1, q2), (q1, -_quats(4, 23))):
        for t in (0.0, 0.3, 1.0):
            want = np.asarray(jrot.slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
            np.testing.assert_allclose(rot.slerp(torch.tensor(a), torch.tensor(b), t).numpy(),
                                       want, **F64)


def test_re_exports_are_the_grids_functions():
    from arreau_tpu_torch.ops import grids

    for name in ("quat_to_matrix", "random_quat", "random_so2_matrix", "random_so3_matrix"):
        assert getattr(rot, name) is getattr(grids, name)


def test_random_quat_is_unit_and_drives_random_so3():
    """The same draws from one seed: unit quaternions, and random_so3_matrix
    is their matrices."""
    q = random_quat(torch.Generator().manual_seed(3), (64,), torch.float64)
    assert q.shape == (64, 4)
    np.testing.assert_allclose(torch.linalg.norm(q, dim=-1).numpy(), 1.0, atol=1e-12)
    m = random_so3_matrix(torch.Generator().manual_seed(3), (64,), torch.float64)
    torch.testing.assert_close(m, rot.quat_to_matrix(q), rtol=0, atol=0)


# ---- the JAX package's properties (tests/test_grids.py), on the port ----


def test_random_so2_matrix_is_rotation():
    R = rot.random_so2_matrix(torch.Generator().manual_seed(2), (10,), torch.float64).numpy()
    for i in range(10):
        np.testing.assert_allclose(R[i] @ R[i].T, np.eye(2), atol=1e-9)
        np.testing.assert_allclose(np.linalg.det(R[i]), 1.0, rtol=1e-9)


def test_quat_to_matrix_identity():
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    np.testing.assert_allclose(rot.quat_to_matrix(q).numpy(), np.eye(3), atol=1e-12)


def test_rotation_converters_roundtrip():
    q = random_quat(torch.Generator().manual_seed(0), (16,), torch.float64)
    q = torch.where(q[:, :1] < 0, -q, q)  # canonical sign (w >= 0) for comparison
    m = rot.quat_to_matrix(q)
    q2 = rot.matrix_to_quat(m)
    q2 = torch.where(q2[:, :1] < 0, -q2, q2)
    np.testing.assert_allclose(q2.numpy(), q.numpy(), atol=1e-8)
    np.testing.assert_allclose(rot.euler_to_matrix(rot.matrix_to_euler(m)).numpy(), m.numpy(),
                               atol=1e-8)


def test_rotation_geodesic_and_slerp():
    q1 = random_quat(torch.Generator().manual_seed(1), (8,), torch.float64)
    q2 = random_quat(torch.Generator().manual_seed(2), (8,), torch.float64)
    d_q = rot.geodesic_distance_quat(q1, q2)
    d_m = rot.geodesic_distance_matrix(rot.quat_to_matrix(q1), rot.quat_to_matrix(q2))
    # the SO(3) angle is twice the quaternion angle (double cover)
    np.testing.assert_allclose(d_m.numpy(), 2 * d_q.numpy(), atol=1e-5)

    mid = rot.slerp(q1, q2, 0.5)
    np.testing.assert_allclose(torch.linalg.norm(mid, dim=-1).numpy(), 1.0, atol=1e-9)
    np.testing.assert_allclose(rot.geodesic_distance_quat(q1, mid).numpy(),
                               rot.geodesic_distance_quat(mid, q2).numpy(), atol=1e-5)
    np.testing.assert_allclose(rot.slerp(q1, q1, 0.3).numpy(), q1.numpy(), atol=1e-6)


def test_quat_mul_matches_matrix_product():
    q1 = random_quat(torch.Generator().manual_seed(3), (5,), torch.float64)
    q2 = random_quat(torch.Generator().manual_seed(4), (5,), torch.float64)
    np.testing.assert_allclose(rot.quat_to_matrix(rot.quat_mul(q1, q2)).numpy(),
                               (rot.quat_to_matrix(q1) @ rot.quat_to_matrix(q2)).numpy(),
                               atol=1e-8)


def test_quat_conj_inverts_and_rotation_applies():
    q = random_quat(torch.Generator().manual_seed(5), (6,), torch.float64)
    ident = rot.quat_mul(q, rot.quat_conj(q))
    np.testing.assert_allclose(ident.numpy(), np.tile([1.0, 0, 0, 0], (6, 1)), atol=1e-12)
    v = torch.randn((6, 3), generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    m = rot.quat_to_matrix(q)
    np.testing.assert_allclose(rot.apply_rotation(m, v).numpy(),
                               np.einsum("bij,bj->bi", m.numpy(), v.numpy()), atol=1e-12)


def test_jax_float64_is_on():
    """The comparisons above are float64 on the JAX side too."""
    assert jax.config.jax_enable_x64
