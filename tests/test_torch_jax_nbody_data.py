"""The port's N-body dataset against the JAX package's from the same seed,
on the CPU: the initial states of every split drawn from JAX's keys (the
charges and so the couplings exactly, positions and velocities within 3
ulp), and the frames ``generate_nbody_npz(seed=43)`` saves against a JAX
run in a fresh process (one CPU device, no ``enable_x64``), which part
only where the float32 integration is chaotic."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu_torch.data.nbody import SUFFIX, draw_charged, generate_nbody_npz
from arreau_tpu_torch.ops import prng
from tests.test_torch_jax_streams import ROOT

# a float32 normal against JAX's (tests/test_torch_prng.py)
NORMAL_ULP = 3
# the splits of the comparison: a few dozen systems at the CLI's T = 5000
SIZES = {"train": 32, "valid": 16, "test": 16}
# a system "parts" from JAX's where its frames 30 or 40 (the nbody_small
# pair) differ by more than PARTED_ATOL in a position or velocity. Measured
# on the CPU at SIZES (PERF.md, the chaos finding): 13 of 64 systems parted (the
# largest gap 3.10), the median system's gap 8.8e-6, and every frame 0
# (after 100 steps) within 2.7e-6. The bounds leave room for other vector
# widths' rounding: at most a quarter parted, the median within 1e-4, every
# frame 0 within FIRST_FRAME_ATOL.
PARTED_ATOL = 1e-3
MAX_PARTED = 16
MEDIAN_ATOL = 1e-4
FIRST_FRAME_ATOL = 1e-5


def _ulp_gap(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _jax_draws(key, num_sims, n_balls=5):
    """What ``arreau_tpu/data/nbody.py:simulate_charged`` draws from
    ``key`` without ``enable_x64`` (float32 draws, a float32 ``p``)."""
    k_q, k_loc, k_vel = jax.random.split(key, 3)
    charges = np.where(np.asarray(jax.random.bernoulli(k_q, jnp.float32(0.5),
                                                       (num_sims, n_balls))), 1.0, -1.0)
    loc = np.asarray(jax.random.normal(k_loc, (num_sims, n_balls, 3), jnp.float32))
    vel = np.asarray(jax.random.normal(k_vel, (num_sims, n_balls, 3), jnp.float32))
    speed = np.asarray(jnp.linalg.norm(jnp.asarray(vel), axis=-1, keepdims=True))
    return loc, vel * np.float32(0.5) / speed, charges


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_initial_states_are_jax_draws(split):
    """Each split's key as ``generate_nbody_npz(seed=43)`` splits it off
    ``PRNGKey(43)`` (at the CLI's default sizes, 3000 and 600): the charges
    equal JAX's, the positions and velocities within NORMAL_ULP."""
    num = 3000 if split == "train" else 600
    key = jax.random.PRNGKey(43)
    for _ in range(["train", "valid", "test"].index(split) + 1):
        key, sub = jax.random.split(key)
    pkey = prng.prng_key(43)
    for _ in range(["train", "valid", "test"].index(split) + 1):
        pkey, psub = prng.split(pkey)
    np.testing.assert_array_equal(psub, np.asarray(sub))
    loc, vel, charges = (t.numpy() for t in draw_charged(psub, num, device="cpu"))
    want_loc, want_vel, want_charges = _jax_draws(sub, num)
    np.testing.assert_array_equal(charges, want_charges)
    assert _ulp_gap(loc, want_loc) <= NORMAL_ULP
    assert _ulp_gap(vel, want_vel) <= NORMAL_ULP


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(port dir, JAX dir): ``generate_nbody_npz(seed=43)`` at SIZES in each
    package, JAX's in a fresh process."""
    root = tmp_path_factory.mktemp("nbody")
    generate_nbody_npz(str(root / "port"), SIZES["train"], SIZES["valid"], SIZES["test"], seed=43)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    code = ("import sys; from arreau_tpu.data.nbody import generate_nbody_npz; "
            "generate_nbody_npz(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), "
            "int(sys.argv[4]), seed=43)")
    proc = subprocess.run([sys.executable, "-c", code, str(root / "jax"),
                           *(str(SIZES[s]) for s in ("train", "valid", "test"))],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return root / "port", root / "jax"


def _load(d, field, split):
    return np.load(os.path.join(d, f"{field}_{split}{SUFFIX}.npy"))


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_charges_and_edges_equal_jax(datasets, split):
    port, want = datasets
    for field in ("charges", "edges"):
        got, exp = _load(port, field, split), _load(want, field, split)
        assert got.shape == exp.shape and got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)


def test_saved_frames_match_jax_but_where_chaotic(datasets):
    """Every saved frame has JAX's shape and is finite; frame 0 of every
    system within FIRST_FRAME_ATOL; at frames 30 and 40 the median system
    within MEDIAN_ATOL and at most MAX_PARTED of 64 parted."""
    port, want = datasets
    gaps = []
    for split in ("train", "valid", "test"):
        loc, vel = _load(port, "loc", split), _load(port, "vel", split)
        want_loc, want_vel = _load(want, "loc", split), _load(want, "vel", split)
        assert loc.shape == want_loc.shape == (SIZES[split], 49, 3, 5)
        assert np.isfinite(loc).all() and np.isfinite(vel).all()
        first = max(np.abs(loc[:, 0] - want_loc[:, 0]).max(),
                    np.abs(vel[:, 0] - want_vel[:, 0]).max())
        assert first <= FIRST_FRAME_ATOL, (split, first)
        pair = [30, 40]
        gap = np.maximum(np.abs(loc[:, pair] - want_loc[:, pair]).reshape(len(loc), -1).max(1),
                         np.abs(vel[:, pair] - want_vel[:, pair]).reshape(len(loc), -1).max(1))
        gaps.append(gap)
    gaps = np.concatenate(gaps)
    parted = int((gaps > PARTED_ATOL).sum())
    print(f"frames 30/40: {parted} of {len(gaps)} systems parted beyond {PARTED_ATOL}, "
          f"largest gap {gaps.max():.4g}, median {np.median(gaps):.3g}")
    assert np.median(gaps) <= MEDIAN_ATOL
    assert parted <= MAX_PARTED


def test_port_reads_the_jax_files_as_jax(datasets):
    """The port's loader on JAX's files gives JAX's loader's arrays."""
    from arreau_tpu.data.nbody import load_nbody_split as j_load
    from arreau_tpu_torch.data.nbody import load_nbody_split

    _, want = datasets
    for a, b in zip(load_nbody_split(str(want), "val"), j_load(str(want), "val")):
        np.testing.assert_array_equal(a, b)
    assert torch.from_numpy(_load(want, "charges", "test")).abs().eq(1).all()
