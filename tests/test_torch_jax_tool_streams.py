"""The exploration tools' own key chains against the JAX tools from the
same seed, on the CPU, with nothing injected: the sampler diagnosis
(``PRNGKey(seed)`` split into the prior's keys and a loop key, one split of
it a step), the VP-prior check (``PRNGKey(seed)`` for the forward chain,
``split(PRNGKey(seed + 1))`` for the prior and its angles) and the
equivariance check's loss draws (``split(PRNGKey(0), n_noise)``)."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arreau_tpu.exploration import diagnose_sampler as j_diagnose
from arreau_tpu.exploration import verify_equivariance as j_equiv
from arreau_tpu.ops.lattice import sample_bravais_angles as j_bravais
from arreau_tpu_torch.exploration import diagnose_sampler, verify_equivariance, vp_prior_check
from arreau_tpu_torch.ops import prng
from tests.test_torch_exploration_chain import (
    CHAIN_TOL,
    LOSS_TOL,
    _diagnose_noise,
    _write_checkpoints,
)
from tests.test_torch_jax_streams import ROOT
from tests.test_torch_prng import NORMAL_ULP, _ulp_gap


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{diffuse_angles: (JAX dir, port dir, config)}: one tiny model each."""
    return {d: _write_checkpoints(tmp_path_factory.mktemp(f"ckpt{int(d)}"), d)
            for d in (False, True)}


@pytest.mark.parametrize("diffuse_angles", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_diagnosis_noise_is_the_jax_tools_draws(checkpoints, diffuse_angles, seed):
    """``draw_diagnosis_noise`` of ``PRNGKey(seed)`` is what the JAX tool
    draws: uniforms, Bravais angles and bits equal, normals within
    NORMAL_ULP."""
    _, _, jcfg = checkpoints[diffuse_angles]
    B, A, C = 3, 5, jcfg.num_atomic_states
    with jax.enable_x64(False):  # the JAX tool's own types
        want = _diagnose_noise(jcfg, B, A, seed)
    got = diagnose_sampler.draw_diagnosis_noise(prng.prng_key(seed), jcfg.num_timesteps - 1,
                                                B, A, C, diffuse_angles, "cpu")
    for name in ("ang_enc0", "lengths0", "frac0", "lattice", "pos", "types", "angles"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape, name
        tol = NORMAL_ULP if name in ("ang_enc0", "lengths0", "frac0", "lattice", "pos") else 0
        assert _ulp_gap(g.numpy(), w.numpy()) <= tol, name
    if diffuse_angles:  # read only under diffuse_angles
        assert _ulp_gap(got.angle.numpy(), want.angle.numpy()) <= NORMAL_ULP


@pytest.mark.parametrize("diffuse_angles", [False, True])
def test_diagnose_sampler_seed_gives_the_jax_records(checkpoints, diffuse_angles, tmp_path,
                                                     capsys):
    """``diagnose_sampler --seed 5`` in both packages on one checkpoint, the
    port drawing its own noise: every record within the chain tolerance of
    ``tests/test_torch_exploration_chain.py``."""
    jax_dir, port_dir, _ = checkpoints[diffuse_angles]
    common = ["--ref", "synthetic:300:0", "--num_samples", "4", "--num_atoms_per_sample", "5",
              "--record_every", "10", "--seed", "5"]
    with jax.enable_x64(False):  # as the JAX tool runs: float32 draws
        want = j_diagnose.main(["--checkpoint_dir", str(jax_dir), *common,
                                "--out", str(tmp_path / "jax.json")])
    got = diagnose_sampler.main(["--checkpoint_dir", str(port_dir), *common, "--device", "cpu",
                                 "--out", str(tmp_path / "port.json")])
    capsys.readouterr()
    assert [r["t"] for r in got] == [r["t"] for r in want] == [28, 19, 9, 0]
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], **CHAIN_TOL, err_msg=f"t={w['t']} {k}")
    assert json.loads((tmp_path / "port.json").read_text())["records"] == got


@pytest.mark.parametrize("seed", [0, 3])
def test_vp_prior_noise_is_the_jax_tools_draws(seed):
    """``vp_prior_check.draw_noise(seed)``: the forward normals of
    ``PRNGKey(seed)``, the prior's of ``kd`` and the Bravais angles of
    ``ka``, ``kd, ka = split(PRNGKey(seed + 1))``, as the JAX tool draws
    them without ``enable_x64`` (float32)."""
    N, n = 50, 6
    got = vp_prior_check.draw_noise(seed, N, n, "cpu")
    with jax.enable_x64(False):
        kd, ka = jax.random.split(jax.random.PRNGKey(seed + 1))
        forward = jax.random.normal(jax.random.PRNGKey(seed), (N, 3), jnp.float32)
        prior = jax.random.normal(kd, (n, 3), jnp.float32)
        angles = np.asarray(j_bravais(ka, "monoclinic", n))
    assert _ulp_gap(got.forward.numpy(), np.asarray(forward)) <= NORMAL_ULP
    assert _ulp_gap(got.prior.numpy(), np.asarray(prior)) <= NORMAL_ULP
    np.testing.assert_array_equal(got.angles.numpy(), angles)


def _numbers(text, line_start):
    [line] = [ln for ln in text.splitlines() if ln.startswith(line_start)]
    return [float(x) for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]\d+)?", line)]


def test_vp_prior_check_seed_gives_the_jax_report(tmp_path, capsys):
    """``vp_prior_check --seed 2`` against the JAX tool in a fresh process
    (one CPU device, no ``enable_x64``: its float32 draws): the terminal
    marginal's numbers and the decoded prior's volumes as printed (their
    last digit), and the same verdict."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    flags = ["--num_render", "4", "--seed", "2"]
    proc = subprocess.run([sys.executable, "-m", "arreau_tpu.exploration.vp_prior_check", *flags,
                           "--out_dir", str(tmp_path / "jax")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = proc.stdout
    ok = vp_prior_check.main([*flags, "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    got = capsys.readouterr().out
    assert ok == ("PASS" in want.splitlines())
    np.testing.assert_allclose(_numbers(got, "terminal marginal"),
                               _numbers(want, "terminal marginal"), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_numbers(got, "prior-decoded"), _numbers(want, "prior-decoded"),
                               rtol=0, atol=0.1)


def test_compare_components_draws_the_jax_tools_noise(checkpoints, tmp_path, capsys):
    """``compare_components`` with its own draws (``split(PRNGKey(0),
    n_noise)``, the timestep pinned): every per-term mean on the crystal
    and on its rotation within the loss tolerance of the JAX tool's."""
    jax_dir, port_dir, _ = checkpoints[True]
    with jax.enable_x64(False):  # as the JAX tool runs: int32 timesteps, float32 draws
        want = j_equiv.compare_components(str(jax_dir), data_dir=str(tmp_path), n_noise=4)
    got = verify_equivariance.compare_components(str(port_dir), data_dir=str(tmp_path),
                                                 n_noise=4, device="cpu")
    capsys.readouterr()
    for g, w in zip(got, want):
        assert set(g) == set(w) and {"loss_coord", "loss_type", "loss"} <= set(g)
        for k in w:
            np.testing.assert_allclose(g[k], float(w[k]), **LOSS_TOL, err_msg=k)
