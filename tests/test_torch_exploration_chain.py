"""The port's reverse-chain tools against the JAX package's on the CPU: the
equivariance check's per-component comparison
(``exploration/verify_equivariance.py:compare_components``) and the
sampler diagnosis (``exploration/diagnose_sampler.py``), each reading a
checkpoint that both packages wrote from the same parameters, the Fourier
frequencies carried in ``meta.json`` (the test session's float64 JAX would
otherwise draw others). The JAX tools' random numbers are drawn from their
keys and injected into the port."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.data.crystal import pack_dense_batch as j_pack
from arreau_tpu.exploration import diagnose_sampler as j_diagnose
from arreau_tpu.exploration import verify_equivariance as j_equiv
from arreau_tpu.ops.lattice import sample_bravais_angles as j_bravais
from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import DiffusionModel as JModel
from arreau_tpu.train.checkpoint import CheckpointManager as JCheckpoint
from arreau_tpu.train.checkpoint import diffusion_meta as j_diffusion_meta
from arreau_tpu.train.optim import make_optimizer
from arreau_tpu.train.state import create_train_state
from arreau_tpu_torch.exploration import diagnose_sampler, verify_equivariance
from arreau_tpu_torch.interop.from_jax import save_params_npz
from arreau_tpu_torch.tasks.diffusion import SamplerNoise
from tests.test_torch_model import Z_TABLE, _batch, perturbed_params, tiny_config
from tests.test_torch_train import loss_noise

# float32 losses after the graph, two conv layers and the readouts, averaged
# over the draws; sums in another order than XLA's
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
# chain statistics after 29 float32 reverse steps through the backbone (the
# sampler tests hold the chain's lattice to 1e-4)
CHAIN_TOL = dict(rtol=1e-4, atol=1e-4)
T = 30


def _write_checkpoints(root, diffuse_angles):
    """(JAX checkpoint dir, port checkpoint dir, config): one tiny model's
    perturbed init written by each package (the JAX one through its orbax
    CheckpointManager), with the synthetic z-table (9 classes, so the
    equivariance pair's own 7-class indices stay in range) and the
    frequencies in meta.json."""
    jcfg = tiny_config(diffuse_angles=diffuse_angles, max_neighbors=27 * 8, num_timesteps=T)
    jmodel = JModel(jcfg)
    host = JBatch(*map(jnp.asarray, _batch(4, 8, 0)))
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(0), host))
    meta = j_diffusion_meta(jcfg, Z_TABLE)
    meta["fourier_w"] = [float(w) for w in np.asarray(jmodel.fourier_w, np.float32)]
    JCheckpoint(str(root / "jax"), meta=meta).save(
        create_train_state(jax.tree.map(jnp.asarray, params), make_optimizer(1e-3), 0.999), "best")
    (root / "port" / "best").mkdir(parents=True)
    (root / "port" / "meta.json").write_text(json.dumps(meta))
    save_params_npz(str(root / "port" / "best" / "params.npz"), params)
    return root / "jax", root / "port", jcfg


@pytest.fixture(scope="module")
def diffuse_angles_ckpt(tmp_path_factory):
    """The flagship's setting: the angles diffused, four loss terms."""
    return _write_checkpoints(tmp_path_factory.mktemp("diffuse"), True)


@pytest.fixture(scope="module")
def angles_fixed_ckpt(tmp_path_factory):
    return _write_checkpoints(tmp_path_factory.mktemp("fixed"), False)


def test_compare_components_matches_jax(diffuse_angles_ckpt, tmp_path, capsys):
    """Each loss term on the crystal and on its rotation, averaged over 4
    shared draws: the JAX tool's keys (split(PRNGKey(0), 4)) drawn for the
    port."""
    jax_dir, port_dir, jcfg = diffuse_angles_ckpt
    n = 4
    want = j_equiv.compare_components(str(jax_dir), data_dir=str(tmp_path), n_noise=n)
    want_table = capsys.readouterr().out
    jds, _, _, _ = j_equiv.build_equivariance_datasets(str(tmp_path))
    host = j_pack(jds, np.array([0]), int(jds.packed.num_atoms.max()))
    noises = []
    for key in jax.random.split(jax.random.PRNGKey(0), n):
        noise = loss_noise(key, host, jcfg)
        noise.t = torch.full_like(noise.t, 5)
        noises.append(noise)
    got = verify_equivariance.compare_components(str(port_dir), data_dir=str(tmp_path),
                                                 device="cpu", noises=noises)
    got_table = capsys.readouterr().out
    components = {"loss_coord", "loss_type", "loss_lattice", "loss_angle", "loss"}
    for g, w in zip(got, want):
        assert components <= set(g) and set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], float(w[k]), **LOSS_TOL, err_msg=k)
    # the same table; the gaps of an equivariant model are 0.00% in both
    assert [ln.split()[0] for ln in got_table.splitlines() if ln.startswith("loss")] == [
        ln.split()[0] for ln in want_table.splitlines() if ln.startswith("loss")]
    assert all(ln.split()[3] == "0.00%" for ln in got_table.splitlines() if ln.startswith("loss"))


def _diagnose_noise(jcfg, B, A, seed) -> SamplerNoise:
    """The numbers the JAX diagnosis draws: split(PRNGKey(seed), 4) for the
    prior, then per step one split of the carried key into four."""
    f32 = jnp.float32
    key = jax.random.PRNGKey(seed)
    k_ang, k_len, k_frac, key = jax.random.split(key, 4)
    steps = {"lattice": [], "angle": [], "pos": [], "types": []}
    for _ in range(jcfg.num_timesteps - 1):
        key, sub = jax.random.split(key)
        k_lat, k_pos, k_type, k_ang2 = jax.random.split(sub, 4)
        steps["lattice"].append(jax.random.normal(k_lat, (B, 3), f32))
        steps["angle"].append(jax.random.normal(k_ang2, (B, 6), f32))
        steps["pos"].append(jax.random.normal(k_pos, (B, A, 3), f32))
        steps["types"].append(jax.random.uniform(k_type, (B, A, jcfg.num_atomic_states), f32,
                                                 minval=0.0, maxval=1.0))

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    if jcfg.diffuse_angles:
        angles, ang_enc0 = None, t(jax.random.normal(k_ang, (B, 6), f32))
    else:
        angles, ang_enc0 = t(j_bravais(k_ang, "monoclinic", B)), torch.zeros((B, 6))
    return SamplerNoise(angles=angles, ang_enc0=ang_enc0,
                        lengths0=t(jax.random.normal(k_len, (B, 3), f32)),
                        frac0=t(jax.random.normal(k_frac, (B, A, 3), f32)),
                        **{k: t(jnp.stack(v)) for k, v in steps.items()})


@pytest.mark.parametrize("ckpt", ["angles_fixed_ckpt", "diffuse_angles_ckpt"])
def test_diagnose_sampler_records_match_jax(ckpt, request, tmp_path, capsys):
    """The dense chain (29 steps), recorded every 10: each record's chain
    and x0-prediction statistics and forward marginal against the JAX
    tool's, from its own draws; the JSON files hold the same keys."""
    jax_dir, port_dir, jcfg = request.getfixturevalue(ckpt)
    B, A = 4, 5
    common = ["--ref", "synthetic:300:0", "--num_samples", str(B), "--num_atoms_per_sample",
              str(A), "--record_every", "10"]
    want = j_diagnose.main(["--checkpoint_dir", str(jax_dir), *common,
                            "--out", str(tmp_path / "jax.json")])
    got = diagnose_sampler.main(["--checkpoint_dir", str(port_dir), *common, "--device", "cpu",
                                 "--out", str(tmp_path / "port.json")],
                                noise=_diagnose_noise(jcfg, B, A, seed=0))
    capsys.readouterr()
    assert [r["t"] for r in got] == [r["t"] for r in want] == [28, 19, 9, 0]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], **CHAIN_TOL, err_msg=f"t={w['t']} {k}")
    jfile, pfile = (json.loads((tmp_path / f).read_text()) for f in ("jax.json", "port.json"))
    assert jfile.keys() == pfile.keys()
    np.testing.assert_allclose([pfile["l0_mean"], pfile["l0_var"]],
                               [jfile["l0_mean"], jfile["l0_var"]], rtol=1e-12)
