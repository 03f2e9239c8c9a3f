"""The PyTorch port's sampler slice against the JAX package on the CPU:
the reverse chains with the same weights and the same random numbers, the
crystals file, and the generate CLI.

The JAX sampler draws from ``jax.random`` keys; the test draws the same
numbers from the same keys (the splits ``DiffusionModel._sample_impl``
makes) and injects them into the port through ``SamplerNoise``."""

import dataclasses
import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.inference.io import SampleResult as JResult
from arreau_tpu.inference.io import from_dense_batch as j_from_dense_batch
from arreau_tpu.inference.io import save_sample_results as j_save
from arreau_tpu.ops.lattice import sample_bravais_angles
from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import DiffusionModel as JModel
from arreau_tpu_torch.cli import generate
from arreau_tpu_torch.data.atoms import synthetic_z_table as port_z_table
from arreau_tpu_torch.inference.io import (
    SampleResult,
    from_dense_batch,
    load_sample_results,
    save_sample_results,
)
from arreau_tpu_torch.interop.from_jax import params_from_jax, save_params_npz
from arreau_tpu_torch.tasks.diffusion import (
    CrystalBatch,
    DiffusionModel,
    SamplerNoise,
    strided_levels,
)
from tests.test_torch_model import Z_TABLE, _batch, perturbed_params, port_config, tiny_config

B, A = 4, 5
LENGTH_BOUNDS = (0.5, 10.5)


def jax_model_and_params(seed=0):
    jmodel = JModel(tiny_config())
    host = _batch(B, A, seed)
    host = JBatch(*map(jnp.asarray, host))
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), host))
    return jmodel, params


def jax_noise(key, num_steps, C, B=B, A=A):
    """The numbers ``_sample_impl`` draws from ``key`` for ``B`` crystals of
    ``A`` atoms (angles fixed), as a SamplerNoise."""
    f32 = jnp.float32
    k_ang, k_len, k_frac, k_loop = jax.random.split(key, 4)
    steps = {"lattice": [], "angle": [], "pos": [], "types": []}
    for _ in range(num_steps):
        k_loop, k_lat, k_pos, k_type, k_ang2 = jax.random.split(k_loop, 5)
        steps["lattice"].append(jax.random.normal(k_lat, (B, 3), f32))
        steps["angle"].append(jax.random.normal(k_ang2, (B, 6), f32))
        steps["pos"].append(jax.random.normal(k_pos, (B, A, 3), f32))
        steps["types"].append(jax.random.uniform(k_type, (B, A, C), f32, minval=0.0, maxval=1.0))

    def t(x):
        return torch.tensor(np.asarray(x))

    return SamplerNoise(
        angles=t(sample_bravais_angles(k_ang, "monoclinic", B).astype(f32)),
        ang_enc0=torch.zeros((B, 6)),
        lengths0=t(jax.random.normal(k_len, (B, 3), f32)),
        frac0=t(jax.random.normal(k_frac, (B, A, 3), f32)),
        **{k: t(jnp.stack(v)) for k, v in steps.items()},
    )


def run_both(sample_steps, ddim_eta, type_temperature, seed):
    """(JAX batch, port batch, JAX type logits of the last step)."""
    jmodel, params = jax_model_and_params(seed)
    seen = []
    predict = jmodel.predict_scores

    def recording(*args):  # keeps the type logits of every step, in order
        out = predict(*args)
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), out[1], ordered=True)
        return out

    jmodel.predict_scores = recording
    key = jax.random.PRNGKey(seed + 10)
    kw = dict(length_bounds=LENGTH_BOUNDS, type_temperature=type_temperature,
              sample_steps=sample_steps, ddim_eta=ddim_eta)
    want = jmodel._sample_impl(params, key, B, A, **kw)
    T = jmodel.config.num_timesteps
    S = len(strided_levels(T, sample_steps)) - 1 if sample_steps else T - 1
    model = DiffusionModel(port_config(jmodel.config), device="cpu", fourier_w=np.asarray(jmodel.fourier_w))
    params_from_jax(model, params)
    with torch.no_grad():
        got = model._sample_impl(B, A, noise=jax_noise(key, S, len(Z_TABLE)), **kw)
    return want, got, seen[-1]


def assert_same_crystals(want, got, logits):
    # positions on the circle: mod 1 may wrap a coordinate at 0 to 1 - ulp
    d = np.abs(got.frac_x.numpy() - np.asarray(want.frac_x))
    assert np.minimum(d, 1 - d).max() < 1e-4
    np.testing.assert_allclose(got.lattice.numpy(), np.asarray(want.lattice), rtol=1e-4, atol=1e-4)
    # types where the JAX decision is not a near-tie of its two best logits
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 1e-4
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got.atom_types.numpy()[decided], np.asarray(want.atom_types)[decided])


def test_strided_chain_matches_jax():
    """The sampler slice: 3 strided DDIM steps, eta 0, argmax types,
    same prior. Positions and lattice agree to float32 rounding carried
    through three forwards of the backbone (1e-4); types agree exactly
    wherever JAX's top-2 logit margin exceeds 1e-4."""
    want, got, logits = run_both(sample_steps=3, ddim_eta=0.0, type_temperature=0.0, seed=0)
    assert_same_crystals(want, got, logits)
    assert torch.equal(got.num_atoms, torch.full((B,), A)) and bool(got.atom_mask.all())


@pytest.mark.parametrize("sample_steps", [4, None])
def test_stochastic_chains_match_jax(sample_steps):
    """The strided chain with ancestral noise (eta 1) and the dense 49-step
    reference chain, both with gumbel type draws (temperature 1): every
    per-step draw injected from the JAX keys."""
    want, got, logits = run_both(sample_steps, ddim_eta=1.0, type_temperature=1.0, seed=1)
    assert_same_crystals(want, got, logits)


def test_crystals_file_holds_the_h5_datasets(tmp_path):
    """Port's crystals.h5 and the JAX crystals.h5 of the same result hold the
    same datasets, with the same values and types, as h5py reads them."""
    rng = np.random.default_rng(0)
    mask = np.arange(A)[None, :] < np.array([5, 3, 4, 1])[:, None]
    dense = dict(
        frac_x=rng.uniform(size=(B, A, 3)).astype(np.float32),
        atom_types=rng.integers(0, len(Z_TABLE), size=(B, A)),
        lattice=rng.normal(size=(B, 3, 3)).astype(np.float32),
        num_atoms=mask.sum(1),
        atom_mask=mask,
    )
    jres = j_from_dense_batch(JBatch(**dense), Z_TABLE)
    res = from_dense_batch(CrystalBatch(**{k: torch.as_tensor(v) for k, v in dense.items()}),
                           port_z_table())
    j_save(str(tmp_path / "crystals.h5"), jres)
    save_sample_results(str(tmp_path / "port.h5"), res)
    with h5py.File(tmp_path / "crystals.h5", "r") as f, h5py.File(tmp_path / "port.h5", "r") as g:
        assert list(g) == list(f) == ["crystals"]
        assert set(f["crystals"].keys()) == set(g["crystals"].keys())
        for name in g["crystals"]:
            assert g["crystals"][name].dtype == f["crystals"][name].dtype, name
            np.testing.assert_array_equal(g["crystals"][name][:], f["crystals"][name][:])
    back = load_sample_results(str(tmp_path / "port.h5"))
    assert isinstance(back, SampleResult) and back.num_crystals == B
    assert isinstance(jres, JResult)


def write_checkpoint(path, jmodel, params, **meta_extra):
    """``meta.json`` at ``path`` and the parameters under the tag ``last``,
    the layout generate reads (``--checkpoint_dir path``, default tag)."""
    (path / "last").mkdir(parents=True)
    meta = {"config": dataclasses.asdict(jmodel.config), "z_table_zs": list(map(int, Z_TABLE.zs)),
            **meta_extra}
    (path / "meta.json").write_text(json.dumps(meta))
    save_params_npz(str(path / "last" / "params.npz"), params)


def test_generate_cli_on_cpu(tmp_path, capsys):
    jmodel, params = jax_model_and_params()
    write_checkpoint(tmp_path / "ckpt", jmodel, params, length_stats={"min": 3.0, "max": 8.0},
                     fourier_w=np.asarray(jmodel.fourier_w).tolist())
    out = tmp_path / "out"
    result = generate.main(["--checkpoint_dir", str(tmp_path / "ckpt"), "--device", "cpu",
                            "--num_crystals", "5", "--batch_size", "3", "--num_atoms_per_sample", "4",
                            "--sample_steps", "3", "--out_dir", str(out)])
    printed = capsys.readouterr().out
    assert "sampler throughput:" in printed and "cpu)" in printed
    saved = load_sample_results(str(out / "crystals.h5"))
    assert saved.num_crystals == result.num_crystals == 5
    assert np.all(saved.num_atoms == 4) and np.isfinite(saved.lattice).all()
    lengths = np.linalg.norm(saved.lattice, axis=-1)  # clip_denoised: 3 - 2.5 .. 8 + 2.5
    assert lengths.min() >= 0.5 - 1e-4 and lengths.max() <= 10.5 + 1e-4

    pinned = generate.main(["--checkpoint_dir", str(tmp_path / "ckpt"), "--device", "cpu",
                            "--num_crystals", "2", "--batch_size", "2", "--sample_steps", "2",
                            "--constant_atomic_symbols", "C,O,O", "--out_dir", str(out)])
    np.testing.assert_array_equal(pinned.atomic_numbers, [6, 8, 8, 6, 8, 8])


def test_generate_data_parallel_on_one_device_samples_as_without(tmp_path):
    """``--data_parallel true`` (the JAX CLI's default) on one device samples
    there, as the JAX CLI does when it sees one device: the same crystals
    as ``--data_parallel false`` under one seed."""
    jmodel, params = jax_model_and_params()
    write_checkpoint(tmp_path / "ckpt", jmodel, params,
                     fourier_w=np.asarray(jmodel.fourier_w).tolist())
    results = {}
    for flag in ("true", "false"):
        out = tmp_path / f"out_{flag}"
        generate.main(["--checkpoint_dir", str(tmp_path / "ckpt"), "--device", "cpu",
                       "--num_crystals", "3", "--batch_size", "3", "--num_atoms_per_sample", "4",
                       "--sample_steps", "3", "--seed", "7", "--data_parallel", flag,
                       "--out_dir", str(out)])
        results[flag] = vars(load_sample_results(str(out / "crystals.h5")))
    assert results["true"].keys() == results["false"].keys()
    for name in results["true"]:
        np.testing.assert_array_equal(results["true"][name], results["false"][name], err_msg=name)
    assert results["true"]["num_atoms"].sum() == 12
