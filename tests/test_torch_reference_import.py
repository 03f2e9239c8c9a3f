"""The port's importer of reference (PyTorch Lightning) PONITA_DIFFUSION
checkpoints (``arreau_tpu_torch/interop/torch_import.py`` and
``cli/import_checkpoint.py``) against the JAX package's, on the CPU.

The checkpoints are the ones the JAX package's own importer test builds
from real ``torch.nn`` modules with the reference's key names
(``tests/test_torch_import.py``: ``_make_state_dict``, ``_reference_args``,
``_write_ckpt``). The converted tree must equal the JAX converter's bit for
bit, and the imported model must compute the JAX import's scores."""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.cli import import_checkpoint as j_cli
from arreau_tpu.cli.generate import load_model as j_load_model
from arreau_tpu.interop import torch_import as jimp
from arreau_tpu_torch.cli import generate, import_checkpoint
from arreau_tpu_torch.data.synthetic import random_lattices
from arreau_tpu_torch.interop import torch_import as imp
from arreau_tpu_torch.interop.from_jax import _flatten, load_params_npz, params_to_jax
from tests.test_torch_exploration import argument_set
from tests.test_torch_import import H, L, S, _make_state_dict, _reference_args, _write_ckpt
from tests.test_torch_model import F32_MODEL


def _sd():
    return {k: v.numpy() for k, v in _make_state_dict().items()}


def test_converted_tree_equals_jax_bit_for_bit():
    sd = _sd()
    want, want_w, want_z = jimp.convert_state_dict(sd, L)
    got, got_w, got_z = imp.convert_state_dict(sd, L)
    flat_w, flat_g = _flatten(want), _flatten(got)
    assert flat_g.keys() == flat_w.keys()
    for key, value in flat_w.items():
        assert flat_g[key].dtype == value.dtype, key
        np.testing.assert_array_equal(flat_g[key], value, err_msg=key)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(got_z, want_z)
    # the conv kernel: the reference's nn.Linear(BD, H) weight [H, BD], once transposed
    np.testing.assert_array_equal(got["params"]["layer_0"]["conv"]["kernel"],
                                  sd["model.interaction_layers.0.conv.kernel.weight"].T)
    assert "edge_readout_0" not in got["params"]  # zero-width edge readouts dropped


def test_tolerant_load_and_args(tmp_path):
    """A checkpoint that pickles a class this process cannot import loads;
    the hyper-parameters and the buffers come through."""
    path = _write_ckpt(str(tmp_path / "ref.ckpt"))
    sd, args = imp.load_reference_checkpoint(path)
    want_sd, want_args = jimp.load_reference_checkpoint(path)
    assert args == want_args and args["hidden_dim"] == H and args["layers"] == L
    assert sd.keys() == want_sd.keys()
    for key in sd:
        np.testing.assert_array_equal(sd[key], want_sd[key], err_msg=key)
    assert list(sd["z_table_zs"]) == [1, 6, 8, 14, 2001]
    cfg = imp.config_from_reference_args(args, num_atomic_states=S)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jimp.config_from_reference_args(want_args, num_atomic_states=S))
    # a bare state_dict file: no hyper-parameters
    torch.save(_make_state_dict(), str(tmp_path / "bare.pt"))
    assert imp.load_reference_checkpoint(str(tmp_path / "bare.pt"))[1] == {}


def test_missing_key_raises_key_error_naming_it():
    sd = _sd()
    del sd["model.interaction_layers.1.norm.weight"]
    with pytest.raises(KeyError, match="interaction_layers.1.norm"):
        imp.convert_state_dict(sd, L)


def test_shape_mismatch_raises_value_error(tmp_path):
    """Hyper-parameters that do not fit the weights: the JAX importer's
    ValueError, not torch's load_state_dict error."""
    path = str(tmp_path / "wide.ckpt")
    torch.save({"state_dict": _make_state_dict(),
                "hyper_parameters": {"args": argparse.Namespace(
                    **{**vars(_reference_args()), "hidden_dim": 2 * H})}}, path)
    with pytest.raises(ValueError, match="converted parameter tree does not match the model "
                                         "built from the checkpoint's hyper-parameters"):
        imp.convert_reference_checkpoint(path, str(tmp_path / "out"))


def test_import_cli_then_generate(tmp_path, capsys):
    """The CLI writes a port checkpoint (meta with the Fourier frequencies and
    the z-table, params.npz equal to the converted tree, ema_params.npz equal
    to params.npz); the port's generate samples from it, the same crystals
    with and without --use_ema."""
    path = _write_ckpt(str(tmp_path / "ref.ckpt"))
    out = tmp_path / "imported"
    meta = import_checkpoint.main(["--ckpt", path, "--out_dir", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"imported {path} -> {out}/best (hidden {H}, basis")
    assert lines[1] == (f"generate with: python -m arreau_tpu_torch.cli.generate "
                        f"--checkpoint_dir {out} --tag best")
    assert meta["z_table_zs"] == [1, 6, 8, 14, 2001] and len(meta["fourier_w"]) == 32
    assert json.loads((out / "meta.json").read_text()) == json.loads(
        (out / "best" / "meta.json").read_text())

    params = _flatten(load_params_npz(str(out / "best" / "params.npz")))
    ema = _flatten(load_params_npz(str(out / "best" / "ema_params.npz")))
    want = _flatten(jimp.convert_state_dict(_sd(), L)[0])
    assert params.keys() == ema.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(params[key], value.astype(np.float32), err_msg=key)
        np.testing.assert_array_equal(ema[key], params[key], err_msg=key)

    model, z_table, _ = generate.load_model(str(out), "best", True, "cpu")
    np.testing.assert_array_equal(model.fourier_w.numpy(),
                                  np.asarray(meta["fourier_w"], np.float32))
    assert list(z_table.zs) == [1, 6, 8, 14, 2001]
    results = {}
    for use_ema in ("true", "false"):
        results[use_ema] = generate.main([
            "--device", "cpu", "--checkpoint_dir", str(out), "--tag", "best", "--use_ema", use_ema,
            "--num_crystals", "3", "--batch_size", "3", "--num_atoms_per_sample", "4",
            "--sample_steps", "4", "--out_dir", str(tmp_path / f"gen_{use_ema}")])
    a, b = results["true"], results["false"]
    assert a.frac_x.shape == (12, 3) and np.isfinite(a.lattice).all()
    for field in ("frac_x", "atomic_numbers", "lattice"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_imported_scores_match_the_jax_import(tmp_path):
    """predict_scores of the port's import against the JAX package's on its
    own import of the same .ckpt (its orbax checkpoint, read by its
    generate loader), on 6 crystals of up to 4 atoms (padding included).
    Both metas get max_neighbors 27 * A, so that the graph cannot depend on
    the order of equidistant images."""
    path = _write_ckpt(str(tmp_path / "ref.ckpt"))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    imp.convert_reference_checkpoint(path, str(port_dir))
    jimp.convert_reference_checkpoint(path, str(jax_dir))
    B, A = 6, 4
    for meta_path in (port_dir / "meta.json", jax_dir / "meta.json"):
        meta = json.loads(meta_path.read_text())
        meta["config"]["max_neighbors"] = 27 * A
        meta_path.write_text(json.dumps(meta))

    rng = np.random.default_rng(0)
    lattice = random_lattices(rng, B).astype(np.float32)
    frac = rng.uniform(size=(B, A, 3)).astype(np.float32)
    num_atoms = np.array([4, 3, 2, 4, 1, 3])
    mask = np.arange(A)[None, :] < num_atoms[:, None]
    onehot = np.eye(S, dtype=np.float32)[np.where(mask, rng.integers(0, S - 1, (B, A)), 0)]
    t = rng.integers(1, 21, size=B)
    lengths = np.linalg.norm(lattice, axis=-1).astype(np.float32)
    angles = np.deg2rad(rng.uniform(80, 100, size=(B, 3))).astype(np.float32)
    inputs = (frac, onehot, t, num_atoms, lengths, angles, mask)

    jmodel, jparams, _ = j_load_model(str(jax_dir), "best", use_ema=False)
    want = jax.jit(jmodel.predict_scores)(jparams, *map(jnp.asarray, inputs))
    model, _, _ = generate.load_model(str(port_dir), "best", False, "cpu")
    assert model.config.max_neighbors == 27 * A
    flat_j = _flatten(jax.tree.map(np.asarray, jparams))
    for key, value in _flatten(params_to_jax(model.model)).items():
        np.testing.assert_array_equal(value, flat_j[key], err_msg=key)
    with torch.no_grad():
        got = model.predict_scores(*map(torch.tensor, inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_MODEL)


def test_cli_arguments_match_jax():
    assert argument_set(import_checkpoint.parse_args) == argument_set(j_cli.parse_args)
