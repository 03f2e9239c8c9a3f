"""The port's exploration tools (``arreau_tpu_torch/exploration/``) and the
training CLI's ``--dataset eval-equivariance`` against the JAX package's, on
the CPU.

The tools that draw random numbers take them injected: the tests draw the
numbers the JAX tool draws from its keys (the splits its code makes) and
hand them to the port, as ``tests/test_torch_sampler.py`` does. The two
tools that run the model on a checkpoint are held to JAX in
``tests/test_torch_exploration_chain.py``."""

import argparse
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.data.crystal import write_packed_h5 as j_write_packed_h5
from arreau_tpu.data.synthetic import synthetic_packed as j_synthetic_packed
from arreau_tpu.exploration import dataset_stats as j_dataset_stats
from arreau_tpu.exploration import diagnose_sampler as j_diagnose
from arreau_tpu.exploration import lattice_eda as j_lattice_eda
from arreau_tpu.exploration import verify_equivariance as j_equiv
from arreau_tpu.exploration import view_crystals as j_view
from arreau_tpu.exploration import vp_prior_check as j_vp_prior
from arreau_tpu.inference.io import SampleResult as JResult
from arreau_tpu.inference.io import save_sample_results as j_save
from arreau_tpu.ops.lattice import sample_bravais_angles as j_bravais
from arreau_tpu_torch.cli import train_diffusion
from arreau_tpu_torch.data.synthetic import synthetic_packed
from arreau_tpu_torch.exploration import (
    dataset_stats,
    diagnose_sampler,
    lattice_eda,
    verify_equivariance,
    view_crystals,
    vp_prior_check,
)
from arreau_tpu_torch.inference.io import SampleResult, save_sample_results

# ---------------- argument sets ----------------


class _Parsed(Exception):
    pass


def _actions(parser) -> dict:
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        if isinstance(a, argparse._SubParsersAction):
            out.update({f"{name}:": _actions(sub) for name, sub in a.choices.items()})
            continue
        out[a.dest] = (tuple(a.option_strings), a.default, getattr(a.type, "__name__", a.type),
                       a.choices, a.nargs, a.required)
    return out


def argument_set(entry, argv=()) -> dict:
    """{dest: (flags, default, type name, choices, nargs, required)} of the
    parser ``entry(argv)`` builds, caught at its ``parse_args`` (nothing
    after it runs)."""
    parsers = []

    def grab(self, args=None, namespace=None):
        parsers.append(self)
        raise _Parsed

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        entry(list(argv))
    except _Parsed:
        pass
    finally:
        argparse.ArgumentParser.parse_args = original
    return _actions(parsers[0])


@pytest.mark.parametrize("tool", ["dataset_stats", "diagnose_sampler", "lattice_eda",
                                  "view_crystals", "vp_prior_check"])
def test_tool_arguments_match_jax(tool):
    """The port's flags are the JAX tool's, ``--device`` apart."""
    port = {"dataset_stats": dataset_stats.main, "diagnose_sampler": diagnose_sampler.parse_args,
            "lattice_eda": lattice_eda.main, "view_crystals": view_crystals.main,
            "vp_prior_check": vp_prior_check.main}[tool]
    jax_tool = {"dataset_stats": j_dataset_stats.main, "diagnose_sampler": j_diagnose.parse_args,
                "lattice_eda": j_lattice_eda.main, "view_crystals": j_view.main,
                "vp_prior_check": j_vp_prior.main}[tool]
    got, want = argument_set(port), argument_set(jax_tool)
    if tool in ("diagnose_sampler", "lattice_eda", "vp_prior_check"):
        assert got.pop("device") == (("--device",), "cuda", "str", None, None, False)
    assert got == want


def test_verify_equivariance_takes_only_device():
    """The JAX tool's ``main()`` takes no arguments; the port's adds ``--device``."""
    assert argument_set(verify_equivariance.main) == {
        "device": (("--device",), "cuda", "str", None, None, False)}


@pytest.mark.parametrize("tool, argv", [
    ("diagnose_sampler", ["--checkpoint_dir", "ckpt"]),
    ("verify_equivariance", []),
    ("vp_prior_check", []),
    ("lattice_eda", []),
])
def test_cuda_default_raises_without_cuda(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the CUDA path runs instead of raising")
    module = {"diagnose_sampler": diagnose_sampler, "verify_equivariance": verify_equivariance,
              "vp_prior_check": vp_prior_check, "lattice_eda": lattice_eda}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


def alexandria_dir(path, n=120, seed=5):
    """``path`` holding a packed shard ``alexandria_ps_000.h5`` of ``n``
    synthetic crystals, written by the JAX package (h5py), and a take-10
    shard the full-dataset paths must skip."""
    packed = j_synthetic_packed(n, seed=seed).packed
    j_write_packed_h5(str(path / "alexandria_ps_000.h5"), packed)
    j_write_packed_h5(str(path / "alexandria_ps_000_take10.h5"),
                      j_synthetic_packed(10, seed=seed + 1).packed)
    return packed


@pytest.mark.parametrize("tool", ["dataset_stats", "lattice_eda", "vp_prior_check",
                                  "view_crystals", "diagnose_sampler"])
def test_hdf5_paths_match_jax(tool, tmp_path, capsys):
    """Each tool's HDF5 input (``--data_dir``, ``--dataset alexandria``,
    ``--ref <shard>``) on shards the JAX package wrote: what the port
    prints, renders or returns is the JAX tool's on the same shards."""
    data = tmp_path / "data"
    data.mkdir()
    packed = alexandria_dir(data)
    if tool == "dataset_stats":  # every *.h5 under --data_dir, the take-10 shard too
        j_dataset_stats.main(["--data_dir", str(data)])
        want = capsys.readouterr().out
        stats = dataset_stats.main(["--data_dir", str(data)])
        assert capsys.readouterr().out == want and stats["num_crystals"] == 130
    elif tool == "lattice_eda":
        j_lattice_eda.main(["--dataset", "alexandria", "--data_dir", str(data),
                            "--out_dir", str(tmp_path / "jax"), "--num_render", "1"])
        want = capsys.readouterr().out
        stats = lattice_eda.main(["--dataset", "alexandria", "--data_dir", str(data), "--out_dir",
                                  str(tmp_path / "port"), "--num_render", "1", "--device", "cpu"])
        got = capsys.readouterr().out
        assert got.splitlines()[0] == want.splitlines()[0] and len(stats["natoms"]) == 120
        assert _stat_lines(got) == _stat_lines(want) and len(_stat_lines(want)) == 8
    elif tool == "vp_prior_check":
        n = 3
        j_vp_prior.main(["--dataset", "alexandria", "--data_dir", str(data), "--out_dir",
                         str(tmp_path / "jax"), "--num_render", str(n)])
        want = capsys.readouterr().out
        kd, ka = jax.random.split(jax.random.PRNGKey(1))

        def t(x):
            return torch.tensor(np.asarray(x, np.float32))

        noise = vp_prior_check.VPPriorNoise(
            forward=t(jax.random.normal(jax.random.PRNGKey(0), (120, 3), jnp.float32)),
            prior=t(jax.random.normal(kd, (n, 3))), angles=t(j_bravais(ka, "monoclinic", n)))
        vp_prior_check.main(["--dataset", "alexandria", "--data_dir", str(data), "--out_dir",
                             str(tmp_path / "port"), "--num_render", str(n), "--device", "cpu"],
                            noise=noise)
        got = capsys.readouterr().out
        [w], [g] = ([ln for ln in text.splitlines() if ln.startswith("terminal marginal")]
                    for text in (want, got))
        np.testing.assert_allclose(*(
            [float(x) for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]\d+)?", line)]
            for line in (g, w)), rtol=0, atol=1.5e-4)
    elif tool == "view_crystals":  # the first --max_shards of every *.h5, sorted
        runs = {}
        for name, main in (("jax", j_view.main), ("port", view_crystals.main)):
            out = tmp_path / name
            assert main(["dataset", "--data_dir", str(data), "--num", "3", "--out_dir",
                         str(out)]) == 3
            runs[name] = capsys.readouterr().out.replace(str(out), "OUT")
            assert sorted(p.name for p in out.iterdir()) == ["0.png", "1.png", "2.png"]
        assert runs["port"] == runs["jax"] and "sample 2 (" not in runs["port"]
    else:
        from arreau_tpu.data.crystal import CrystalDataset as JDataset
        from arreau_tpu.inference.quality import lattice_params_np as j_lattice_params_np

        shard = str(data / "alexandria_ps_000.h5")
        lengths, _ = j_lattice_params_np(JDataset([shard]).packed.lattices)
        assert diagnose_sampler.reference_lengths(shard) == (float(lengths.mean()),
                                                             float(lengths.var()))
        np.testing.assert_array_equal(lengths, j_lattice_params_np(packed.lattices)[0])


# ---------------- host tools ----------------


def test_compute_stats_matches_jax(capsys):
    ds = synthetic_packed(300, seed=0)
    assert dataset_stats.compute_stats(ds.packed) == j_dataset_stats.compute_stats(ds.packed)
    j_dataset_stats.main(["--synthetic_size", "300"])
    want = capsys.readouterr().out
    dataset_stats.main(["--synthetic_size", "300"])
    assert capsys.readouterr().out == want


def test_view_crystals_matches_jax(tmp_path, capsys):
    """Both modes render what the JAX viewer renders (the port reads the
    port's crystals.h5, the JAX viewer the JAX package's of the same
    crystals) and print the same lines."""
    rng = np.random.default_rng(0)
    fields = dict(frac_x=rng.uniform(size=(7, 3)), atomic_numbers=np.array([1, 6, 8, 8, 14, 6, 1]),
                  lattice=np.stack([np.eye(3) * 4.0, np.eye(3) * 5.0]),
                  idx_start=np.array([0, 4]), num_atoms=np.array([4, 3]))
    j_save(str(tmp_path / "crystals.h5"), JResult(**fields))
    save_sample_results(str(tmp_path / "port.h5"), SampleResult(**fields))
    runs = {}
    for name, main, crystals in (("jax", j_view.main, "crystals.h5"),
                                 ("port", view_crystals.main, "port.h5")):
        out = tmp_path / name
        assert main(["generated", "--crystal_file", str(tmp_path / crystals), "--index", "0", "1",
                     "--shift", "0.1", "0.2", "0.3", "--out_dir", str(out / "gen")]) == 2
        assert main(["dataset", "--dataset", "synthetic", "--num", "2",
                     "--out_dir", str(out / "data")]) == 2
        runs[name] = capsys.readouterr().out.replace(str(out), "OUT")
        assert sorted(p.name for p in out.rglob("*.png")) == [
            "0.png", "1.png", "generated_0.png", "generated_1.png"]
    assert runs["port"] == runs["jax"]


def _stat_lines(text: str) -> dict:
    pattern = r"^(\w+)\s+mean\s+(\S+)\s+std\s+(\S+)\s+p1\s+(\S+)\s+median\s+(\S+)\s+p99\s+(\S+)$"
    return {m.group(1): [float(x) for x in m.groups()[1:]]
            for m in re.finditer(pattern, text, re.MULTILINE)}


def test_lattice_eda_statistics_match_jax(tmp_path, capsys):
    """Every printed statistic of the port (lattice parameters on the
    device, float64) equals the JAX tool's within its last printed digit."""
    j_lattice_eda.main(["--out_dir", str(tmp_path / "jax"), "--num_render", "1"])
    want_text = capsys.readouterr().out
    stats = lattice_eda.main(["--out_dir", str(tmp_path / "port"), "--num_render", "1",
                              "--device", "cpu"])
    got_text = capsys.readouterr().out
    assert got_text.splitlines()[0] == want_text.splitlines()[0]  # counts
    want, got = _stat_lines(want_text), _stat_lines(got_text)
    assert list(got) == list(want) == ["length_a", "length_b", "length_c", "alpha", "beta",
                                       "gamma", "volume", "density"]
    for name, values in want.items():
        x = stats[name]
        exact = [x.mean(), x.std(), *np.percentile(x, [1, 50, 99])]
        np.testing.assert_allclose(exact, values, rtol=0, atol=5e-4 + 1e-9, err_msg=name)
        assert got[name] == values, name
    assert (tmp_path / "port" / "lattice_eda.png").exists()
    assert (tmp_path / "port" / "example_cell_0.png").exists()


def test_vp_prior_check_matches_jax(tmp_path, capsys):
    """The terminal marginal and the decoded prior's volumes from the JAX
    tool's own draws: the forward chain's normals from PRNGKey(seed), the
    prior's from PRNGKey(seed + 1)."""
    n = 4
    assert j_vp_prior.main(["--out_dir", str(tmp_path / "jax"), "--num_render", str(n)]) is True
    want = capsys.readouterr().out
    kd, ka = jax.random.split(jax.random.PRNGKey(1))
    lattices = synthetic_packed(2000, seed=0).packed.lattices

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    noise = vp_prior_check.VPPriorNoise(
        forward=t(jax.random.normal(jax.random.PRNGKey(0), (len(lattices), 3), jnp.float32)),
        prior=t(jax.random.normal(kd, (n, 3))),
        angles=t(j_bravais(ka, "monoclinic", n)))
    assert vp_prior_check.main(["--out_dir", str(tmp_path / "port"), "--num_render", str(n),
                                "--device", "cpu"], noise=noise) is True
    got = capsys.readouterr().out

    def numbers(text, line_start):
        [line] = [ln for ln in text.splitlines() if ln.startswith(line_start)]
        return [float(x) for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]\d+)?", line)]

    np.testing.assert_allclose(numbers(got, "terminal marginal"), numbers(want, "terminal marginal"),
                               rtol=0, atol=1.5e-4)
    np.testing.assert_allclose(numbers(got, "prior-decoded"), numbers(want, "prior-decoded"),
                               rtol=0, atol=0.15)
    assert "PASS" in got.splitlines()
    assert len(list((tmp_path / "port").glob("vp_prior_lattice_*.png"))) == n


# ---------------- the equivariance check ----------------


def test_build_equivariance_datasets_matches_jax(tmp_path):
    ds, splits, z_table, t = verify_equivariance.build_equivariance_datasets(str(tmp_path))
    jds, jsplits, jz, jt = j_equiv.build_equivariance_datasets(str(tmp_path))
    assert t == jt == train_diffusion.EVAL_EQUIVARIANCE_TIMESTEP == 5
    assert list(z_table.zs) == list(jz.zs)
    for field in ("atomic_numbers", "frac_coords", "offsets", "lattices"):
        np.testing.assert_array_equal(getattr(ds.packed, field), getattr(jds.packed, field))
    np.testing.assert_array_equal(ds.type_indices, jds.type_indices)
    assert splits.keys() == jsplits.keys()
    for k in splits:
        np.testing.assert_array_equal(splits[k], jsplits[k])
    # crystal 1 is crystal 0 turned 90 degrees about z
    a, b = ds.packed.lattices
    np.testing.assert_allclose(b, a @ np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]]), atol=1e-12)


def test_build_equivariance_datasets_reads_the_shard(tmp_path, capsys):
    """Where the take-10 shard exists, both tools check its first crystal:
    the same datasets, splits and z-table as the JAX tool's, and the
    training CLI's ``--dataset eval-equivariance`` trains on it."""
    j_write_packed_h5(str(tmp_path / "alexandria_ps_000_take10.h5"),
                      j_synthetic_packed(10, seed=9).packed)
    ds, splits, z_table, t = verify_equivariance.build_equivariance_datasets(str(tmp_path))
    jds, jsplits, jz, jt = j_equiv.build_equivariance_datasets(str(tmp_path))
    assert t == jt and list(z_table.zs) == list(jz.zs)
    for field in ("atomic_numbers", "frac_coords", "offsets", "lattices"):
        np.testing.assert_array_equal(getattr(ds.packed, field), getattr(jds.packed, field))
    np.testing.assert_array_equal(ds.type_indices, jds.type_indices)
    assert all(np.array_equal(splits[k], jsplits[k]) for k in jsplits)
    first = j_synthetic_packed(10, seed=9).packed
    np.testing.assert_array_equal(ds.packed.lattices[0], first.lattices[0])
    loss = train_diffusion.main([
        "--device", "cpu", "--dataset", "eval-equivariance", "--data_dir", str(tmp_path),
        "--epochs", "2", "--val_interval", "2", "--num_timesteps", "300", "--batch_size", "4",
        "--hidden_dim", "16", "--basis_dim", "8", "--layers", "2", "--num_ori", "4",
        "--log", "False", "--checkpoint_dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert np.isfinite(loss) and f"z-table: {len(jz)} classes" in out


def test_train_cli_eval_equivariance_pins_the_timestep(tmp_path, monkeypatch, capsys):
    """``--dataset eval-equivariance`` trains on the crystal and validates on
    its rotation, every loss at t = 5."""
    seen = []
    draw = train_diffusion.draw_loss_noise

    def recording(*args, **kwargs):
        noise = draw(*args, **kwargs)
        seen.append(noise.t)
        return noise

    monkeypatch.setattr(train_diffusion, "draw_loss_noise", recording)
    loss = train_diffusion.main([
        "--device", "cpu", "--dataset", "eval-equivariance", "--data_dir", str(tmp_path),
        "--epochs", "4", "--val_interval", "2", "--num_timesteps", "300", "--batch_size", "4",
        "--hidden_dim", "16", "--basis_dim", "8", "--layers", "2", "--num_ori", "4",
        "--log", "False", "--checkpoint_dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert np.isfinite(loss)
    assert "steps/epoch: 1 | z-table: 7 classes" in out
    assert out.count("valid loss") == 2 and (tmp_path / "ckpt" / "best" / "params.npz").exists()
    # 4 train steps, 2 validations, 1 test
    assert len(seen) == 7 and all(bool((t == 5).all()) for t in seen)
