"""The port's renders (``inference/visualize.py``) and the render flags of
its CLIs against the JAX package's on the CPU: generate ``--gif``
(snapshots of the last batch, ``sampling_steps/step_{t}.png`` and
``sampling.gif``), ``--visualize`` and ``--show_bonds``, process_results
``--visualize``, the notice for ``--gif`` with a strided chain, and the
ImportError, before any work, where matplotlib or PIL does not import."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from arreau_tpu.cli import generate as j_generate
from arreau_tpu.cli import process_results as j_process_results
from arreau_tpu.inference import visualize as j_visualize
from arreau_tpu.inference.io import SampleResult as JResult
from arreau_tpu.inference.io import save_sample_results as j_save
from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import DiffusionModel as JModel
from arreau_tpu.train.checkpoint import CheckpointManager, diffusion_meta
from arreau_tpu.train.optim import make_optimizer
from arreau_tpu.train.state import create_train_state
from arreau_tpu_torch.cli import generate, process_results
from arreau_tpu_torch.data.atoms import synthetic_z_table
from arreau_tpu_torch.inference import bonds, visualize
from arreau_tpu_torch.inference.io import SampleResult, load_sample_results, save_sample_results
from arreau_tpu_torch.interop.from_jax import save_params_npz
from tests.test_torch_model import Z_TABLE, _batch, tiny_config

T = 12
GEN = ["--tag", "best", "--use_ema", "false", "--num_crystals", "4", "--batch_size", "2",
       "--num_atoms_per_sample", "4", "--seed", "3", "--snapshot_every", "5"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The same tiny model (T = 12) as a JAX checkpoint (tag ``best``) and as
    the port's (``meta.json`` and ``best/params.npz``)."""
    root = tmp_path_factory.mktemp("ckpts")
    jmodel = JModel(tiny_config(num_timesteps=T))
    host = JBatch(*map(jnp.asarray, _batch(2, 4, 0)))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), host)
    meta = diffusion_meta(jmodel.config, Z_TABLE, {"min": 3.0, "max": 8.0, "mean": 5.5, "std": 1.4})
    CheckpointManager(str(root / "jax"), meta=meta).save(
        create_train_state(params, make_optimizer(1e-3), ema_decay=0.999), "best")
    port = root / "port"
    (port / "best").mkdir(parents=True)
    (port / "meta.json").write_text(json.dumps(
        {**meta, "fourier_w": np.asarray(jmodel.fourier_w).tolist()}))
    save_params_npz(str(port / "best" / "params.npz"), jax.tree.map(np.asarray, params))
    return root / "jax", port


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _is_png(path):
    with Image.open(path) as im:
        return im.format == "PNG" and im.size[0] > 0 and im.size[1] > 0


def test_generate_renders_the_jax_cli_files(checkpoints, tmp_path, capsys):
    """``--gif --visualize --show_bonds`` on the dense chain: the same files
    as the JAX CLI on the same checkpoint (``crystals.h5`` in both): the
    last batch's snapshots after 5, 10 and 11 of the 11 steps, a GIF of
    those three frames, and the first four crystals."""
    jdir, pdir = checkpoints
    flags = ["--gif", "true", "--visualize", "true", "--show_bonds", "true"]
    j_generate.main(["--checkpoint_dir", str(jdir), *GEN, *flags, "--out_dir", str(tmp_path / "j")])
    generate.main(["--checkpoint_dir", str(pdir), "--device", "cpu", *GEN, *flags,
                   "--out_dir", str(tmp_path / "p")])
    printed = capsys.readouterr().out
    want = _files(tmp_path / "j")
    got = _files(tmp_path / "p")
    assert got == want
    assert got == sorted(["crystals.h5", "sampling.gif"]
                         + [f"crystal_{i}.png" for i in range(4)]
                         + [f"sampling_steps/step_{t}.png" for t in (6, 1, 0)])
    assert f"wrote {tmp_path / 'p'}/sampling.gif" in printed
    assert f"rendered PNGs under {tmp_path / 'p'}" in printed
    for f in got:
        if f.endswith(".png"):
            assert _is_png(tmp_path / "p" / f), f
    with Image.open(tmp_path / "p" / "sampling.gif") as gif:
        assert gif.format == "GIF" and gif.n_frames == 3
    assert load_sample_results(str(tmp_path / "p" / "crystals.h5")).num_crystals == 4


def test_generate_gif_with_strided_chain_prints_the_notice(checkpoints, tmp_path, capsys):
    """``--gif`` with ``--sample_steps`` below T - 1: the JAX CLI's notice,
    and no GIF; ``--visualize`` alone renders the four crystals."""
    _, pdir = checkpoints
    generate.main(["--checkpoint_dir", str(pdir), "--device", "cpu", *GEN, "--sample_steps", "3",
                   "--gif", "true", "--visualize", "true", "--out_dir", str(tmp_path)])
    assert ("gif snapshots are not supported with --sample_steps; disabling gif"
            in capsys.readouterr().out)
    assert _files(tmp_path) == ["crystal_0.png", "crystal_1.png", "crystal_2.png",
                                "crystal_3.png", "crystals.h5"]


@pytest.mark.parametrize("hidden", ["matplotlib", "PIL"])
@pytest.mark.parametrize("flag", ["--gif", "--visualize"])
def test_render_flags_raise_import_error_before_any_work(hidden, flag, monkeypatch, tmp_path):
    """Where matplotlib or PIL does not import, ``--gif`` / ``--visualize``
    raise an ImportError naming the package before the checkpoint is read
    (here: none exists) or anything is sampled; process_results
    ``--visualize`` raises before it reads its file."""
    monkeypatch.setitem(sys.modules, hidden, None)
    package = {"matplotlib": "matplotlib", "PIL": "pillow"}[hidden]
    with pytest.raises(ImportError, match=package):
        generate.main(["--checkpoint_dir", str(tmp_path / "none"), "--device", "cpu", flag,
                       "true", "--out_dir", str(tmp_path)])
    if flag == "--visualize":
        with pytest.raises(ImportError, match=package):
            process_results.main(["--in_path", str(tmp_path / "none.npz"), "--device", "cpu",
                                  "--visualize", "true"])
    assert not os.listdir(tmp_path)


def _result():
    rng = np.random.default_rng(0)
    counts = np.array([4, 2, 3, 4, 1])
    zs = rng.choice([6, 8, 14], size=int(counts.sum()))
    lattice = np.stack([np.diag(rng.uniform(3.0, 5.0, size=3)) for _ in counts])
    return SampleResult(rng.uniform(size=(int(counts.sum()), 3)), zs, lattice,
                        np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64), counts)


def test_process_results_visualize_renders_the_jax_cli_files(tmp_path):
    result = _result()
    save_sample_results(str(tmp_path / "p" / "crystals.h5"), result)
    j_save(str(tmp_path / "j" / "crystals.h5"), JResult(*(getattr(result, k) for k in (
        "frac_x", "atomic_numbers", "lattice", "idx_start", "num_atoms"))))
    process_results.main(["--in_path", str(tmp_path / "p" / "crystals.h5"), "--device", "cpu",
                          "--steps", "5", "--visualize", "true"])
    j_process_results.main(["--in_path", str(tmp_path / "j" / "crystals.h5"), "--steps", "5",
                            "--visualize", "true"])
    got = _files(tmp_path / "p")
    assert got == _files(tmp_path / "j")
    assert got == sorted(["crystals.h5", "crystals_relaxed.h5"]
                         + [f"relaxed_{i}.png" for i in range(4)])
    assert all(_is_png(tmp_path / "p" / f) for f in got if f.endswith(".png"))


def test_crystal_matches_jax():
    result = _result()
    jres = JResult(*(getattr(result, k) for k in ("frac_x", "atomic_numbers", "lattice",
                                                  "idx_start", "num_atoms")))
    for i in range(result.num_crystals):
        for got, want in zip(result.crystal(i), jres.crystal(i)):
            np.testing.assert_array_equal(got, want)


def test_one_radii_table_equal_to_the_jax_one():
    assert visualize._COVALENT_RADII is bonds._COVALENT_RADII
    assert visualize._COVALENT_RADII == j_visualize._COVALENT_RADII
    assert visualize._ELEMENT_COLORS == j_visualize._ELEMENT_COLORS


def test_predict_bonds_matches_jax():
    rng = np.random.default_rng(1)
    cart = rng.uniform(0.0, 4.0, size=(12, 3))
    zs = rng.choice([1, 6, 8, 26, 99], size=12)
    got = visualize.predict_bonds(cart, zs)
    assert got == j_visualize.predict_bonds(cart, zs) and len(got) > 0


def test_plot_crystal_draws_bonds_and_lattice(tmp_path):
    """A bonded pair renders differently with ``show_bonds``; the unit cell
    alone renders too (``plot_lattice``)."""
    frac = np.array([[0.0, 0.0, 0.0], [0.3, 0.0, 0.0]])
    lattice = np.eye(3) * 4.0
    for name, show in (("plain.png", False), ("bonds.png", True)):
        visualize.plot_crystal(frac, np.array([6, 6]), lattice, str(tmp_path / name),
                               show_bonds=show, title=name)
    with Image.open(tmp_path / "plain.png") as a, Image.open(tmp_path / "bonds.png") as b:
        assert a.size == b.size and a.tobytes() != b.tobytes()
    visualize.plot_lattice(lattice, str(tmp_path / "cell.png"))
    assert _is_png(tmp_path / "cell.png")


def test_generate_gif_orders_frames_by_descending_timestep(tmp_path):
    """``generate_gif`` takes the PNGs whose name ends in an integer, in
    descending order, as the JAX package's; with none it raises."""
    for t, shade in ((0, 0), (10, 120), (5, 250)):
        Image.new("RGB", (4, 4), (shade, shade, shade)).save(tmp_path / f"step_{t}.png")
    Image.new("RGB", (4, 4)).save(tmp_path / "other.png")
    visualize.generate_gif(str(tmp_path), str(tmp_path / "out.gif"), prefix="step")
    with Image.open(tmp_path / "out.gif") as gif:
        shades = []
        for i in range(gif.n_frames):
            gif.seek(i)
            shades.append(gif.convert("RGB").getpixel((0, 0))[0])
    assert shades == [120, 250, 0]
    with pytest.raises(FileNotFoundError):
        visualize.generate_gif(str(tmp_path), str(tmp_path / "x.gif"), prefix="none")


def test_vis_crystal_during_sampling_writes_name_png(tmp_path):
    visualize.vis_crystal_during_sampling(
        synthetic_z_table(), np.array([0, 1]), np.eye(3) * 3.0,
        np.array([[0.1, 0.2, 0.3], [0.5, 0.5, 0.5]]), str(tmp_path / "step_7"))
    assert _is_png(tmp_path / "step_7.png")
