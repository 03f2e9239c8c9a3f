"""The serving export (``inference/export.py``, ``cli/export_sampler.py``)
and the five forward kernels as PyTorch operators, on the CPU: the
exported sampler reproduces ``DiffusionModel.sample`` from the same seed
(mirroring the JAX package's ``tests/test_export.py``), fixed and with
``variable_num_atoms``, on the plain branch and on the kernel branch, whose
program keeps #3 and #8 as operator nodes that look their wrapper up when
they run; the CLI's defaults; ``torch.library.opcheck`` on each operator
in float32 and bfloat16."""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch

from arreau_tpu.cli import export_sampler as j_export_cli
from arreau_tpu.cli import generate as j_generate
from arreau_tpu.cli import train_diffusion as j_train_diffusion
from arreau_tpu_torch.cli import export_sampler as export_cli
from arreau_tpu_torch.cli import generate, train_diffusion
from arreau_tpu_torch.data.atoms import synthetic_z_table
from arreau_tpu_torch.inference.export import export_sampler, load_exported, noise_steps
from arreau_tpu_torch.interop.from_jax import params_to_jax, save_params_npz
from arreau_tpu_torch.kernels import basis_h1, spatial_conv
from arreau_tpu_torch.tasks.diffusion import DiffusionConfig, DiffusionModel

T = 12
LENGTH_STATS = {"min": 3.0, "max": 8.0}


def _checkpoint(path, use_pallas=None, diffuse_angles=False, ema=True):
    """A seeded tiny model (T = 12) saved as the port's checkpoint, tag
    ``best`` (and an ``ema_params.npz`` of other weights with ``ema``)."""
    zt = synthetic_z_table()
    cfg = DiffusionConfig(num_atomic_states=len(zt), num_timesteps=T, hidden_dim=8, basis_dim=8,
                          num_layers=2, num_ori=4, use_pallas=use_pallas,
                          diffuse_angles=diffuse_angles)
    model = DiffusionModel(cfg, device="cpu")
    model.model.init_parameters(torch.Generator().manual_seed(0))
    (path / "best").mkdir(parents=True)
    (path / "meta.json").write_text(json.dumps({
        "config": dataclasses.asdict(cfg), "z_table_zs": [int(z) for z in zt.zs],
        "length_stats": LENGTH_STATS}))
    save_params_npz(str(path / "best" / "params.npz"), params_to_jax(model.model))
    if ema:
        ema_model = DiffusionModel(cfg, device="cpu")
        ema_model.model.init_parameters(torch.Generator().manual_seed(1))
        save_params_npz(str(path / "best" / "ema_params.npz"), params_to_jax(ema_model.model))
        return ema_model
    return model


def _reference(model, seed, B, A, sample_steps, num_atoms=None):
    return model.sample(B, A, generator=torch.Generator().manual_seed(seed),
                        sample_steps=sample_steps, length_bounds=(0.5, 10.5), num_atoms=num_atoms)


def _assert_same(out, ref):
    frac, types, lattice = out
    torch.testing.assert_close(frac, ref.frac_x, rtol=1e-6, atol=1e-6)
    assert torch.equal(types, ref.atom_types)
    torch.testing.assert_close(lattice, ref.lattice, rtol=1e-6, atol=1e-6)
    # the same program on the same device: bit for bit, not only within 1e-6
    assert torch.equal(frac, ref.frac_x) and torch.equal(lattice, ref.lattice)


@pytest.mark.parametrize("use_pallas,diffuse_angles", [(None, False), (True, True)])
def test_export_roundtrip_matches_sampler(tmp_path, use_pallas, diffuse_angles):
    """The artifact (EMA weights by default) reproduces the in-process
    sampler from the same seed: a strided chain of 5 steps, types equal,
    frac and lattice within 1e-6 (and bit for bit); ``angles`` is an input
    exactly without ``diffuse_angles``."""
    model = _checkpoint(tmp_path / "ckpt", use_pallas, diffuse_angles)
    out = str(tmp_path / "sampler.pt2")
    sidecar = export_sampler(str(tmp_path / "ckpt"), out, batch_size=3, num_atoms_per_sample=2,
                             sample_steps=5, device="cpu")
    assert sidecar["batch_size"] == 3 and sidecar["bytes"] > 0 and sidecar["use_ema"]
    assert sidecar["platforms"] == ["cpu"] and sidecar["noise_steps"] == 5
    assert ("angles" in sidecar["inputs"]) == (not diffuse_angles)
    assert json.load(open(out + ".json"))["z_table_zs"] == [int(z) for z in synthetic_z_table().zs]

    call, sc = load_exported(out)
    frac, types, lattice = call(7)
    assert frac.shape == (3, 2, 3) and types.shape == (3, 2) and lattice.shape == (3, 3, 3)
    _assert_same((frac, types, lattice), _reference(model, 7, 3, 2, 5))
    with pytest.raises(ValueError, match="variable_num_atoms"):
        call(7, [1, 2, 2])


def test_export_variable_num_atoms_roundtrip(tmp_path):
    """The size-matched variant takes per-crystal counts and reproduces the
    in-process sampler with those counts."""
    model = _checkpoint(tmp_path / "ckpt", ema=False)
    out = str(tmp_path / "sampler_var.pt2")
    sidecar = export_sampler(str(tmp_path / "ckpt"), out, use_ema=False, batch_size=3,
                             num_atoms_per_sample=4, sample_steps=5, variable_num_atoms=True,
                             device="cpu")
    assert sidecar["variable_num_atoms"] is True and sidecar["inputs"][-1] == "num_atoms"
    assert "num_atoms: int64[B]" in sidecar["calling_convention"]
    call, _ = load_exported(out)
    counts = np.asarray([2, 4, 3])
    frac, types, lattice = call(9, counts)
    assert frac.shape == (3, 4, 3)
    _assert_same((frac, types, lattice), _reference(model, 9, 3, 4, 5, torch.tensor(counts)))
    with pytest.raises(ValueError, match="variable_num_atoms"):
        call(9)


class _Counted:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def test_kernel_branch_program_calls_the_wrappers_through_their_modules(tmp_path, monkeypatch):
    """On the kernel branch the program holds #3 and #8 as operator nodes
    (``spatial_conv``: one a layer and step, ``basis_h1``: one a step) and
    nothing of the kernels else; exporting calls no wrapper, and running
    the program calls each through its module's name, where a caller may
    have swapped it."""
    _checkpoint(tmp_path / "ckpt", use_pallas=True)
    out = str(tmp_path / "sampler.pt2")
    counted = {name: _Counted(getattr(mod, name))
               for mod, name in ((spatial_conv, "spatial_conv"), (basis_h1, "basis_h1"))}
    monkeypatch.setattr(spatial_conv, "spatial_conv", counted["spatial_conv"])
    monkeypatch.setattr(basis_h1, "basis_h1", counted["basis_h1"])
    export_sampler(str(tmp_path / "ckpt"), out, batch_size=2, num_atoms_per_sample=3,
                   sample_steps=4, device="cpu")
    assert {name: c.calls for name, c in counted.items()} == {"spatial_conv": 0, "basis_h1": 0}
    program = torch.export.load(out)
    targets = [str(n.target) for n in program.graph.nodes if "arreau_tpu_torch" in str(n.target)]
    S = noise_steps(T, 4)
    assert sorted(set(targets)) == ["arreau_tpu_torch.basis_h1.default",
                                    "arreau_tpu_torch.spatial_conv.default"]
    assert targets.count("arreau_tpu_torch.spatial_conv.default") == 2 * S
    assert targets.count("arreau_tpu_torch.basis_h1.default") == S
    call, _ = load_exported(out)
    call(0)
    assert {name: c.calls for name, c in counted.items()} == {"spatial_conv": 2 * S,
                                                              "basis_h1": S}


def test_export_cli_defaults(tmp_path, capsys):
    """The JAX CLI's defaults: ``--sample_steps 100`` (here above T - 1: the
    full chain's 11 steps), ``0`` for the full chain; ``--tag best``."""
    _checkpoint(tmp_path / "ckpt")
    assert export_cli.parse_args(["--checkpoint_dir", "c", "--out", "o"]).sample_steps == 100
    out = str(tmp_path / "art.pt2")
    sidecar = export_cli.main(["--checkpoint_dir", str(tmp_path / "ckpt"), "--use_ema", "False",
                               "--batch_size", "2", "--num_atoms_per_sample", "2", "--out", out,
                               "--device", "cpu"])
    assert "exported" in capsys.readouterr().out
    call, loaded = load_exported(out)
    assert loaded["sample_steps"] == sidecar["sample_steps"] == 100
    assert loaded["noise_steps"] == T - 1 and not loaded["use_ema"]
    assert call(0)[0].shape == (2, 2, 3)
    out2 = str(tmp_path / "art_full.pt2")
    export_cli.main(["--checkpoint_dir", str(tmp_path / "ckpt"), "--batch_size", "2",
                     "--num_atoms_per_sample", "2", "--out", out2, "--sample_steps", "0",
                     "--device", "cpu"])
    _, full = load_exported(out2)
    assert full["sample_steps"] is None and full["noise_steps"] == T - 1 and full["use_ema"]


def test_export_cli_on_cuda_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the CUDA path runs instead of raising")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_cli.main(["--checkpoint_dir", str(tmp_path), "--out", str(tmp_path / "o")])


def _op_args(name, dtype, variant):
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=dtype):
        return torch.randn(shape, generator=g).to(dt)

    Bp, O, K, TA, D, C, d, H = 2, 3, 2, 5, 6, 7, 4, 5
    E = K * TA
    src = torch.randint(-1, TA, (Bp, E), generator=g, dtype=torch.int32)
    if name == "spatial_conv":
        return (r(Bp, O, E, D), r(D, C), r(Bp, O, TA, C), src, torch.rand((Bp, E), generator=g))
    if name == "basis_h1":
        return r(Bp, O, d, E), r(d + d * d, H), r(H), 2
    if name == "fiber_conv":
        return r(Bp, O, E, D), r(D, C), r(Bp, O, TA, C), src, r(O, O, C), variant
    if name == "convnext_mlp":
        f32 = torch.float32
        readout = (r(C, 3, dt=f32), r(3, dt=f32)) if variant else (None, None)
        return (r(Bp, O, TA, C, dt=f32), r(Bp, O, TA, C), r(C, dt=f32), r(C, dt=f32),
                r(C, 4 * C), r(4 * C), r(4 * C, C), r(C), r(C, dt=f32), *readout)
    return r(Bp, O, E, d), r(d + d * d, H), r(H, D), 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,variant", [
    ("spatial_conv", None), ("basis_h1", None), ("fiber_conv", True), ("fiber_conv", False),
    ("convnext_mlp", True), ("convnext_mlp", False), ("fused_basis_mlp", None)])
def test_opcheck(name, variant, dtype):
    """Schema, fake (shape, type and layout of every output, as the export
    traces it), autograd registration and AOT dispatch of each operator,
    whose CPU implementation is the plain version."""
    op = getattr(torch.ops.arreau_tpu_torch, name).default
    result = torch.library.opcheck(op, _op_args(name, dtype, variant))
    assert set(result.values()) == {"SUCCESS"}, result


def _flags(module, argv):
    """{dest: (default, choices)} of the parser ``module.parse_args`` builds."""
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        return parse(self, args, namespace)

    argparse.ArgumentParser.parse_args = grab
    try:
        module.parse_args(argv)
    finally:
        argparse.ArgumentParser.parse_args = parse
    return {a.dest: (a.default, a.choices) for a in seen["parser"]._actions if a.dest != "help"}


@pytest.mark.parametrize("port,jax_cli", [(generate, j_generate), (export_cli, j_export_cli),
                                          (train_diffusion, j_train_diffusion)],
                         ids=["generate", "export_sampler", "train_diffusion"])
def test_cli_flags_and_defaults_are_the_jax_clis(port, jax_cli):
    """Every flag of the JAX parser with its default and choices, and the
    port's ``--device`` (default ``cuda``); ``--profiler`` names this
    package's profiler (``torch``) where the JAX one names ``jax``."""
    argv = ["--checkpoint_dir", "c", "--out", "o"] if port is export_cli else []
    got, want = _flags(port, argv), _flags(jax_cli, argv)
    assert got.pop("device") == ("cuda", None)
    if "profiler" in want:
        assert want.pop("profiler") == (None, [None, "jax"])
        assert got.pop("profiler") == (None, [None, "torch"])
    assert got == want
