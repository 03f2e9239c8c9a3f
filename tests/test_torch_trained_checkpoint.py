"""Trained checkpoints of the JAX package in the PyTorch port, on the CPU:
``convert_jax_checkpoint.py`` on the tracked orbax checkpoints, the port's
reverse chain on a converted float32 checkpoint against the JAX chain, one
bfloat16 score prediction of the flagship checkpoint and its bfloat16 chain
on a few crystals through both packages, and the committed
``ported_ckpt/ang_on`` against a fresh conversion.

The flagship was trained on a TPU, where the JAX package's one float32
product of its bfloat16 network, the readout's ``jnp.dot(xcat, wcat)`` at
DEFAULT precision, takes bfloat16 operands; on the CPU JAX computes it in
float32. The JAX side runs it both ways (``jax_tpu_readout.py``), and the port
serves the flagship as it was trained (``readout_bf16_operands``).

The converter and the JAX side of the bfloat16 checks run in fresh
processes, as a user runs them: tests/conftest.py enables float64 in JAX,
under which ``DiffusionModel`` draws other Fourier frequencies than the
float32 ones the checkpoints were trained with."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from arreau_tpu.cli.generate import load_model as j_load_model
from arreau_tpu_torch.cli import generate
from arreau_tpu_torch.data.atoms import synthetic_z_table
from arreau_tpu_torch.data.synthetic import make_synthetic_batch
from arreau_tpu_torch.interop.from_jax import load_params_npz, params_from_jax
from arreau_tpu_torch.ops.fourier import _FOURIER_W_SEED_1234
from arreau_tpu_torch.tasks.diffusion import (
    DiffusionConfig,
    DiffusionModel,
    SamplerNoise,
    strided_levels,
)
from tests.test_torch_bf16 import SCORE_REL_TOL, _rel
from tests.test_torch_sampler import assert_same_crystals, jax_noise

ROOT = Path(__file__).resolve().parents[1]
RAND = ROOT / "out" / "r3" / "ckpt_rand"  # float32, 4 training steps
ANG_ON = ROOT / "out" / "r4" / "ckpt_ang_on"  # the flagship: bfloat16, diffuse_angles
PORTED = ROOT / "ported_ckpt" / "ang_on"


def convert(checkpoint_dir, tag, out_dir, *flags):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, str(ROOT / "convert_jax_checkpoint.py"), "--checkpoint_dir",
                    str(checkpoint_dir), "--tag", tag, "--out_dir", str(out_dir), *flags],
                   cwd=ROOT, env=env, check=True, timeout=300, capture_output=True)


def test_converted_float32_checkpoint_chain_matches_jax(tmp_path):
    """``ckpt_rand`` converted and loaded by the port's generate loader: two
    strided steps (eta 0, argmax types, clip_denoised from its
    length_stats) on 2 crystals of 4 atoms at the canonical width, every
    random number injected from the JAX keys, against ``_sample_impl`` on
    the parameters the JAX CLI's loader restores. Positions and lattice
    within 1e-4, types where the JAX top-2 logit margin exceeds 1e-4."""
    convert(RAND, "last", tmp_path / "rand")
    model, z_table, meta = generate.load_model(str(tmp_path / "rand"), "last", True, "cpu")
    assert meta["config"]["compute_dtype"] is None
    np.testing.assert_array_equal(meta["fourier_w"], np.float32(_FOURIER_W_SEED_1234))

    jmodel, params, j_z_table, j_meta = j_load_model(str(RAND), "last", True, return_meta=True)
    assert j_meta["config"] == meta["config"] and list(j_z_table.zs) == list(z_table.zs)
    # the JAX loader's own rule for a meta that carries its frequencies: under
    # float64 (tests/conftest.py) JAX would draw others than training used
    jmodel.fourier_w = jax.numpy.asarray(meta["fourier_w"], jax.numpy.float32)
    seen = []
    predict = jmodel.predict_scores

    def recording(*args):  # keeps the type logits of every step, in order
        out = predict(*args)
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), out[1], ordered=True)
        return out

    jmodel.predict_scores = recording
    B, A, S = 2, 4, 2
    key = jax.random.PRNGKey(5)
    kw = dict(length_bounds=generate.length_bounds_from_meta(meta), type_temperature=0.0,
              sample_steps=S, ddim_eta=0.0)
    want = jmodel._sample_impl(params, key, B, A, **kw)
    num_steps = len(strided_levels(meta["config"]["num_timesteps"], S)) - 1
    noise = jax_noise(key, num_steps, len(z_table), B=B, A=A)
    with torch.no_grad():
        got = model._sample_impl(B, A, noise=noise, **kw)
    assert_same_crystals(want, got, seen[-1])


# the JAX side's switch between the readout product as the CPU computes it
# (float32) and as a TPU does at DEFAULT precision (bfloat16 operands, float32
# sums), from the repository's witness script
_TPU_READOUT = """
from jax_tpu_readout import tpu_readout
"""

_JAX_SCORES = _TPU_READOUT + """
import dataclasses
import sys
import jax
import numpy as np
from arreau_tpu.cli.generate import load_model
from arreau_tpu.tasks.diffusion import DiffusionModel

bf16, params, _ = load_model(sys.argv[1], "best", False)
f32 = DiffusionModel(dataclasses.replace(bf16.config, compute_dtype=None))
a = np.load(sys.argv[2])
args = [a[k] for k in ("frac", "onehot", "t", "num_atoms", "lengths", "angles", "mask")]
out = {}
for name, model in (("bfloat16", bf16), ("float32", f32)):
    for tpu in (False, True):
        tpu_readout(tpu)
        scores = jax.jit(lambda *a: model.predict_scores(*a))(params, *args)
        for i, o in enumerate(scores):
            out[f"{name}{'_tpu' if tpu else ''}{i}"] = np.asarray(o, np.float32)
np.savez(sys.argv[3], **out)
"""
SCORE_ARGS = ("frac", "onehot", "t", "num_atoms", "lengths", "angles", "mask")


def port_flagship(compute_dtype, use_kernels, readout_bf16_operands=True):
    """The committed flagship checkpoint in the port, at ``compute_dtype``
    (its own: bfloat16) on the given branch, its readout as the TPU it was
    trained on computed it (its own) or in float32."""
    meta = json.loads((PORTED / "meta.json").read_text())
    assert meta["config"]["compute_dtype"] == "bfloat16" and meta["config"]["diffuse_angles"]
    assert meta["readout_bf16_operands"] is True
    config = DiffusionConfig(**{**meta["config"], "compute_dtype": compute_dtype,
                                "use_pallas": use_kernels})
    model = DiffusionModel(config, device="cpu", fourier_w=meta["fourier_w"],
                           readout_bf16_operands=readout_bf16_operands)
    params_from_jax(model, load_params_npz(str(PORTED / "best" / "params.npz")))
    return model


@pytest.fixture(scope="module")
def flagship_scores(tmp_path_factory):
    """(inputs, the JAX package's scores in bfloat16 and float32, each with
    the readout as the CPU and as a TPU computes it) of the flagship
    checkpoint restored by the JAX CLI's loader. The inputs are
    those the sampler gives the model: the first, sixth and last forwards
    of a ten-step strided chain of 4 crystals of 8 atoms (t = 999, 500,
    100), run by the port in float32. JAX runs in a fresh process with
    XLA's excess precision off (XLA's CPU compiler otherwise keeps bfloat16
    intermediates in float32)."""
    tmp = tmp_path_factory.mktemp("flagship")
    model = port_flagship(None, False, False)
    seen = []
    predict = model.predict_scores
    model.predict_scores = lambda *a: seen.append([x.clone() for x in a]) or predict(*a)
    model.sample(4, 8, generator=torch.Generator().manual_seed(3), sample_steps=10)
    inputs = {k: torch.cat([seen[i][j] for i in (0, 5, 9)]).numpy()
              for j, k in enumerate(SCORE_ARGS)}
    np.savez(tmp / "in.npz", **inputs)
    flags = f"{os.environ.get('XLA_FLAGS', '')} --xla_allow_excess_precision=false".strip()
    env = {**os.environ, "XLA_FLAGS": flags, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", _JAX_SCORES, str(ANG_ON), str(tmp / "in.npz"),
                    str(tmp / "out.npz")], cwd=ROOT, env=env, check=True, timeout=300)
    with np.load(tmp / "out.npz") as out:
        return inputs, {dt: [out[f"{dt}{i}"] for i in range(3)]
                        for dt in ("bfloat16", "bfloat16_tpu", "float32", "float32_tpu")}


def port_scores(inputs, compute_dtype, use_kernels, readout_bf16_operands=True):
    model = port_flagship(compute_dtype, use_kernels, readout_bf16_operands)
    with torch.no_grad():
        out = model.predict_scores(*[torch.as_tensor(inputs[k]) for k in SCORE_ARGS])
    return [o.float().numpy() for o in out]


def _rms_rel(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want**2)))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_flagship_float32_scores_match_jax(flagship_scores, use_kernels):
    """The flagship's trained weights as the float32 function: the port's
    plain branch and its kernel branch (the kernels' plain versions on the
    CPU) against the JAX package's, every output within 1e-4 of its largest
    magnitude. Any misplaced or mistransposed weight of the trained tree
    shows here."""
    inputs, want = flagship_scores
    for name, a, b in zip(("eps", "logits", "global"),
                          port_scores(inputs, None, use_kernels, False), want["float32"]):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 1e-4, name


@pytest.mark.parametrize("use_kernels", [False, True])
def test_flagship_tpu_readout_matches_jax(flagship_scores, use_kernels):
    """``readout_bf16_operands`` is the JAX readout as a TPU computes it. In
    the float32 function, where nothing else rounds, the port's outputs
    with it match the JAX package's with its readout product taken from
    bfloat16 operands: the type logits and the lattice head within 1e-4 of
    their largest magnitude (measured: 3.6e-06 and 2.8e-05), the coordinate
    head within 1e-2 (1.8e-03: a float32 difference of the two packages'
    activations can round them to neighbouring bfloat16 values, and eps is
    a small sum). That readout moves the lattice head by more than 1e-2
    from JAX's float32 readout (2.2%) and eps by 6.7%, so the check tells
    the two apart."""
    inputs, want = flagship_scores
    got = port_scores(inputs, None, use_kernels, True)
    for name, a, b, tol in zip(("eps", "logits", "global"), got, want["float32_tpu"],
                               (1e-2, 1e-4, 1e-4)):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= tol, name
    assert _rel(got[2], want["float32"][2]) > 1e-2


# the coordinate head's bfloat16 rounding noise on these inputs: two
# evaluations at the JAX package's cast points that differ only in the order
# of their sums (the port's plain and kernel branches) differ by 8.4% of its
# RMS; the port against JAX 9.6% (plain) and 9.8% (kernel branch); JAX's own
# bfloat16 against its float32 function 16.2%
EPS_BF16_RMS_TOL = 0.12


@pytest.mark.parametrize("use_kernels", [False, True])
def test_flagship_bf16_scores_match_jax(flagship_scores, use_kernels):
    """The flagship as it was trained, bfloat16 with the TPU's readout
    (``readout_bf16_operands``), on both of the port's branches, against the
    JAX package's bfloat16 outputs with its readout as a TPU computes it. The type logits
    and the lattice head within 2e-2 of their largest magnitude, the
    bfloat16 score tolerance of ``tests/test_torch_bf16.py``. The coordinate
    head (eps) of the trained model is a small sum over orientations
    (largest magnitude ~6e-3) that bfloat16 rounding moves by more than
    that in either package; it is held to JAX's bfloat16 eps within
    EPS_BF16_RMS_TOL of its RMS, 1.4x the rounding noise measured between
    the port's own two branches."""
    inputs, want = flagship_scores
    got = port_scores(inputs, "bfloat16", use_kernels)
    for name, a, b in zip(("logits", "global"), got[1:], want["bfloat16_tpu"][1:]):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= SCORE_REL_TOL, name
    assert got[0].shape == want["bfloat16_tpu"][0].shape
    assert _rms_rel(got[0], want["bfloat16_tpu"][0]) <= EPS_BF16_RMS_TOL


_JAX_CHAIN = _TPU_READOUT + """
import dataclasses
import sys
import jax
import jax.numpy as jnp
import numpy as np
from arreau_tpu.cli.generate import load_model
from arreau_tpu.tasks.diffusion import POS_SIGMA_MAX, DiffusionModel
from arreau_tpu_torch.tasks.diffusion import strided_levels

bf16, params, _ = load_model(sys.argv[1], "best", False)
f32 = DiffusionModel(dataclasses.replace(bf16.config, compute_dtype=None))
B, A, S, seed = (int(v) for v in sys.argv[3:7])
C, dt = bf16.config.num_atomic_states, jnp.float32
key = jax.random.PRNGKey(seed)
kw = dict(length_bounds=None, type_temperature=1.0, sample_steps=S, ddim_eta=0.0)
out = {}
for name, model, tpu in (("bfloat16", bf16, False), ("float32", f32, False),
                         ("bfloat16_tpu", bf16, True)):
    tpu_readout(tpu)
    crystals = jax.jit(lambda p, k: model._sample_impl(p, k, B, A, **kw))(params, key)
    out[f"{name}_lattice"] = np.asarray(crystals.lattice)
    out[f"{name}_types"] = np.asarray(crystals.atom_types)
# the numbers _sample_impl draws from key, for the port's SamplerNoise
k_ang, k_len, k_frac, k_loop = jax.random.split(key, 4)
steps = {"lattice": [], "angle": [], "pos": [], "types": []}
for _ in range(len(strided_levels(bf16.config.num_timesteps, S)) - 1):
    k_loop, k_lat, k_pos, k_type, k_ang2 = jax.random.split(k_loop, 5)
    steps["lattice"].append(jax.random.normal(k_lat, (B, 3), dt))
    steps["angle"].append(jax.random.normal(k_ang2, (B, 6), dt))
    steps["pos"].append(jax.random.normal(k_pos, (B, A, 3), dt))
    steps["types"].append(jax.random.uniform(k_type, (B, A, C), dt, minval=0.0, maxval=1.0))
np.savez(sys.argv[2], **out, ang_enc0=np.asarray(jax.random.normal(k_ang, (B, 6), dt)),
         lengths0=np.asarray(jax.random.normal(k_len, (B, 3), dt)),
         frac0=np.asarray(jax.random.normal(k_frac, (B, A, 3), dt) * POS_SIGMA_MAX),
         **{k: np.asarray(jnp.stack(v)) for k, v in steps.items()})
"""


CHAIN = (8, 8, 100, 0)  # crystals, atoms, strided steps, seed


@pytest.fixture(scope="module")
def flagship_chain(tmp_path_factory):
    """(the JAX package's crystals, its injected noise) of the flagship
    command's chain (100 strided steps, no length clamp, gumbel type draws,
    eta 0) on 8 crystals of 8 atoms: bfloat16 and float32 with the readout
    as the CPU computes it, and bfloat16 with the readout as a TPU does."""
    tmp = tmp_path_factory.mktemp("chain")
    flags = f"{os.environ.get('XLA_FLAGS', '')} --xla_allow_excess_precision=false".strip()
    env = {**os.environ, "XLA_FLAGS": flags, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", _JAX_CHAIN, str(ANG_ON), str(tmp / "jax.npz"),
                    *map(str, CHAIN)], cwd=ROOT, env=env, check=True, timeout=600)
    with np.load(tmp / "jax.npz") as a:
        want = {k: a[k] for k in a.files}
    noise = SamplerNoise(angles=None, **{k: torch.as_tensor(want[k]) for k in (
        "ang_enc0", "lengths0", "frac0", "lattice", "angle", "pos", "types")})
    return want, noise


def port_chain(noise, readout_bf16_operands):
    """The port's bfloat16 kernel branch on the flagship chain's noise:
    (atom types, lattice lengths)."""
    B, A, S, _ = CHAIN
    model = port_flagship("bfloat16", True, readout_bf16_operands)
    with torch.no_grad():
        got = model._sample_impl(B, A, noise=noise, length_bounds=None, type_temperature=1.0,
                                 sample_steps=S, ddim_eta=0.0)
    return got.atom_types.numpy(), np.linalg.norm(got.lattice.numpy(), axis=-1)


def test_flagship_bf16_chain_matches_jax(flagship_chain):
    """The flagship command's chain through both packages on the same
    injected noise, the readout as the CPU computes it. The port's bfloat16
    kernel branch gives the JAX package's bfloat16 crystals: every atom
    type the same, each lattice length within 5% (measured: 2.4% at most;
    the port's own two branches part by 1.7%, rounding carried through 100
    steps) and their mean within 1% (0.4%). The JAX package's float32 chain
    of the same weights on the same noise gives a mean length more than 2%
    longer (3.8%; every one of the 8 crystals longer)."""
    want, noise = flagship_chain
    types, lengths = port_chain(noise, False)
    jax_lengths = {dt: np.linalg.norm(want[f"{dt}_lattice"], axis=-1)
                   for dt in ("bfloat16", "float32")}
    np.testing.assert_array_equal(types, want["bfloat16_types"])
    np.testing.assert_allclose(lengths, jax_lengths["bfloat16"], rtol=5e-2)
    assert lengths.mean() == pytest.approx(jax_lengths["bfloat16"].mean(), rel=1e-2)
    assert jax_lengths["float32"].mean() > 1.02 * jax_lengths["bfloat16"].mean()


def test_flagship_tpu_readout_chain_matches_jax(flagship_chain):
    """The same chain with the readout as the TPU the flagship was trained
    on computed it: the port as it serves the flagship
    (``readout_bf16_operands``) against the JAX package's bfloat16 chain
    with its readout product from bfloat16 operands. Each lattice length
    within 5% (measured: 3.4% at most) and their mean within 1% (0.4%); the
    atom types the same but for at most 2 of the 64 (measured: 1, a gumbel
    draw near a tie; the two JAX chains part in 4, the port's two branches
    in none). That readout lengthens JAX's own lattices by more than 4%
    (7.1%): the readout's operand rounding is where the TPU run's longer
    lattices come from (PERF.md §6)."""
    want, noise = flagship_chain
    types, lengths = port_chain(noise, True)
    jax_lengths = {k: np.linalg.norm(want[f"{k}_lattice"], axis=-1)
                   for k in ("bfloat16_tpu", "bfloat16")}
    assert np.sum(types != want["bfloat16_tpu_types"]) <= 2
    np.testing.assert_allclose(lengths, jax_lengths["bfloat16_tpu"], rtol=5e-2)
    assert lengths.mean() == pytest.approx(jax_lengths["bfloat16_tpu"].mean(), rel=1e-2)
    assert jax_lengths["bfloat16_tpu"].mean() > 1.04 * jax_lengths["bfloat16"].mean()


def test_committed_flagship_checkpoint_is_a_fresh_conversion(tmp_path):
    """Converting ``ckpt_ang_on/best`` again gives the committed
    ``ported_ckpt/ang_on``: every array equal bit for bit (float32, as
    stored) and the same ``meta.json``, whose frequencies are the float32
    draw the port carries for seed 1234 and which serves the readout as
    the TPU the checkpoint was trained on computed it."""
    convert(ANG_ON, "best", tmp_path / "ang_on", "--readout_bf16_operands", "true")
    fresh = json.loads((tmp_path / "ang_on" / "meta.json").read_text())
    committed = json.loads((PORTED / "meta.json").read_text())
    assert fresh == committed
    assert committed["readout_bf16_operands"] is True
    assert committed["config"] == json.loads((ANG_ON / "meta.json").read_text())["config"]
    np.testing.assert_array_equal(committed["fourier_w"], np.float32(_FOURIER_W_SEED_1234))
    assert sorted(os.listdir(tmp_path / "ang_on" / "best")) == ["params.npz"]
    with np.load(tmp_path / "ang_on" / "best" / "params.npz") as a, \
            np.load(PORTED / "best" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sum(v.size for v in jax.tree.leaves(load_params_npz(str(PORTED / "best" / "params.npz")))) \
        == 2313007
