"""The flagship checkpoint's bfloat16 reverse chain on a few crystals
through both packages, on the CPU: the JAX package's chain in a fresh
process (its readout as the CPU computes it and as a TPU does), the port's
on the same injected noise. The chain takes minutes; in a file of its own
it runs beside the other checks of ``tests/test_torch_trained_checkpoint.py``,
whose helpers it shares."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arreau_tpu_torch.tasks.diffusion import SamplerNoise
from tests.test_torch_trained_checkpoint import ANG_ON, ROOT, _TPU_READOUT, port_flagship

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
