"""The port's bfloat16 sampler from a JAX key, nothing injected, against
the JAX package's ``_sample_impl(params, PRNGKey(s), B, A)`` on the CPU:
dense and strided chains, angles fixed or diffused (T = 50, ancestral
noise, gumbel type draws). The JAX chains run in one fresh process with
XLA's excess precision off (in-process, XLA's CPU compiler keeps bfloat16
intermediates in float32) and without ``enable_x64``."""

import os
import subprocess
import sys

import numpy as np
import pytest

from arreau_tpu_torch.ops import prng
from tests.test_torch_jax_streams import A, B, ROOT, SAMPLE_KW, _jax_model, port_model_and_noise

SEED = 3
# the injected-noise chain tests' T (tiny_config's); at T = 20 the strided
# chain with Bravais angles parts from JAX's in one type (PERF.md, Findings)
NUM_TIMESTEPS = 50
CHAINS = [(steps, angles) for steps in (3, None) for angles in (False, True)]
# a bfloat16 chain through both packages: the backbone's bfloat16 rounding
# points are the same, its sums are not, so the chains part as the flagship
# chain's do (tests/test_torch_trained_checkpoint_chain.py): each lattice
# length within 5%
BF16_LENGTH_RTOL = 5e-2

# argv: out path, T; every chain of CHAINS, as the JAX package samples it
_JAX_BF16_SAMPLES = """
import sys
import jax
import numpy as np
from tests.test_torch_jax_streams import A, B, SAMPLE_KW, _jax_model
from tests.test_torch_jax_streams_bf16 import CHAINS, SEED

out = {}
for steps, angles in CHAINS:
    jmodel, params = _jax_model(SEED, diffuse_angles=angles, compute_dtype="bfloat16",
                                num_timesteps=int(sys.argv[2]))
    kw = dict(SAMPLE_KW, sample_steps=steps)
    got = jax.jit(lambda p, k: jmodel._sample_impl(p, k, B, A, **kw))(params,
                                                                    jax.random.PRNGKey(SEED))
    out[f"{steps}_{angles}_lattice"] = np.asarray(got.lattice)
    out[f"{steps}_{angles}_types"] = np.asarray(got.atom_types)
np.savez(sys.argv[1], **out)
"""


def jax_bf16_chains(path, num_timesteps=NUM_TIMESTEPS) -> dict:
    """The JAX package's bfloat16 chains of CHAINS at ``num_timesteps``,
    sampled in a fresh process."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1 "
                        "--xla_allow_excess_precision=false"}
    subprocess.run([sys.executable, "-c", _JAX_BF16_SAMPLES, str(path), str(num_timesteps)],
                   cwd=ROOT, env=env, check=True, timeout=600)
    with np.load(path) as a:
        return {k: a[k] for k in a.files}


def port_bf16_chain(sample_steps, diffuse_angles, num_timesteps=NUM_TIMESTEPS):
    """The port's bfloat16 chain from ``prng_key(SEED)``, nothing injected."""
    jmodel, params = _jax_model(SEED, diffuse_angles=diffuse_angles, compute_dtype="bfloat16",
                                num_timesteps=num_timesteps)
    model = port_model_and_noise(jmodel, params, SEED, sample_steps, diffuse_angles)
    return model.sample(B, A, key=prng.prng_key(SEED), **dict(SAMPLE_KW, sample_steps=sample_steps))


@pytest.fixture(scope="module")
def jax_chains(tmp_path_factory):
    return jax_bf16_chains(tmp_path_factory.mktemp("bf16") / "jax.npz")


@pytest.mark.parametrize("sample_steps,diffuse_angles", CHAINS,
                         ids=[f"{'strided' if s else 'dense'}-{'diffused' if a else 'bravais'}"
                              for s, a in CHAINS])
def test_bf16_sample_from_a_key_matches_jax(jax_chains, sample_steps, diffuse_angles):
    """The noise the port draws is JAX's (``port_model_and_noise``); the
    bfloat16 crystals are within the flagship chain test's tolerances
    (``tests/test_torch_trained_checkpoint_chain.py``): every type the
    same, each lattice length within ``BF16_LENGTH_RTOL``."""
    got = port_bf16_chain(sample_steps, diffuse_angles)
    name = f"{sample_steps}_{diffuse_angles}"
    np.testing.assert_array_equal(got.atom_types.numpy(), jax_chains[f"{name}_types"])
    np.testing.assert_allclose(np.linalg.norm(got.lattice.numpy(), axis=-1),
                               np.linalg.norm(jax_chains[f"{name}_lattice"], axis=-1),
                               rtol=BF16_LENGTH_RTOL)
