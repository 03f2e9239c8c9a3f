"""The port's own random streams against the JAX package's on the CPU: from
the same seed, with no number injected, the port draws what the JAX
package draws and gives its results. Here ``DiffusionModel.sample`` with a
key in float32 (dense and strided chains, angles fixed or diffused); its
bfloat16 chains are ``tests/test_torch_jax_streams_bf16.py``, the loss
from a key ``tests/test_torch_jax_loss_streams.py``, ``init`` against
Flax's ``model.init`` ``tests/test_torch_jax_init.py``, the generate and
training CLIs ``tests/test_torch_jax_cli_streams.py`` and
``tests/test_torch_jax_train_streams.py``.

JAX runs without ``enable_x64``, as its CLIs do (under it, JAX draws the
Bravais angles and the loss's timesteps in 64 bits)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import DiffusionModel as JModel
from arreau_tpu_torch.interop.from_jax import params_from_jax
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.tasks.diffusion import DiffusionModel, strided_levels
from tests.test_torch_model import Z_TABLE, _batch, perturbed_params, port_config, tiny_config
from tests.test_torch_prng import NORMAL_ULP, _ulp_gap
from tests.test_torch_sampler import LENGTH_BOUNDS, assert_same_crystals, jax_noise

ROOT = Path(__file__).resolve().parents[1]
B, A = 4, 5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def _jax_model(seed, **config):
    """A tiny JAX model (``tests/test_torch_model.py:tiny_config``, T = 50, as
    the injected-noise chain tests take it; float32 draws) and perturbed
    parameters."""
    with jax.enable_x64(False):
        jmodel = JModel(tiny_config(**config))
        host = JBatch(*map(jnp.asarray, _batch(B, A, seed)))
        params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), host), seed)
    return jmodel, params


SAMPLE_KW = dict(length_bounds=LENGTH_BOUNDS, type_temperature=1.0, ddim_eta=1.0)


def port_model_and_noise(jmodel, params, seed, sample_steps, diffuse_angles):
    """The port's model of ``jmodel`` with ``params``; checks first that the
    noise it draws from ``prng_key(seed)`` is the JAX sampler's from
    ``PRNGKey(seed)`` (uniforms bit for bit, normals within
    ``NORMAL_ULP``)."""
    model = DiffusionModel(port_config(jmodel.config), device="cpu",
                           fourier_w=np.asarray(jmodel.fourier_w))
    params_from_jax(model, params)
    T = jmodel.config.num_timesteps
    S = len(strided_levels(T, sample_steps)) - 1 if sample_steps else T - 1
    with jax.enable_x64(False):
        injected = jax_noise(jax.random.PRNGKey(seed), S, len(Z_TABLE))
    drawn = model.draw_noise(prng.prng_key(seed), B, A, sample_steps)
    for name in ("lengths0", "frac0", "lattice", "angle", "pos"):
        assert _ulp_gap(getattr(drawn, name), getattr(injected, name)) <= NORMAL_ULP, name
    assert torch.equal(drawn.types, injected.types)
    if not diffuse_angles:
        assert torch.equal(drawn.angles, injected.angles)
    return model


@pytest.mark.parametrize("diffuse_angles", [False, True], ids=["bravais", "diffused"])
@pytest.mark.parametrize("sample_steps", [3, None], ids=["strided", "dense"])
def test_sample_from_a_key_matches_jax(sample_steps, diffuse_angles):
    """``sample(B, A, key=prng_key(s))``, nothing injected, against the JAX
    package's ``_sample_impl(params, PRNGKey(s), B, A)`` (ancestral noise,
    gumbel type draws), float32: the noise the port draws is JAX's
    (``port_model_and_noise``) and the crystals are within the injected-noise
    chain tests' tolerances (``tests/test_torch_sampler.py``)."""
    seed = 3
    jmodel, params = _jax_model(seed, diffuse_angles=diffuse_angles)
    kw = dict(SAMPLE_KW, sample_steps=sample_steps)
    model = port_model_and_noise(jmodel, params, seed, sample_steps, diffuse_angles)
    got = model.sample(B, A, key=prng.prng_key(seed), **kw)
    seen = []
    predict = jmodel.predict_scores

    def recording(*args):  # the type logits of every step, in order
        out = predict(*args)
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), out[1], ordered=True)
        return out

    jmodel.predict_scores = recording
    with jax.enable_x64(False):
        want = jmodel._sample_impl(params, jax.random.PRNGKey(seed), B, A, **kw)
    assert_same_crystals(want, got, seen[-1])
