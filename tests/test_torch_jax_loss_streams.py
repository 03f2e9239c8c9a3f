"""``DiffusionModel.loss`` from a JAX key, nothing injected, against the
JAX package's ``loss(params, PRNGKey(s), batch, timestep)`` on the CPU,
without ``enable_x64`` (under it JAX draws the timesteps in 64 bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import DiffusionModel as JModel
from arreau_tpu_torch.interop.from_jax import params_from_jax
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.tasks.diffusion import DiffusionModel, batch_to_device
from tests.test_torch_model import perturbed_params, port_config, tiny_config
from tests.test_torch_train import GRAPH, LOSS_TOL
from tests.test_torch_train import _batch as train_batch


@pytest.mark.parametrize("timestep", [None, 17], ids=["drawn_t", "fixed_t"])
@pytest.mark.parametrize("diffuse_angles", [False, True], ids=["bravais", "diffused"])
def test_loss_from_a_key_matches_jax(diffuse_angles, timestep):
    """``loss(batch, key, timestep)``, nothing injected, against the JAX
    package's ``loss(params, PRNGKey(s), batch, timestep)`` on the plain
    branches (a padded batch of 6 crystals): every loss term within the
    loss parity tolerance (``tests/test_torch_train.py``)."""
    seed = 11
    with jax.enable_x64(False):
        jmodel = JModel(tiny_config(diffuse_angles=diffuse_angles, use_pallas=False, **GRAPH))
        host = train_batch(seed)
        jbatch = JBatch(*map(jnp.asarray, host))
        params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jbatch), seed)
        _, want = jax.jit(lambda p, k: jmodel.loss(p, k, jbatch, timestep=timestep))(
            params, jax.random.PRNGKey(seed))
    model = DiffusionModel(port_config(jmodel.config), device="cpu",
                           fourier_w=np.asarray(jmodel.fourier_w))
    params_from_jax(model, params)
    with torch.no_grad():
        _, got = model.loss(batch_to_device(host, "cpu"), prng.prng_key(seed), timestep)
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].item(), float(value), **LOSS_TOL, err_msg=name)
