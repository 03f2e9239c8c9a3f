"""The parameters the port draws from a JAX key against Flax's
``model.init`` of the JAX model from the same key, on the CPU, without
``enable_x64``: the diffusion model in several configurations and the EGNN
baseline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arreau_tpu.models.egnn import EGNN as JEGNN
from arreau_tpu.models.egnn import EGNNConfig as JEGNNConfig
from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import DiffusionModel as JModel
from arreau_tpu_torch.interop.from_jax import params_to_jax
from arreau_tpu_torch.models.egnn import EGNN, EGNNConfig
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.tasks.diffusion import DiffusionModel, batch_to_device
from tests.test_torch_jax_streams import A, B, _flat
from tests.test_torch_model import _batch, port_config, tiny_config
from tests.test_torch_prng import NORMAL_ULP, _ulp_gap

SEEDS = [0, 1, 12345]


INIT_CONFIGS = {
    "default": {},
    "kernel_branch": dict(use_pallas=True),
    "diffused_angles_in_bias": dict(diffuse_angles=True, basis_bias="in"),
    "per_layer_readouts": dict(stacked_readout=False, multiple_readouts=False, layer_scale=None),
}


@pytest.mark.parametrize("config", list(INIT_CONFIGS))
def test_init_from_a_key_matches_flax(config):
    """``DiffusionModel.init(key, batch)`` against Flax's ``model.init`` of
    the JAX model from the same key, seeds 0, 1 and 12345: the same tree,
    every leaf within ``NORMAL_ULP``."""
    with jax.enable_x64(False):
        jmodel = JModel(tiny_config(**INIT_CONFIGS[config]))
        host = _batch(B, A, 0)
        jhost = JBatch(*map(jnp.asarray, host))
        for seed in SEEDS:
            want = _flat(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jhost))
            model = DiffusionModel(port_config(jmodel.config), device="cpu")
            model.init(prng.prng_key(seed), batch_to_device(host, "cpu"))
            got = _flat(params_to_jax(model.model))
            assert got.keys() == want.keys()
            for name in want:
                assert _ulp_gap(got[name], want[name]) <= NORMAL_ULP, (seed, name)


def test_egnn_init_from_a_key_matches_flax():
    """The EGNN baseline's ``init_parameters(key)`` (its ``coord`` head at
    variance scale 0.001) against Flax's ``model.init``: every leaf within
    ``NORMAL_ULP``."""
    rng = np.random.default_rng(0)
    pos, vel = rng.normal(size=(2, 5, 3)), rng.normal(size=(2, 5, 3))
    charges = rng.choice([-1.0, 1.0], size=(2, 5))
    cfg = dict(hidden_dim=16, num_layers=3)
    with jax.enable_x64(False):
        for seed in SEEDS:
            want = _flat(JEGNN(JEGNNConfig(**cfg)).init(
                jax.random.PRNGKey(seed), *(jnp.asarray(a, jnp.float32) for a in (pos, vel,
                                                                                  charges))))
            model = EGNN(EGNNConfig(**cfg))
            model.init_parameters(prng.prng_key(seed))
            got = _flat(params_to_jax(model))
            assert got.keys() == want.keys()
            for name in want:
                assert _ulp_gap(got[name], want[name]) <= NORMAL_ULP, (seed, name)
