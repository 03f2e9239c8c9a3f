"""Snapshot sampling (``snapshot_every``) of the port's sampler against the
JAX package's segmented chain on the CPU, with the same weights and the
same random numbers (the JAX keys' draws injected as ``SamplerNoise``), at
the tiny config with T = 12: the dense chain of 11 steps paused every 5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import DiffusionModel as JModel
from arreau_tpu_torch.interop.from_jax import params_from_jax
from arreau_tpu_torch.tasks.diffusion import DiffusionModel
from tests.test_torch_model import Z_TABLE, _batch, perturbed_params, port_config, tiny_config
from tests.test_torch_sampler import LENGTH_BOUNDS, assert_same_crystals, jax_noise

B, A, T, EVERY = 4, 5, 12, 5


def _models(seed=0):
    jmodel = JModel(tiny_config(num_timesteps=T))
    host = JBatch(*map(jnp.asarray, _batch(B, A, seed)))
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), host))
    model = DiffusionModel(port_config(jmodel.config), device="cpu",
                           fourier_w=np.asarray(jmodel.fourier_w))
    params_from_jax(model, params)
    return jmodel, params, model


def test_snapshots_match_jax_segmented_chain():
    """Labels 6, 1, 0 (T - 1 - steps done, after 5, 10 and 11 steps) in both
    packages; each snapshot and the final batch agree with the JAX
    package's within the sampler test's tolerances (types where JAX's top-2
    margin of the step that drew them exceeds 1e-4)."""
    jmodel, params, model = _models()
    seen = []
    predict = jmodel.predict_scores

    def recording(*args):  # keeps the type logits of every step, in order
        out = predict(*args)
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), out[1], ordered=True)
        return out

    jmodel.predict_scores = recording
    key = jax.random.PRNGKey(11)
    kw = dict(length_bounds=LENGTH_BOUNDS, type_temperature=1.0)
    want, want_snaps = jmodel._sample_impl(params, key, B, A, snapshot_every=EVERY, **kw)
    with torch.no_grad():
        got, got_snaps = model._sample_impl(B, A, noise=jax_noise(key, T - 1, len(Z_TABLE)),
                                            snapshot_every=EVERY, **kw)
    assert [t for t, _ in want_snaps] == [t for t, _ in got_snaps] == [6, 1, 0]
    assert len(seen) == T - 1
    for (t, w), (_, g) in zip(want_snaps, got_snaps):
        assert_same_crystals(w, g, seen[T - 2 - t])
    assert_same_crystals(want, got, seen[-1])
    for name in ("frac_x", "atom_types", "lattice", "num_atoms", "atom_mask"):
        assert torch.equal(getattr(got_snaps[-1][1], name), getattr(got, name)), name


@pytest.mark.parametrize("num_atoms", [None, [5, 3, 4, 1]])
def test_final_batch_equals_the_unsegmented_chain_bit_for_bit(num_atoms):
    """The same generator gives the same final batch with and without
    snapshots (the arithmetic of the chain is the same), through ``sample``
    (inference mode) as through ``_sample_impl``; every snapshot is decoded
    as the final batch (lattice from lengths and angles, the masks kept)."""
    _, _, model = _models()
    counts = None if num_atoms is None else torch.tensor(num_atoms)
    kw = dict(length_bounds=LENGTH_BOUNDS, num_atoms=counts)
    plain = model.sample(B, A, generator=torch.Generator().manual_seed(3), **kw)
    batch, snaps = model.sample(B, A, generator=torch.Generator().manual_seed(3),
                                snapshot_every=EVERY, **kw)
    for name in plain._fields:
        assert torch.equal(getattr(plain, name), getattr(batch, name)), name
    assert [t for t, _ in snaps] == [6, 1, 0]
    for _, snap in snaps:
        assert snap.lattice.shape == (B, 3, 3) and torch.isfinite(snap.lattice).all()
        assert torch.equal(snap.atom_mask, plain.atom_mask)
        assert torch.equal(snap.num_atoms, plain.num_atoms)


def test_snapshot_labels_every_ten_of_the_full_chain():
    """T = 1000, every 10 steps: 100 snapshots, 989, 979, ..., 9, 0 (the
    JAX package's labels), here on a chain of 999 steps of a 1-layer model
    on 1 crystal of 2 atoms."""
    cfg = port_config(tiny_config(num_timesteps=1000, num_layers=1, hidden_dim=8))
    model = DiffusionModel(cfg, device="cpu")
    model.model.init_parameters(torch.Generator().manual_seed(0))
    _, snaps = model.sample(1, 2, generator=torch.Generator().manual_seed(0), snapshot_every=10)
    assert [t for t, _ in snaps] == list(range(989, 8, -10)) + [0]
    assert len(snaps) == 100


def test_snapshots_with_strided_sampling_raise():
    _, _, model = _models()
    with pytest.raises(ValueError, match="strided"):
        model.sample(B, A, generator=torch.Generator().manual_seed(0), sample_steps=3,
                     snapshot_every=EVERY)
    # sample_steps at or above T - 1 is the dense chain, which takes snapshots
    _, snaps = model.sample(B, A, generator=torch.Generator().manual_seed(0), sample_steps=T - 1,
                            snapshot_every=EVERY)
    assert [t for t, _ in snaps] == [6, 1, 0]
