"""``PonitaConfig.remat`` and ``stacked_readout`` of the port against the
JAX package on the CPU (its plain branch: each loss term and every
parameter gradient), the port's rematerialised blocks against its
blocks kept whole (bit for bit, on each branch), ``make_ponita``'s fields,
and a model of another Fourier seed through training, its checkpoint and
generate."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.models.ponita import PonitaConfig as JPonitaConfig
from arreau_tpu.ops.fourier import make_fourier_weights
from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu_torch.cli import generate, train_diffusion
from arreau_tpu_torch.interop.from_jax import _jax_name
from arreau_tpu_torch.models import make_ponita
from arreau_tpu_torch.models.ponita import PonitaConfig
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.tasks.diffusion import (
    DiffusionConfig,
    DiffusionModel,
    batch_to_device,
    draw_loss_noise,
)
from tests.test_torch_model import tiny_config
from tests.test_torch_train import (
    GRAD_REL_TOL,
    GRAPH,
    LOSS_TOL,
    TINY_ARGS,
    _batch,
    _flat,
    _jax_setup,
    _port_model,
    loss_noise,
)


def test_remat_and_per_layer_readout_match_jax():
    """The JAX package's plain branch with ``remat=True`` (``nn.remat``
    around each block) and ``stacked_readout=False`` (an ``nn.Dense`` a
    layer) against the port's with both fields: each loss term within
    ``LOSS_TOL`` (1e-5 relative) and every parameter gradient within 1e-4 of
    its largest entry, as the port's other float32 parity tests."""
    config = dict(remat=True, stacked_readout=False)
    jmodel, host, params = _jax_setup(True, use_pallas=False, **config)
    key = jax.random.PRNGKey(5)
    (_, want_metrics), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, key, JBatch(*map(jnp.asarray, host))), has_aux=True))(params)
    want_grads = _flat(want_grads)

    model = _port_model(jmodel, params, use_kernels=False)
    assert all(getattr(model.model.config, k) == v for k, v in config.items())
    loss, metrics = model.loss(batch_to_device(host, "cpu"), loss_noise(key, host, jmodel.config))
    assert set(metrics) == set(want_metrics)
    for name, value in want_metrics.items():
        np.testing.assert_allclose(metrics[name].item(), float(value), **LOSS_TOL, err_msg=name)
    loss.backward()
    for name, p in model.model.named_parameters():
        key_, transpose = _jax_name(name)
        want = want_grads[key_]
        got = (p.grad.t() if transpose else p.grad).numpy()
        assert np.abs(got - want).max() <= GRAD_REL_TOL * np.abs(want).max(), name


BRANCHES = {
    "plain": dict(use_pallas=False),
    "kernels": dict(use_pallas=True),
    "fuse_fiber": dict(use_pallas=True, fuse_fiber=True),
    "bf16_fuse_convnext": dict(use_pallas=True, compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_remat_equals_whole_blocks_bit_for_bit(branch):
    """One loss and backward with ``remat`` on and off, on the same weights
    and noise: every loss term and every parameter gradient equal bit for
    bit (the recompute runs the same operations on the same inputs). The
    kernel branches run the kernels' plain versions here,
    ``bf16_fuse_convnext`` the fused ConvNext tail and readout (#9/#10).
    Each block is called twice a step with ``remat`` (the recompute), once
    without, and once either way without gradients."""
    host = _batch()
    config = DiffusionConfig(**{**dataclasses.asdict(tiny_config(diffuse_angles=True, **GRAPH)),
                                **BRANCHES[branch]})
    g = torch.Generator().manual_seed(0)  # the perturbed layer scales and biases
    noise = draw_loss_noise(prng.prng_key(0), *host.atom_types.shape, config.num_atomic_states,
                            config.num_timesteps, True, "cpu")
    state = None
    results = {}
    for remat in (False, True):
        model = DiffusionModel(dataclasses.replace(config, remat=remat), device="cpu")
        if branch == "bf16_fuse_convnext":
            # no config field reaches the fused ConvNext path, in either package
            model.model = type(model.model)(dataclasses.replace(model.model.config,
                                                                fuse_convnext=True))
        backbone = model.model
        if state is None:
            # layer scales of order 1 and nonzero biases: the blocks count
            backbone.init_parameters(prng.prng_key(0))
            state = {k: torch.rand(v.shape, generator=g) + 0.5 if k.endswith("layer_scale")
                     else (torch.randn(v.shape, generator=g) * 0.2 if k.endswith("bias") else v)
                     for k, v in backbone.state_dict().items()}
        backbone.load_state_dict(state)
        calls = []
        for layer in backbone.layers:
            layer.register_forward_pre_hook(lambda *_: calls.append(1))
        loss, metrics = model.loss(batch_to_device(host, "cpu"), noise)
        loss.backward()
        assert len(calls) == (2 if remat else 1) * len(backbone.layers)
        with torch.no_grad():
            model.loss(batch_to_device(host, "cpu"), noise)
        assert len(calls) == (3 if remat else 2) * len(backbone.layers)
        results[remat] = ({k: v.item() for k, v in metrics.items()},
                          {n: p.grad.clone() for n, p in backbone.named_parameters()})
    assert results[True][0] == results[False][0]
    for name, want in results[False][1].items():
        assert torch.equal(results[True][1][name], want), name


def test_remat_keeps_the_window_cotangent(monkeypatch):
    """Position gradients of the backbone with ``position_grads`` on the
    kernel branch, ``remat`` on against off: equal bit for bit; #3 runs
    twice a layer with ``remat`` (the recompute), #4 with its window
    cotangent once a layer either way."""
    from arreau_tpu.ops.radius import radius_neighbor_list as j_radius_neighbor_list
    from arreau_tpu_torch.interop.from_jax import params_to_jax
    from arreau_tpu_torch.kernels import spatial_conv
    from arreau_tpu_torch.models.ponita import PonitaFiberBundle
    from tests.test_torch_position_grads import CFG, K, _Counted, _host, _port_position_grad

    host = _host(1)
    nl = j_radius_neighbor_list(jnp.asarray(host["pos"]), jnp.asarray(host["mask"]), 1000.0, K,
                                loop=False)
    g = torch.Generator().manual_seed(2)  # the perturbed layer scales and biases
    backbone = PonitaFiberBundle(PonitaConfig(input_dim_scalar=3, input_dim_vec=1, **CFG))
    backbone.init_parameters(prng.prng_key(2))
    with torch.no_grad():
        for name, p in backbone.named_parameters():
            if name.endswith("layer_scale") or name.endswith("bias"):
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
    params = params_to_jax(backbone)
    grads = {}
    for remat in (False, True):
        counted = {name: _Counted(getattr(spatial_conv, name))
                   for name in ("spatial_conv", "spatial_conv_bwd")}
        for name, c in counted.items():
            monkeypatch.setattr(spatial_conv, name, c)
        grads[remat] = _port_position_grad(host, params, nl, remat=remat, use_kernels=True)
        layers = CFG["num_layers"]
        assert counted["spatial_conv"].calls == (2 if remat else 1) * layers
        assert counted["spatial_conv_bwd"].calls == counted["spatial_conv_bwd"].window_grad == layers
    assert np.abs(grads[False]).max() > 0
    np.testing.assert_array_equal(grads[True], grads[False])


def test_make_ponita_takes_every_jax_field():
    """Every field of the JAX package's ``PonitaConfig`` is a keyword of the
    port's ``make_ponita`` (``use_pallas`` standing for ``use_kernels``),
    with the JAX package's default."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(JPonitaConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(PonitaConfig)}
    port_fields["use_pallas"] = port_fields.pop("use_kernels")
    assert {k: port_fields.get(k) for k in jax_fields} == jax_fields
    kwargs = {**jax_fields, "num_ori": 4, "hidden_dim": 8, "basis_dim": 4}
    model = make_ponita(input_dim_scalar=3, input_dim_vec=1, **kwargs)
    assert model.config.remat and model.config.stacked_readout and model.config.use_kernels is None


def test_other_fourier_seed_trains_saves_and_generates(tmp_path, monkeypatch):
    """A model with ``fourier_seed=7`` (which raised before the port drew
    its frequencies): the training CLI builds it, takes a step and saves a
    ``meta.json`` whose ``fourier_w`` is the JAX package's float32-mode draw
    for seed 7, bit for bit; generate reloads those frequencies and
    samples."""
    monkeypatch.setattr(train_diffusion, "DiffusionConfig",
                        functools.partial(DiffusionConfig, fourier_seed=7))
    ckpt = tmp_path / "ckpt"
    loss = train_diffusion.main([*TINY_ARGS, "--max_steps", "1", "--checkpoint_dir", str(ckpt)])
    assert np.isfinite(loss)
    with jax.enable_x64(False):
        want = np.asarray(make_fourier_weights(jax.random.PRNGKey(7), 32, 16.0))
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["config"]["fourier_seed"] == 7
    np.testing.assert_array_equal(np.float32(meta["fourier_w"]), want)
    model, _, _ = generate.load_model(str(ckpt), "last", True, "cpu")
    np.testing.assert_array_equal(model.fourier_w.numpy(), want)
    result = generate.main(["--device", "cpu", "--checkpoint_dir", str(ckpt), "--num_crystals",
                            "2", "--batch_size", "2", "--num_atoms_per_sample", "4",
                            "--sample_steps", "3", "--out_dir", str(tmp_path / "gen")])
    assert result.num_crystals == 2 and np.isfinite(result.frac_x).all()
