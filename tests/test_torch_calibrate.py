"""The port's conv-kernel calibration (``arreau_tpu_torch/models/calibrate.py``)
against the JAX package's (``arreau_tpu/models/calibrate.py``) on a tiny
``PonitaFiberBundle``, on the CPU: the same weights, inputs and neighbour
list, padded atoms included. The port's kernel branch (the kernels' plain
versions on the CPU) against its plain branch too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.models.calibrate import calibrate_conv_kernels as j_calibrate
from arreau_tpu.models.ponita import FiberBundleInputs as JInputs
from arreau_tpu.models.ponita import PonitaConfig as JConfig
from arreau_tpu.models.ponita import PonitaFiberBundle as JBackbone
from arreau_tpu.ops.pbc import pbc_neighbor_list as j_pbc_neighbor_list
from arreau_tpu_torch.data.synthetic import random_lattices
from arreau_tpu_torch.interop.from_jax import _flatten, params_from_jax, params_to_jax
from arreau_tpu_torch.models.calibrate import calibrate_conv_kernels
from arreau_tpu_torch.models.ponita import FiberBundleInputs, PonitaConfig, PonitaFiberBundle, pick_tile
from arreau_tpu_torch.ops.grids import cached_grid_s2
from arreau_tpu_torch.ops.pbc import NeighborList
from tests.test_torch_model import perturbed_params

# a std over every element of a layer's output (float32 sums in other
# orders than XLA's), and kernels rescaled by its inverse
CAL_TOL = dict(rtol=1e-5, atol=1e-7)
B, A, F, V, L = 4, 5, 6, 2, 2
COMMON = dict(hidden_dim=16, basis_dim=8, degree=2, num_layers=L, radius=4.0, num_ori=4,
              output_dim_scalar=2, output_dim_vec=1, output_dim_global_scalar=3)


def _inputs(seed=0):
    """(JAX inputs, port inputs): 4 crystals of 5, 3, 4 and 2 atoms padded to
    5 (the padded rows carry random features, as the JAX tests' inputs do);
    the neighbour list is JAX's, with every in-radius image an edge."""
    rng = np.random.default_rng(seed)
    lattice = random_lattices(rng, B).astype(np.float32)
    frac = rng.uniform(size=(B, A, 3)).astype(np.float32)
    mask = np.arange(A)[None, :] < np.array([5, 3, 4, 2])[:, None]
    scalar = rng.normal(size=(B, A, F)).astype(np.float32)
    vec = rng.normal(size=(B, A, V, 3)).astype(np.float32)
    ori = cached_grid_s2(COMMON["num_ori"]).astype(np.float32)
    cart = np.einsum("bai,bij->baj", frac, lattice)
    nl = j_pbc_neighbor_list(jnp.asarray(cart), jnp.asarray(lattice), jnp.asarray(mask),
                             COMMON["radius"], 27 * A)
    jin = JInputs(jnp.asarray(scalar), jnp.asarray(vec), nl, jnp.asarray(mask),
                  jnp.asarray(lattice), jnp.asarray(ori))
    neighbors = NeighborList(*(torch.tensor(np.asarray(a)) for a in nl))
    neighbors = neighbors._replace(src=neighbors.src.long(), image=neighbors.image.long())
    pin = FiberBundleInputs(torch.tensor(scalar), torch.tensor(vec), neighbors, torch.tensor(mask),
                            torch.tensor(lattice), torch.tensor(ori))
    return jin, pin


def _jax_setup(seed=0):
    jin, pin = _inputs(seed)
    jmodel = JBackbone(JConfig(**COMMON, remat=False, use_pallas=False))
    params = perturbed_params(jmodel.init(jax.random.PRNGKey(seed + 1), jin), seed)
    return jmodel, params, jin, pin


def _port(params, use_kernels: bool) -> PonitaFiberBundle:
    backbone = PonitaFiberBundle(PonitaConfig(input_dim_scalar=F, input_dim_vec=V, **COMMON,
                                              use_kernels=use_kernels))
    params_from_jax(backbone, params)
    return backbone


def _layer_outputs(backbone, inputs) -> list:
    """Each interaction layer's output in the plain layout ``[B, A, O, C]``
    (the kernel branch's ``[B', O, TA, C]`` laid back)."""
    outs = []
    hooks = [layer.register_forward_hook(lambda m, a, out: outs.append(out[0]))
             for layer in backbone.layers]
    with torch.no_grad():
        backbone(inputs)
    for h in hooks:
        h.remove()
    if backbone.config.use_kernels:
        tile = pick_tile(B, A, target=128)
        outs = [o.reshape(B // tile, o.shape[1], tile, A, -1).permute(0, 2, 3, 1, 4)
                .reshape(B, A, o.shape[1], -1) for o in outs]
    return outs


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernel_branch"])
def test_calibration_matches_jax(use_kernels):
    """The measured stds and the rescaled conv kernels against JAX's
    ``calibrate_conv_kernels`` (its plain branch); every other parameter
    unchanged."""
    jmodel, params, jin, pin = _jax_setup()
    want_params, want_stds = j_calibrate(jmodel.apply, params, jin)
    backbone = _port(params, use_kernels)
    stds = calibrate_conv_kernels(backbone, pin)
    assert list(stds) == [f"layers.{i}" for i in range(L)]
    for i in range(L):
        np.testing.assert_allclose(stds[f"layers.{i}"], float(want_stds[f"layer_{i}/__call__"]),
                                   **CAL_TOL)
        assert stds[f"layers.{i}"] > 0
    got = _flatten(params_to_jax(backbone))
    want, before = _flatten(jax.tree.map(np.asarray, want_params)), _flatten(params)
    assert got.keys() == want.keys()
    for key, value in want.items():
        if key.endswith("conv/kernel"):
            assert not np.allclose(value, before[key])
            np.testing.assert_allclose(got[key], value, **CAL_TOL, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], before[key], err_msg=key)


def test_padded_rows_match_jax():
    """The std runs over every row, padded atoms included, so the layers'
    outputs there must be JAX's too: each layer's whole output, plain branch
    against JAX's captured intermediates, kernel branch against plain."""
    jmodel, params, jin, pin = _jax_setup(seed=2)
    _, state = jmodel.apply(params, jin, capture_intermediates=True, mutable=["intermediates"])
    plain = _layer_outputs(_port(params, False), pin)
    kernel = _layer_outputs(_port(params, True), pin)
    padded = ~pin.atom_mask
    assert padded.any()
    for i in range(L):
        want = np.asarray(state["intermediates"][f"layer_{i}"]["__call__"][0][0])
        assert want.shape == tuple(plain[i].shape) == (B, A, COMMON["num_ori"], COMMON["hidden_dim"])
        scale = np.abs(want).max()
        np.testing.assert_allclose(plain[i].numpy(), want, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(plain[i][padded].numpy(), want[padded.numpy()], rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(kernel[i].numpy(), plain[i].numpy(), rtol=0, atol=1e-5 * scale)


def test_kernel_branch_matches_plain_branch():
    """The same calibration on the kernel branch and on the plain branch of
    the port, and the calibrated model's next forward: each layer's output
    std moves to 1 on the layer the rescale reaches first."""
    _, params, _, pin = _jax_setup(seed=3)
    results = {}
    for use_kernels in (False, True):
        backbone = _port(params, use_kernels)
        results[use_kernels] = (calibrate_conv_kernels(backbone, pin),
                                _flatten(params_to_jax(backbone)), backbone)
    (s0, p0, _), (s1, p1, kernel_backbone) = results[False], results[True]
    for name in s0:
        np.testing.assert_allclose(s1[name], s0[name], **CAL_TOL)
    for key in p0:
        np.testing.assert_allclose(p1[key], p0[key], **CAL_TOL, err_msg=key)
    out = kernel_backbone(pin)
    assert all(torch.isfinite(t).all() for t in out if torch.is_tensor(t))
    # a second calibration measures the rescaled model: its stds differ
    again = calibrate_conv_kernels(_port(params, True), pin)
    assert again == pytest.approx(s1, rel=1e-5)
    assert calibrate_conv_kernels(kernel_backbone, pin) != pytest.approx(s1, rel=1e-5)


def test_zero_std_keeps_the_kernel():
    """A layer whose output is constant (std 0) is left as it is, as the JAX
    function leaves it."""
    _, params, _, pin = _jax_setup(seed=4)
    backbone = _port(params, False)
    layer = backbone.layers[0]
    with torch.no_grad():
        layer.layer_scale.zero_()
        layer.norm.weight.zero_()
    pin = pin._replace(scalar=torch.zeros_like(pin.scalar), vec=torch.zeros_like(pin.vec))
    before = layer.conv.kernel.detach().clone()
    stds = calibrate_conv_kernels(backbone, pin)
    assert stds["layers.0"] == 0.0
    assert torch.equal(layer.conv.kernel, before)


def test_target_std_scales_the_rescale():
    _, params, _, pin = _jax_setup(seed=5)
    a, b = _port(params, False), _port(params, False)
    calibrate_conv_kernels(a, pin)
    calibrate_conv_kernels(b, pin, target_std=2.0)
    for la, lb in zip(a.layers, b.layers):
        np.testing.assert_allclose(lb.conv.kernel.detach().numpy(),
                                   2.0 * la.conv.kernel.detach().numpy(), rtol=1e-6)


def test_config_fields_match_jax():
    """The tiny backbone's settings mean the same in both packages."""
    jfields = {f.name for f in dataclasses.fields(JConfig)}
    assert set(COMMON) <= jfields
    assert set(COMMON) <= {f.name for f in dataclasses.fields(PonitaConfig)}
