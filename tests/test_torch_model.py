"""The PyTorch port's backbone against the JAX package on the CPU: the
blocks, parameter carrying, and the whole score prediction (PBC graph,
invariants, basis MLPs, conv layers, readouts) with the same weights."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.data.synthetic import make_synthetic_batch, synthetic_z_table
from arreau_tpu.models.blocks import polynomial_features as j_poly
from arreau_tpu.ops.lattice import matrix_to_params
from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import DiffusionConfig as JConfig
from arreau_tpu.tasks.diffusion import DiffusionModel as JModel
from arreau_tpu_torch.interop.from_jax import (
    load_params_npz,
    params_from_jax,
    params_to_jax,
    save_params_npz,
)
from arreau_tpu_torch.models.blocks import BasisMLP, LayerNorm, gelu, polynomial_features
from arreau_tpu_torch.tasks.diffusion import DiffusionConfig, DiffusionModel

Z_TABLE = synthetic_z_table()
# max_neighbors = 27 * A (A = 5 atoms): every image within the radius is an
# edge, so the graph cannot depend on how the two packages order images at
# equal distance (an atom's own images at +a and -a always are); the
# neighbor-list test holds the top-K selection itself to the JAX package.
# outputs of order 1 after the graph, two conv layers and the readouts, in
# float32 with sums in another order than XLA's: ~1e-5 of the output scale
F32_MODEL = dict(rtol=1e-4, atol=1e-4)


def tiny_config(**kw):
    base = dict(num_atomic_states=len(Z_TABLE), num_timesteps=50, radius=5.0, max_neighbors=135,
                hidden_dim=16, basis_dim=8, degree=2, num_layers=2, num_ori=4, remat=False)
    return JConfig(**{**base, **kw})


def perturbed_params(params, seed=0):
    """The JAX init with every layer scale and bias drawn at random: at the
    init's layer scale of 1e-6 the conv layers would barely reach the
    outputs, and zero biases would test nothing."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "layer_scale":
                out[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
            elif k == "bias":
                out[k] = (rng.normal(size=v.shape) * 0.2).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(jax.tree.map(np.asarray, params))


def port_config(jcfg, **kw):
    return DiffusionConfig(**{**dataclasses.asdict(jcfg), **kw})


def _batch(B, A, seed):
    return make_synthetic_batch(np.random.default_rng(seed), Z_TABLE, B, A)


def test_port_config_has_every_jax_field():
    """A checkpoint's meta.json config loads into the port unchanged."""
    assert {f.name for f in dataclasses.fields(JConfig)} == {
        f.name for f in dataclasses.fields(DiffusionConfig)
    }


# ---------------- blocks ----------------


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_polynomial_features_match_jax(degree):
    x = np.random.default_rng(0).normal(size=(3, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(polynomial_features(torch.tensor(x), degree).numpy(),
                                  np.asarray(j_poly(jnp.asarray(x), degree)))


def test_layer_norm_and_gelu_match_flax():
    """flax LayerNorm takes the fast variance E[x^2]-E[x]^2 (eps 1e-5 as
    the port pins it); flax gelu is the tanh approximation."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 7, 32)) * 3.0 + 5.0).astype(np.float32)
    scale = rng.normal(size=32).astype(np.float32)
    bias = rng.normal(size=32).astype(np.float32)
    want = fnn.LayerNorm(epsilon=1e-5).apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    ln = LayerNorm(32)
    ln.load_state_dict({"weight": torch.tensor(scale), "bias": torch.tensor(bias)})
    with torch.no_grad():
        np.testing.assert_allclose(ln(torch.tensor(x)).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gelu(torch.tensor(x)).numpy(), np.asarray(fnn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_basis_mlp_kernel_layout_matches_plain_layout():
    """The kernel-layout forward (lane-major attributes, first layer in the
    basis_h1 wrapper, one alias per consuming layer) is the same function as
    the plain forward."""
    torch.manual_seed(0)
    mlp = BasisMLP(6, 20, 12, 3)
    attr = torch.randn(2, 3, 6, 40)  # [B', O, d, E]
    with torch.no_grad():
        want = mlp(attr.transpose(-1, -2))
        got = mlp.forward_kernel_layout(attr, 3)
    assert len(got) == 3
    for g in got:
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


# ---------------- parameters ----------------


def test_params_round_trip_through_jax_layout_and_npz(tmp_path):
    jmodel = JModel(tiny_config())
    host = _batch(4, 5, 2)
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(0), JBatch(*map(jnp.asarray, host))))
    model = DiffusionModel(port_config(jmodel.config), device="cpu")
    params_from_jax(model, params)
    save_params_npz(str(tmp_path / "params.npz"), params_to_jax(model.model))
    back = load_params_npz(str(tmp_path / "params.npz"))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, value in flat_a:
        np.testing.assert_array_equal(flat_b[path], value)
    with pytest.raises(KeyError, match="no place"):
        params_from_jax(model, {**params, "params": {**params["params"], "extra": {"kernel": np.ones(2)}}})
    missing = {k: v for k, v in params["params"].items() if k != "x_embedder"}
    with pytest.raises(KeyError, match="x_embedder"):
        params_from_jax(model, {"params": missing})


# ---------------- the backbone, end to end ----------------


def _scores_inputs(host, T, seed):
    rng = np.random.default_rng(seed)
    lengths, angles = (np.asarray(a, np.float32) for a in matrix_to_params(jnp.asarray(host.lattice)))
    onehot = np.eye(len(Z_TABLE), dtype=np.float32)[host.atom_types]
    t = rng.integers(1, T + 1, size=host.num_atoms.shape)
    return (host.frac_x, onehot, t, host.num_atoms, lengths, angles, host.atom_mask)


@pytest.mark.parametrize("degree", [2, 3])
def test_backbone_scores_match_jax(degree):
    """``predict_scores`` of the port, on both of its branches, against the
    JAX package's plain (use_pallas=False) branch with the same weights.
    30 crystals of up to 5 atoms make two super-crystals of 15 on the
    kernel branch."""
    jcfg = tiny_config(degree=degree)
    jmodel = JModel(jcfg)
    host = _batch(30, 5, seed=3)
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(1), JBatch(*map(jnp.asarray, host))))
    inputs = _scores_inputs(host, jcfg.num_timesteps, seed=4)
    want = jax.jit(jmodel.predict_scores)(params, *map(jnp.asarray, inputs))
    outs = {}
    for use_kernels in (False, True):
        model = DiffusionModel(port_config(jcfg, use_pallas=use_kernels), device="cpu",
                               fourier_w=np.asarray(jmodel.fourier_w))
        params_from_jax(model, params)
        with torch.no_grad():
            outs[use_kernels] = model.predict_scores(*map(torch.tensor, inputs))
        for got, ref in zip(outs[use_kernels], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_MODEL)
    for a, b in zip(outs[True], outs[False]):
        # the two branches of the port differ only in summation order
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


# ---------------- the fused fiber conv path (fuse_fiber) ----------------


@pytest.mark.parametrize("degree", [2, 3])
def test_fuse_fiber_backbone_scores_match_jax_pallas_branch(degree):
    """``predict_scores`` of the port's kernel branch with ``fuse_fiber``
    (plain basis MLP windowed outside the kernel, one basis for every layer,
    fused_fiber_conv per layer) against the JAX package's Pallas branch with
    ``fuse_fiber=True`` (fused_fiber_conv in interpret mode), same weights;
    30 crystals of up to 5 atoms make two super-crystals of 15."""
    jcfg = tiny_config(degree=degree, use_pallas=True, fuse_fiber=True)
    jmodel = JModel(jcfg)
    host = _batch(30, 5, seed=5)
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(2), JBatch(*map(jnp.asarray, host))))
    inputs = _scores_inputs(host, jcfg.num_timesteps, seed=6)
    want = jax.jit(jmodel.predict_scores)(params, *map(jnp.asarray, inputs))
    model = DiffusionModel(port_config(jcfg), device="cpu", fourier_w=np.asarray(jmodel.fourier_w))
    assert model.model.config.fuse_fiber and model.model.config.use_kernels
    params_from_jax(model, params)
    with torch.no_grad():
        got = model.predict_scores(*map(torch.tensor, inputs))
    for a, ref in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **F32_MODEL)


def test_jax_fuse_fiber_params_load_into_port():
    """A JAX ``fuse_fiber=True`` parameter tree (its basis MLP is the plain
    ``BasisMLP``, not ``MultiBasisMLP``) has the default tree's names: it
    loads into the port and comes back unchanged."""
    host = _batch(4, 5, 2)
    jbatch = JBatch(*map(jnp.asarray, host))
    fused = jax.jit(JModel(tiny_config(use_pallas=True, fuse_fiber=True)).init)(jax.random.PRNGKey(0), jbatch)
    default = jax.jit(JModel(tiny_config(use_pallas=True)).init)(jax.random.PRNGKey(0), jbatch)
    paths = [p for p, _ in jax.tree_util.tree_leaves_with_path(fused)]
    assert paths == [p for p, _ in jax.tree_util.tree_leaves_with_path(default)]
    model = DiffusionModel(port_config(tiny_config(fuse_fiber=True)), device="cpu")
    params_from_jax(model, fused)
    back = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(model.model)))
    for path, value in jax.tree_util.tree_leaves_with_path(fused):
        np.testing.assert_array_equal(back[path], np.asarray(value))


# ---------------- the backbone's other heads and make_ponita ----------------


def _fiber_inputs(seed=0, B=2, A=6, K=4, num_ori=4):
    """(JAX inputs, port inputs) of the bare backbone: scalars, one vector
    a node, a radius graph (the second crystal with two padded atoms) and
    random lattices for the edge scalars."""
    from arreau_tpu.models.ponita import FiberBundleInputs as JInputs
    from arreau_tpu.ops.grids import cached_grid_s2 as j_grid
    from arreau_tpu.ops.radius import radius_neighbor_list as j_radius_neighbor_list
    from arreau_tpu_torch.models.ponita import FiberBundleInputs
    from arreau_tpu_torch.ops.pbc import NeighborList

    rng = np.random.default_rng(seed)
    arrays = dict(scalar=rng.normal(size=(B, A, 3)), vec=rng.normal(size=(B, A, 1, 3)),
                  lattice=rng.normal(size=(B, 3, 3)) * 4.0)
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    mask = np.arange(A)[None, :] < np.array([[A], [A - 2]])
    pos = (rng.normal(size=(B, A, 3)) * 1.5).astype(np.float32)
    nb = j_radius_neighbor_list(jnp.asarray(pos), jnp.asarray(mask), 3.0, K)
    grid = np.asarray(j_grid(num_ori), np.float32)
    j_in = JInputs(neighbors=nb, atom_mask=jnp.asarray(mask), ori_grid=jnp.asarray(grid),
                   **{k: jnp.asarray(v) for k, v in arrays.items()})
    t_in = FiberBundleInputs(neighbors=NeighborList(*(torch.tensor(np.asarray(a)) for a in nb)),
                             atom_mask=torch.tensor(mask), ori_grid=torch.tensor(grid),
                             **{k: torch.tensor(v) for k, v in arrays.items()})
    return j_in, t_in


HEADS = dict(output_dim_scalar=2, output_dim_vec=1, output_dim_global_vec=2,
             output_dim_global_scalar=1, output_dim_edge_scalar=3)
# float32 heads after two conv layers, sums in another order than XLA's
HEAD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("heads", [
    dict(output_dim_global_vec=2, output_dim_global_scalar=1),
    HEADS,
], ids=["global_vec", "global_vec_and_edges"])
def test_global_vector_and_edge_readouts_match_jax(heads):
    """``output_dim_global_vec`` (its slice of the readout projected off the
    sphere and summed over the atoms) and ``output_dim_edge_scalar`` (per
    reading layer, on the messages and the lifted edge scalars) against the
    JAX backbone's plain path with the converted parameters; the edge
    readouts' parameters ``edge_readout_{i}`` carry both ways."""
    from arreau_tpu.models.ponita import PonitaConfig as JPonitaConfig
    from arreau_tpu.models.ponita import PonitaFiberBundle as JPonita
    from arreau_tpu_torch.models.ponita import PonitaConfig, PonitaFiberBundle

    j_in, t_in = _fiber_inputs()
    common = dict(hidden_dim=16, basis_dim=8, degree=2, num_layers=2, num_ori=4, radius=3.0, **heads)
    jmodel = JPonita(JPonitaConfig(use_pallas=False, remat=False, **common))
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(3), j_in), seed=3)
    want = jax.jit(jmodel.apply)(params, j_in)
    model = PonitaFiberBundle(PonitaConfig(input_dim_scalar=3, input_dim_vec=1, **common))
    params_from_jax(model, params)
    with torch.no_grad():
        got = model(t_in)
    assert got.global_vec.shape == (2, heads["output_dim_global_vec"], 3)
    assert all(torch.isfinite(t).all() for t in (*got[:4], *got.edge_scalar))
    for name in ("node_scalar", "node_vec", "global_scalar", "global_vec"):
        if getattr(want, name) is None:  # a head of width 0: JAX returns None, the port 0 columns
            assert getattr(got, name).numel() == 0, name
            continue
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   **HEAD_TOL, err_msg=name)
    assert len(got.edge_scalar) == len(want.edge_scalar) == (2 if "output_dim_edge_scalar" in heads
                                                             else 0)
    for a, b in zip(got.edge_scalar, want.edge_scalar):
        assert a.shape == (2, 6, 4, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **HEAD_TOL)
    back = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(model)))
    for path, value in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(back[path], np.asarray(value))


def test_edge_readouts_refuse_the_kernel_branch():
    """Edge readouts need the per-edge messages: the automatic choice takes
    the plain branch, an explicit ``use_kernels=True`` raises."""
    from arreau_tpu_torch.models.ponita import PonitaConfig, PonitaFiberBundle

    _, t_in = _fiber_inputs()
    cfg = PonitaConfig(input_dim_scalar=3, input_dim_vec=1, hidden_dim=16, basis_dim=8,
                       degree=2, num_layers=2, num_ori=4, **HEADS)
    with torch.no_grad():
        assert len(PonitaFiberBundle(cfg)(t_in).edge_scalar) == 2
        with pytest.raises(ValueError, match="edge readouts need the per-edge messages"):
            PonitaFiberBundle(dataclasses.replace(cfg, use_kernels=True))(t_in)


@pytest.mark.parametrize("num_ori", [4, -1, 0], ids=["fiber_bundle", "lifted", "plain"])
def test_make_ponita_modes_match_jax(num_ori):
    """``make_ponita``'s three modes build the JAX factory's model, and
    with the same parameters compute its outputs."""
    from arreau_tpu.models import make_ponita as j_make_ponita
    from arreau_tpu_torch.interop.from_jax import point_cloud_params_from_jax
    from arreau_tpu_torch.models import make_ponita
    from tests.test_torch_point_cloud import _inputs

    common = dict(hidden_dim=16, basis_dim=8, degree=2, num_layers=2, output_dim_scalar=2)
    switches = {"use_pallas": False, "remat": False} if num_ori > 0 else {}
    jmodel = j_make_ponita(num_ori, **common, **switches)
    if num_ori > 0:
        j_in, t_in = _fiber_inputs()
        extra = dict(input_dim_scalar=3, input_dim_vec=1)
    else:
        j_in, t_in = _inputs(7, lifted=num_ori == -1)
        t_in = t_in._replace(**{k: getattr(t_in, k).float() for k in ("pos", "scalar", "vec")},
                             neighbors=t_in.neighbors._replace(
                                 dist=t_in.neighbors.dist.float(),
                                 direction=t_in.neighbors.direction.float()))
        j_in = j_in._replace(pos=j_in.pos.astype(jnp.float32), scalar=j_in.scalar.astype(jnp.float32),
                             vec=j_in.vec.astype(jnp.float32))
        extra = dict(input_dim_scalar=3, input_dim_vec=0)
    model = make_ponita(num_ori, **common, **switches, **extra)
    assert type(model).__name__ == type(jmodel).__name__
    jcfg, cfg = dataclasses.asdict(jmodel.config), dataclasses.asdict(model.config)
    assert all(cfg[k] == v for k, v in jcfg.items() if k in cfg)
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(num_ori + 2), j_in), seed=1)
    want = jax.jit(jmodel.apply)(params, j_in)
    (params_from_jax if num_ori > 0 else point_cloud_params_from_jax)(model, params)
    with torch.no_grad():
        got = model(t_in)
    for a, b in zip(got, want):
        if isinstance(b, tuple) or b is None:
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_MODEL)
