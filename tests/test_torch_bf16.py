"""The port's bfloat16 compute path (``compute_dtype="bfloat16"``) against
the JAX package on the CPU: the bfloat16 plain versions of kernels #3, #4,
#7 and #8 against the Pallas kernels in interpret mode, the bfloat16
backbone on both branches, the loss terms and every parameter gradient
against ``jax.grad`` (with and without ``fuse_convnext``), the port's own
bfloat16-against-float32 check, parameter trees, and the training CLI in
bfloat16 feeding the generate CLI.

Inputs are made with numpy and fed to both packages. Where a test holds
bfloat16 results together, both sides sum in float32 and round at the same
points; they still differ where a value next to a rounding boundary rounds
the other way (one bf16 ulp, 2^-8 relative) and carries, and where the two
packages evaluate an elementwise chain (GELU and its derivative) in
bfloat16 step by step (flax, XLA) or in float32 rounded once (the port).
The tolerances below are stated with that reason."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.models.ponita import PonitaFiberBundle as JPonita
from arreau_tpu.ops.pallas_basis import _h1_fwd, _multi_bwd, poly_selection_matrices
from arreau_tpu.ops.pallas_conv import fused_spatial_conv as j_fused_spatial_conv
from arreau_tpu.ops.pallas_conv import make_gather_matrix
from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import DiffusionModel as JModel
from arreau_tpu_torch.cli import generate, train_diffusion
from arreau_tpu_torch.data.atoms import synthetic_z_table
from arreau_tpu_torch.data.synthetic import make_synthetic_batch
from arreau_tpu_torch.interop.from_jax import _jax_name, params_from_jax, params_to_jax
from arreau_tpu_torch.kernels.basis_h1 import basis_h1_plain
from arreau_tpu_torch.kernels.basis_mlp import basis_mlp_bwd_plain
from arreau_tpu_torch.kernels.spatial_conv import spatial_conv_bwd_plain, spatial_conv_plain
from arreau_tpu_torch.models.ponita import PonitaFiberBundle, tile_senders
from arreau_tpu_torch.tasks.diffusion import (
    DiffusionConfig,
    DiffusionModel,
    batch_to_device,
    draw_loss_noise,
)
from tests.test_torch_model import _scores_inputs, perturbed_params, port_config
from tests.test_torch_train import TINY_ARGS, _flat, _jax_setup, loss_noise

BF16 = jnp.bfloat16
# module level: each bfloat16-stored output within 1e-2 of its largest
# magnitude, float32 outputs (weight gradients) within 1e-2 of their
# largest entry (see the module docstring for why not tighter)
KERNEL_REL_TOL = 1e-2
# model level, against the JAX package's same branch: loss terms within
# 5e-3 relative (the JAX package's own two bfloat16 branches differ by up to
# 8.4e-4), every parameter gradient within 5e-2 of its largest entry, and
# backbone outputs within 2e-2 of their largest magnitude (bfloat16 flips
# through two conv layers and the readouts)
LOSS_REL_TOL = 5e-3
GRAD_REL_TOL = 5e-2
SCORE_REL_TOL = 2e-2
# fuse_convnext at compute_dtype="float32" is the float32 function: tight
F32_LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
F32_GRAD_REL_TOL = 1e-5


def _rel(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    return np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max() / scale


def _bf16(a):
    """numpy float32 values rounded to bfloat16 (kept as float32)."""
    return np.asarray(jnp.asarray(a, BF16).astype(jnp.float32))


def t16(a):
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


# ---------------- kernels #3 and #4 ----------------


def _conv_inputs(B=6, A=5, K=4, O=3, D=16, C=24, tile=3, seed=8):
    rng = np.random.default_rng(seed)
    Bp, TA = B // tile, tile * A
    E = K * TA
    return dict(
        basis=_bf16(rng.normal(size=(Bp, O, E, D))), w=_bf16(rng.normal(size=(D, C)) * 0.2),
        x=_bf16(rng.normal(size=(Bp, O, TA, C))), g=_bf16(rng.normal(size=(Bp, O, TA, C))),
        win=rng.uniform(size=(Bp, E)).astype(np.float32),
        src=rng.integers(0, A, size=(B, A, K)), mask=rng.random((B, A, K)) > 0.3, tile=tile)


def test_bf16_spatial_conv_plain_versions_match_pallas_kernels():
    """#3 and #4 in bfloat16: spatial_conv_plain and spatial_conv_bwd_plain
    against fused_spatial_conv (out_dtype bfloat16, the bfloat16 compute
    path's call) and its custom VJP, Pallas interpret mode."""
    d = _conv_inputs()
    sel = make_gather_matrix(jnp.asarray(d["src"]), jnp.asarray(d["mask"]), dtype=BF16,
                             crystals_per_tile=d["tile"])
    win = jnp.asarray(d["win"])[..., None]

    def fwd(basis, w, x):
        return j_fused_spatial_conv(basis, w, x, sel, win, window_grad=False, out_dtype=BF16)

    want, vjp = jax.vjp(fwd, *(jnp.asarray(d[k], BF16) for k in ("basis", "w", "x")))
    want_grads = vjp(jnp.asarray(d["g"], BF16))
    src = tile_senders(torch.as_tensor(d["src"]), torch.as_tensor(d["mask"]), d["tile"])
    args = (t16(d["basis"]), t16(d["w"]), t16(d["x"]), src, torch.tensor(d["win"]))
    got = spatial_conv_plain(*args)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want.astype(jnp.float32)) <= KERNEL_REL_TOL
    got_grads = spatial_conv_bwd_plain(*args, t16(d["g"]))
    for name, a, b in zip(("dbasis", "dw", "dx"), got_grads, want_grads):
        assert a.dtype == torch.bfloat16 and b.dtype == BF16, name
        assert _rel(a.float(), b.astype(jnp.float32)) <= KERNEL_REL_TOL, name


# ---------------- kernels #7 and #8 ----------------


@pytest.mark.parametrize("degree", [2, 3])
def test_bf16_basis_mlp_plain_versions_match_pallas_kernels(degree):
    """#8 and #7 in bfloat16: basis_h1_plain against _h1_fwd (the
    pre-activation) and basis_mlp_bwd_plain against _multi_bwd with three
    cotangents, Pallas interpret mode."""
    rng = np.random.default_rng(9 + degree)
    Bp, O, d, E, H, D = 2, 3, 6, 40, 20, 12
    F = sum(d**i for i in range(1, degree + 1))
    attrT = _bf16(rng.normal(size=(Bp, O, d, E)))
    w1, b1 = _bf16(rng.normal(size=(F, H)) * 0.1), _bf16(rng.normal(size=(H,)) * 0.3)
    w2, b2 = _bf16(rng.normal(size=(H, D)) * 0.3), _bf16(rng.normal(size=(D,)) * 0.3)
    gs = [_bf16(rng.normal(size=(Bp, O, E, D))) for _ in range(3)]
    sels = poly_selection_matrices(d, degree)
    j = [jnp.asarray(a, BF16) for a in (attrT, w1, b1, w2, b2)]
    want_h1 = _h1_fwd(j[0], j[1], j[2], sels)
    got_h1 = basis_h1_plain(t16(attrT), t16(w1), t16(b1), degree)
    assert got_h1.dtype == torch.bfloat16
    assert _rel(got_h1.float(), want_h1.astype(jnp.float32)) <= KERNEL_REL_TOL
    want = _multi_bwd(*j, sels, [jnp.asarray(g, BF16) for g in gs])
    got = basis_mlp_bwd_plain(t16(attrT), t16(w1), t16(b1), t16(w2), t16(b2), degree,
                              [t16(g) for g in gs])
    for name, a, b in zip(("dw1", "db1", "dw2", "db2"), got, want):
        assert a.dtype == torch.float32, name
        assert _rel(a, b.astype(jnp.float32)) <= KERNEL_REL_TOL, name


# ---------------- the backbone ----------------


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bf16_backbone_scores_match_jax_same_branch(use_pallas):
    """predict_scores in bfloat16: the port's plain branch against the JAX
    plain branch, and its kernel branch against the JAX Pallas branch, same
    weights (biases and layer scales drawn at random so every layer
    counts); 30 crystals of up to 5 atoms make two super-crystals of 15."""
    from tests.test_torch_model import _batch, tiny_config

    jcfg = tiny_config(degree=3, compute_dtype="bfloat16", use_pallas=use_pallas)
    jmodel = JModel(jcfg)
    host = _batch(30, 5, seed=3)
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                                   JBatch(*map(jnp.asarray, host))))
    inputs = _scores_inputs(host, jcfg.num_timesteps, seed=4)
    want = jax.jit(jmodel.predict_scores)(params, *map(jnp.asarray, inputs))
    model = DiffusionModel(port_config(jcfg), device="cpu", fourier_w=np.asarray(jmodel.fourier_w))
    assert model.model.config.compute_dtype == "bfloat16"
    params_from_jax(model, params)
    with torch.no_grad():
        got = model.predict_scores(*map(torch.tensor, inputs))
    for name, a, b in zip(("eps", "logits", "global"), got, want):
        assert a.dtype == torch.float32, name
        assert _rel(a.numpy(), np.asarray(b, np.float32)) <= SCORE_REL_TOL, name


def _fused_convnext(model_or_jmodel):
    """Swap the backbone for one with ``fuse_convnext=True``, as a caller of
    either package does (DiffusionConfig has no such field)."""
    if isinstance(model_or_jmodel, JModel):
        cfg = dataclasses.replace(model_or_jmodel.model.config, fuse_convnext=True)
        model_or_jmodel.model = JPonita(cfg)
    else:
        cfg = dataclasses.replace(model_or_jmodel.model.config, fuse_convnext=True)
        model_or_jmodel.model = PonitaFiberBundle(cfg).to(model_or_jmodel.device)
    return model_or_jmodel


def _assert_loss_and_gradients(jmodel, host, params, loss_tol, grad_rel_tol, fuse_convnext):
    key = jax.random.PRNGKey(7)
    jbatch = JBatch(*map(jnp.asarray, host))
    if fuse_convnext:
        _fused_convnext(jmodel)
    (_, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, key, jbatch), has_aux=True))(params)
    want_g = _flat(want_g)
    model = DiffusionModel(port_config(jmodel.config), device="cpu",
                           fourier_w=np.asarray(jmodel.fourier_w))
    if fuse_convnext:
        _fused_convnext(model)
        assert model.model.config.fuse_convnext and model.model.config.use_kernels
    params_from_jax(model, params)
    loss, metrics = model.loss(batch_to_device(host, "cpu"), loss_noise(key, host, jmodel.config))
    assert set(metrics) == set(want_m)
    for name, value in want_m.items():
        if name.startswith("loss"):
            np.testing.assert_allclose(metrics[name].item(), float(value), **loss_tol,
                                       err_msg=name)
    loss.backward()
    names = dict(model.model.named_parameters())
    assert len(names) == len(want_g)
    for name, p in names.items():
        key_, transpose = _jax_name(name)
        got = (p.grad.t() if transpose else p.grad).numpy()
        assert _rel(got, want_g[key_]) <= grad_rel_tol, (name, _rel(got, want_g[key_]))


@pytest.mark.parametrize("fuse_convnext", [False, True])
def test_bf16_loss_terms_and_every_gradient_match_jax_pallas_branch(fuse_convnext):
    """Each loss term, then every parameter gradient, of the port's bfloat16
    kernel branch (the kernels' Functions running their plain versions on
    the CPU) against jax.grad of the JAX loss on its bfloat16 Pallas branch
    (interpret mode), without and with fuse_convnext (#9/#10 against the
    Pallas fused_convnext_mlp)."""
    jmodel, host, params = _jax_setup(True, compute_dtype="bfloat16")
    _assert_loss_and_gradients(jmodel, host, params, dict(rtol=LOSS_REL_TOL, atol=1e-6),
                               GRAD_REL_TOL, fuse_convnext)


def test_bf16_plain_branch_loss_terms_match_jax_plain_branch():
    """The port's bfloat16 plain branch (the CPU default): its loss terms
    against the JAX package's bfloat16 plain branch (use_pallas=False). Its
    gradients are not held to that branch's: there XLA's autodiff sums each
    Dense bias cotangent over the edge rows in bfloat16, which put the basis
    MLP's dense_out bias gradient 1.3e-1 of its scale away from the float32
    gradient on this batch, where the port's float32 sums stayed within
    2.2e-2 (measured). The Pallas branch test holds every gradient to the JAX
    package's bfloat16 kernels."""
    jmodel, host, params = _jax_setup(False, use_pallas=False, compute_dtype="bfloat16")
    key = jax.random.PRNGKey(7)
    jbatch = JBatch(*map(jnp.asarray, host))
    want_m = jax.jit(lambda p: jmodel.loss(p, key, jbatch)[1])(params)
    model = DiffusionModel(port_config(jmodel.config), device="cpu",
                           fourier_w=np.asarray(jmodel.fourier_w))
    params_from_jax(model, params)
    with torch.no_grad():
        _, metrics = model.loss(batch_to_device(host, "cpu"), loss_noise(key, host, jmodel.config))
    names = [name for name in want_m if name.startswith("loss")]
    assert len(names) == 4  # loss, loss_coord, loss_type, loss_lattice
    for name in names:
        np.testing.assert_allclose(metrics[name].item(), float(want_m[name]), rtol=LOSS_REL_TOL,
                                   atol=1e-6, err_msg=name)


def test_float32_fuse_convnext_matches_jax_tightly():
    """compute_dtype="float32" with fuse_convnext is the float32 function:
    the fused path (#9/#10 plain versions) against the JAX package's fused
    Pallas path, loss terms to 1e-5 and every gradient to 1e-5 of its
    largest entry."""
    jmodel, host, params = _jax_setup(True, compute_dtype="float32")
    _assert_loss_and_gradients(jmodel, host, params, F32_LOSS_TOL, F32_GRAD_REL_TOL, True)


@pytest.mark.parametrize("layer_scale", [1e-6, 1.0])
def test_bf16_loss_tracks_float32(layer_scale):
    """The port's own guard, as the JAX package's
    test_bf16_compute_path_tracks_f32: on one batch and one set of weights
    the bfloat16 loss terms stay within 5% of the float32 ones (also with
    the layer scale at 1, where every layer counts)."""
    zt = synthetic_z_table()
    host = make_synthetic_batch(np.random.default_rng(0), zt, 16, 8)
    kw = dict(num_atomic_states=len(zt), num_timesteps=50, hidden_dim=32, basis_dim=32,
              num_ori=4, num_layers=2, max_neighbors=4, layer_scale=layer_scale)
    m32 = DiffusionModel(DiffusionConfig(**kw), device="cpu")
    mbf = DiffusionModel(DiffusionConfig(**kw, compute_dtype="bfloat16"), device="cpu")
    batch = batch_to_device(host, "cpu")
    m32.init(torch.Generator().manual_seed(0), batch)
    mbf.model.load_state_dict(m32.model.state_dict())
    noise = draw_loss_noise(torch.Generator().manual_seed(1), 16, 8, len(zt), 50, False, "cpu",
                            timestep=17)
    with torch.no_grad():
        _, r32 = m32.loss(batch, noise)
        _, rbf = mbf.loss(batch, noise)
    for k in ("loss_coord", "loss_type", "loss_lattice"):
        a, b = r32[k].item(), rbf[k].item()
        assert rbf[k].dtype == torch.float32
        assert abs(a - b) / max(abs(a), 1e-3) < 0.05, (k, a, b)


# ---------------- parameters, configurations, entry points ----------------


def test_jax_fuse_convnext_bf16_params_load_into_port():
    """A JAX fuse_convnext=True, compute_dtype="bfloat16" parameter tree
    (its readouts created at the top level for the fused epilogue) has the
    flax chain's names: it loads into the port's fuse_convnext backbone
    and comes back unchanged."""
    from tests.test_torch_model import _batch, tiny_config

    jbatch = JBatch(*map(jnp.asarray, _batch(4, 5, 2)))
    jcfg = tiny_config(use_pallas=True, compute_dtype="bfloat16")
    fused = jax.jit(_fused_convnext(JModel(jcfg)).init)(jax.random.PRNGKey(0), jbatch)
    default = jax.jit(JModel(tiny_config(use_pallas=True)).init)(jax.random.PRNGKey(0), jbatch)
    paths = [p for p, _ in jax.tree_util.tree_leaves_with_path(fused)]
    assert paths == [p for p, _ in jax.tree_util.tree_leaves_with_path(default)]
    model = _fused_convnext(DiffusionModel(port_config(jcfg), device="cpu"))
    params_from_jax(model, fused)
    back = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(model.model)))
    for path, value in jax.tree_util.tree_leaves_with_path(fused):
        assert back[path].dtype == np.float32
        np.testing.assert_array_equal(back[path], np.asarray(value))


@pytest.mark.parametrize("config,error", [
    (dict(compute_dtype="float16"), ValueError),
])
def test_unported_compute_settings_raise(config, error):
    zt = synthetic_z_table()
    with pytest.raises(error, match="fuse_fiber|compute_dtype"):
        DiffusionModel(DiffusionConfig(num_atomic_states=len(zt), **config), device="cpu")


def test_train_cli_bf16_checkpoint_feeds_generate(tmp_path, capsys):
    """The training CLI with --compute_dtype bfloat16 on the CPU: finite
    losses, a meta.json that carries the compute type, and a checkpoint the
    generate CLI samples from in bfloat16."""
    ckpt = tmp_path / "ckpt"
    loss = train_diffusion.main([*TINY_ARGS, "--compute_dtype", "bfloat16", "--max_steps", "3",
                                 "--checkpoint_dir", str(ckpt)])
    assert np.isfinite(loss)
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["config"]["compute_dtype"] == "bfloat16"
    model, _, _ = generate.load_model(str(ckpt), "best", True, "cpu")
    assert model.model.dtype == torch.bfloat16
    result = generate.main(["--device", "cpu", "--checkpoint_dir", str(ckpt), "--tag", "best",
                            "--num_crystals", "3", "--batch_size", "3", "--num_atoms_per_sample",
                            "4", "--sample_steps", "4", "--out_dir", str(tmp_path / "gen")])
    assert result.num_crystals == 3 and np.isfinite(result.frac_x).all()
    assert np.isfinite(result.lattice).all()
    with pytest.raises(SystemExit):
        train_diffusion.main([*TINY_ARGS, "--compute_dtype", "float16",
                              "--checkpoint_dir", str(tmp_path / "bad")])
