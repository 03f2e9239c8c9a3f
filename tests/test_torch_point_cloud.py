"""The PyTorch port's point-cloud Ponita and its QM9 and MD17 tasks against
the JAX package on the CPU: the lifted and plain models' outputs with the
same parameters (float32 and float64), rotation invariance, padding
independence, the two tasks' losses and every parameter gradient (one
rotation drawn by JAX, handed to both), the forces -dE/dpos, finite
forces with padded atoms, rotation-averaged test predictions, the data
(loaders on the real-format fixtures, synthetic molecules, the DimeNet
split) and the two training CLIs, whose flags are the JAX CLIs' plus
``--device``. Tiny widths (hidden 16, basis 8, degree 2, two layers, at
most 6 atoms, K = 4): the JAX package's own model tests at this size are
marked slow."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.cli import train_md17 as j_cli_md17
from arreau_tpu.cli import train_qm9 as j_cli_qm9
from arreau_tpu.data import molecules as j_molecules
from arreau_tpu.models.point_cloud import PointCloudConfig as JPCConfig
from arreau_tpu.models.point_cloud import PointCloudInputs as JPCInputs
from arreau_tpu.models.point_cloud import PonitaPointCloud as JPonitaPointCloud
from arreau_tpu.ops.grids import random_so3_matrix as j_random_so3_matrix
from arreau_tpu.ops.radius import radius_neighbor_list as j_radius_neighbor_list
from arreau_tpu.tasks.md17 import MD17Batch as JMD17Batch
from arreau_tpu.tasks.md17 import MD17Config as JMD17Config
from arreau_tpu.tasks.md17 import MD17Model as JMD17Model
from arreau_tpu.tasks.md17 import rotate_md17_batch as j_rotate_md17_batch
from arreau_tpu.tasks.qm9 import MoleculeBatch as JMoleculeBatch
from arreau_tpu.tasks.qm9 import QM9Config as JQM9Config
from arreau_tpu.tasks.qm9 import QM9Model as JQM9Model
from arreau_tpu.tasks.qm9 import rotate_molecule_batch as j_rotate_molecule_batch
from arreau_tpu_torch.cli import train_md17, train_qm9
from arreau_tpu_torch.data import molecules
from arreau_tpu_torch.interop.from_jax import _jax_name, point_cloud_params_from_jax
from arreau_tpu_torch.models.point_cloud import (
    PointCloudConfig,
    PointCloudInputs,
    PonitaPointCloud,
)
from arreau_tpu_torch.ops.grids import random_so3_matrix
from arreau_tpu_torch.ops.radius import radius_neighbor_list
from arreau_tpu_torch.tasks.md17 import MD17Batch, MD17Config, MD17Model, rotate_md17_batch
from arreau_tpu_torch.tasks.qm9 import MoleculeBatch, QM9Config, QM9Model, rotate_molecule_batch
from arreau_tpu_torch.train.loop import eval_step
from arreau_tpu_torch.ops import prng
from tests.test_torch_model import perturbed_params

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TINY = dict(hidden_dim=16, basis_dim=8, degree=2, num_layers=2)
# float32 outputs after two conv layers and the readouts, sums in another
# order than XLA's: as tests/test_torch_model.py
F32_MODEL = dict(rtol=1e-4, atol=1e-4)
# float64 end to end: the two packages differ by summation order alone
F64 = dict(rtol=1e-9, atol=1e-11)
# float64 gradients: each parameter's against 1e-9 of its largest entry
GRAD64_REL_TOL = 1e-9


def _inputs(seed, lifted=True, B=2, N=6, F=3, V=0):
    """(JAX inputs, port inputs): float64 positions, scalars and ``V``
    vectors, the second molecule with two padded atoms, each package's own
    neighbour list of the same positions (distinct distances: the two agree
    slot by slot)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(B, N, 3))
    scalar = rng.normal(size=(B, N, F))
    vec = rng.normal(size=(B, N, V, 3))
    mask = np.arange(N)[None, :] < np.array([[N], [N - 2]])
    j_nb = j_radius_neighbor_list(jnp.asarray(pos), jnp.asarray(mask), 1000.0, 4, loop=not lifted)
    nb = radius_neighbor_list(torch.tensor(pos), torch.tensor(mask), 1000.0, 4, loop=not lifted)
    np.testing.assert_array_equal(nb.src.numpy(), np.asarray(j_nb.src))
    j_in = JPCInputs(pos=jnp.asarray(pos), scalar=jnp.asarray(scalar), vec=jnp.asarray(vec),
                     neighbors=j_nb, node_mask=jnp.asarray(mask))
    t_in = PointCloudInputs(pos=torch.tensor(pos), scalar=torch.tensor(scalar),
                            vec=torch.tensor(vec), neighbors=nb, node_mask=torch.tensor(mask))
    return j_in, t_in


def _models(j_in, seed, **kw):
    """(JAX model, its perturbed parameters, the port's float64 model with them)."""
    jcfg = JPCConfig(**{**TINY, "output_dim_scalar": 2, **kw})
    jmodel = JPonitaPointCloud(jcfg)
    params = perturbed_params(jmodel.init(jax.random.PRNGKey(seed), j_in), seed)
    model = PonitaPointCloud(PointCloudConfig(input_dim_scalar=j_in.scalar.shape[-1],
                                              input_dim_vec=j_in.vec.shape[-2],
                                              **dataclasses.asdict(jcfg))).double()
    point_cloud_params_from_jax(model, params)
    return jmodel, params, model


def _as(t_in, dtype):
    return t_in._replace(pos=t_in.pos.to(dtype), scalar=t_in.scalar.to(dtype),
                         vec=t_in.vec.to(dtype),
                         neighbors=t_in.neighbors._replace(
                             dist=t_in.neighbors.dist.to(dtype),
                             direction=t_in.neighbors.direction.to(dtype)))


def _f64(params):
    """The parameters in float64, so that JAX's gradients are float64 too
    (a float32 parameter's cotangent is rounded to float32)."""
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)


def _flat_grads(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_grads_match(module, want_tree, rel=GRAD64_REL_TOL):
    """Every parameter's gradient against the JAX tree's, within ``rel`` of
    its largest entry; both trees name the same parameters."""
    want = _flat_grads(want_tree)
    names = dict(module.named_parameters())
    assert len(names) == len(want)
    for name, p in names.items():
        key, transpose = _jax_name(name)
        got = (p.grad.t() if transpose else p.grad).numpy()
        scale = np.abs(want[key]).max()
        assert scale > 0, name
        assert np.abs(got - want[key]).max() <= rel * scale, name


# ---------------- the model ----------------


def test_port_configs_have_every_jax_field():
    extra = {"input_dim_scalar", "input_dim_vec"}
    assert {f.name for f in dataclasses.fields(JPCConfig)} | extra == {
        f.name for f in dataclasses.fields(PointCloudConfig)}
    for j, t in ((JQM9Config, QM9Config), (JMD17Config, MD17Config)):
        assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
        got = dataclasses.asdict(t().pc_config())
        assert (got.pop("input_dim_scalar"), got.pop("input_dim_vec")) == (t().input_dim, 0)
        assert got == dataclasses.asdict(j().pc_config())


@pytest.mark.parametrize("lifted,radius,V", [(True, None, 0), (True, 2.5, 0), (False, None, 0),
                                             (False, 2.5, 0), (True, None, 2)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_point_cloud_outputs_match_jax(lifted, radius, V, dtype):
    """Graph-level outputs of the lifted and plain modes, windowed or not,
    and of the lifted mode with vector inputs and a vector head, with the
    JAX package's parameters; float64 and float32 (the JAX model run in
    the same type)."""
    j_in, t_in = _inputs(0, lifted, V=V)
    heads = {"output_dim_vec": 1} if V else {}
    jmodel, params, model = _models(j_in, 1, lifted=lifted, radius=radius, layer_scale=0.5,
                                    **heads)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j_in = j_in._replace(pos=j_in.pos.astype(jdt), scalar=j_in.scalar.astype(jdt),
                         vec=j_in.vec.astype(jdt), neighbors=j_in.neighbors._replace(
                             dist=j_in.neighbors.dist.astype(jdt),
                             direction=j_in.neighbors.direction.astype(jdt)))
    params = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    want = jmodel.apply(params, j_in)
    with torch.no_grad():
        got = model.to(dtype)(_as(t_in, dtype))
    tol = F64 if dtype == torch.float64 else F32_MODEL
    assert got.scalar.shape == (2, 2)
    np.testing.assert_allclose(got.scalar.numpy(), np.asarray(want.scalar), **tol)
    if V:
        assert got.vec.shape == (2, 1, 3)
        np.testing.assert_allclose(got.vec.numpy(), np.asarray(want.vec), **tol)
    else:
        assert got.vec is None


def test_lifted_point_cloud_is_rotation_invariant():
    """The graph-level scalar is invariant to a rotation of the positions
    (every attribute is an invariant of the geometry), in float64."""
    j_in, t_in = _inputs(2)
    _, _, model = _models(j_in, 3)
    R = random_so3_matrix(prng.prng_key(3), (), torch.float64)
    pos_r = t_in.pos @ R.T
    nb_r = radius_neighbor_list(pos_r, t_in.node_mask, 1000.0, 4, loop=False)
    with torch.no_grad():
        out = model(t_in).scalar
        out_r = model(t_in._replace(pos=pos_r, neighbors=nb_r)).scalar
    np.testing.assert_allclose(out_r.numpy(), out.numpy(), rtol=1e-8)


def test_lifted_point_cloud_padding_independence():
    """Junk in the padded atoms' features changes nothing."""
    j_in, t_in = _inputs(4)
    _, _, model = _models(j_in, 1)
    junk = torch.where(t_in.node_mask[..., None], t_in.scalar, 123.0)
    with torch.no_grad():
        out1 = model(t_in).scalar
        out2 = model(t_in._replace(scalar=junk)).scalar
    np.testing.assert_allclose(out2.numpy(), out1.numpy(), rtol=1e-9)


def test_plain_point_cloud_mode():
    """``lifted=False`` (``--num_ori 0``): base-node conv on edge lengths,
    one output, finite, the JAX package's value."""
    j_in, t_in = _inputs(5, lifted=False)
    jmodel, params, model = _models(j_in, 1, lifted=False, output_dim_scalar=1)
    with torch.no_grad():
        out = model(t_in).scalar
    assert out.shape == (2, 1) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jmodel.apply(params, j_in).scalar), **F64)


def test_init_has_flax_distributions():
    model = PonitaPointCloud(PointCloudConfig(input_dim_scalar=5, layer_scale=1e-6))
    model.init_parameters(prng.prng_key(0))
    kernel = model.convs[0].kernel.weight  # [C, D]: 1/sqrt(8) / fan_in 256
    assert abs(kernel.std().item() - (1 / 8**0.5 / 256) ** 0.5) < 0.1 * (1 / 8**0.5 / 256) ** 0.5
    w1 = model.layers[0].linear_1.weight  # lecun normal, fan_in 128
    assert abs(w1.std().item() - 128**-0.5) < 0.05 * 128**-0.5
    assert torch.count_nonzero(model.convs[0].bias) == 0
    assert torch.all(model.layers[0].layer_scale == 1e-6)


# ---------------- QM9 and MD17 ----------------


def _molecules(num, seed, max_atoms, min_atoms, with_forces=False):
    return molecules.synthetic_molecules(num, seed=seed, max_atoms=max_atoms,
                                         min_atoms=min_atoms, with_forces=with_forces)


def test_qm9_loss_and_gradients_match_jax():
    """QM9's z-scored MAE and every parameter gradient, float64, on a batch
    rotated by one rotation per molecule that JAX draws (its
    ``rotate_molecule_batch``) and the port is handed."""
    data = _molecules(6, 0, 6, 4)
    shift, scale = float(np.mean(data.y)), float(np.std(data.y))
    jcfg = JQM9Config(**{**TINY, "num_layers": 1}, max_neighbors=4)
    jmodel = JQM9Model(jcfg, shift, scale, dtype=jnp.float64)
    jbatch = JMoleculeBatch(pos=jnp.asarray(data.pos, jnp.float64),
                            one_hot=jnp.asarray(data.one_hot, jnp.float64),
                            mask=jnp.asarray(data.mask), y=jnp.asarray(data.y))
    params = _f64(perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch), 0))
    key = jax.random.PRNGKey(7)
    jbatch = j_rotate_molecule_batch(key, jbatch)
    rot = np.asarray(j_random_so3_matrix(key, (6,)))
    (want_loss, want_m), want = _jax_loss_and_grads(jmodel, params, jbatch)

    model = QM9Model(QM9Config(**dataclasses.asdict(jcfg)), shift, scale, device="cpu",
                     dtype=torch.float64)
    point_cloud_params_from_jax(model, params)
    batch = rotate_molecule_batch(torch.tensor(rot), MoleculeBatch(
        pos=torch.tensor(data.pos, dtype=torch.float64),
        one_hot=torch.tensor(data.one_hot, dtype=torch.float64),
        mask=torch.tensor(data.mask), y=torch.tensor(data.y)))
    np.testing.assert_allclose(batch.pos.numpy(), np.asarray(jbatch.pos), **F64)
    loss, metrics = model.loss(batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **F64)
    np.testing.assert_allclose(metrics["mae"].item(), float(want_m["mae"]), **F64)
    _assert_grads_match(model.model, want)


def _jax_loss_and_grads(jmodel, params, jbatch):
    """((loss, metrics), parameter gradients) of the JAX task, one compile."""
    fn = jax.value_and_grad(lambda p: jmodel.loss(p, None, jbatch), has_aux=True)
    return jax.jit(fn)(params)


def _md17_setup(num, seed, max_atoms, min_atoms, shift=0.0, scale=1.0, **cfg):
    """(JAX task, batch and float64 parameters; the port's float64 task with
    them, its batch): one conv layer (each JAX call compiles a double
    backward)."""
    data = _molecules(num, seed, max_atoms, min_atoms, with_forces=True)
    jcfg = JMD17Config(**{**TINY, "num_layers": 1, "input_dim": 5, "max_neighbors": 4, **cfg})
    jmodel = JMD17Model(jcfg, shift, scale, dtype=jnp.float64)
    jbatch = JMD17Batch(pos=jnp.asarray(data.pos, jnp.float64),
                        one_hot=jnp.asarray(data.one_hot, jnp.float64),
                        mask=jnp.asarray(data.mask), energy=jnp.asarray(data.y),
                        force=jnp.asarray(data.forces, jnp.float64))
    params = _f64(perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jbatch), seed))
    model = MD17Model(MD17Config(**dataclasses.asdict(jcfg)), shift, scale, device="cpu",
                      dtype=torch.float64)
    point_cloud_params_from_jax(model, params)
    batch = MD17Batch(pos=torch.tensor(data.pos, dtype=torch.float64),
                      one_hot=torch.tensor(data.one_hot, dtype=torch.float64),
                      mask=torch.tensor(data.mask), energy=torch.tensor(data.y),
                      force=torch.tensor(data.forces, dtype=torch.float64))
    return jmodel, jbatch, params, model, batch


def _port_md17(num, seed, max_atoms, min_atoms):
    """The port's float64 MD17 task at the test width, seeded, and a batch."""
    data = _molecules(num, seed, max_atoms, min_atoms, with_forces=True)
    model = MD17Model(MD17Config(**TINY, input_dim=5, max_neighbors=4), device="cpu",
                      dtype=torch.float64)
    model.init(prng.prng_key(seed))
    batch = MD17Batch(*(torch.tensor(a, dtype=torch.float64 if a.dtype.kind == "f" else None)
                        for a in (data.pos, data.one_hot, data.mask, data.y, data.forces)))
    return model, batch


def test_md17_loss_and_gradients_match_jax():
    """MD17's loss (E-MSE / lambda_F + F-MSE), its MAEs and every parameter
    gradient (a double backward: the loss differentiates through the
    forces), float64, on a batch JAX rotated (forces co-rotated)."""
    jmodel, jbatch, params, model, batch = _md17_setup(5, 1, 5, 4, shift=3.0, scale=2.0)
    key = jax.random.PRNGKey(8)
    jbatch = j_rotate_md17_batch(key, jbatch)
    batch = rotate_md17_batch(torch.tensor(np.asarray(j_random_so3_matrix(key, (5,)))), batch)
    (want_loss, want_m), want = _jax_loss_and_grads(jmodel, params, jbatch)
    loss, metrics = model.loss(batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **F64)
    for k in ("mae_energy", "mae_force"):
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]), **F64)
    _assert_grads_match(model.model, want)


def test_md17_forces_are_the_negative_energy_gradient_and_match_jax():
    """``predict_energy_and_force`` against the JAX package's (its
    ``jax.grad``), and one force component against a finite difference of
    the energy, float64; outside a graph-recording context (no_grad) the
    forces exist all the same."""
    jmodel, jbatch, params, model, batch = _md17_setup(4, 2, 5, 5)
    want_e, want_f = jax.jit(jmodel.predict_energy_and_force)(params, jbatch)
    with torch.no_grad():
        energy, force = model.predict_energy_and_force(batch)
    assert not energy.requires_grad and not force.requires_grad
    np.testing.assert_allclose(energy.numpy(), np.asarray(want_e), **F64)
    np.testing.assert_allclose(force.numpy(), np.asarray(want_f), rtol=1e-8, atol=1e-10)
    eps = 1e-6
    pos2 = batch.pos.clone()
    pos2[0, 1, 2] += eps
    with torch.no_grad():
        e2 = model.predict_energy(pos2, batch)
    fd = -(e2[0].item() - energy[0].item()) / eps
    np.testing.assert_allclose(fd, force[0, 1, 2].item(), rtol=1e-4, atol=1e-7)


def test_md17_forces_finite_with_padded_atoms():
    """Padded atoms (empty slots, zero distances) give finite forces and a
    finite loss: the square roots at zero distance carry an eps."""
    model, batch = _port_md17(4, 3, 8, 4)
    assert not bool(batch.mask.all()), "fixture should include padded atoms"
    _, force = model.predict_energy_and_force(batch)
    assert torch.isfinite(force).all()
    loss, _ = model.loss(batch)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.model.parameters())


def test_md17_rotation_averaged_test_predictions_match_jax():
    """``test_repeats`` with the rotations JAX draws from its key."""
    jmodel, jbatch, params, model, batch = _md17_setup(3, 4, 5, 4, shift=1.0, scale=2.0)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda p, b: jmodel.test_repeats(p, key, b, repeats=2))(params, jbatch)
    rots = torch.stack([torch.tensor(np.asarray(j_random_so3_matrix(k, (3,))))
                        for k in jax.random.split(key, 2)])
    got = model.test_repeats(batch, rots)
    assert len(got) == 2
    for (e, f), (we, wf) in zip(got, want):
        np.testing.assert_allclose(e.item(), float(we), **F64)
        np.testing.assert_allclose(f.item(), float(wf), rtol=1e-8)


def test_eval_step_gives_md17_its_forces_and_keeps_qm9_off_autograd():
    """``eval_step`` runs under no_grad: MD17 takes its forces inside its
    own enable_grad block (finite force MAE, nothing left requiring grad),
    QM9's metrics record no graph."""
    model, batch = _port_md17(3, 5, 5, 4)
    metrics = eval_step(model, batch)
    assert np.isfinite(metrics["mae_force"].item()) and metrics["mae_force"].item() > 0
    assert not any(v.requires_grad for v in metrics.values())
    data = _molecules(3, 6, 5, 4)
    qm9 = QM9Model(QM9Config(**TINY, max_neighbors=4), device="cpu")
    qm9.init(prng.prng_key(0))
    qbatch = MoleculeBatch(torch.tensor(data.pos), torch.tensor(data.one_hot),
                           torch.tensor(data.mask), torch.tensor(data.y, dtype=torch.float32))
    assert not any(v.requires_grad for v in eval_step(qm9, qbatch).values())


# ---------------- data ----------------


@pytest.mark.parametrize("with_forces", [False, True])
def test_synthetic_molecules_match_jax(with_forces):
    got = molecules.synthetic_molecules(20, seed=3, with_forces=with_forces)
    want = j_molecules.synthetic_molecules(20, seed=3, with_forces=with_forces)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [100, 130000])
def test_dimenet_split_matches_jax(n):
    got, want = molecules.dimenet_split(n), j_molecules.dimenet_split(n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(np.unique(np.concatenate(got))) == n


@pytest.mark.parametrize("target", ["alpha", "mu", "Cv"])
def test_qm9_xyz_loader_matches_jax(target):
    """The gdb9 fixture (the '*^' exponent notation included)."""
    root = os.path.join(FIXTURES, "qm9")
    got = molecules.load_qm9_xyz_dir(root, target)
    want = j_molecules.load_qm9_xyz_dir(root, target)
    assert molecules.QM9_ELEMENTS == j_molecules.QM9_ELEMENTS
    assert molecules.QM9_MAX_ATOMS == j_molecules.QM9_MAX_ATOMS
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


def test_rmd17_npz_loader_matches_jax():
    path = os.path.join(FIXTURES, "rmd17_toy.npz")
    for limit in (None, 4):
        got = molecules.load_rmd17_npz(path, limit)
        want = j_molecules.load_rmd17_npz(path, limit)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------- the CLIs ----------------


@pytest.mark.parametrize("port,jax_cli", [(train_qm9, j_cli_qm9), (train_md17, j_cli_md17)])
def test_cli_flags_are_the_jax_clis_and_device(port, jax_cli):
    want = vars(jax_cli.parse_args([]))
    got = vars(port.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


TINY_CLI = ["--device", "cpu", "--epochs", "2", "--val_interval", "1", "--batch_size", "4",
            "--hidden_dim", "16", "--basis_dim", "8", "--degree", "2", "--layers", "2",
            "--max_neighbors", "4"]


def test_qm9_cli_runs_on_cpu(tmp_path, capsys):
    test_mae = train_qm9.main([*TINY_CLI, "--synthetic_size", "40", "--max_steps", "10",
                               "--checkpoint_dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert np.isfinite(test_mae)
    assert "qm9 model:" in out and "steps/epoch 8" in out
    assert "epoch 1 | valid MAE" in out and f"test MAE {test_mae:.6f}" in out
    assert (tmp_path / "ckpt" / "best" / "ema_params.npz").exists()


def test_md17_cli_runs_on_cpu_and_reads_an_rmd17_npz(tmp_path, capsys):
    test_f = train_md17.main([*TINY_CLI, "--npz", os.path.join(FIXTURES, "rmd17_toy.npz"),
                              "--train_size", "4", "--val_size", "2", "--batch_size", "2",
                              "--repeats", "2", "--checkpoint_dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert np.isfinite(test_f)
    assert "md17 model:" in out and "steps/epoch 2" in out
    assert "epoch 1 | valid E-MAE" in out and "test MAE x2" in out
    assert (tmp_path / "ckpt" / "best" / "ema_params.npz").exists()


@pytest.mark.parametrize("cli", [train_qm9, train_md17])
def test_cli_on_cuda_raises_without_cuda(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the CUDA path runs instead of raising")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--checkpoint_dir", str(tmp_path)])
