"""The PyTorch port's N-body task against the JAX package on the CPU: the
radius graph, the cutoff, the S^1 grid and rotations, the 2-D and 3-D
invariants, the simulator's integrator (JAX's own initial draws through
the port's ``integrate_charged``), the npz files, the Ponita N-body model
(predictions, loss, every gradient, on both of the port's branches, one
neighbour list) and the EGNN baseline, with the same parameters; and the
training CLI, whose flags are the JAX CLI's plus ``--device``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.cli import train_nbody as j_cli
from arreau_tpu.data.nbody import load_nbody_split as j_load_nbody_split
from arreau_tpu.data.nbody import simulate_charged as j_simulate_charged
from arreau_tpu.models.egnn import EGNNConfig as JEGNNConfig
from arreau_tpu.models.egnn import EGNNNBody as JEGNNNBody
from arreau_tpu.models.ponita import fiber_bundle_invariants as j_invariants
from arreau_tpu.ops.grids import quat_to_matrix as j_quat_to_matrix
from arreau_tpu.ops.grids import uniform_grid_s1 as j_uniform_grid_s1
from arreau_tpu.ops.radius import radius_neighbor_list as j_radius_neighbor_list
from arreau_tpu.ops.windowing import polynomial_cutoff as j_polynomial_cutoff
from arreau_tpu.tasks.nbody import NBodyBatch as JBatch
from arreau_tpu.tasks.nbody import NBodyConfig as JConfig
from arreau_tpu.tasks.nbody import NBodyModel as JModel
from arreau_tpu_torch.cli import train_nbody
from arreau_tpu_torch.data.nbody import (
    generate_nbody_npz,
    integrate_charged,
    load_nbody_split,
    load_or_generate,
)
from arreau_tpu_torch.interop.from_jax import _jax_name, egnn_params_from_jax, params_from_jax
from arreau_tpu_torch.models.egnn import EGNNConfig, EGNNNBody
from arreau_tpu_torch.models.ponita import fiber_bundle_invariants
from arreau_tpu_torch.ops.grids import (
    quat_to_matrix,
    random_so2_matrix,
    random_so3_matrix,
    uniform_grid_s1,
)
from arreau_tpu_torch.ops.pbc import NeighborList
from arreau_tpu_torch.ops.radius import radius_neighbor_list
from arreau_tpu_torch.ops.windowing import polynomial_cutoff
from arreau_tpu_torch.tasks.nbody import NBodyBatch, NBodyConfig, NBodyModel, rotate_nbody_batch
from arreau_tpu_torch.ops import prng
from tests.test_nbody import _oracle_trajectory
from tests.test_torch_model import perturbed_params

# float32 outputs after the graph, two conv layers and the readouts, sums in
# another order than XLA's: as tests/test_torch_model.py
F32_MODEL = dict(rtol=1e-4, atol=1e-4)
# float32 loss, and each parameter's gradient against 1e-4 of its largest
# entry, as tests/test_torch_train.py; but at least 1e-7 of the largest
# gradient of any parameter: a bias that every orientation shares reaches
# the vector head only through the grid's mean direction (~0), so its
# gradient is a cancellation of terms ~1e4 larger, and keeps their float32
# roundoff
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_REL_TOL = 1e-4
GRAD_FLOOR = 1e-7
# the simulator against JAX's and the numpy oracle: tests/test_nbody.py's
SIM_TOL = dict(rtol=1e-4, atol=1e-6)
# 50 systems of 5 particles: two super-crystals of TA = 125 on the kernel
# branch, the N-body task's tile
B, N = 50, 5


def _neighbors_to_torch(nl) -> NeighborList:
    return NeighborList(*(torch.tensor(np.asarray(a)) for a in nl))


# ---------------- ops ----------------


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("loop", [True, False])
def test_radius_neighbor_list_matches_jax(D, loop):
    """Masked nodes, a radius that cuts some pairs, K < N; distinct random
    distances, so the two top-K agree slot by slot."""
    rng = np.random.default_rng(D + 2 * loop)
    pos = rng.normal(size=(3, 9, D)) * 2.0
    mask = rng.random((3, 9)) > 0.2
    mask[:, 0] = True
    want = j_radius_neighbor_list(jnp.asarray(pos), jnp.asarray(mask), 2.5, 4, loop=loop)
    got = radius_neighbor_list(torch.tensor(pos), torch.tensor(mask), 2.5, 4, loop=loop)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert 0 < got.mask.sum() < got.mask.numel()
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(want.src))
    np.testing.assert_array_equal(got.image.numpy(), 0)
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist), rtol=1e-12)
    np.testing.assert_allclose(got.direction.numpy(), np.asarray(want.direction), rtol=1e-12)


def test_fully_connected_graph_has_every_slot():
    pos = torch.tensor(np.random.default_rng(0).normal(size=(2, 5, 3)))
    nl = radius_neighbor_list(pos, torch.ones((2, 5), dtype=torch.bool), 1000.0, 5, loop=True)
    assert nl.mask.all()
    assert (nl.dist[:, :, 0] == 0).all()  # each node's nearest is itself


def test_polynomial_cutoff_none_is_ones_and_matches_jax():
    x = np.random.default_rng(1).uniform(0, 6, size=(4, 7))
    np.testing.assert_array_equal(polynomial_cutoff(torch.tensor(x), None).numpy(), 1.0)
    np.testing.assert_allclose(polynomial_cutoff(torch.tensor(x), 5.0).numpy(),
                               np.asarray(j_polynomial_cutoff(jnp.asarray(x), 5.0)), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("n", [6, 10])
def test_uniform_grid_s1_matches_jax(n):
    np.testing.assert_allclose(uniform_grid_s1(n, torch.float64).numpy(),
                               np.asarray(j_uniform_grid_s1(n)), rtol=1e-12, atol=1e-15)


def test_quat_to_matrix_matches_jax_and_rotations_are_rotations():
    q = np.random.default_rng(2).normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(quat_to_matrix(torch.tensor(q)).numpy(),
                               np.asarray(j_quat_to_matrix(jnp.asarray(q))), rtol=1e-12,
                               atol=1e-15)
    k3, k2 = prng.split(prng.prng_key(0))
    for R, dim in ((random_so3_matrix(k3, (7,), torch.float64), 3),
                   (random_so2_matrix(k2, (7,), torch.float64), 2)):
        assert R.shape == (7, dim, dim)
        np.testing.assert_allclose((R @ R.transpose(-1, -2)).numpy(),
                                   np.eye(dim)[None].repeat(7, 0), atol=1e-12)
        np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, rtol=1e-12)


@pytest.mark.parametrize("D,num_ori", [(2, 6), (3, 8)])
def test_fiber_bundle_invariants_match_jax(D, num_ori):
    """The 2-D grid's signed orthogonal component, the 3-D grid's norm."""
    from arreau_tpu.ops.grids import cached_grid_s2 as j_grid_s2

    rng = np.random.default_rng(3)
    pos = rng.normal(size=(2, 6, D))
    mask = np.ones((2, 6), bool)
    mask[1, 4:] = False
    grid = np.asarray(j_uniform_grid_s1(num_ori)) if D == 2 else j_grid_s2(num_ori)
    nl = j_radius_neighbor_list(jnp.asarray(pos), jnp.asarray(mask), 100.0, 4)
    want = j_invariants(nl, jnp.asarray(grid))
    got = fiber_bundle_invariants(_neighbors_to_torch(nl), torch.tensor(grid))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    if D == 2:  # chirality: the component changes sign under reflection
        assert (got[0][..., 1] < 0).any() and (got[0][..., 1] > 0).any()


# ---------------- data ----------------


def test_integrator_matches_jax_simulator_and_oracle():
    """JAX's initial draws (as tests/test_nbody.py reconstructs them) through
    the port's integrator, T = 600, sample_freq = 100, in float64 as the
    JAX run under x64."""
    T, freq, S, n = 600, 100, 3, 5
    key = jax.random.PRNGKey(0)
    loc, vel, edges, charges = j_simulate_charged(key, num_sims=S, T=T, sample_freq=freq)
    k_q, k_loc, k_vel = jax.random.split(key, 3)
    charges0 = np.where(np.asarray(jax.random.bernoulli(k_q, 0.5, (S, n))), 1.0, -1.0)
    loc0 = np.asarray(jax.random.normal(k_loc, (S, n, 3)))
    vel0 = np.asarray(jax.random.normal(k_vel, (S, n, 3)))
    vel0 = vel0 * 0.5 / np.linalg.norm(vel0, axis=-1, keepdims=True)
    got = integrate_charged(*(torch.tensor(a) for a in (loc0, vel0, charges0)), T, freq)
    got_loc, got_vel, got_edges, got_charges = (t.numpy() for t in got)
    assert got_loc.shape == (S, T // freq - 1, n, 3)
    np.testing.assert_allclose(got_loc, loc, **SIM_TOL)
    np.testing.assert_allclose(got_vel, vel, **SIM_TOL)
    np.testing.assert_array_equal(got_edges, edges)
    np.testing.assert_array_equal(got_charges, charges)
    for s in range(S):
        oloc, ovel = _oracle_trajectory(loc0[s], vel0[s], np.outer(charges0[s], charges0[s]), T,
                                        freq)
        np.testing.assert_allclose(got_loc[s], oloc, **SIM_TOL)
        np.testing.assert_allclose(got_vel[s], ovel, **SIM_TOL)


def test_npz_files_round_trip_and_read_in_both_packages(tmp_path):
    generate_nbody_npz(str(tmp_path), num_train=4, num_valid=3, num_test=2, T=500, sample_freq=10)
    ex = load_nbody_split(str(tmp_path), "train", "nbody_small")
    assert ex.loc0.shape == (4, 5, 3) and ex.charges.shape == (4, 5)
    assert set(np.unique(ex.charges)) <= {-1.0, 1.0}
    assert np.isfinite(ex.loc_end).all()
    assert len(load_nbody_split(str(tmp_path), "val", "nbody_small")) == 3
    want = j_load_nbody_split(str(tmp_path), "train", "nbody_small")
    for a, b in zip(ex, want):
        np.testing.assert_array_equal(a, b)


def test_load_or_generate_generates_once(tmp_path):
    d = str(tmp_path / "nb")
    first = load_or_generate(d, "valid", num_train=20)
    assert len(first) == 100  # valid and test: at least 100
    again = load_or_generate(d, "valid", num_train=20)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert len(load_or_generate(d, "train", num_train=20, max_samples=7)) == 7


# ---------------- the Ponita N-body model ----------------


def _host_batch(seed, B_=B):
    rng = np.random.default_rng(seed)
    return dict(pos=rng.normal(size=(B_, N, 3)).astype(np.float32),
                vel=(rng.normal(size=(B_, N, 3)) * 0.5).astype(np.float32),
                charges=rng.choice([-1.0, 1.0], size=(B_, N)).astype(np.float32),
                target_pos=rng.normal(size=(B_, N, 3)).astype(np.float32))


TINY = dict(hidden_dim=16, basis_dim=12, degree=3, num_layers=2, num_ori=8)


def _jax_setup(seed=0, **kw):
    jmodel = JModel(JConfig(**{**TINY, **kw}), dtype=jnp.float32)
    host = _host_batch(seed)
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in host.items()})
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jbatch), seed)
    return jmodel, host, jbatch, params


def _port(jmodel, params, use_kernels):
    model = NBodyModel(NBodyConfig(**dataclasses.asdict(jmodel.config), use_pallas=use_kernels),
                       device="cpu")
    params_from_jax(model, params)
    return model


def _port_inputs(model, host, jmodel):
    """The port's backbone inputs with the JAX package's neighbour list."""
    batch = NBodyBatch(**{k: torch.tensor(v) for k, v in host.items()})
    jnl = j_radius_neighbor_list(jnp.asarray(host["pos"]), jnp.ones((B, N), bool),
                                 jmodel.config.radius or 1000.0, N, loop=True)
    return batch, model.build_inputs(batch)._replace(neighbors=_neighbors_to_torch(jnl))


def test_port_config_has_every_jax_field():
    assert {f.name for f in dataclasses.fields(JConfig)} | {"use_pallas"} == {
        f.name for f in dataclasses.fields(NBodyConfig)}


@pytest.mark.parametrize("radius", [None, 3.0])
def test_nbody_predictions_and_loss_match_jax(radius):
    """``predict_positions`` and the MSE of both of the port's branches
    against the JAX package's (plain branch on the CPU), same parameters;
    radius None (the task's: no window) and 3 (windowed)."""
    jmodel, host, jbatch, params = _jax_setup(radius=radius)
    want = np.asarray(jax.jit(jmodel.predict_positions)(params, jbatch))
    want_loss = float(jax.jit(jmodel.loss)(params, jax.random.PRNGKey(0), jbatch)[0])
    for use_kernels in (False, True):
        model = _port(jmodel, params, use_kernels)
        batch, inputs = _port_inputs(model, host, jmodel)
        with torch.no_grad():
            got = model.predict_positions(batch, inputs)
            loss, metrics = model.loss(batch, inputs)
        np.testing.assert_allclose(got.numpy(), want, **F32_MODEL)
        np.testing.assert_allclose(loss.item(), want_loss, **LOSS_TOL)
        assert set(metrics) == {"loss", "mse"}


def test_nbody_loss_gradients_match_jax():
    """Every parameter's gradient of the kernel branch (the kernels'
    autograd Functions, their plain versions on the CPU, at TA = 125, d = 2)
    and of the plain branch against ``jax.grad`` of the JAX loss."""
    jmodel, host, jbatch, params = _jax_setup(seed=1)
    want = jax.jit(jax.grad(lambda p: jmodel.loss(p, jax.random.PRNGKey(0), jbatch)[0]))(params)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    for use_kernels in (True, False):
        model = _port(jmodel, params, use_kernels)
        batch, inputs = _port_inputs(model, host, jmodel)
        model.loss(batch, inputs)[0].backward()
        names = dict(model.model.named_parameters())
        assert len(names) == len(flat)
        largest = max(np.abs(g).max() for g in flat.values())
        for name, p in names.items():
            key, transpose = _jax_name(name)
            got = (p.grad.t() if transpose else p.grad).numpy()
            scale = np.abs(flat[key]).max()
            assert scale > 0, name
            tol = max(GRAD_REL_TOL * scale, GRAD_FLOOR * largest)
            assert np.abs(got - flat[key]).max() <= tol, (name, use_kernels)


def test_nbody_model_is_equivariant_with_its_grid_rotated():
    """Rotating positions, velocities and the orientation grid rotates the
    predicted displacement (float64, plain branch)."""
    jmodel, host, _, params = _jax_setup(seed=2)
    model = _port(jmodel, params, False)
    model.model.double()
    batch = NBodyBatch(**{k: torch.tensor(v, dtype=torch.float64) for k, v in host.items()})
    R = random_so3_matrix(prng.prng_key(3), (), torch.float64)
    with torch.no_grad():
        out = model.predict_positions(batch) - batch.pos
        model.ori_grid = model.ori_grid.double() @ R.T
        rotated = rotate_nbody_batch(R.expand(B, 3, 3), batch)
        out_r = model.predict_positions(rotated) - rotated.pos
    np.testing.assert_allclose(out_r.numpy(), (out @ R.T).numpy(), rtol=1e-6, atol=1e-9)


def test_rotation_augmentation_keeps_distances_and_charges():
    batch = NBodyBatch(**{k: torch.tensor(v, dtype=torch.float64)
                          for k, v in _host_batch(4, 4).items()})
    rot = rotate_nbody_batch(random_so3_matrix(prng.prng_key(0), (4,),
                                               torch.float64), batch)
    np.testing.assert_allclose(torch.cdist(rot.pos, rot.pos).numpy(),
                               torch.cdist(batch.pos, batch.pos).numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(rot.vel.norm(dim=-1).numpy(), batch.vel.norm(dim=-1).numpy(),
                               rtol=1e-9)
    assert torch.equal(rot.charges, batch.charges)


# ---------------- EGNN ----------------


def test_egnn_predictions_and_loss_match_jax():
    host = _host_batch(5, 6)
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in host.items()})
    jmodel = JEGNNNBody(JEGNNConfig(hidden_dim=16, num_layers=2))
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch))
    model = EGNNNBody(EGNNConfig(hidden_dim=16, num_layers=2), device="cpu")
    egnn_params_from_jax(model, params)
    batch = NBodyBatch(**{k: torch.tensor(v) for k, v in host.items()})
    with torch.no_grad():
        got = model.predict_positions(batch)
        loss = model.loss(batch)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.predict_positions(params, jbatch)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(jmodel.loss(params, None, jbatch)[0]),
                               **LOSS_TOL)
    R = random_so3_matrix(prng.prng_key(1), ())
    with torch.no_grad():
        got_r = model.predict_positions(batch._replace(pos=batch.pos @ R.T, vel=batch.vel @ R.T))
    np.testing.assert_allclose(got_r.numpy(), (got @ R.T).numpy(), rtol=1e-4, atol=1e-5)


def test_egnn_init_has_flax_distributions():
    model = EGNNNBody(EGNNConfig(hidden_dim=64, num_layers=2), device="cpu")
    model.init(prng.prng_key(0))
    layer = model.model.layers[0]
    assert torch.count_nonzero(layer.edge_1.bias) == 0
    assert abs(layer.edge_2.weight.std().item() - 64**-0.5) < 0.1 * 64**-0.5
    assert abs(layer.coord.weight.std().item() - (0.001 / 64) ** 0.5) < 0.2 * (0.001 / 64) ** 0.5


# ---------------- the CLI ----------------


def test_cli_flags_are_the_jax_clis_and_device():
    want = vars(j_cli.parse_args([]))
    got = vars(train_nbody.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("model", ["ponita", "egnn"])
def test_train_cli_runs_on_cpu(model, tmp_path, capsys):
    test_mse = train_nbody.main([
        "--device", "cpu", "--model", model, "--epochs", "2", "--val_interval", "1",
        "--batch_size", "10", "--max_training_samples", "30", "--generate_train", "30",
        "--hidden_dim", "16", "--basis_dim", "8", "--layers", "2", "--num_ori", "4",
        "--scan_epoch", "True", "--data_dir", str(tmp_path / "data"),
        "--checkpoint_dir", str(tmp_path / "ckpt"),
    ])
    out = capsys.readouterr().out
    assert np.isfinite(test_mse)
    assert "nbody model:" in out and "steps/epoch 3" in out
    assert "epoch 1 | valid MSE" in out and f"test MSE {test_mse:.6f}" in out
    assert (tmp_path / "ckpt" / "best" / "ema_params.npz").exists()
    lines = (tmp_path / "ckpt" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3 and "test/mse" in lines[-1]


def test_train_cli_on_cuda_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the CUDA path runs instead of raising")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_nbody.main(["--data_dir", str(tmp_path), "--checkpoint_dir", str(tmp_path)])
