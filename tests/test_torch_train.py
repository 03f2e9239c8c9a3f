"""The PyTorch port's training slice against the JAX package on the CPU:
the diffusion loss (each term) and the gradient of every parameter against
``jax.grad`` of the JAX loss on its Pallas branch (the spatial conv and
basis MLP kernels with their custom VJPs, in interpret mode), one optimizer
step (clip + AdamW + schedule + EMA) against optax, and the training CLI,
whose checkpoint the generate CLI reads.

The loss's random numbers are the ones the JAX loss draws from its key
(``jax.random.split(key, 5)``), handed to the port as a ``LossNoise``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.data.crystal import pack_dense_batch as j_pack
from arreau_tpu.data.synthetic import synthetic_packed as j_synthetic_packed
from arreau_tpu.ops.lattice import matrix_to_params as j_matrix_to_params
from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import DiffusionModel as JModel
from arreau_tpu.train.optim import cosine_warmup_schedule as j_schedule
from arreau_tpu.train.optim import make_optimizer
from arreau_tpu.train.state import create_train_state, apply_gradients
from arreau_tpu_torch.cli import generate, train_diffusion
from arreau_tpu_torch.interop.from_jax import _jax_name, params_from_jax, params_to_jax
from arreau_tpu_torch.tasks.diffusion import (
    DiffusionModel,
    LossNoise,
    batch_to_device,
    draw_loss_noise,
)
from arreau_tpu_torch.train.optim import AdamW, cosine_warmup_schedule, decays
from arreau_tpu_torch.train.state import EMA
from arreau_tpu_torch.ops import prng
from tests.test_torch_model import perturbed_params, port_config, tiny_config

A = 4
# max_neighbors = 27 * A: every in-radius image is an edge, so the graph
# cannot depend on the packages' tie order between equidistant images
GRAPH = dict(max_neighbors=27 * A)
# float32 losses after the graph, two conv layers and the readouts; sums in
# another order than XLA's and than the Pallas interpreter's (measured:
# ~1e-6 relative)
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
# gradients: float32 backward through the same chain; each parameter is
# held to 1e-4 of its own largest gradient entry (measured: <= 6e-6)
GRAD_REL_TOL = 1e-4


def _batch(seed=0):
    """A loader batch of 6 crystals of up to 4 atoms: 5 real crystals and
    one padding example (all slots masked, identity lattice)."""
    ds = j_synthetic_packed(40, seed=seed, max_atoms=A)
    idx = np.array([0, 3, 7, 11, 19, -1])
    return j_pack(ds, idx, A)


def _jax_setup(diffuse_angles, use_pallas=True, seed=0, **config):
    jcfg = tiny_config(diffuse_angles=diffuse_angles, use_pallas=use_pallas, **GRAPH, **config)
    jmodel = JModel(jcfg)
    host = _batch(seed)
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                                   JBatch(*map(jnp.asarray, host))), seed)
    return jmodel, host, params


def loss_noise(key, host, cfg) -> LossNoise:
    """The numbers ``DiffusionModel.loss`` draws from ``key``."""
    B, A_ = host.atom_types.shape
    k_t, k_pos, k_type, k_lat, k_ang = jax.random.split(key, 5)
    lengths, _ = j_matrix_to_params(jnp.asarray(host.lattice))
    f32 = jnp.float32
    return LossNoise(
        t=torch.tensor(np.asarray(jax.random.randint(k_t, (B,), 1, cfg.num_timesteps + 1))),
        pos=torch.tensor(np.asarray(jax.random.normal(k_pos, host.frac_x.shape, dtype=f32))),
        types=torch.tensor(np.asarray(jax.random.uniform(
            k_type, (B, A_, cfg.num_atomic_states), dtype=f32, minval=0.0, maxval=1.0))),
        lattice=torch.tensor(np.asarray(jax.random.normal(k_lat, lengths.shape, dtype=lengths.dtype))),
        angle=(torch.tensor(np.asarray(jax.random.normal(k_ang, (B, 6), dtype=f32)))
               if cfg.diffuse_angles else None),
    )


def _port_model(jmodel, params, use_kernels):
    model = DiffusionModel(port_config(jmodel.config, use_pallas=use_kernels), device="cpu",
                           fourier_w=np.asarray(jmodel.fourier_w))
    params_from_jax(model, params)
    return model


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


@pytest.mark.parametrize("diffuse_angles", [False, True])
def test_loss_terms_and_every_gradient_match_jax_pallas_branch(diffuse_angles):
    """Each loss term, then the gradient of every parameter, of the port's
    kernel branch (the CUDA kernels' autograd Functions, running their
    plain versions on the CPU) against jax.grad of the JAX loss on its
    Pallas branch (fused_spatial_conv and basis_mlp_multi with their custom
    VJPs, Pallas kernels in interpret mode)."""
    _assert_loss_and_gradients_match_jax(*_jax_setup(diffuse_angles))


@pytest.mark.parametrize("diffuse_angles", [False, True])
def test_fuse_fiber_loss_terms_and_every_gradient_match_jax_pallas_branch(diffuse_angles):
    """The same with ``fuse_fiber=True`` on both sides: the port's kernel
    branch runs the plain basis MLP and the fused_fiber_conv Function
    (kernels #1/#2, plain versions on the CPU); the JAX Pallas branch runs
    fused_fiber_conv with its custom VJP in interpret mode."""
    _assert_loss_and_gradients_match_jax(*_jax_setup(diffuse_angles, fuse_fiber=True))


def _assert_loss_and_gradients_match_jax(jmodel, host, params):
    key = jax.random.PRNGKey(7)
    jbatch = JBatch(*map(jnp.asarray, host))
    (_, want_metrics), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, key, jbatch), has_aux=True))(params)
    want_grads = _flat(want_grads)

    model = _port_model(jmodel, params, use_kernels=True)
    noise = loss_noise(key, host, jmodel.config)
    loss, metrics = model.loss(batch_to_device(host, "cpu"), noise)
    assert set(metrics) == set(want_metrics)
    for name, value in want_metrics.items():
        np.testing.assert_allclose(metrics[name].item(), float(value), **LOSS_TOL, err_msg=name)
    loss.backward()
    names = dict(model.model.named_parameters())
    assert len(names) == len(want_grads)
    for name, p in names.items():
        key_, transpose = _jax_name(name)
        want = want_grads[key_]
        got = (p.grad.t() if transpose else p.grad).numpy()
        scale = np.abs(want).max()
        assert scale > 0, name
        assert np.abs(got - want).max() <= GRAD_REL_TOL * scale, (name, np.abs(got - want).max(), scale)


def test_kernel_branch_gradients_equal_plain_branch_on_cpu():
    """Both branches of the port on one batch: the same loss and gradients
    (float32, other summation orders: 1e-4 of each parameter's largest)."""
    jmodel, host, params = _jax_setup(True)
    noise = loss_noise(jax.random.PRNGKey(3), host, jmodel.config)
    grads = {}
    for use_kernels in (True, False):
        model = _port_model(jmodel, params, use_kernels)
        model.loss(batch_to_device(host, "cpu"), noise)[0].backward()
        grads[use_kernels] = {n: p.grad for n, p in model.model.named_parameters()}
    for name, want in grads[False].items():
        got = grads[True][name]
        assert (got - want).abs().max() <= 1e-4 * want.abs().max(), name


def test_one_optimizer_and_ema_step_matches_optax():
    """Three steps of clip 0.5 + AdamW (decay on the kernels only) on a
    warmup-cosine schedule, then the EMA, against optax and the JAX train
    state on the same gradients; the first step's gradients are scaled to
    clip, the others not. float32 updates: 1e-6."""
    jmodel, host, params = _jax_setup(False, use_pallas=False)
    rng = np.random.default_rng(0)
    flat = _flat(params)
    grads_seq = []
    for scale in (10.0, 1e-3, 1e-2):
        grads_seq.append({k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                          for k, v in flat.items()})

    def unflat(d):
        tree = {}
        for name, v in d.items():
            node = tree
            *parents, leaf = name.split("/")
            for q in parents:
                node = node.setdefault(q, {})
            node[leaf] = jnp.asarray(v)
        return tree

    wd, ema_decay = 0.05, 0.9
    tx = make_optimizer(j_schedule(1e-2, 1, 10, 2), weight_decay=wd, grad_clip=0.5)
    state = create_train_state(unflat(flat), tx, ema_decay=ema_decay)
    for g in grads_seq:
        state = apply_gradients(state, unflat(g), tx)
    want_params, want_ema = _flat(state.params), _flat(state.ema_params)

    model = _port_model(jmodel, params, use_kernels=False)
    opt = AdamW(model.model, cosine_warmup_schedule(1e-2, 1, 10, 2), weight_decay=wd, grad_clip=0.5)
    ema = EMA(model.model, ema_decay)
    norms = []
    for g in grads_seq:
        for name, p in model.model.named_parameters():
            key_, transpose = _jax_name(name)
            value = torch.tensor(g[key_])
            p.grad = value.t().contiguous() if transpose else value
        norms.append(opt.step().item())
        ema.update(model.model)
    assert norms[0] > 0.5 > norms[1]  # the first step clipped, the second did not
    assert opt.count == 3
    decayed = {n for n, p in model.model.named_parameters() if decays(n, p)}
    assert "layers.0.conv.kernel" in decayed and "layers.0.norm.weight" not in decayed
    for name, p in model.model.named_parameters():
        key_, transpose = _jax_name(name)
        for got, want in ((p.detach(), want_params[key_]), (ema.params[name], want_ema[key_])):
            got = (got.t() if transpose else got).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)


def test_draw_loss_noise_shapes_and_ranges():
    k1, k2 = prng.split(prng.prng_key(0))
    n = draw_loss_noise(k1, 5, 3, 9, 50, True, "cpu")
    assert n.t.shape == (5,) and int(n.t.min()) >= 1 and int(n.t.max()) <= 50
    assert n.pos.shape == (5, 3, 3) and n.types.shape == (5, 3, 9) and n.angle.shape == (5, 6)
    assert draw_loss_noise(k2, 5, 3, 9, 50, False, "cpu", timestep=5).angle is None


def test_ranked_checkpoints_keep_the_lowest_scores(tmp_path):
    """save_ranked keeps the `keep` lowest validation losses as best-<step>,
    `best` as the lowest, and evicts the rest; a restore returns its step."""
    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.train.checkpoint import CheckpointManager, diffusion_meta

    jcfg = tiny_config()
    model = DiffusionModel(port_config(jcfg), device="cpu")
    opt = AdamW(model.model, lambda count: 1e-3)
    ckpt = CheckpointManager(str(tmp_path), diffusion_meta(model.config, synthetic_z_table()))
    entered = []
    for step, score in enumerate([5.0, 3.0, 4.0, 6.0, 2.0]):
        opt.count = step
        entered.append(ckpt.save_ranked(score, step, model, opt, keep=3))
    assert entered == [True, True, True, False, True]
    assert {p.name for p in tmp_path.iterdir() if p.is_dir()} == {"best", "best-1", "best-2", "best-4"}
    assert ckpt.load_scores()["ranked"] == [[2.0, "best-4"], [3.0, "best-1"], [4.0, "best-2"]]
    assert ckpt.best_score() == 2.0
    assert ckpt.restore("best", model, AdamW(model.model, lambda count: 1e-3)) == 4


TINY_ARGS = ["--device", "cpu", "--dataset", "synthetic", "--synthetic_size", "60",
             "--batch_size", "8", "--hidden_dim", "16", "--basis_dim", "8", "--layers", "2",
             "--num_ori", "4", "--num_timesteps", "50", "--warmup", "0", "--val_interval", "1",
             "--ema", "0.9"]


def test_train_cli_checkpoint_feeds_generate(tmp_path, capsys):
    """A few CPU steps of the training CLI write last/best checkpoints that
    the generate CLI samples from; a second run resumes from last."""
    ckpt = tmp_path / "ckpt"
    loss = train_diffusion.main([*TINY_ARGS, "--max_steps", "4", "--checkpoint_dir", str(ckpt)])
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert "train throughput" in out and "test loss" in out
    for tag in ("last", "best"):
        assert {p.name for p in (ckpt / tag).iterdir()} == {
            "meta.json", "params.npz", "ema_params.npz", "state.pt"}
    meta = json.loads((ckpt / "meta.json").read_text())
    assert len(meta["fourier_w"]) == 32 and meta["length_stats"]["min"] >= 3.0
    records = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert any("valid/loss" in r for r in records) and "test/loss" in records[-1]

    result = generate.main(["--device", "cpu", "--checkpoint_dir", str(ckpt), "--tag", "best",
                            "--num_crystals", "3", "--batch_size", "3", "--num_atoms_per_sample",
                            "4", "--sample_steps", "4", "--out_dir", str(tmp_path / "gen")])
    assert result.num_crystals == 3 and np.isfinite(result.frac_x).all()

    train_diffusion.main([*TINY_ARGS, "--max_steps", "6", "--checkpoint_dir", str(ckpt)])
    assert "resumed from" in capsys.readouterr().out
    state = torch.load(ckpt / "last" / "state.pt", weights_only=True)
    assert state["step"] == 6


def test_generate_samples_ema_weights_by_default(tmp_path, capsys):
    """generate reads ``<dir>/<tag>`` with the JAX CLI's defaults (``--tag
    last --use_ema true``): after a CPU run of the training CLI with
    ``--ema``, the defaults load exactly the tensors of ``last/ema_params.npz``,
    ``--use_ema false`` exactly those of ``last/params.npz``, and the two
    samples differ."""
    from arreau_tpu_torch.interop.from_jax import load_params_npz

    ckpt = tmp_path / "ckpt"
    train_diffusion.main([*TINY_ARGS, "--max_steps", "4", "--checkpoint_dir", str(ckpt)])
    gen = ["--device", "cpu", "--checkpoint_dir", str(ckpt), "--num_crystals", "3",
           "--batch_size", "3", "--num_atoms_per_sample", "4", "--sample_steps", "4"]
    results = {}
    for use_ema, name in ((None, "ema_params.npz"), ("false", "params.npz")):
        capsys.readouterr()
        flags = [] if use_ema is None else ["--use_ema", use_ema]
        results[name] = generate.main([*gen, *flags, "--out_dir", str(tmp_path / name)])
        assert f"loaded {ckpt / 'last' / name}" in capsys.readouterr().out
        model, _, _ = generate.load_model(str(ckpt), "last", use_ema is None, "cpu")
        want = _flat(load_params_npz(str(ckpt / "last" / name)))
        loaded = _flat(params_to_jax(model.model))
        assert loaded.keys() == want.keys()
        for key_, value in want.items():
            np.testing.assert_array_equal(loaded[key_], value, err_msg=key_)
    ema, raw = (_flat(load_params_npz(str(ckpt / "last" / n))) for n in ("ema_params.npz", "params.npz"))
    assert any(not np.array_equal(ema[k], raw[k]) for k in raw)
    a, b = results["ema_params.npz"], results["params.npz"]
    assert not (np.array_equal(a.frac_x, b.frac_x) and np.array_equal(a.lattice, b.lattice))


@pytest.mark.parametrize("flag, error, match", [
    (["--model_parallel", "2"], ValueError, "1 devices not divisible by model_size=2"),
], ids=["flag0"])
def test_train_cli_later_slices_raise(flag, error, match, tmp_path):
    """``--model_parallel 2`` in one process (world size 1) raises the JAX
    package's divisibility error."""
    with pytest.raises(error, match=match):
        train_diffusion.main([*TINY_ARGS, "--checkpoint_dir", str(tmp_path), *flag])


def test_train_cli_alexandria_shards_match_jax(tmp_path):
    """``--dataset alexandria`` and ``alexandria-dev`` on shards the JAX
    package wrote: the datasets, splits and z-tables of the JAX CLI's
    ``build_datasets``; training on the shard of the synthetic set's
    crystals gives the ``--dataset synthetic`` run's losses bit for bit
    (the z-tables agree); no shard raises the JAX CLI's error."""
    from arreau_tpu.cli import train_diffusion as j_train_diffusion
    from arreau_tpu.data.crystal import write_packed_h5 as j_write_packed_h5

    data = tmp_path / "shards"
    j_write_packed_h5(str(data / "alexandria_ps_000.h5"), j_synthetic_packed(60, seed=0).packed)
    j_write_packed_h5(str(data / "alexandria_ps_000_take10.h5"),
                      j_synthetic_packed(10, seed=1).packed)
    for dataset, size in (("alexandria", 60), ("alexandria-dev", 10)):
        argv = ["--dataset", dataset, "--data_dir", str(data)]
        ds, splits, z_table, t = train_diffusion.build_datasets(train_diffusion.parse_args(argv))
        jds, jsplits, jz, jt = j_train_diffusion.build_datasets(j_train_diffusion.parse_args(argv))
        assert len(ds) == size and t is jt is None and list(z_table.zs) == list(jz.zs)
        for field in ("atomic_numbers", "frac_coords", "offsets", "lattices"):
            np.testing.assert_array_equal(getattr(ds.packed, field), getattr(jds.packed, field))
        np.testing.assert_array_equal(ds.type_indices, jds.type_indices)
        assert splits.keys() == jsplits.keys()
        assert all(np.array_equal(splits[k], jsplits[k]) for k in splits)
    losses = {}
    for name, flags in (("synthetic", []),
                        ("alexandria", ["--dataset", "alexandria", "--data_dir", str(data)])):
        losses[name] = train_diffusion.main([*TINY_ARGS, *flags, "--max_steps", "3",
                                             "--checkpoint_dir", str(tmp_path / name)])
    assert np.isfinite(losses["synthetic"]) and losses["alexandria"] == losses["synthetic"]
    for cli in (train_diffusion, j_train_diffusion):
        with pytest.raises(FileNotFoundError, match="no alexandria shards under"):
            cli.build_datasets(cli.parse_args(["--data_dir", str(tmp_path / "none")]))


def test_train_cli_on_cuda_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the CUDA path runs instead of raising")
    args = [a for a in TINY_ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_diffusion.main([*args, "--checkpoint_dir", str(tmp_path)])


def test_position_grads_builds_and_differentiates():
    """``position_grads=True`` builds (DiffusionConfig has no such field, in
    either package: the backbone is built with it), and a diffusion loss on
    the kernel branch (the kernels' plain versions on the CPU)
    differentiates through the positions: the window cotangent reaches
    them."""
    import dataclasses

    from arreau_tpu_torch.models.ponita import PonitaFiberBundle

    jmodel, host, params = _jax_setup(False)
    model = _port_model(jmodel, params, True)
    model.model = PonitaFiberBundle(dataclasses.replace(model.model.config, position_grads=True))
    params_from_jax(model, params)
    batch = batch_to_device(host, "cpu")
    frac = batch.frac_x.clone().requires_grad_()
    noise = draw_loss_noise(prng.prng_key(0), *host.atom_types.shape,
                            jmodel.config.num_atomic_states, jmodel.config.num_timesteps, False,
                            "cpu")
    loss, _ = model.loss(batch._replace(frac_x=frac), noise)
    (grad,) = torch.autograd.grad(loss, frac)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
