"""The PyTorch port's MNIST-superpixels task against the JAX package on the
CPU: the data pipeline (idx reader, SLIC, the synthetic digits), the model
on the R^2 x S^1 grid (logits, loss and every gradient, with the Sparsify
mask and an all-dim digit, on both of the port's branches, one neighbour
list, the same parameters), its invariance with the grid rotated, and the
training CLI, whose flags are the JAX CLI's plus ``--device``."""

import dataclasses
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.cli import train_mnist as j_cli
from arreau_tpu.data import mnist as j_data
from arreau_tpu.ops.radius import radius_neighbor_list as j_radius_neighbor_list
from arreau_tpu.tasks.mnist import Mnist2DBatch as JBatch
from arreau_tpu.tasks.mnist import MnistConfig as JConfig
from arreau_tpu.tasks.mnist import MnistModel as JModel
from arreau_tpu_torch.cli import train_mnist
from arreau_tpu_torch.data import mnist as data
from arreau_tpu_torch.interop.from_jax import _jax_name, params_from_jax
from arreau_tpu_torch.ops.grids import random_so2_matrix
from arreau_tpu_torch.tasks.mnist import Mnist2DBatch, MnistConfig, MnistModel, rotate_mnist_batch
from arreau_tpu_torch.ops import prng
from tests.test_torch_nbody import GRAD_REL_TOL, LOSS_TOL, _neighbors_to_torch
from tests.test_torch_model import perturbed_params

# float32 logits after two conv layers and the readouts, summed over up to 75
# nodes, in another order than XLA's
F32_LOGITS = dict(rtol=1e-4, atol=1e-4)
TINY = dict(hidden_dim=16, basis_dim=12, degree=3, num_layers=2, num_ori=6)


@pytest.fixture(scope="module")
def host():
    """Five synthetic digits through SLIC; the last made all dim (every gray
    value <= the Sparsify threshold), so only its first node stays."""
    ex = data.synthetic_superpixels(5, seed=3)
    value = ex.value.copy()
    value[-1] = np.minimum(value[-1], 0.45)
    return data.Mnist2DExamples(ex.pos, value, ex.mask, ex.label)  # its __len__ breaks _replace


# ---------------- data ----------------


def test_synthetic_superpixels_equal_jax(host):
    want = j_data.synthetic_superpixels(5, seed=3)
    got = data.synthetic_superpixels(5, seed=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got.pos.shape == (5, 75, 2) and got.mask.any(axis=1).all()
    images, labels = data.synthetic_digit_images(3, seed=1)
    j_images, j_labels = j_data.synthetic_digit_images(3, seed=1)
    np.testing.assert_array_equal(images, j_images)
    np.testing.assert_array_equal(labels, j_labels)
    for a, b in zip(data.slic_superpixels(images[0]), j_data.slic_superpixels(j_images[0])):
        np.testing.assert_array_equal(a, b)


def _write_idx(path, array):
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, array.ndim))
        f.write(struct.pack(">" + "I" * array.ndim, *array.shape))
        f.write(array.astype(np.uint8).tobytes())


def test_idx_files_read_as_in_jax(tmp_path):
    images, labels = data.synthetic_digit_images(4, seed=2)
    _write_idx(tmp_path / "train-images-idx3-ubyte", (images * 255).astype(np.uint8))
    _write_idx(tmp_path / "train-labels-idx1-ubyte", labels)
    got = data.load_mnist_superpixels(str(tmp_path), "train", 75)
    want = j_data.load_mnist_superpixels(str(tmp_path), "train", 75)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.label, labels)


# ---------------- the model ----------------


def _jax_setup(host, seed=0):
    jmodel = JModel(JConfig(**TINY), dtype=jnp.float32)
    jbatch = JBatch(pos=jnp.asarray(host.pos), value=jnp.asarray(host.value),
                    mask=jnp.asarray(host.mask), label=jnp.asarray(host.label))
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jbatch), seed)
    return jmodel, jbatch, params


def _port(jmodel, params, use_kernels):
    model = MnistModel(MnistConfig(**dataclasses.asdict(jmodel.config), use_pallas=use_kernels),
                       device="cpu")
    params_from_jax(model, params)
    return model


def _port_inputs(model, host, jmodel):
    """The port's backbone inputs with the JAX package's neighbour list."""
    batch = Mnist2DBatch(pos=torch.tensor(host.pos), value=torch.tensor(host.value),
                         mask=torch.tensor(host.mask), label=torch.tensor(host.label).long())
    inputs = model.build_inputs(batch)
    jnl = j_radius_neighbor_list(jnp.asarray(host.pos), jnp.asarray(inputs.atom_mask.numpy()),
                                 jmodel.config.radius, jmodel.config.max_neighbors, loop=True)
    return batch, inputs._replace(neighbors=_neighbors_to_torch(jnl))


def test_port_config_has_every_jax_field():
    assert {f.name for f in dataclasses.fields(JConfig)} | {"use_pallas"} == {
        f.name for f in dataclasses.fields(MnistConfig)}


def test_sparsify_mask_keeps_a_node_of_an_all_dim_digit(host):
    model = MnistModel(MnistConfig(**TINY), device="cpu")
    batch = Mnist2DBatch(torch.tensor(host.pos), torch.tensor(host.value),
                         torch.tensor(host.mask), torch.tensor(host.label))
    mask = model.node_mask(batch)
    assert mask[-1, 0] and mask[-1].sum() == 1
    want = host.mask & (host.value > 0.5)
    np.testing.assert_array_equal(mask[:-1].numpy(), want[:-1])


def test_mnist_logits_and_loss_match_jax(host):
    """Logits, cross-entropy and accuracy of both of the port's branches
    (the kernel branch at TA = 75, d = 2, one image a super-crystal) against
    the JAX package's plain branch, same parameters and neighbour list."""
    jmodel, jbatch, params = _jax_setup(host)
    want = np.asarray(jax.jit(jmodel.logits)(params, jbatch))
    want_loss, want_m = jax.jit(jmodel.loss)(params, jax.random.PRNGKey(0), jbatch)
    for use_kernels in (False, True):
        model = _port(jmodel, params, use_kernels)
        batch, inputs = _port_inputs(model, host, jmodel)
        with torch.no_grad():
            got = model.logits(batch, inputs)
            loss, metrics = model.loss(batch, inputs)
        assert got.shape == (5, 10)
        np.testing.assert_allclose(got.numpy(), want, **F32_LOGITS)
        np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
        assert metrics["accuracy"].item() == float(want_m["accuracy"])


def test_mnist_loss_gradients_match_jax(host):
    jmodel, jbatch, params = _jax_setup(host, seed=1)
    want = jax.jit(jax.grad(lambda p: jmodel.loss(p, None, jbatch)[0]))(params)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    for use_kernels in (True, False):
        model = _port(jmodel, params, use_kernels)
        batch, inputs = _port_inputs(model, host, jmodel)
        model.loss(batch, inputs)[0].backward()
        names = dict(model.model.named_parameters())
        assert len(names) == len(flat)
        for name, p in names.items():
            key, transpose = _jax_name(name)
            got = (p.grad.t() if transpose else p.grad).numpy()
            scale = np.abs(flat[key]).max()
            assert scale > 0, name
            assert np.abs(got - flat[key]).max() <= GRAD_REL_TOL * scale, (name, use_kernels)


def test_mnist_logits_are_invariant_with_the_grid_rotated(host):
    """Rotating the positions and the S^1 grid leaves the logits unchanged
    (float64, plain branch)."""
    jmodel, _, params = _jax_setup(host, seed=2)
    model = _port(jmodel, params, False)
    model.model.double()
    batch = Mnist2DBatch(torch.tensor(host.pos, dtype=torch.float64),
                         torch.tensor(host.value, dtype=torch.float64),
                         torch.tensor(host.mask), torch.tensor(host.label))
    R = random_so2_matrix(prng.prng_key(4), (), torch.float64)
    with torch.no_grad():
        out = model.logits(batch)
        model.ori_grid = model.ori_grid.double() @ R.T
        out_r = model.logits(rotate_mnist_batch(R.expand(5, 2, 2), batch))
    np.testing.assert_allclose(out_r.numpy(), out.numpy(), rtol=1e-6, atol=1e-9)


# ---------------- the CLI ----------------


def test_cli_flags_are_the_jax_clis_and_device():
    want = vars(j_cli.parse_args([]))
    got = vars(train_mnist.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_train_cli_runs_on_cpu(tmp_path, capsys):
    acc = train_mnist.main([
        "--device", "cpu", "--epochs", "2", "--val_interval", "1", "--batch_size", "4",
        "--synthetic_size", "50", "--hidden_dim", "16", "--basis_dim", "8", "--layers", "2",
        "--num_ori", "6", "--max_steps", "3", "--checkpoint_dir", str(tmp_path),
    ])
    out = capsys.readouterr().out
    assert 0.0 <= acc <= 1.0
    assert "mnist model:" in out and "steps/epoch 10" in out
    assert "epoch 0 | valid acc" in out and f"test accuracy {acc:.4f}" in out
    assert (tmp_path / "last" / "ema_params.npz").exists()


def test_train_cli_on_cuda_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the CUDA path runs instead of raising")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mnist.main(["--synthetic_size", "4", "--checkpoint_dir", str(tmp_path)])
