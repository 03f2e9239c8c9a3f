"""The port's CUDA kernels, forward and backward, against their plain
PyTorch versions on the card, at ragged shapes (tiles that do not divide
the receivers, channels, basis or hidden widths; empty neighbour slots),
and the kernel branch's parameter gradients against the plain branch's,
with and without ``fuse_fiber``. Needs an NVIDIA GPU and nvcc; on
a machine without CUDA every test here skips. This file imports no JAX, so
it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from arreau_tpu_torch.kernels.basis_h1 import basis_h1, basis_h1_plain
from arreau_tpu_torch.kernels.basis_mlp import basis_mlp_bwd, basis_mlp_bwd_plain
from arreau_tpu_torch.kernels.fiber_conv import (
    fiber_conv,
    fiber_conv_bwd,
    fiber_conv_bwd_plain,
    fiber_conv_plain,
)
from arreau_tpu_torch.kernels.spatial_conv import (
    spatial_conv,
    spatial_conv_bwd,
    spatial_conv_bwd_plain,
    spatial_conv_plain,
)

# float32 sums in another order than the plain version's matmul
REL_TOL = 1e-5
# the backward kernels' weight gradients add every edge row (up to ~1e5
# terms) in split partials, and dx adds with shared-memory atomics, in
# another order than the plain version's matmuls and scatter
BWD_REL_TOL = 1e-4


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, rel=REL_TOL):
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


def _conv_args(rng, dev, Bp, O, K, TA, D, C):
    E = K * TA
    src = rng.integers(0, TA, size=(Bp, E))
    src[rng.random((Bp, E)) < 0.3] = -1
    src[rng.random((Bp, E)) < 0.05] = TA + 2  # outside [0, TA): an empty slot too
    return (
        torch.tensor(rng.normal(size=(Bp, O, E, D)), dtype=torch.float32, device=dev),
        torch.tensor(rng.normal(size=(D, C)) * 0.1, dtype=torch.float32, device=dev),
        torch.tensor(rng.normal(size=(Bp, O, TA, C)), dtype=torch.float32, device=dev),
        torch.tensor(src, dtype=torch.int32, device=dev),
        torch.tensor(rng.random((Bp, E)), dtype=torch.float32, device=dev),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,K,TA,D,C", [(2, 3, 4, 40, 37, 70), (1, 16, 8, 128, 256, 200)])
def test_spatial_conv_kernel_matches_plain(Bp, O, K, TA, D, C):
    dev = _device()
    args = _conv_args(np.random.default_rng(0), dev, Bp, O, K, TA, D, C)
    before = spatial_conv.launches
    got = spatial_conv(*args)
    torch.cuda.synchronize()
    assert spatial_conv.launches == before + 1
    _assert_close(got, spatial_conv_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,d,E,H,degree", [(2, 3, 6, 100, 70, 3), (1, 2, 5, 64, 33, 2)])
def test_basis_h1_kernel_matches_plain(Bp, O, d, E, H, degree):
    dev = _device()
    rng = np.random.default_rng(1)
    F = sum(d**i for i in range(1, degree + 1))
    args = (
        torch.tensor(rng.normal(size=(Bp, O, d, E)), dtype=torch.float32, device=dev),
        torch.tensor(rng.normal(size=(F, H)) * 0.1, dtype=torch.float32, device=dev),
        torch.tensor(rng.normal(size=(H,)), dtype=torch.float32, device=dev),
        degree,
    )
    before = basis_h1.launches
    got = basis_h1(*args)
    torch.cuda.synchronize()
    assert basis_h1.launches == before + 1
    _assert_close(got, basis_h1_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,K,TA,D,C", [(2, 3, 4, 40, 37, 70), (2, 16, 8, 120, 256, 200)])
def test_spatial_conv_bwd_kernel_matches_plain(Bp, O, K, TA, D, C):
    """Ragged tiles (TA = 120 as at the 24-atom bucket, D and C not
    multiples of 64), empty slots, and every receiver's senders colliding in
    the dx scatter."""
    dev = _device()
    rng = np.random.default_rng(2)
    args = _conv_args(rng, dev, Bp, O, K, TA, D, C)
    g = torch.tensor(rng.normal(size=(Bp, O, TA, C)), dtype=torch.float32, device=dev)
    before = spatial_conv_bwd.launches
    got = spatial_conv_bwd(*args, g)
    torch.cuda.synchronize()
    assert spatial_conv_bwd.launches == before + 1
    for a, b in zip(got, spatial_conv_bwd_plain(*args, g)):
        _assert_close(a, b, BWD_REL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,d,E,H,D,n_g", [(2, 3, 6, 100, 70, 37, 3), (2, 16, 6, 960, 200, 256, 5),
                                              (1, 2, 5, 64, 33, 20, 1)])
def test_basis_mlp_bwd_kernel_matches_plain(Bp, O, d, E, H, D, n_g):
    dev = _device()
    rng = np.random.default_rng(3)
    degree = 3 if d == 6 else 2
    F = sum(d**i for i in range(1, degree + 1))

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    args = (t(Bp, O, d, E), t(F, H, scale=0.1), t(H), t(H, D, scale=0.1), t(D), degree)
    gs = [t(Bp, O, E, D) for _ in range(n_g)]
    before = basis_mlp_bwd.launches
    got = basis_mlp_bwd(*args, gs)
    torch.cuda.synchronize()
    assert basis_mlp_bwd.launches == before + 1
    for a, b in zip(got, basis_mlp_bwd_plain(*args, gs)):
        _assert_close(a, b, BWD_REL_TOL)


def _fiber_args(rng, dev, Bp, O, P, K, TA, D, C):
    basis, w, x, src, _ = _conv_args(rng, dev, Bp, O, K, TA, D, C)
    fk = torch.tensor(rng.normal(size=(O, P, C)) * 0.3 / O, dtype=torch.float32, device=dev)
    return basis, w, x, src, fk


# ragged: TA = 120 (the 24-atom bucket), D and C not multiples of 64, P != O;
# and the full width, O = P = 16
FIBER_SHAPES = [(2, 3, 5, 4, 40, 37, 70), (2, 16, 16, 8, 120, 256, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,P,K,TA,D,C", FIBER_SHAPES)
def test_fiber_conv_kernel_matches_plain(Bp, O, P, K, TA, D, C):
    """#1 with empty and out-of-range slots; every output element is written
    by one block, so no element may keep a stale value. With the residual:
    the spatial conv too."""
    dev = _device()
    args = _fiber_args(np.random.default_rng(5), dev, Bp, O, P, K, TA, D, C)
    before = fiber_conv.launches
    got = fiber_conv(*args)
    got_y, got_x_sp = fiber_conv(*args, save_x_sp=True)
    torch.cuda.synchronize()
    assert fiber_conv.launches == before + 2
    want_y, want_x_sp = fiber_conv_plain(*args, save_x_sp=True)
    _assert_close(got, want_y)
    assert torch.equal(got_y, got)
    _assert_close(got_x_sp, want_x_sp)


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,P,K,TA,D,C", FIBER_SHAPES)
def test_fiber_conv_bwd_kernel_matches_plain(Bp, O, P, K, TA, D, C):
    dev = _device()
    rng = np.random.default_rng(6)
    args = _fiber_args(rng, dev, Bp, O, P, K, TA, D, C)
    g = torch.tensor(rng.normal(size=(Bp, P, TA, C)), dtype=torch.float32, device=dev)
    x_sp = fiber_conv_plain(*args, save_x_sp=True)[1]
    before = fiber_conv_bwd.launches
    got = fiber_conv_bwd(*args, g, x_sp)
    torch.cuda.synchronize()
    assert fiber_conv_bwd.launches == before + 1
    for a, b in zip(got, fiber_conv_bwd_plain(*args, g, x_sp)):
        _assert_close(a, b, BWD_REL_TOL)


def _assert_kernel_branch_gradients_match_plain_branch(**config):
    import dataclasses

    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.tasks.diffusion import DiffusionConfig, DiffusionModel

    dev = _device()
    rng = np.random.default_rng(4)
    B, A = 12, 5
    cfg = DiffusionConfig(num_atomic_states=len(synthetic_z_table()), num_timesteps=50,
                          hidden_dim=32, basis_dim=24, num_layers=2, num_ori=4,
                          max_neighbors=27 * A, layer_scale=1.0, **config)
    models = {k: DiffusionModel(dataclasses.replace(cfg, use_pallas=k), device=dev)
              for k in (True, False)}
    models[True].model.init_parameters(torch.Generator(device=dev).manual_seed(0))
    models[False].model.load_state_dict(models[True].model.state_dict())
    inputs = (
        torch.tensor(rng.random((B, A, 3)), dtype=torch.float32, device=dev),
        torch.nn.functional.one_hot(torch.tensor(rng.integers(0, 8, (B, A)), device=dev),
                                    cfg.num_atomic_states).float(),
        torch.tensor(rng.integers(1, 50, B), device=dev),
        torch.full((B,), A, device=dev),
        torch.tensor(3.0 + 3.0 * rng.random((B, 3)), dtype=torch.float32, device=dev),
        torch.full((B, 3), np.pi / 2, device=dev),
        torch.ones((B, A), dtype=torch.bool, device=dev),
    )
    grads = {}
    for k, model in models.items():
        outs = model.predict_scores(*inputs)
        loss = sum((o * torch.linspace(-1, 1, o.numel(), device=dev).view_as(o)).sum() for o in outs)
        loss.backward()
        grads[k] = {n: p.grad for n, p in model.model.named_parameters()}
    for name, want in grads[False].items():
        got = grads[True][name]
        assert got is not None, name
        scale = want.abs().max().item()
        assert scale > 0, name
        assert (got - want).abs().max().item() <= BWD_REL_TOL * scale, name


@pytest.mark.cuda
def test_kernel_branch_parameter_gradients_match_plain_branch():
    """The kernel branch's parameter gradients on the card equal the plain
    branch's (both on the card, one neighbour list): the forward kernels'
    outputs carry their backward kernels, not a detached tensor."""
    _assert_kernel_branch_gradients_match_plain_branch()


@pytest.mark.cuda
def test_fuse_fiber_kernel_branch_parameter_gradients_match_plain_branch():
    """The same with ``fuse_fiber``: kernels #1/#2 and the plain basis MLP."""
    _assert_kernel_branch_gradients_match_plain_branch(fuse_fiber=True)


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back():
    dev = _device()
    x = torch.zeros((1, 1, 4, 8), device=dev)
    with pytest.raises(TypeError):
        spatial_conv(torch.zeros((1, 1, 4, 2), device=dev), torch.zeros((2, 8), device=dev), x,
                     torch.zeros((1, 4), dtype=torch.int64, device=dev),
                     torch.zeros((1, 4), device=dev))
    with pytest.raises(ValueError):
        basis_h1(torch.zeros((1, 1, 2, 8), device=dev)[..., ::2],
                 torch.zeros((6, 3), device=dev), torch.zeros((3,), device=dev), 2)
    with pytest.raises(ValueError, match="contiguous"):
        fiber_conv(torch.zeros((1, 1, 4, 2), device=dev), torch.zeros((2, 8), device=dev),
                   torch.zeros((1, 1, 8, 4), device=dev).transpose(2, 3),
                   torch.zeros((1, 4), dtype=torch.int32, device=dev),
                   torch.zeros((1, 2, 8), device=dev))
