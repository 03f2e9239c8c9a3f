"""The port's CUDA kernels, forward and backward, against their plain
PyTorch versions on the card, at ragged shapes (tiles that do not divide
the receivers, channels, basis or hidden widths; empty neighbour slots),
in float32 and (kernels #3, #4, #7, #8, #9, #10) in bfloat16, and the
kernel branch's parameter gradients against the plain branch's, with and
without ``fuse_fiber``, and in bfloat16 with and without
``fuse_convnext``. Needs an NVIDIA GPU and nvcc; on
a machine without CUDA every test here skips. This file imports no JAX, so
it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from arreau_tpu_torch.kernels.basis_h1 import basis_h1, basis_h1_plain
from arreau_tpu_torch.kernels.basis_mlp import basis_mlp_bwd, basis_mlp_bwd_plain
from arreau_tpu_torch.kernels.convnext_mlp import (
    convnext_mlp,
    convnext_mlp_bwd,
    convnext_mlp_bwd_plain,
    convnext_mlp_plain,
)
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
# bfloat16: kernel and plain version sum in float32 in other orders and
# round at the same points, so a value next to a rounding boundary may round
# the other way (one bf16 ulp, 2^-8) and carry: 1e-2 of each output's scale
BF16_REL_TOL = 1e-2
# a bfloat16 model's gradients, kernel branch against plain branch: the two
# round at different points (the kernels' as the JAX Pallas kernels, the
# plain branch's as flax's chain), through two layers: 5e-2 of each
# parameter's largest gradient
BF16_GRAD_REL_TOL = 5e-2


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, rel=REL_TOL):
    assert got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


def _bf16(args):
    """The floating-point tensors of ``args`` in bfloat16 (the window stays
    float32 where the caller keeps it aside)."""
    return tuple(a.to(torch.bfloat16) if torch.is_tensor(a) and a.is_floating_point() else a
                 for a in args)


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


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,K,TA,D,C", [(2, 3, 4, 40, 37, 70), (2, 16, 8, 120, 256, 200)])
def test_bf16_spatial_conv_kernels_match_plain(Bp, O, K, TA, D, C):
    """#3 and #4 in bfloat16 (basis, W, x, g and the outputs; the window
    float32) at ragged shapes with empty and out-of-range slots."""
    dev = _device()
    rng = np.random.default_rng(7)
    *args, win = _conv_args(rng, dev, Bp, O, K, TA, D, C)
    args = (*_bf16(args), win)
    g = torch.tensor(rng.normal(size=(Bp, O, TA, C)), device=dev).to(torch.bfloat16)
    before = (spatial_conv.launches, spatial_conv_bwd.launches)
    got = spatial_conv(*args)
    got_grads = spatial_conv_bwd(*args, g)
    torch.cuda.synchronize()
    assert (spatial_conv.launches, spatial_conv_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16
    _assert_close(got, spatial_conv_plain(*args), BF16_REL_TOL)
    for a, b in zip(got_grads, spatial_conv_bwd_plain(*args, g)):
        assert a.dtype == torch.bfloat16
        _assert_close(a, b, BF16_REL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,d,E,H,D,n_g", [(2, 3, 6, 100, 70, 37, 3), (2, 16, 6, 960, 200, 256, 5)])
def test_bf16_basis_kernels_match_plain(Bp, O, d, E, H, D, n_g):
    """#8 and #7 in bfloat16; E, H and D not multiples of 64."""
    dev = _device()
    rng = np.random.default_rng(8)
    F = sum(d**i for i in range(1, 4))

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, device=dev).to(torch.bfloat16)

    args = (t(Bp, O, d, E), t(F, H, scale=0.1), t(H), t(H, D, scale=0.1), t(D), 3)
    gs = [t(Bp, O, E, D) for _ in range(n_g)]
    before = (basis_h1.launches, basis_mlp_bwd.launches)
    h1 = basis_h1(args[0], args[1], args[2], 3)
    got = basis_mlp_bwd(*args, gs)
    torch.cuda.synchronize()
    assert (basis_h1.launches, basis_mlp_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert h1.dtype == torch.bfloat16
    _assert_close(h1, basis_h1_plain(args[0], args[1], args[2], 3), BF16_REL_TOL)
    for a, b in zip(got, basis_mlp_bwd_plain(*args, gs)):
        assert a.dtype == torch.float32
        _assert_close(a, b, BF16_REL_TOL)


def _convnext_args(rng, dev, dtype, Bp, O, TA, C, W, R):
    """(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr, br, g_out, g_r); wr,
    br and g_r None for R = 0."""

    def t(*shape, scale=1.0, shift=0.0, dt=torch.float32):
        return torch.tensor(rng.normal(size=shape) * scale + shift, device=dev).to(dt)

    return (t(Bp, O, TA, C, scale=2.0, shift=0.5), t(Bp, O, TA, C, dt=dtype),
            t(C, scale=0.1, shift=1.0), t(C, scale=0.1), t(C, W, scale=0.1, dt=dtype),
            t(W, scale=0.1, dt=dtype), t(W, C, scale=0.05, dt=dtype), t(C, scale=0.1, dt=dtype),
            t(C, scale=0.5, shift=1.0), t(C, R, scale=0.1) if R else None,
            t(R, scale=0.1) if R else None, t(Bp, O, TA, C, dt=dtype),
            t(Bp, O, TA, R) if R else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bp,O,TA,C,W,R", [(2, 3, 40, 70, 150, 5), (2, 16, 120, 200, 800, 19),
                                           (2, 3, 40, 70, 150, 0)])
def test_convnext_mlp_kernels_match_plain(dtype, Bp, O, TA, C, W, R):
    """#9 and #10 with and without the readout (R = 0); rows, C and W not
    multiples of the kernels' 64-wide tiles."""
    dev = _device()
    *args, g_out, g_r = _convnext_args(np.random.default_rng(9), dev, dtype, Bp, O, TA, C, W, R)
    before = (convnext_mlp.launches, convnext_mlp_bwd.launches)
    out, r = convnext_mlp(*args)
    grads = convnext_mlp_bwd(*args, g_out, g_r)
    torch.cuda.synchronize()
    assert (convnext_mlp.launches, convnext_mlp_bwd.launches) == (before[0] + 1, before[1] + 1)
    want_out, want_r = convnext_mlp_plain(*args)
    rel = REL_TOL if dtype == torch.float32 else BF16_REL_TOL
    assert out.dtype == dtype
    _assert_close(out, want_out, rel)
    assert (r is None) == (R == 0)
    if R:
        _assert_close(r, want_r, rel)
    want = convnext_mlp_bwd_plain(*args, g_out, g_r)
    for a, b in zip(grads, want):
        assert (a is None) == (b is None)
        if b is not None:
            _assert_close(a, b, BWD_REL_TOL if dtype == torch.float32 else BF16_REL_TOL)


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


def _assert_kernel_branch_gradients_match_plain_branch(rel=BWD_REL_TOL, fuse_convnext=False,
                                                       **config):
    import dataclasses

    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.models.ponita import PonitaFiberBundle
    from arreau_tpu_torch.tasks.diffusion import DiffusionConfig, DiffusionModel

    dev = _device()
    rng = np.random.default_rng(4)
    B, A = 12, 5
    cfg = DiffusionConfig(num_atomic_states=len(synthetic_z_table()), num_timesteps=50,
                          hidden_dim=32, basis_dim=24, num_layers=2, num_ori=4,
                          max_neighbors=27 * A, layer_scale=1.0, **config)
    models = {k: DiffusionModel(dataclasses.replace(cfg, use_pallas=k), device=dev)
              for k in (True, False)}
    if fuse_convnext:
        models[True].model = PonitaFiberBundle(dataclasses.replace(
            models[True].model.config, fuse_convnext=True)).to(dev)
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
        assert (got - want).abs().max().item() <= rel * scale, name


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
@pytest.mark.parametrize("fuse_convnext", [False, True])
def test_bf16_kernel_branch_parameter_gradients_match_plain_branch(fuse_convnext):
    """compute_dtype="bfloat16": the kernel branch (the bfloat16 kernels,
    and #9/#10 with fuse_convnext) against the plain branch, on the card."""
    from arreau_tpu_torch.kernels import convnext_mlp as cm

    before = (cm.convnext_mlp.launches, cm.convnext_mlp_bwd.launches)
    _assert_kernel_branch_gradients_match_plain_branch(
        BF16_GRAD_REL_TOL, fuse_convnext=fuse_convnext, compute_dtype="bfloat16")
    launched = (cm.convnext_mlp.launches - before[0], cm.convnext_mlp_bwd.launches - before[1])
    assert launched == ((2, 2) if fuse_convnext else (0, 0))


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
    # a wrong type: float16, or bfloat16 beside float32
    conv = (torch.zeros((1, 1, 4, 2), device=dev), torch.zeros((2, 8), device=dev), x,
            torch.zeros((1, 4), dtype=torch.int32, device=dev), torch.zeros((1, 4), device=dev))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        spatial_conv(conv[0].half(), *conv[1:])
    with pytest.raises(TypeError, match="like the basis"):
        spatial_conv(conv[0].bfloat16(), *conv[1:])
    with pytest.raises(TypeError, match="like attrT"):
        basis_h1(torch.zeros((1, 1, 2, 8), device=dev).bfloat16(),
                 torch.zeros((6, 3), device=dev), torch.zeros((3,), device=dev), 2)
    # the fused ConvNext MLP: a wrong type, non-contiguous, too wide
    *cn, g_out, g_r = _convnext_args(np.random.default_rng(0), dev, torch.bfloat16,
                                     1, 1, 8, 16, 64, 3)
    with pytest.raises(TypeError, match="compute type"):
        convnext_mlp(cn[0], cn[1].half(), *cn[2:])
    with pytest.raises(TypeError, match="w1 must be"):
        convnext_mlp(*cn[:4], cn[4].float(), *cn[5:])
    with pytest.raises(ValueError, match="contiguous"):
        convnext_mlp(cn[0].transpose(2, 3).contiguous().transpose(2, 3), *cn[1:])
    with pytest.raises(ValueError, match="g_out must be"):
        convnext_mlp_bwd(*cn, g_out.float(), g_r)
    wide = _convnext_args(np.random.default_rng(0), dev, torch.bfloat16, 1, 1, 8, 264, 64, 3)
    with pytest.raises(ValueError, match="at most 256 channels"):
        convnext_mlp(*wide[:11])
