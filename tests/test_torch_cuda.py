"""The port's CUDA kernels, forward and backward, against their plain
PyTorch versions on the card, at ragged shapes (tiles that do not divide
the receivers, channels, basis or hidden widths; empty neighbour slots),
in float32 and bfloat16, and the kernel branch's parameter gradients
against the plain branch's, with and without ``fuse_fiber``, and in
bfloat16 with and without ``fuse_convnext`` and with ``fuse_fiber``; and
``BasisMLP(fused=True)`` through kernels #5/#6. Needs an NVIDIA GPU and nvcc; on
a machine without CUDA every test here skips. This file imports no JAX, so
it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from pathlib import Path

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
from arreau_tpu_torch.kernels.fused_basis_mlp import (
    fused_basis_mlp,
    fused_basis_mlp_bwd,
    fused_basis_mlp_bwd_plain,
    fused_basis_mlp_plain,
)
from arreau_tpu_torch.kernels.spatial_conv import (
    spatial_conv,
    spatial_conv_bwd,
    spatial_conv_bwd_plain,
    spatial_conv_plain,
    tile_product,
    wgmma_product,
)
from arreau_tpu_torch.ops import prng

# float32 sums in another order than the plain version's matmul
REL_TOL = 1e-5
# the backward kernels' weight gradients add every edge row (up to ~1e5
# terms) in split partials, and dx adds each sender's terms in ascending e,
# in another order than the plain version's matmuls and scatter (#4 and #2
# in 3xTF32)
BWD_REL_TOL = 1e-4
# the tensor-core tile product against a float64 product: bfloat16 products
# are exact in float32 and 3xTF32 keeps ~2^-22 of each product, so only
# float32 summation error remains
TILE_REL_TOL = 1e-5
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a_kmajor", [True, False])
@pytest.mark.parametrize("b_kmajor", [True, False])
@pytest.mark.parametrize("M,N,K", [(16, 8, 16), (200, 150, 77), (256, 256, 256)])
def test_tile_product_fragments_match_float64(dtype, a_kmajor, b_kmajor, M, N, K):
    """csrc/mma.cuh's fragments in all four operand layouts (k-contiguous or
    not, ldmatrix or ldmatrix.trans in bfloat16), one MMA tile, ragged
    tiles with element copies (K = 77), and whole tiles by cp.async: within
    1e-5 of a float64 product's scale (bfloat16 in, 3xTF32 for float32)."""
    dev = _device()
    rng = np.random.default_rng(12)
    a = torch.tensor(rng.normal(size=(M, K)), device=dev).to(dtype)
    b = torch.tensor(rng.normal(size=(K, N)), device=dev).to(dtype)
    # the layout the kernel reads: a [M, K] or the transpose of a [K, M]
    a_in = a.contiguous() if a_kmajor else a.t().contiguous().t()
    b_in = b.t().contiguous().t() if b_kmajor else b.contiguous()
    before = tile_product.launches
    got = tile_product(a_in, b_in)
    torch.cuda.synchronize()
    assert tile_product.launches == before + 1
    want = a.double() @ b.double()
    err = (got.double() - want).abs().max().item()
    assert err <= TILE_REL_TOL * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a_kmajor", [True, False])
@pytest.mark.parametrize("b_kmajor", [True, False])
@pytest.mark.parametrize("M,N,K", [(16, 8, 16), (200, 150, 77), (256, 256, 256)])
def test_built_tile_product_matches_float64(dtype, a_kmajor, b_kmajor, M, N, K):
    """The tile product whose A tile the block writes into shared memory
    itself (``TileProduct::run_built``, the polynomial features of #8/#7):
    A staged a K-slice at a time by cp.async into a slot and copied into the
    A tile by the block's threads, in both A layouts, ragged (K = 77) and
    whole tiles, within 1e-5 of a float64 product's scale."""
    dev = _device()
    rng = np.random.default_rng(14)
    a = torch.tensor(rng.normal(size=(M, K)), device=dev).to(dtype)
    b = torch.tensor(rng.normal(size=(K, N)), device=dev).to(dtype)
    a_in = a.contiguous() if a_kmajor else a.t().contiguous().t()
    b_in = b.t().contiguous().t() if b_kmajor else b.contiguous()
    before = tile_product.launches
    got = tile_product(a_in, b_in, built=True)
    torch.cuda.synchronize()
    assert tile_product.launches == before + 1
    want = a.double() @ b.double()
    err = (got.double() - want).abs().max().item()
    assert err <= TILE_REL_TOL * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a_kmajor", [True, False])
@pytest.mark.parametrize("b_kmajor", [True, False])
@pytest.mark.parametrize("M,N,K", [(16, 8, 16), (200, 150, 77), (130, 420, 200)])
def test_staged_tile_product_matches_float64(dtype, a_kmajor, b_kmajor, M, N, K):
    """``TileProduct::product`` on tiles the block stages itself, as #9/#10's
    row blocks run it: 13 n8 tiles a warp (an odd count, the last B fragment
    loaded alone), both layouts of each operand, ragged depth (K = 77) and
    several 64 x 208 tiles, within 1e-5 of a float64 product's scale."""
    dev = _device()
    rng = np.random.default_rng(16)
    a = torch.tensor(rng.normal(size=(M, K)), device=dev).to(dtype)
    b = torch.tensor(rng.normal(size=(K, N)), device=dev).to(dtype)
    a_in = a.contiguous() if a_kmajor else a.t().contiguous().t()
    b_in = b.t().contiguous().t() if b_kmajor else b.contiguous()
    before = tile_product.launches
    got = tile_product(a_in, b_in, staged=True)
    torch.cuda.synchronize()
    assert tile_product.launches == before + 1
    want = a.double() @ b.double()
    err = (got.double() - want).abs().max().item()
    assert err <= TILE_REL_TOL * want.abs().max().item(), err


def _basis_args(rng, dev, dtype, Bp, O, d, E, H, D, degree, n_g):
    """(attrT, w1, b1, w2, b2, degree) and n_g cotangents of the basis MLP."""
    F = sum(d**i for i in range(1, degree + 1))

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, device=dev).to(dtype)

    args = (t(Bp, O, d, E), t(F, H, scale=0.1), t(H), t(H, D, scale=0.1), t(D), degree)
    return args, [t(Bp, O, E, D) for _ in range(n_g)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bp,O,d,E,H,D,degree,n_g", [
    (2, 3, 6, 17, 33, 37, 1, 1), (2, 3, 5, 100, 70, 20, 2, 5), (1, 2, 6, 17, 70, 64, 3, 16),
    (2, 3, 5, 100, 33, 37, 3, 5), (32, 16, 6, 1024, 200, 256, 3, 5),
    (4, 16, 2, 625, 128, 256, 3, 5), (96, 10, 2, 600, 64, 128, 3, 4)])
def test_basis_kernels_match_plain_at_ragged_shapes(dtype, Bp, O, d, E, H, D, degree, n_g):
    """#8 and #7 (tensor-core products, features built in shared memory)
    against their plain versions: rows, H, D and F that fill no tile (F = 6
    to 155), degrees 1-3, one to sixteen cotangents, the canonical
    training shape (524288 rows, F = 258, H = 200, D = 256, five layers),
    and the N-body and MNIST tasks' shapes (d = 2: F = 14, less than one
    K-stage, through the runtime-decoded feature builder)."""
    dev = _device()
    args, gs = _basis_args(np.random.default_rng(15), dev, dtype, Bp, O, d, E, H, D, degree, n_g)
    before = (basis_h1.launches, basis_mlp_bwd.launches)
    h1 = basis_h1(*args[:3], degree)
    got = basis_mlp_bwd(*args, gs)
    torch.cuda.synchronize()
    assert (basis_h1.launches, basis_mlp_bwd.launches) == (before[0] + 1, before[1] + 1)
    fwd_tol, bwd_tol = (REL_TOL, BWD_REL_TOL) if dtype == torch.float32 else (BF16_REL_TOL,) * 2
    _assert_close(h1, basis_h1_plain(*args[:3], degree), fwd_tol)
    for a, b in zip(got, basis_mlp_bwd_plain(*args, gs)):
        assert a.dtype == torch.float32
        _assert_close(a, b, bwd_tol)


# the backbone tasks' default-path shapes (float32): B', O, K, TA, D, C, H
# and the basis MLP's cotangents (one per layer); both have d = 2 invariants
# (F = 14) and no window (N-body: radius None, a window of ones)
TASK_SHAPES = {"nbody": (4, 16, 5, 125, 256, 128, 128, 5), "mnist": (96, 10, 8, 75, 128, 64, 64, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("task", sorted(TASK_SHAPES))
def test_task_shape_kernels_match_plain_and_repeat(task):
    """#3, #4, #8 and #7 at the N-body and MNIST training shapes against
    their plain versions, each called twice with equal bits: N-body's
    fully connected systems of 5 fill every slot (TA = 125: 25 systems a
    super-crystal), MNIST's Sparsify mask leaves most slots empty (TA = 75,
    C = 64 one partial column tile)."""
    dev = _device()
    rng = np.random.default_rng(17)
    Bp, O, K, TA, D, C, H, n_g = TASK_SHAPES[task]
    E = K * TA
    t, k = np.arange(TA)[None, :], np.arange(K)[:, None]
    if task == "nbody":
        src = np.broadcast_to(((t // 5) * 5 + (t + k) % 5).reshape(-1), (Bp, E)).copy()
        win = np.ones((Bp, E))
    else:
        src = rng.integers(0, TA, size=(Bp, E))
        src[rng.random((Bp, E)) < 0.85] = -1
        win = rng.random((Bp, E))

    def f32(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    conv = (f32(Bp, O, E, D), f32(D, C, scale=0.1), f32(Bp, O, TA, C),
            torch.tensor(src, dtype=torch.int32, device=dev),
            torch.tensor(win, dtype=torch.float32, device=dev))
    g = f32(Bp, O, TA, C)
    args, gs = _basis_args(rng, dev, torch.float32, Bp, O, 2, E, H, D, 3, n_g)
    calls = (("spatial_conv", spatial_conv, spatial_conv_plain, conv, REL_TOL),
             ("spatial_conv_bwd", spatial_conv_bwd, spatial_conv_bwd_plain, (*conv, g),
              BWD_REL_TOL),
             ("basis_h1", basis_h1, basis_h1_plain, args[:3] + (3,), REL_TOL),
             ("basis_mlp_bwd", basis_mlp_bwd, basis_mlp_bwd_plain, (*args, gs), BWD_REL_TOL))
    for name, kernel, plain, a, tol in calls:
        before = kernel.launches
        first, second = kernel(*a), kernel(*a)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2, name
        first, second = (x if isinstance(x, tuple) else (x,) for x in (first, second))
        want = plain(*a)
        for i, (x, y, w) in enumerate(zip(first, second, want if isinstance(want, tuple)
                                          else (want,))):
            assert torch.equal(x, y), (name, i)
            _assert_close(x, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_repeat_bit_for_bit(dtype):
    """#4, #2, #8, #7, #9 and #10 called twice on the same inputs give every
    output equal, dx included (each sender's terms summed in a fixed order)
    and the split-K weight gradients and column sums (partials added in split
    and block order; no atomics)."""
    dev = _device()
    rng = np.random.default_rng(13)
    Bp, O, P, K, TA, D, C = 2, 16, 16, 8, 120, 256, 200
    *args, win = _conv_args(rng, dev, Bp, O, K, TA, D, C)
    args = (*(_bf16(args) if dtype == torch.bfloat16 else args), win)
    g = torch.tensor(rng.normal(size=(Bp, O, TA, C)), device=dev).to(dtype)
    first, second = spatial_conv_bwd(*args, g), spatial_conv_bwd(*args, g)
    fargs = _fiber_args(rng, dev, Bp, O, P, K, TA, D, C)
    fargs = _bf16(fargs) if dtype == torch.bfloat16 else fargs
    fg = torch.tensor(rng.normal(size=(Bp, P, TA, C)), dtype=torch.float32, device=dev)
    x_sp = fiber_conv_plain(*fargs, save_x_sp=True)[1]
    first += fiber_conv_bwd(*fargs, fg, x_sp)
    second += fiber_conv_bwd(*fargs, fg, x_sp)
    bargs, gs = _basis_args(rng, dev, dtype, 2, 16, 6, 960, 200, 256, 3, 5)
    first += (basis_h1(*bargs[:3], 3), *basis_mlp_bwd(*bargs, gs))
    second += (basis_h1(*bargs[:3], 3), *basis_mlp_bwd(*bargs, gs))
    *cargs, g_out, g_r = _convnext_args(rng, dev, dtype, 2, 16, 120, 200, 800, 19)
    first += (*convnext_mlp(*cargs), *convnext_mlp_bwd(*cargs, g_out, g_r))
    second += (*convnext_mlp(*cargs), *convnext_mlp_bwd(*cargs, g_out, g_r))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,K,TA,D,C", [(2, 3, 4, 40, 37, 70), (2, 16, 8, 120, 256, 200),
                                            (2, 16, 8, 12, 256, 200), (1, 2, 1, 17, 24, 8)])
def test_spatial_conv_bwd_kernel_matches_plain(Bp, O, K, TA, D, C):
    """Ragged tiles (TA = 120 as at the 24-atom bucket, TA = 12 as at the
    12-atom one, D and C not multiples of 64, K = 1, C = 8), empty slots, and
    every receiver's senders colliding in dx."""
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bp,O,K,TA,D,C", [(2, 3, 4, 40, 37, 70), (2, 16, 8, 12, 256, 200),
                                            (1, 2, 1, 17, 24, 8), (2, 5, 3, 30, 40, 130),
                                            (32, 16, 8, 128, 256, 200)])
def test_spatial_conv_bwd_window_cotangent_matches_plain_and_repeats(dtype, Bp, O, K, TA, D, C):
    """#4 with ``window_grad``: dwin (float32) and the other three outputs
    against the plain version, at ragged shapes (one or two column tiles of
    the per-edge kernel, C = 8 and 130, empty and out-of-range slots, zero
    windows) and at the training shape (B'=32, O=16, E=1024, TA=128, D=256,
    C=200), float32 and bfloat16; every output the same bit for bit on a
    second call, and the three without ``window_grad`` equal to those with."""
    dev = _device()
    rng = np.random.default_rng(17)
    *args, win = _conv_args(rng, dev, Bp, O, K, TA, D, C)
    win[:, ::7] = 0.0  # edges at the cutoff
    args = (*(_bf16(args) if dtype == torch.bfloat16 else args), win)
    g = torch.tensor(rng.normal(size=(Bp, O, TA, C)), device=dev).to(dtype)
    before = spatial_conv_bwd.launches
    first = spatial_conv_bwd(*args, g, True)
    second = spatial_conv_bwd(*args, g, True)
    without = spatial_conv_bwd(*args, g)
    torch.cuda.synchronize()
    assert spatial_conv_bwd.launches == before + 3
    assert len(first) == 4 and len(without) == 3
    assert first[3].dtype == torch.float32 and first[3].shape == (Bp, K * TA)
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i
    for i, (a, b) in enumerate(zip(first, without)):
        assert torch.equal(a, b), i
    tol = BF16_REL_TOL if dtype == torch.bfloat16 else BWD_REL_TOL
    want = spatial_conv_bwd_plain(*args, g, True)
    for i, (a, b) in enumerate(zip(first, want)):
        _assert_close(a, b, BWD_REL_TOL if i == 3 else tol)
    live = (args[3] >= 0) & (args[3] < TA)
    assert (first[3][~live] == 0).all()


@pytest.mark.cuda
def test_position_grads_kernel_branch_position_gradients_match_plain_branch():
    """``position_grads=True``: a scalar of the scores differentiated with
    respect to the fractional coordinates and the lattice lengths, on the
    kernel branch (#3, and #4 with the window cotangent, no #8/#7) against
    the plain branch, both on the card (one neighbour list); 2 + 2 launches."""
    import dataclasses

    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.kernels import basis_mlp as bm
    from arreau_tpu_torch.models.ponita import PonitaFiberBundle
    from arreau_tpu_torch.tasks.diffusion import DiffusionConfig, DiffusionModel

    dev = _device()
    rng = np.random.default_rng(5)
    B, A = 12, 5
    cfg = DiffusionConfig(num_atomic_states=len(synthetic_z_table()), num_timesteps=50,
                          hidden_dim=32, basis_dim=24, num_layers=2, num_ori=4,
                          max_neighbors=27 * A, layer_scale=1.0)
    models = {k: DiffusionModel(dataclasses.replace(cfg, use_pallas=k), device=dev)
              for k in (True, False)}
    models[True].model = PonitaFiberBundle(dataclasses.replace(
        models[True].model.config, position_grads=True)).to(dev)
    models[True].model.init_parameters(prng.prng_key(0))
    models[False].model.load_state_dict(models[True].model.state_dict())
    frac = torch.tensor(rng.random((B, A, 3)), dtype=torch.float32, device=dev)
    lengths = torch.tensor(3.0 + 3.0 * rng.random((B, 3)), dtype=torch.float32, device=dev)
    rest = (torch.nn.functional.one_hot(torch.tensor(rng.integers(0, 8, (B, A)), device=dev),
                                        cfg.num_atomic_states).float(),
            torch.tensor(rng.integers(1, 50, B), device=dev), torch.full((B,), A, device=dev))
    grads = {}
    before = (spatial_conv.launches, spatial_conv_bwd.launches, basis_h1.launches,
              bm.basis_mlp_bwd.launches)
    for k, model in models.items():
        leaves = (frac.clone().requires_grad_(), lengths.clone().requires_grad_())
        outs = model.predict_scores(leaves[0], *rest, leaves[1],
                                    torch.full((B, 3), np.pi / 2, device=dev),
                                    torch.ones((B, A), dtype=torch.bool, device=dev))
        s = sum((o * torch.linspace(-1, 1, o.numel(), device=dev).view_as(o)).sum() for o in outs)
        grads[k] = torch.autograd.grad(s, leaves)
    torch.cuda.synchronize()
    after = (spatial_conv.launches, spatial_conv_bwd.launches, basis_h1.launches,
             bm.basis_mlp_bwd.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 0, 0)
    for got, want in zip(grads[True], grads[False]):
        assert want.abs().max().item() > 0
        _assert_close(got, want, 1e-3)


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
@pytest.mark.parametrize("Bp,O,K,TA,D,C", [(2, 3, 4, 40, 37, 70), (2, 16, 8, 120, 256, 200),
                                            (2, 16, 8, 12, 256, 200), (1, 2, 1, 17, 24, 8)])
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


# wgmma.cuh's warpgroup products against a float64 product: both operands
# K-major in 128-byte-swizzled shared memory (the one layout the port's
# wgmma kernels use), staged by the block's threads (bfloat16, and float32
# split into tf32 halves for 3xTF32) or by TMA (bfloat16, K a multiple of
# 8); M over several 64-row warpgroup tiles and ragged, N in each width
# class (64, 128, 208, 256) and ragged, K ragged
WGMMA_SHAPES = [(64, 16, 16), (130, 150, 80), (64, 256, 256), (200, 200, 272), (70, 8, 40)]
WGMMA_CASES = ([(torch.float32, False, *s) for s in WGMMA_SHAPES + [(130, 150, 77)]]
               + [(torch.bfloat16, False, *s) for s in WGMMA_SHAPES + [(130, 150, 77)]]
               + [(torch.bfloat16, True, *s) for s in WGMMA_SHAPES])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tma,M,N,K", WGMMA_CASES)
def test_wgmma_products_match_float64(dtype, tma, M, N, K):
    """a [M, K] @ b [N, K]^T through csrc/wgmma.cuh (fragments, descriptors,
    the 128-byte swizzle, TMA loads) within TILE_REL_TOL of float64."""
    dev = _device()
    rng = np.random.default_rng(M + N + K)
    a = torch.tensor(rng.normal(size=(M, K)), device=dev).to(dtype)
    b = torch.tensor(rng.normal(size=(N, K)), device=dev).to(dtype)
    before = wgmma_product.launches
    got = wgmma_product(a, b, tma=tma)
    torch.cuda.synchronize()
    assert wgmma_product.launches == before + 1
    want = a.double() @ b.double().t()
    err = (got.double() - want).abs().max().item()
    assert err <= TILE_REL_TOL * want.abs().max().item(), err


# wgmma.cuh's two layouts for #3 and #4 (csrc/conv_sm90.cuh), bfloat16 by
# TMA, against float64: A read through a 3-D map of slabs whose 64-row boxes
# are clipped at the slab's end (slab = TA: 128, 125, 80, 75, 40, 12, 17
# rows), and both operands MN-major (#4's weight gradient: N in each width
# class 64, 128, 208, 256, ragged, with partial 64-column boxes; K ragged)
WGMMA_SLAB_CASES = [(256, 200, 256, 128), (250, 128, 256, 125), (160, 208, 256, 80),
                    (150, 64, 128, 75), (120, 70, 64, 40), (36, 8, 24, 12), (34, 16, 40, 17)]
WGMMA_MN_CASES = [(256, 200, 4096), (128, 128, 200), (64, 64, 64), (200, 256, 130),
                  (40, 72, 77), (256, 208, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,slab", WGMMA_SLAB_CASES)
def test_wgmma_slab_map_matches_float64(M, N, K, slab):
    dev = _device()
    rng = np.random.default_rng(M + N + K + slab)
    a = torch.tensor(rng.normal(size=(M, K)), device=dev).to(torch.bfloat16)
    b = torch.tensor(rng.normal(size=(N, K)), device=dev).to(torch.bfloat16)
    got = wgmma_product(a, b, slab=slab)
    torch.cuda.synchronize()
    want = a.double() @ b.double().t()
    err = (got.double() - want).abs().max().item()
    assert err <= TILE_REL_TOL * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", WGMMA_MN_CASES)
def test_wgmma_mn_major_operands_match_float64(M, N, K):
    dev = _device()
    rng = np.random.default_rng(M + 3 * N + K)
    a = torch.tensor(rng.normal(size=(K, M)), device=dev).to(torch.bfloat16)
    b = torch.tensor(rng.normal(size=(K, N)), device=dev).to(torch.bfloat16)
    got = wgmma_product(a, b, mn_major=True)
    torch.cuda.synchronize()
    want = a.double().t() @ b.double()
    err = (got.double() - want).abs().max().item()
    assert err <= TILE_REL_TOL * want.abs().max().item(), err


# every shape the port hands #3 and #4 (on wgmma and TMA since the Hopper
# redesign): the training, serving and flagship cells (TA = 128, 128, 80),
# the N-body and MNIST tasks (TA = 125, 75; C = 128, 64; D = 128), and ragged
# shapes (D = 37 and 24, rows the threads stage; C = 70, 130 and 8; TA = 40,
# 12, 17, 30, 120; K = 1)
SM90_CONV_SHAPES = [(32, 16, 8, 128, 256, 200), (8, 16, 8, 128, 256, 200),
                    (10, 16, 8, 80, 256, 200), (4, 16, 5, 125, 256, 128),
                    (96, 10, 8, 75, 128, 64), (2, 3, 4, 40, 37, 70), (2, 16, 8, 12, 256, 200),
                    (1, 2, 1, 17, 24, 8), (2, 5, 3, 30, 40, 130), (2, 16, 8, 120, 256, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bp,O,K,TA,D,C", SM90_CONV_SHAPES)
def test_conv_kernels_match_plain_and_repeat_at_every_shape(dtype, Bp, O, K, TA, D, C):
    """#3 and #4 (with and without the window cotangent) against their plain
    versions, float32 and bfloat16, with empty and out-of-range slots and
    zero windows; every output the same bit for bit on a second call, and
    #4's three outputs without the window cotangent equal to those with it."""
    dev = _device()
    rng = np.random.default_rng(Bp + O + K + TA + D + C)
    *args, win = _conv_args(rng, dev, Bp, O, K, TA, D, C)
    win[:, ::7] = 0.0
    args = (*(_bf16(args) if dtype == torch.bfloat16 else args), win)
    g = torch.tensor(rng.normal(size=(Bp, O, TA, C)), device=dev).to(dtype)
    before = (spatial_conv.launches, spatial_conv_bwd.launches)
    out = (spatial_conv(*args), spatial_conv(*args))
    first = spatial_conv_bwd(*args, g, True)
    second = spatial_conv_bwd(*args, g, True)
    without = spatial_conv_bwd(*args, g)
    torch.cuda.synchronize()
    assert (spatial_conv.launches, spatial_conv_bwd.launches) == (before[0] + 2, before[1] + 3)
    assert torch.equal(out[0], out[1])
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i
    for i, (a, b) in enumerate(zip(first, without)):
        assert torch.equal(a, b), i
    bf16 = dtype == torch.bfloat16
    _assert_close(out[0], spatial_conv_plain(*args), BF16_REL_TOL if bf16 else REL_TOL)
    for i, (a, b) in enumerate(zip(first, spatial_conv_bwd_plain(*args, g, True))):
        _assert_close(a, b, BWD_REL_TOL if i == 3 or not bf16 else BF16_REL_TOL)
    live = (args[3] >= 0) & (args[3] < TA)
    assert (first[3][~live] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_weight_copies_follow_the_weights(dtype):
    """The wrappers keep W's K-major copies for each state of W: after an
    in-place update, after a new storage (``.data =``, as the tensor-parallel
    plan shards a weight) and for a tensor made in inference mode (no
    version counter), #3 and #4 use the W they are given."""
    dev = _device()
    rng = np.random.default_rng(7)
    *args, win = _conv_args(rng, dev, 2, 3, 4, 40, 64, 70)
    basis, w, x, src = _bf16(args) if dtype == torch.bfloat16 else args
    g = torch.tensor(rng.normal(size=x.shape), device=dev).to(dtype)

    def check():
        a = (basis, w, x, src, win)
        bf16 = dtype == torch.bfloat16
        _assert_close(spatial_conv(*a), spatial_conv_plain(*a), BF16_REL_TOL if bf16 else REL_TOL)
        for got, want in zip(spatial_conv_bwd(*a, g), spatial_conv_bwd_plain(*a, g)):
            _assert_close(got, want, BF16_REL_TOL if bf16 else BWD_REL_TOL)

    check()
    w.mul_(-0.5)
    check()
    w.data = torch.flip(w, dims=(1,)).contiguous()
    check()
    with torch.inference_mode():
        w = w.to(dtype) * 2.0
        check()
        w.add_(1.0)
        check()


@pytest.mark.cuda
def test_conv_kernels_refuse_widths_past_one_accumulator():
    """#3 and #4 hold half of C (and of D) in one warpgroup's accumulator:
    C or D above 256 raises before any launch."""
    dev = _device()
    args = _conv_args(np.random.default_rng(0), dev, 1, 1, 1, 8, 16, 264)
    with pytest.raises(ValueError, match="up to 256"):
        spatial_conv(*args)
    args = _conv_args(np.random.default_rng(0), dev, 1, 1, 1, 8, 264, 16)
    with pytest.raises(ValueError, match="up to 256"):
        spatial_conv_bwd(*args, torch.zeros((1, 1, 8, 16), device=dev))


# every shape the port hands #8 and #7 in bfloat16 (on wgmma and TMA): the
# training, serving and flagship (E = 640) cells, the N-body and MNIST
# tasks, and the ragged shapes above (H = 33, 70; D = 20, 37, 64; F = 6 to
# 155; one to sixteen cotangents)
BF16_BASIS_SHAPES = [(32, 16, 6, 1024, 200, 256, 3, 5), (8, 16, 6, 1024, 200, 256, 3, 5),
                     (10, 16, 6, 640, 200, 256, 3, 5), (4, 16, 2, 625, 128, 256, 3, 5),
                     (96, 10, 2, 600, 64, 128, 3, 4), (2, 3, 6, 17, 33, 37, 1, 1),
                     (2, 3, 5, 100, 70, 20, 2, 5), (1, 2, 6, 17, 70, 64, 3, 16),
                     (2, 3, 5, 100, 33, 37, 3, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,d,E,H,D,degree,n_g", BF16_BASIS_SHAPES)
def test_bf16_basis_kernels_repeat_and_match_plain_at_every_shape(Bp, O, d, E, H, D, degree,
                                                                 n_g):
    """#8 and #7 in bfloat16, each called twice: one launch a call, every
    output equal on both calls (no atomics: the split partials add in split
    order), and within BF16_REL_TOL of the plain versions."""
    dev = _device()
    args, gs = _basis_args(np.random.default_rng(21), dev, torch.bfloat16, Bp, O, d, E, H, D,
                           degree, n_g)
    before = (basis_h1.launches, basis_mlp_bwd.launches)
    h1 = [basis_h1(*args[:3], degree) for _ in range(2)]
    grads = [basis_mlp_bwd(*args, gs) for _ in range(2)]
    torch.cuda.synchronize()
    assert (basis_h1.launches, basis_mlp_bwd.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(h1[0], h1[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    _assert_close(h1[0], basis_h1_plain(*args[:3], degree), BF16_REL_TOL)
    for a, b in zip(grads[0], basis_mlp_bwd_plain(*args, gs)):
        _assert_close(a, b, BF16_REL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,d,E,H,D,degree,n_g", BF16_BASIS_SHAPES)
def test_f32_basis_kernels_repeat_and_match_plain_at_every_shape(Bp, O, d, E, H, D, degree, n_g):
    """#8 and #7 in float32 (3xTF32 on tf32 wgmma, csrc/basis_f32_sm90.cuh)
    at every shape the port hands them (the bfloat16 list above: the
    training, serving and flagship cells, N-body, MNIST, the ragged shapes,
    one to sixteen cotangents), each called twice: one launch a call, every
    output equal on both calls, #8 within REL_TOL and #7 within BWD_REL_TOL
    of the plain versions."""
    dev = _device()
    args, gs = _basis_args(np.random.default_rng(23), dev, torch.float32, Bp, O, d, E, H, D,
                           degree, n_g)
    before = (basis_h1.launches, basis_mlp_bwd.launches)
    h1 = [basis_h1(*args[:3], degree) for _ in range(2)]
    grads = [basis_mlp_bwd(*args, gs) for _ in range(2)]
    torch.cuda.synchronize()
    assert (basis_h1.launches, basis_mlp_bwd.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(h1[0], h1[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    _assert_close(h1[0], basis_h1_plain(*args[:3], degree))
    for a, b in zip(grads[0], basis_mlp_bwd_plain(*args, gs)):
        assert a.dtype == torch.float32
        _assert_close(a, b, BWD_REL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_basis_weight_copies_follow_the_weights(dtype):
    """#8 and #7 keep the weights' K-major copies for each state of W1 and W2:
    after an in-place update, after a new storage (``.data =``) and for
    tensors made in inference mode (no version counter: #8's launch copies
    such a W1 in its own call), both kernels use the weights they are
    given."""
    dev = _device()
    args, gs = _basis_args(np.random.default_rng(24), dev, dtype, 2, 3, 6, 100, 70, 37, 3, 2)
    attrT, w1, b1, w2, b2, degree = args
    f32 = dtype == torch.float32

    def check():
        a = (attrT, w1, b1, w2, b2, degree)
        _assert_close(basis_h1(*a[:3], degree), basis_h1_plain(*a[:3], degree),
                      REL_TOL if f32 else BF16_REL_TOL)
        for got, want in zip(basis_mlp_bwd(*a, gs), basis_mlp_bwd_plain(*a, gs)):
            _assert_close(got, want, BWD_REL_TOL if f32 else BF16_REL_TOL)

    check()
    w1.mul_(-0.5)
    w2.mul_(2.0)
    check()
    w1.data = torch.flip(w1, dims=(1,)).contiguous()
    w2.data = torch.flip(w2, dims=(0,)).contiguous()
    check()
    with torch.inference_mode():
        w1, w2 = w1.to(dtype) * 2.0, w2.to(dtype) * 0.5
        check()
        w1.add_(0.25)
        w2.sub_(0.25)
        check()


@pytest.mark.cuda
def test_f32_basis_kernels_refuse_widths_past_one_accumulator():
    """The float32 kernels hold all of H and of D in one wgmma accumulator
    (N <= 256) too: wider layers raise on the card rather than fall back."""
    dev = _device()
    args, gs = _basis_args(np.random.default_rng(22), dev, torch.float32, 1, 2, 6, 64, 300,
                           32, 3, 1)
    with pytest.raises(ValueError, match="<= 256"):
        basis_h1(*args[:3], 3)
    args, gs = _basis_args(np.random.default_rng(22), dev, torch.float32, 1, 2, 6, 64, 32,
                           300, 3, 1)
    with pytest.raises(ValueError, match="<= 256"):
        basis_mlp_bwd(*args, gs)


@pytest.mark.cuda
def test_bf16_basis_kernels_refuse_widths_past_one_accumulator():
    """The bfloat16 kernels hold all of H and of D in one wgmma accumulator
    (N <= 256): wider layers raise on the card rather than fall back."""
    dev = _device()
    args, gs = _basis_args(np.random.default_rng(22), dev, torch.bfloat16, 1, 2, 6, 64, 300,
                           32, 3, 1)
    with pytest.raises(ValueError, match="<= 256"):
        basis_h1(*args[:3], 3)
    args, gs = _basis_args(np.random.default_rng(22), dev, torch.bfloat16, 1, 2, 6, 64, 32,
                           300, 3, 1)
    with pytest.raises(ValueError, match="<= 256"):
        basis_mlp_bwd(*args, gs)


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


# rows (B' * O * TA) 1, 63, 65 and 129 (either side of the 64- and 128-row
# blocks), C 8 / 70 / 200 / 256 (both block widths, 208 and 256), W 32 / 150
# / 800 / 1024 (chunks ragged and whole), R 1 / 5 / 19 / 32 and 0 (no
# readout), and the canonical training shape (65536 rows)
CONVNEXT_SHAPES = [(1, 1, 1, 8, 32, 1), (1, 1, 63, 70, 150, 19), (1, 1, 65, 200, 800, 0),
                   (1, 1, 129, 256, 1024, 32), (1, 3, 43, 8, 1024, 0), (1, 1, 63, 256, 32, 1),
                   (1, 1, 65, 200, 150, 32), (2, 3, 40, 70, 150, 5), (2, 16, 120, 200, 800, 19),
                   (2, 3, 40, 70, 150, 0), (32, 16, 128, 200, 800, 19)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bp,O,TA,C,W,R", CONVNEXT_SHAPES)
def test_convnext_mlp_kernels_match_plain(dtype, Bp, O, TA, C, W, R):
    """#9 and #10 with and without the readout (R = 0); rows, C and W not
    multiples of the kernels' row blocks, channel widths and hidden chunks."""
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


# bfloat16 #9/#10 on wgmma (csrc/convnext_sm90.cuh) at the widest shapes the
# wrappers take: C = 256 (the 256 class), R = 64, ragged W (1000: a partial
# last chunk of the 64-unit chunks) and rows off the 128-row tile (M = 129,
# 1 + 64 rows); and C = 200, W = 800 at 65 and 1000 rows
CONVNEXT_SM90_SHAPES = [(1, 3, 43, 256, 1000, 64), (1, 1, 129, 256, 1000, 64),
                        (1, 1, 65, 200, 800, 19), (2, 5, 100, 200, 800, 19)]


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,TA,C,W,R", CONVNEXT_SM90_SHAPES)
def test_bf16_convnext_sm90_widest_shapes_match_plain_and_repeat(Bp, O, TA, C, W, R):
    """bfloat16 #9 and #10 (wgmma kernels) against their plain versions at
    BF16_REL_TOL, and a second call's outputs equal to the first's bit for
    bit (fixed-order sums, no atomics)."""
    dev = _device()
    *args, g_out, g_r = _convnext_args(np.random.default_rng(23), dev, torch.bfloat16, Bp, O,
                                       TA, C, W, R)
    first = (*convnext_mlp(*args), *convnext_mlp_bwd(*args, g_out, g_r))
    second = (*convnext_mlp(*args), *convnext_mlp_bwd(*args, g_out, g_r))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    want = (*convnext_mlp_plain(*args), *convnext_mlp_bwd_plain(*args, g_out, g_r))
    for a, b in zip(first, want):
        _assert_close(a, b, BF16_REL_TOL)


@pytest.mark.cuda
def test_convnext_sm90_kernels_issue_warpgroup_products():
    """Every instantiation of the bfloat16 #9/#10 kernels (cnx_fwd_kernel,
    cnx_rows_kernel, cnx_dw_kernel) in the built library issues HGMMA
    (wgmma) and UTMALDG (TMA loads) in its SASS, and no bfloat16
    instantiation of the mma.sync row blocks remains."""
    import re
    import subprocess

    from arreau_tpu_torch.kernels import build

    _device()
    build.library()  # built and loaded
    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build.LIB_PATH)], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"\d(cnx_fwd_kernel|cnx_rows_kernel|cnx_dw_kernel)I(\w+?)EEv", line)
            current = (m.group(1), m.group(2)) if m else None
            if current:
                counts[current] = {"HGMMA": 0, "UTMALDG": 0}
            assert "convnext_fwd_kernelI13__nv_bfloat16" not in line
            assert "convnext_bwd_rows_kernelI13__nv_bfloat16" not in line
        elif current:
            for op in counts[current]:
                counts[current][op] += op in line
    assert {k[0] for k in counts} == {"cnx_fwd_kernel", "cnx_rows_kernel", "cnx_dw_kernel"}
    for key, c in counts.items():
        assert c["HGMMA"] > 0 and c["UTMALDG"] > 0, (key, c)


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


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,O,P,K,TA,D,C", FIBER_SHAPES)
def test_bf16_fiber_conv_kernels_match_plain(Bp, O, P, K, TA, D, C):
    """#1 and #2 in bfloat16 (basis, W, x and Kf; y, x_sp and g float32),
    with empty and out-of-range slots; dbasis and dx in bfloat16, dW and dKf
    in the weights' type."""
    dev = _device()
    rng = np.random.default_rng(10)
    args = _bf16(_fiber_args(rng, dev, Bp, O, P, K, TA, D, C))
    g = torch.tensor(rng.normal(size=(Bp, P, TA, C)), dtype=torch.float32, device=dev)
    before = (fiber_conv.launches, fiber_conv_bwd.launches)
    got_y, got_x_sp = fiber_conv(*args, save_x_sp=True)
    want_y, want_x_sp = fiber_conv_plain(*args, save_x_sp=True)
    got = fiber_conv_bwd(*args, g, want_x_sp)
    torch.cuda.synchronize()
    assert (fiber_conv.launches, fiber_conv_bwd.launches) == (before[0] + 1, before[1] + 1)
    # float32 sums of bfloat16 values, nothing rounded in between: float32 tolerance
    _assert_close(got_y, want_y)
    _assert_close(got_x_sp, want_x_sp)
    for a, b in zip(got, fiber_conv_bwd_plain(*args, g, want_x_sp)):
        assert a.dtype == torch.bfloat16
        _assert_close(a, b, BF16_REL_TOL)


# the forward convs #3 and #1 on the tensor cores: receivers that fill no
# whole tile (TA = 12, 17, 40) or several (480: x read from device memory,
# its rows do not fit in shared memory), one, eight or 40 neighbour slots
# (more than a block stages at once), D and C not multiples of the tiles,
# P != O; and the canonical width
FORWARD_CONV_SHAPES = [(2, 3, 3, 1, 12, 24, 8), (2, 3, 5, 8, 17, 37, 70),
                       (2, 3, 3, 4, 40, 37, 70), (2, 4, 4, 8, 128, 256, 200),
                       (1, 2, 2, 1, 480, 37, 70), (1, 2, 2, 40, 12, 24, 8),
                       (1, 16, 16, 8, 128, 256, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bp,O,P,K,TA,D,C", FORWARD_CONV_SHAPES)
def test_forward_conv_kernels_match_plain_and_repeat(dtype, Bp, O, P, K, TA, D, C):
    """#3 and #1 against their plain versions (float32 within REL_TOL, bf16
    within BF16_REL_TOL for #3's rounded output; #1's float32 outputs of
    bf16 operands within REL_TOL), with -1 and out-of-range slots; every
    output the same bit for bit on a second call; one launch a call; #1's
    x_sp is the spatial conv with a unit window."""
    dev = _device()
    rng = np.random.default_rng(17)
    *args, win = _conv_args(rng, dev, Bp, O, K, TA, D, C)
    fk = torch.tensor(rng.normal(size=(O, P, C)) * 0.3 / O, dtype=torch.float32, device=dev)
    if dtype == torch.bfloat16:
        args, fk = _bf16(args), fk.to(dtype)
    before = (spatial_conv.launches, fiber_conv.launches)
    out = [spatial_conv(*args, win), spatial_conv(*args, win)]
    fib = [fiber_conv(*args, fk, save_x_sp=True), fiber_conv(*args, fk, save_x_sp=True)]
    torch.cuda.synchronize()
    assert (spatial_conv.launches, fiber_conv.launches) == (before[0] + 2, before[1] + 2)
    assert out[0].dtype == dtype and torch.equal(out[0], out[1])
    assert all(torch.equal(a, b) for a, b in zip(*fib))
    _assert_close(out[0], spatial_conv_plain(*args, win),
                  REL_TOL if dtype == torch.float32 else BF16_REL_TOL)
    want_y, want_x_sp = fiber_conv_plain(*args, fk, save_x_sp=True)
    y, x_sp = fib[0]
    assert y.dtype == x_sp.dtype == torch.float32
    _assert_close(y, want_y)
    _assert_close(x_sp, want_x_sp)
    ones = torch.ones_like(win)
    _assert_close(x_sp, spatial_conv_plain(*(a.float() if a.is_floating_point() else a
                                             for a in args), ones))


# ragged: rows not a multiple of the 128-row tile, d < 6, degree 1 to 3, H
# and D not multiples of 8 (rows that do not align to 16 bytes); the
# canonical width (H = 200, D = 256) with d = 3 (features decoded at run
# time) and d = 6 (fixed at compile time) at ragged E, with one split of
# the weight gradients and with several, the last one short; and the
# canonical shape cut to one b'
FUSED_BASIS_SHAPES = [(2, 3, 100, 6, 70, 37, 3), (1, 2, 33, 4, 20, 64, 2), (2, 1, 65, 5, 65, 10, 1),
                      (2, 3, 100, 3, 200, 256, 3), (1, 5, 333, 6, 200, 256, 3),
                      (3, 2, 77, 3, 200, 256, 2), (2, 5, 1001, 6, 200, 256, 3),
                      (1, 16, 1024, 6, 200, 256, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bp,O,E,d,H,D,degree", FUSED_BASIS_SHAPES)
def test_fused_basis_mlp_kernels_match_plain(dtype, Bp, O, E, d, H, D, degree):
    """#5 and #6 (tensor-core products) at ragged shapes, in float32 and
    bfloat16, against their plain versions; every output the same bit for
    bit on a second call; one launch a call."""
    dev = _device()
    rng = np.random.default_rng(11)
    F = sum(d**i for i in range(1, degree + 1))

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, device=dev).to(dtype)

    args = (t(Bp, O, E, d), t(F, H, scale=0.2), t(H, D, scale=0.2), degree)
    g = t(Bp, O, E, D)
    before = (fused_basis_mlp.launches, fused_basis_mlp_bwd.launches)
    out = [fused_basis_mlp(*args), fused_basis_mlp(*args)]
    got = [fused_basis_mlp_bwd(*args, g), fused_basis_mlp_bwd(*args, g)]
    torch.cuda.synchronize()
    assert (fused_basis_mlp.launches, fused_basis_mlp_bwd.launches) == (before[0] + 2,
                                                                        before[1] + 2)
    assert torch.equal(out[0], out[1])
    assert all(torch.equal(a, b) for a, b in zip(*got))
    f32 = dtype == torch.float32
    assert out[0].dtype == dtype
    _assert_close(out[0], fused_basis_mlp_plain(*args), REL_TOL if f32 else BF16_REL_TOL)
    for a, b in zip(got[0], fused_basis_mlp_bwd_plain(*args, g)):
        assert a.dtype == torch.float32
        _assert_close(a, b, BWD_REL_TOL if f32 else BF16_REL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_fused_basis_module_launches_its_kernels(dtype):
    """BasisMLP(fused=True, use_bias=False) on the card: one launch of #5 a
    forward and of #6 a backward, weight gradients of its compute type's
    precision against the plain chain's, no cotangent for the invariants."""
    from arreau_tpu_torch.models.blocks import BasisMLP

    dev = _device()
    torch.manual_seed(0)
    fused = BasisMLP(6, 40, 24, 3, use_bias=False, fused=True).to(dev)
    plain = BasisMLP(6, 40, 24, 3, use_bias=False).to(dev)
    plain.load_state_dict(fused.state_dict())
    attr = torch.randn((2, 4, 100, 6), device=dev, requires_grad=True)
    before = (fused_basis_mlp.launches, fused_basis_mlp_bwd.launches)
    out = fused(attr, dtype)
    (out.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    assert (fused_basis_mlp.launches, fused_basis_mlp_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert out.dtype == (dtype or torch.float32) and attr.grad.abs().max().item() == 0.0
    (plain(attr.detach(), dtype).float() ** 2).sum().backward()
    rel = BWD_REL_TOL if dtype is None else BF16_GRAD_REL_TOL
    for a, b in zip(fused.parameters(), plain.parameters()):
        _assert_close(a.grad, b.grad, rel)


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
    models[True].model.init_parameters(prng.prng_key(0))
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
def test_bf16_fuse_fiber_kernel_branch_parameter_gradients_match_plain_branch():
    """compute_dtype="bfloat16" with fuse_fiber: bf16 #1/#2 against the plain
    branch, on the card; two launches of each."""
    before = (fiber_conv.launches, fiber_conv_bwd.launches)
    _assert_kernel_branch_gradients_match_plain_branch(
        BF16_GRAD_REL_TOL, fuse_fiber=True, compute_dtype="bfloat16")
    assert (fiber_conv.launches - before[0], fiber_conv_bwd.launches - before[1]) == (2, 2)


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
    with pytest.raises(TypeError, match="like the basis"):
        fiber_conv(torch.zeros((1, 1, 4, 2), device=dev).bfloat16(),
                   torch.zeros((2, 8), device=dev), x, torch.zeros((1, 4), dtype=torch.int32,
                                                                device=dev),
                   torch.zeros((1, 2, 8), device=dev))
    with pytest.raises(TypeError, match="like attr"):
        fused_basis_mlp(torch.zeros((1, 1, 8, 2), device=dev).bfloat16(),
                        torch.zeros((6, 3), device=dev), torch.zeros((3, 4), device=dev), 2)
    with pytest.raises(ValueError, match="at most 8 invariants"):
        fused_basis_mlp(torch.zeros((1, 1, 8, 9), device=dev), torch.zeros((9, 3), device=dev),
                        torch.zeros((3, 4), device=dev), 1)
    with pytest.raises(TypeError, match="like attrT"):
        basis_h1(torch.zeros((1, 1, 2, 8), device=dev).bfloat16(),
                 torch.zeros((6, 3), device=dev), torch.zeros((3,), device=dev), 2)
    # the fused ConvNext MLP: a wrong type, non-contiguous, too wide, too wide a readout
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
    *cn, g_out, g_r = _convnext_args(np.random.default_rng(0), dev, torch.bfloat16,
                                     1, 1, 8, 16, 64, 65)
    with pytest.raises(ValueError, match="at most 64 readout columns"):
        convnext_mlp_bwd(*cn, g_out, g_r)


@pytest.mark.cuda
def test_relax_and_quality_report_on_the_card_match_the_cpu():
    """``relax_soft_sphere`` on the card against the same call on the CPU
    (64 crystals of 2..8 atoms in overlapping cells, float32, 50 steps):
    coordinates within 1e-4 on the circle, the energy history within 1e-4
    of its scale; then ``quality_report`` of both relaxed sets against one
    synthetic reference: every value within 1e-4, a rate within one
    crystal (a pair distance or a fingerprint at a threshold may tip)."""
    from arreau_tpu_torch.cli.generate import quality_from_results, reference_dataset
    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.data.synthetic import random_lattices
    from arreau_tpu_torch.inference.io import SampleResult
    from arreau_tpu_torch.inference.relax import relax_soft_sphere

    dev = _device()
    rng = np.random.default_rng(5)
    B, A = 64, 8
    counts = rng.integers(2, A + 1, size=B)
    mask = np.arange(A)[None, :] < counts[:, None]
    frac = rng.uniform(size=(B, A, 3)).astype(np.float32)
    lattice = (0.6 * random_lattices(rng, B)).astype(np.float32)
    runs = {}
    for where in (dev, torch.device("cpu")):
        runs[where.type] = relax_soft_sphere(
            torch.tensor(frac, device=where), torch.tensor(lattice, device=where),
            torch.tensor(mask, device=where), steps=50)
    got, want = runs["cuda"], runs["cpu"]
    d = (got.frac_x.cpu().double() - want.frac_x.double()).abs() % 1.0
    assert torch.minimum(d, 1.0 - d)[torch.tensor(mask)].max().item() <= 1e-4
    scale = want.energy_history.abs().max().item()
    assert scale > 0
    assert (got.energy_history.cpu() - want.energy_history).abs().max().item() <= 1e-4 * scale

    z_table = synthetic_z_table()
    types = rng.integers(0, len(z_table) - 1, size=int(counts.sum()))
    idx_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    reference, reports = reference_dataset("synthetic:100:0"), {}
    for where, run in runs.items():
        relaxed = run.frac_x.cpu().numpy().astype(np.float64)
        result = SampleResult(np.concatenate([relaxed[i][mask[i]] for i in range(B)]),
                              z_table.indices_to_zs(types), lattice.astype(np.float64), idx_start,
                              counts.astype(np.int64))
        reports[where] = quality_from_results(result, z_table, reference)
    assert reports["cuda"].keys() == reports["cpu"].keys()
    for key, value in reports["cpu"].items():
        tol = 1.0 / B if key.endswith(("_rate", "_frac")) else 1e-4 * max(abs(value), 1.0)
        assert abs(reports["cuda"][key] - value) <= tol, key


def _op_args(rng, dev, name, dtype, variant):
    """Arguments of the forward operator ``name`` at a ragged shape on ``dev``."""
    Bp, O, K, TA, D, C, d, H = 2, 3, 4, 40, 37, 70, 6, 33

    def t(*shape, scale=1.0, dt=dtype):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=dt, device=dev)

    f32 = torch.float32
    basis, w, x, src, win = _conv_args(rng, dev, Bp, O, K, TA, D, C)
    if name == "spatial_conv":
        return basis.to(dtype), w.to(dtype), x.to(dtype), src, win
    if name == "fiber_conv":
        return basis.to(dtype), w.to(dtype), x.to(dtype), src, t(O, O, C, scale=0.3), variant
    if name == "basis_h1":
        return t(Bp, O, d, K * TA), t(d + d * d + d ** 3, H, scale=0.1), t(H, scale=0.1), 3
    if name == "fused_basis_mlp":
        return t(Bp, O, K * TA, d), t(d + d * d, H, scale=0.1), t(H, D, scale=0.1), 2
    W = 4 * C
    readout = (t(C, 13, scale=0.1, dt=f32), t(13, scale=0.1, dt=f32)) if variant else (None, None)
    return (t(Bp, O, TA, C, dt=f32), t(Bp, O, TA, C), 1.0 + t(C, scale=0.1, dt=f32),
            t(C, scale=0.1, dt=f32), t(C, W, scale=0.1), t(W, scale=0.1), t(W, C, scale=0.1),
            t(C, scale=0.1), t(C, dt=f32), *readout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,variant", [
    ("spatial_conv", None), ("basis_h1", None), ("fiber_conv", True), ("fiber_conv", False),
    ("convnext_mlp", True), ("convnext_mlp", False), ("fused_basis_mlp", None)])
def test_operator_launches_its_wrapper_and_matches_plain(name, variant, dtype):
    """Each forward operator on the card: one launch of its wrapper's kernel,
    the wrapper's outputs bit for bit (the saved spatial conv of #1 and the
    readout of #9 too; an empty tensor where the wrapper gives none), the
    plain version's within the kernel tests' tolerances, and
    ``torch.library.opcheck``."""
    from arreau_tpu_torch.kernels import (
        basis_h1 as h1_mod,
        convnext_mlp as cn_mod,
        fiber_conv as fc_mod,
        fused_basis_mlp as fb_mod,
        spatial_conv as sc_mod,
    )

    dev = _device()
    mod = {"spatial_conv": sc_mod, "basis_h1": h1_mod, "fiber_conv": fc_mod,
           "convnext_mlp": cn_mod, "fused_basis_mlp": fb_mod}[name]
    wrapper, plain = getattr(mod, name), getattr(mod, name + "_plain")
    args = _op_args(np.random.default_rng(3), dev, name, dtype, variant)
    op = getattr(torch.ops.arreau_tpu_torch, name)
    before = wrapper.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = wrapper(*args)
    want = want if isinstance(want, tuple) else (want,)
    ref = plain(*args)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for i, a in enumerate(got):
        b = want[i] if i < len(want) else None
        if b is None:
            assert a.numel() == 0, i
            continue
        assert a.dtype == b.dtype and a.shape == b.shape and a.is_contiguous()
        assert torch.equal(a, b), i
        _assert_close(a, ref[i], BF16_REL_TOL if dtype == torch.bfloat16 else BWD_REL_TOL)
    result = torch.library.opcheck(op.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.cuda
@pytest.mark.parametrize("variable_num_atoms", [False, True])
def test_exported_sampler_matches_eager_on_the_card(tmp_path, variable_num_atoms):
    """A small model exported on the card (strided chain of 4 steps, the
    kernel branch): the program holds #3/#8 as operators, and ``call(seed)``
    repeats ``DiffusionModel.sample`` from the same seed bit for bit with 2
    launches of #3 and 1 of #8 a step and none in the export."""
    import dataclasses
    import json

    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.inference.export import export_sampler, load_exported
    from arreau_tpu_torch.interop.from_jax import params_to_jax, save_params_npz
    from arreau_tpu_torch.tasks.diffusion import DiffusionConfig, DiffusionModel

    dev = _device()
    zt = synthetic_z_table()
    cfg = DiffusionConfig(num_atomic_states=len(zt), num_timesteps=50, hidden_dim=16,
                          basis_dim=8, num_layers=2, num_ori=4)
    model = DiffusionModel(cfg, device=dev)
    model.model.init_parameters(prng.prng_key(0))
    (tmp_path / "best").mkdir()
    (tmp_path / "meta.json").write_text(json.dumps({
        "config": dataclasses.asdict(cfg), "z_table_zs": [int(z) for z in zt.zs],
        "length_stats": {"min": 3.0, "max": 8.0}}))
    save_params_npz(str(tmp_path / "best" / "params.npz"), params_to_jax(model.model))
    out = str(tmp_path / "sampler.pt2")
    launches = (spatial_conv.launches, basis_h1.launches)
    export_sampler(str(tmp_path), out, batch_size=6, num_atoms_per_sample=5, sample_steps=4,
                   variable_num_atoms=variable_num_atoms, device=dev)
    assert (spatial_conv.launches, basis_h1.launches) == launches
    call, sidecar = load_exported(out)
    assert sidecar["platforms"] == ["cuda"]
    counts = torch.tensor([5, 2, 3, 5, 1, 4], device=dev) if variable_num_atoms else None
    got = call(11, counts) if variable_num_atoms else call(11)
    torch.cuda.synchronize()
    S = sidecar["noise_steps"]
    assert (spatial_conv.launches - launches[0], basis_h1.launches - launches[1]) == (2 * S, S)
    want = model.sample(6, 5, key=prng.prng_key(11),
                        sample_steps=4, length_bounds=(0.5, 10.5), num_atoms=counts)
    for a, b in zip(got, (want.frac_x, want.atom_types, want.lattice)):
        assert a.device.type == "cuda" and torch.equal(a, b)


def _tiny_diffusion(dev, **config):
    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.tasks.diffusion import DiffusionConfig, DiffusionModel

    zt = synthetic_z_table()
    cfg = DiffusionConfig(num_atomic_states=len(zt), num_timesteps=50, hidden_dim=16,
                          basis_dim=8, num_layers=2, num_ori=4, **config)
    model = DiffusionModel(cfg, device=dev)
    model.model.init_parameters(prng.prng_key(0))
    return model, zt


@pytest.mark.cuda
def test_calibration_on_the_card_launches_the_forward_kernels_and_matches_the_cpu():
    """``calibrate_conv_kernels`` on the card: one launch of #3 a layer and
    one of #8 (the probe forward), stds and rescaled kernels as the CPU's
    plain branch on the same inputs and neighbour list."""
    import dataclasses

    from arreau_tpu_torch.data.synthetic import make_synthetic_batch
    from arreau_tpu_torch.models.calibrate import calibrate_conv_kernels
    from arreau_tpu_torch.ops.pbc import NeighborList
    from arreau_tpu_torch.tasks.diffusion import DiffusionModel, batch_to_device, draw_loss_noise

    dev = _device()
    model, zt = _tiny_diffusion(dev, layer_scale=1.0)
    cfg = model.config
    batch = batch_to_device(make_synthetic_batch(np.random.default_rng(0), zt, 12, 6), dev)
    noise = draw_loss_noise(prng.prng_key(0), 12, 6,
                            cfg.num_atomic_states, cfg.num_timesteps, False, dev)
    captured = []
    handle = model.model.register_forward_pre_hook(lambda m, a: captured.append(a[0]))
    with torch.no_grad():
        model.loss(batch, noise)
    handle.remove()
    plain = DiffusionModel(dataclasses.replace(cfg, use_pallas=False), device="cpu")
    plain.model.load_state_dict({k: v.cpu() for k, v in model.model.state_dict().items()})
    inputs = captured[0]
    cpu_inputs = inputs._replace(
        neighbors=NeighborList(*(a.cpu() for a in inputs.neighbors)),
        **{f: getattr(inputs, f).cpu() for f in ("scalar", "vec", "atom_mask", "lattice",
                                                  "ori_grid")})
    before = (spatial_conv.launches, basis_h1.launches)
    stds = calibrate_conv_kernels(model.model, inputs)
    assert (spatial_conv.launches - before[0], basis_h1.launches - before[1]) == (2, 1)
    want = calibrate_conv_kernels(plain.model, cpu_inputs)
    for name, std in want.items():
        assert abs(stds[name] - std) <= 1e-4 * std, name
    for (name, a), b in zip(model.model.named_parameters(), plain.model.parameters()):
        assert (a.detach().cpu() - b.detach()).abs().max() <= 1e-4 * b.abs().max(), name


@pytest.mark.cuda
def test_imported_reference_checkpoint_serves_on_the_card(tmp_path):
    """A Lightning-shaped checkpoint of a seeded model (``chip_smoke``'s
    writer), imported, then generate on the card: 2 launches of #3 and 1 of
    #8 a forward, and the crystals of the source weights from the same seed,
    bit for bit."""
    import json

    import chip_smoke
    from arreau_tpu_torch.cli import generate
    from arreau_tpu_torch.interop.from_jax import params_to_jax, save_params_npz
    from arreau_tpu_torch.interop.torch_import import convert_reference_checkpoint

    dev = _device()
    model, zt = _tiny_diffusion(dev)
    chip_smoke.write_reference_ckpt(tmp_path / "ref.ckpt", model, zt)
    meta = convert_reference_checkpoint(str(tmp_path / "ref.ckpt"), str(tmp_path / "imported"))
    (tmp_path / "source" / "best").mkdir(parents=True)
    (tmp_path / "source" / "meta.json").write_text(json.dumps(meta))
    save_params_npz(str(tmp_path / "source" / "best" / "params.npz"), params_to_jax(model.model))
    results = []
    for name in ("imported", "source"):
        before = (spatial_conv.launches, basis_h1.launches)
        results.append(generate.main([
            "--checkpoint_dir", str(tmp_path / name), "--tag", "best", "--num_crystals", "6",
            "--batch_size", "6", "--num_atoms_per_sample", "5", "--sample_steps", "4",
            "--out_dir", str(tmp_path / f"out_{name}")]))
        assert (spatial_conv.launches - before[0], basis_h1.launches - before[1]) == (8, 4)
    for field in ("frac_x", "atomic_numbers", "lattice"):
        assert np.array_equal(getattr(results[0], field), getattr(results[1], field))


@pytest.mark.cuda
def test_eval_equivariance_and_diagnosis_launch_their_kernels(tmp_path):
    """``train_diffusion --dataset eval-equivariance`` on the card: 2 #3, 2 #4,
    1 #8 and 1 #7 a training step; then ``diagnose`` over 3 steps of its
    checkpoint: 2 #3 and 1 #8 a step, finite records."""
    from arreau_tpu_torch.cli import generate, train_diffusion
    from arreau_tpu_torch.exploration import diagnose_sampler
    from arreau_tpu_torch.tasks.diffusion import draw_sampler_noise

    dev = _device()
    kernels = (spatial_conv, spatial_conv_bwd, basis_h1, basis_mlp_bwd)
    per_step = []
    step = train_diffusion.train_step

    def counted(*a, **kw):
        before = [k.launches for k in kernels]
        out = step(*a, **kw)
        per_step.append(tuple(k.launches - b for k, b in zip(kernels, before)))
        return out

    train_diffusion.train_step = counted
    try:
        train_diffusion.main([
            "--dataset", "eval-equivariance", "--data_dir", str(tmp_path), "--epochs", "3",
            "--val_interval", "1", "--num_timesteps", "300", "--batch_size", "4",
            "--hidden_dim", "16", "--basis_dim", "8", "--layers", "2", "--num_ori", "8",
            "--checkpoint_dir", str(tmp_path / "ckpt")])
    finally:
        train_diffusion.train_step = step
    assert per_step == [(2, 2, 1, 1)] * 3
    model = generate.load_model(str(tmp_path / "ckpt"), "best", False, dev)[0]
    cfg = model.config
    noise = draw_sampler_noise(prng.prng_key(0), 3, 4, 8,
                               cfg.num_atomic_states, "monoclinic", cfg.diffuse_angles, dev)
    before = (spatial_conv.launches, basis_h1.launches)
    records, state = diagnose_sampler.diagnose(model, noise, 5.5, 2.0, record_every=1,
                                               num_steps=3)
    assert (spatial_conv.launches - before[0], basis_h1.launches - before[1]) == (6, 3)
    assert [r["t"] for r in records] == [298, 297, 296]
    assert all(np.isfinite(v) for r in records for v in r.values())
    assert torch.isfinite(state["lengths"]).all()


@pytest.mark.cuda
def test_edge_readouts_take_the_plain_branch_on_the_card():
    """With edge readouts the automatic branch choice on the card is the
    plain branch (the per-edge messages exist only there): no kernel
    launch, and every head, the global-vector and edge readouts included,
    as the CPU's on the same inputs (1e-4 of scale, float32 sums in other
    orders through two layers)."""
    from arreau_tpu_torch.models.ponita import FiberBundleInputs, PonitaConfig, PonitaFiberBundle
    from arreau_tpu_torch.ops.grids import cached_grid_s2
    from arreau_tpu_torch.ops.pbc import NeighborList
    from arreau_tpu_torch.ops.radius import radius_neighbor_list

    dev = _device()
    g = torch.Generator().manual_seed(0)
    pos = torch.randn(2, 6, 3, generator=g) * 1.5
    mask = torch.ones(2, 6, dtype=torch.bool)
    mask[1, 4:] = False
    inputs = FiberBundleInputs(
        scalar=torch.randn(2, 6, 3, generator=g), vec=torch.randn(2, 6, 1, 3, generator=g),
        neighbors=radius_neighbor_list(pos, mask, 3.0, 4), atom_mask=mask,
        lattice=torch.randn(2, 3, 3, generator=g) * 4.0,
        ori_grid=torch.tensor(cached_grid_s2(4), dtype=torch.float32))
    cfg = PonitaConfig(input_dim_scalar=3, input_dim_vec=1, hidden_dim=16, basis_dim=8, degree=2,
                       num_layers=2, num_ori=4, output_dim_scalar=2, output_dim_global_vec=2,
                       output_dim_edge_scalar=3)
    cpu = PonitaFiberBundle(cfg)
    cpu.init_parameters(prng.prng_key(0))
    card = PonitaFiberBundle(cfg).to(dev)
    card.load_state_dict(cpu.state_dict())
    card_inputs = inputs._replace(
        neighbors=NeighborList(*(a.to(dev) for a in inputs.neighbors)),
        **{f: getattr(inputs, f).to(dev) for f in ("scalar", "vec", "atom_mask", "lattice",
                                                    "ori_grid")})
    before = (spatial_conv.launches, basis_h1.launches)
    with torch.no_grad():
        got, want = card(card_inputs), cpu(inputs)
    assert (spatial_conv.launches, basis_h1.launches) == before
    assert len(got.edge_scalar) == len(want.edge_scalar) == 2
    heads = [*zip(got[:4], want[:4]), *zip(got.edge_scalar, want.edge_scalar)]
    assert sum(b.numel() > 0 for _, b in heads) == 4  # node_vec and global_scalar: 0 columns
    assert all(torch.isfinite(b).all() for _, b in heads)
    for a, b in heads:
        if b.numel():
            _assert_close(a.cpu(), b, rel=BWD_REL_TOL)


# ---------------- the threefry kernel (JAX's random draws) ----------------


@pytest.mark.cuda
@pytest.mark.parametrize("mode,dtype", [("bits", torch.float32), ("uniform", torch.float32),
                                        ("uniform", torch.bfloat16), ("normal", torch.float32),
                                        ("normal", torch.bfloat16)])
@pytest.mark.parametrize("K,shape", [(1, ()), (3, (5, 7)), (37, (128, 8, 9)), (2, (1, 70001))])
def test_threefry_kernel_matches_plain_and_prng(K, shape, mode, dtype):
    """The threefry kernel for K keys against its plain version on the card
    and ``prng.py``'s numpy: bits and uniforms (on [0, 1) and on [60, 120))
    bit for bit, normals within 3 ulp; one launch a call; a second call
    equal."""
    from arreau_tpu_torch.kernels.threefry import keys_tensor, threefry, threefry_plain
    from arreau_tpu_torch.ops import prng

    dev = _device()
    keys = prng.split(prng.prng_key(K), K)
    kt = keys_tensor(keys, dev)
    bounds = [(0.0, 1.0), (60.0, 120.0)] if mode == "uniform" else [(0.0, 1.0)]
    np_dt = {torch.float32: np.float32, torch.bfloat16: prng.BF16}[dtype]
    for lo, hi in bounds:
        before = threefry.launches
        got = threefry(kt, shape, mode, dtype, lo, hi)
        torch.cuda.synchronize()
        assert threefry.launches == before + 1 and got.device.type == "cuda"
        assert got.shape == (K, *shape)
        assert torch.equal(got, threefry(kt, shape, mode, dtype, lo, hi))
        plain = threefry_plain(kt, shape, mode, dtype, lo, hi)
        for k, row, prow in zip(keys, got.cpu(), plain.cpu()):
            if mode == "bits":
                want = torch.from_numpy(prng.random_bits(k, 32, shape).astype(np.int64))
            elif mode == "uniform":
                want = torch.from_numpy(np.asarray(prng.uniform(k, shape, np_dt, lo, hi)))
            else:
                want = torch.from_numpy(np.asarray(prng.normal(k, shape, np_dt)))
            if mode == "normal":
                a, b = row.float().view(torch.int32).long(), want.view(torch.int32).long()
                assert int((a - b).abs().max()) <= 3
                assert torch.equal(row, prow)
            else:
                assert torch.equal(row.to(want.dtype), want) and torch.equal(row, prow)


@pytest.mark.cuda
def test_threefry_draws_on_the_card_are_the_cpu_draws():
    """A sampler's noise and a loss's noise drawn on the card equal the
    plain version's on the CPU from the same key (normals within 3 ulp)."""
    from arreau_tpu_torch.ops import prng
    from arreau_tpu_torch.tasks.diffusion import draw_loss_noise, draw_sampler_noise

    dev = _device()
    for fn, args in ((draw_sampler_noise, (4, 6, 5, 9, "monoclinic", True)),
                     (draw_loss_noise, (6, 5, 9, 50, True))):
        card, cpu = fn(prng.prng_key(3), *args, dev), fn(prng.prng_key(3), *args, "cpu")
        for name, a in vars(card).items():
            b = getattr(cpu, name)
            if a is None:
                assert b is None
                continue
            if a.is_floating_point():
                gap = (a.cpu().view(torch.int32).long() - b.view(torch.int32).long()).abs().max()
                assert int(gap) <= 3, name
            else:
                assert torch.equal(a.cpu(), b), name
