"""Gradients through atom positions in the PyTorch port against the JAX
package on the CPU: the window cotangent of the spatial conv's backward
(#4's ``want_dwin`` branch) from ``spatial_conv_bwd_plain`` against
``jax.vjp`` of ``fused_spatial_conv`` (Pallas interpret mode) in float32
and bfloat16, at one and two crystals per super-crystal; and the gradient
of the Ponita backbone's outputs with respect to positions with
``position_grads=True``, on the port's kernel branch (the kernels' autograd
Functions, their plain versions on the CPU; with and without
``fuse_fiber``) and plain branch, against ``jax.grad`` through the JAX
backbone's Pallas branch with ``position_grads=True``, same parameters and
one neighbour list (senders taken once, lengths and directions recomputed
from the positions in each package)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.models.ponita import FiberBundleInputs as JInputs
from arreau_tpu.models.ponita import PonitaConfig as JPonitaConfig
from arreau_tpu.models.ponita import PonitaFiberBundle as JPonitaFiberBundle
from arreau_tpu.ops.grids import cached_grid_s2 as j_cached_grid_s2
from arreau_tpu.ops.pallas_conv import fused_spatial_conv as j_fused_spatial_conv
from arreau_tpu.ops.pallas_conv import make_gather_matrix
from arreau_tpu.ops.pbc import NeighborList as JNeighborList
from arreau_tpu.ops.radius import radius_neighbor_list as j_radius_neighbor_list
from arreau_tpu_torch.interop.from_jax import params_from_jax
from arreau_tpu_torch.kernels import basis_h1, basis_mlp, spatial_conv
from arreau_tpu_torch.kernels.spatial_conv import (
    fused_spatial_conv,
    spatial_conv_bwd_plain,
    spatial_conv_plain,
)
from arreau_tpu_torch.models.ponita import (
    FiberBundleInputs,
    PonitaConfig,
    PonitaFiberBundle,
    tile_senders,
)
from arreau_tpu_torch.ops.pbc import NeighborList
from tests.test_torch_model import perturbed_params

BF16 = jnp.bfloat16
# the window cotangent against JAX's: float32 sums in another order (float32
# and bfloat16 alike: nothing is rounded before the sum in either package),
# each output within 1e-5 of its scale
DWIN_REL_TOL = 1e-5
# the other three cotangents: as tests/test_torch_bf16.py holds them
KERNEL_REL_TOL = 1e-5
# float32 position gradients through the graph, two conv layers and the
# readouts, in other summation orders: within 1e-4 of the largest entry
POS_GRAD_REL_TOL = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---------------- #4's window cotangent ----------------


@pytest.mark.parametrize("tile", [1, 2])
@pytest.mark.parametrize("bf16", [False, True])
def test_window_cotangent_matches_jax_pallas_kernel(tile, bf16):
    """dwin (and dbasis, dW, dx) of the plain backward with ``window_grad``
    against the VJP of ``fused_spatial_conv(..., window_grad=True)`` with
    respect to the window, Pallas interpret mode; in bfloat16 the operands,
    the forward's output and its cotangent are bfloat16, the window and
    dwin float32."""
    rng = np.random.default_rng(3 + tile + 2 * bf16)
    B, A, K, O, D, C = 4, 8, 4, 4, 16, 32
    Bp, TA = B // tile, tile * A
    E = K * TA
    jdt, tdt = (BF16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    src = rng.integers(0, A, size=(B, A, K))
    mask = rng.random((B, A, K)) > 0.3
    host = dict(basis=rng.normal(size=(Bp, O, E, D)), w=rng.normal(size=(D, C)) * 0.2,
                x=rng.normal(size=(Bp, O, TA, C)), g=rng.normal(size=(Bp, O, TA, C)))
    win = rng.uniform(0.0, 1.0, size=(Bp, E)).astype(np.float32)
    win[:, :3] = 0.0  # edges at the cutoff: the window is 0, its cotangent is not
    sel = make_gather_matrix(jnp.asarray(src), jnp.asarray(mask), dtype=jdt,
                             crystals_per_tile=tile)

    def fwd(basis, w, x, win_k):
        return j_fused_spatial_conv(basis, w, x, sel, win_k, window_grad=True, out_dtype=jdt)

    jargs = [jnp.asarray(host[k], jdt) for k in ("basis", "w", "x")]
    _, vjp = jax.vjp(fwd, *jargs, jnp.asarray(win)[..., None])
    want = vjp(jnp.asarray(host["g"], jdt))

    t_src = tile_senders(torch.as_tensor(src), torch.as_tensor(mask), tile)
    targs = [torch.tensor(host[k], dtype=torch.float32).to(tdt) for k in ("basis", "w", "x")]
    got = spatial_conv_bwd_plain(*targs, t_src, torch.tensor(win),
                                 torch.tensor(host["g"], dtype=torch.float32).to(tdt), True)
    assert len(got) == 4 and got[3].dtype == torch.float32 and got[3].shape == (Bp, E)
    for name, a, b, tol in zip(("dbasis", "dw", "dx", "dwin"), got, want,
                               (KERNEL_REL_TOL,) * 3 + (DWIN_REL_TOL,)):
        b = np.asarray(b.astype(jnp.float32))
        assert a.dtype == (torch.float32 if name == "dwin" else tdt), name
        assert _rel(a.float().numpy(), b.reshape(a.shape)) <= tol, name
    live = (t_src >= 0).numpy()
    assert np.all(got[3].numpy()[~live] == 0) and np.abs(got[3].numpy()[:, :3]).max() > 0


def test_window_cotangent_is_autograd_of_the_plain_forward():
    """float64: dwin is the gradient of the plain forward with respect to
    the window (1e-12); and the Function (float32, the types the wrappers
    take) returns it only when asked."""
    rng = np.random.default_rng(12)
    Bp, O, K, TA, D, C = 2, 3, 4, 10, 7, 5
    E = K * TA
    src = torch.tensor(rng.integers(-1, TA + 2, size=(Bp, E)), dtype=torch.int32)
    basis, w, x = (torch.tensor(rng.normal(size=s)) for s in ((Bp, O, E, D), (D, C), (Bp, O, TA, C)))
    win = torch.tensor(rng.random((Bp, E)), requires_grad=True)
    g = torch.tensor(rng.normal(size=(Bp, O, TA, C)))
    (want,) = torch.autograd.grad(spatial_conv_plain(basis, w, x, src, win), win, g)
    got = spatial_conv_bwd_plain(basis, w, x, src, win.detach(), g, True)[3]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    basis, w, x, g = basis.float(), w.float(), x.float(), g.float()
    win = win.detach().float().requires_grad_()
    out = (fused_spatial_conv(basis, w, x, src, win, window_grad=True) * g).sum()
    (dwin,) = torch.autograd.grad(out, win)
    np.testing.assert_allclose(dwin.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    out = (fused_spatial_conv(basis, w, x, src, win) * g).sum()
    assert torch.autograd.grad(out, win, allow_unused=True) == (None,)


# ---------------- the backbone's position gradients ----------------

B, A, K = 34, 4, 3  # 136 atoms: two super-crystals of 17 crystals (TA = 68)
CFG = dict(hidden_dim=16, basis_dim=8, degree=2, num_layers=2, num_ori=4, radius=2.5,
           output_dim_scalar=2, output_dim_vec=1, output_dim_global_scalar=1)


def _host(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, A), bool)
    mask[-1, -1] = False  # a padded atom
    return dict(pos=(rng.normal(size=(B, A, 3)) * 1.2).astype(np.float32), mask=mask,
                scalar=rng.normal(size=(B, A, 3)).astype(np.float32),
                vec=rng.normal(size=(B, A, 1, 3)).astype(np.float32),
                lattice=(rng.normal(size=(B, 3, 3)) + 3 * np.eye(3)).astype(np.float32),
                weights=[rng.normal(size=s).astype(np.float32)
                         for s in ((B, A, 2), (B, A, 1, 3), (B, 1))])


def _edges(pos, src, mask, xp):
    """(dist, direction) of the fixed senders ``src`` from ``pos`` (numpy-like
    module ``xp``: jnp or torch); zero and with a finite gradient on empty
    slots."""
    if xp is torch:
        idx = src.reshape(B, A * K, 1).expand(B, A * K, 3)
        d = torch.gather(pos, 1, idx).reshape(B, A, K, 3) - pos[:, :, None, :]
        direction = torch.where(mask[..., None], d, 0.0)
        sq = torch.where(mask, torch.sum(direction**2, dim=-1), 1.0)
        return torch.where(mask, torch.sqrt(sq), 0.0), direction
    d = jnp.take_along_axis(pos, src.reshape(B, A * K)[..., None], axis=1).reshape(B, A, K, 3)
    direction = jnp.where(mask[..., None], d - pos[:, :, None, :], 0.0)
    sq = jnp.where(mask, jnp.sum(direction**2, axis=-1), 1.0)
    return jnp.where(mask, jnp.sqrt(sq), 0.0), direction


def _jax_position_grad(host, fuse_fiber, seed):
    """(parameters, d(weighted outputs)/d(positions)) of the JAX backbone on
    its Pallas branch with ``position_grads``; and the shared senders."""
    nl = j_radius_neighbor_list(jnp.asarray(host["pos"]), jnp.asarray(host["mask"]), 1000.0, K,
                                loop=False)
    grid = jnp.asarray(j_cached_grid_s2(CFG["num_ori"]), jnp.float32)
    model = JPonitaFiberBundle(JPonitaConfig(**CFG, use_pallas=True, position_grads=True,
                                             fuse_fiber=fuse_fiber, remat=False))

    def inputs(pos):
        dist, direction = _edges(pos, nl.src, nl.mask, jnp)
        return JInputs(scalar=jnp.asarray(host["scalar"]), vec=jnp.asarray(host["vec"]),
                       neighbors=JNeighborList(nl.src, nl.image, dist, direction, nl.mask),
                       atom_mask=jnp.asarray(host["mask"]),
                       lattice=jnp.asarray(host["lattice"]), ori_grid=grid)

    pos = jnp.asarray(host["pos"])
    params = perturbed_params(jax.jit(model.init)(jax.random.PRNGKey(seed), inputs(pos)), seed)

    def scalar(pos):
        out = model.apply(params, inputs(pos))
        return sum(jnp.sum(o * c) for o, c in zip(
            (out.node_scalar, out.node_vec, out.global_scalar), host["weights"]))

    return params, np.asarray(jax.jit(jax.grad(scalar))(pos)), nl


def _port_position_grad(host, params, nl, remat=False, **cfg):
    model = PonitaFiberBundle(PonitaConfig(input_dim_scalar=3, input_dim_vec=1, **CFG,
                                           position_grads=True, remat=remat, **cfg))
    params_from_jax(model, params)
    src, image, mask = (torch.tensor(np.asarray(a)) for a in (nl.src, nl.image, nl.mask))
    pos = torch.tensor(host["pos"], requires_grad=True)
    dist, direction = _edges(pos, src, mask, torch)
    out = model(FiberBundleInputs(
        scalar=torch.tensor(host["scalar"]), vec=torch.tensor(host["vec"]),
        neighbors=NeighborList(src, image, dist, direction, mask),
        atom_mask=torch.tensor(host["mask"]), lattice=torch.tensor(host["lattice"]),
        ori_grid=torch.tensor(j_cached_grid_s2(CFG["num_ori"]), dtype=torch.float32)))
    s = sum(torch.sum(o * torch.tensor(c)) for o, c in zip(out, host["weights"]))
    (grad,) = torch.autograd.grad(s, pos)
    return grad.numpy()


class _Counted:
    """Stands in for a kernel wrapper in its module and counts its calls (and
    those with ``window_grad``), passing each on."""

    def __init__(self, fn):
        self.fn, self.calls, self.window_grad = fn, 0, 0

    def __call__(self, *args):
        self.calls += 1
        self.window_grad += len(args) == 7 and args[6] is True
        return self.fn(*args)


@pytest.mark.parametrize("use_kernels,fuse_fiber", [(True, False), (False, False),
                                                    (True, True)])
def test_backbone_position_gradients_match_jax_pallas_branch(use_kernels, fuse_fiber,
                                                             monkeypatch):
    """d(outputs . weights)/d(positions) of ``PonitaFiberBundle(position_grads
    =True)`` against ``jax.grad`` through the JAX backbone's Pallas branch
    with ``position_grads=True`` (the window cotangent of fused_spatial_conv,
    or fused_fiber_conv's dbasis, in interpret mode), 34 crystals of up to 4
    atoms, windowed at radius 2.5; on the kernel branch the forward and
    backward call #3 and #4 (with the window cotangent) once a layer and
    neither #8 nor #7 (the plain basis MLP)."""
    host = _host(1)
    params, want, nl = _jax_position_grad(host, fuse_fiber, seed=2)
    counted = {}
    for mod, name in ((spatial_conv, "spatial_conv"), (spatial_conv, "spatial_conv_bwd"),
                      (basis_h1, "basis_h1"), (basis_mlp, "basis_mlp_bwd")):
        counted[name] = _Counted(getattr(mod, name))
        monkeypatch.setattr(mod, name, counted[name])
    got = _port_position_grad(host, params, nl, use_kernels=use_kernels, fuse_fiber=fuse_fiber)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert _rel(got, want) <= POS_GRAD_REL_TOL
    calls = {name: c.calls for name, c in counted.items()}
    layers = CFG["num_layers"] if use_kernels and not fuse_fiber else 0
    assert calls == {"spatial_conv": layers, "spatial_conv_bwd": layers, "basis_h1": 0,
                     "basis_mlp_bwd": 0}
    assert counted["spatial_conv_bwd"].window_grad == layers
