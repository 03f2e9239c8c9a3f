"""PonitaFiberBundle: the SE(3)-equivariant backbone on an R^3 x S^2 grid
(or SE(2) on R^2 x S^1, given a 2-D grid); counterpart of
``arreau_tpu/models/ponita.py``.

Scalar and vector features are lifted onto the orientation grid, per-edge
invariants feed the polynomial-basis kernel MLPs, ``num_layers`` ConvNext
blocks around the fiber-bundle conv exchange messages, and the per-layer
readouts are averaged and split into node-scalar, node-vector,
global-vector and global-scalar heads. The invariants are the two spatial
ones per edge and orientation, then ``num_edge_scalar_features`` more: 4
appends the diffusion task's ``lattice_edge_scalars``, 0 none (the N-body
and MNIST tasks, d = 2). ``radius=None`` windows nothing.
``output_dim_edge_scalar`` adds per-edge readouts (``edge_readouts.{i}`` on
each reading layer's messages and the lifted edge scalars, averaged over
the orientations; one output a reading layer, as the JAX package's). They
need the per-edge messages, which only the plain conv forms: the automatic
branch choice then takes the plain branch, and an explicit
``use_kernels=True`` raises (the JAX package turns its Pallas path off).

On CUDA the backbone takes the kernel branch (the JAX package's
``use_pallas`` branch): super-crystals of ``pick_tile(B, A, 128)``
crystals. With ``fuse_fiber=False`` the basis MLP and spatial conv are
``torch.autograd.Function``s over the CUDA kernels (forwards ``basis_h1``
and ``spatial_conv``, backwards ``basis_mlp_bwd`` and ``spatial_conv_bwd``).
With ``fuse_fiber=True`` the basis MLP is the plain chain on ``[B', O, E,
d]`` invariants, windowed outside the kernel and shared by every layer, and
each layer's conv is the ``fiber_conv`` / ``fiber_conv_bwd`` Function. On
the CPU the backbone takes the plain branch. ``use_kernels`` forces either; the
kernel branch on CPU tensors runs the kernels' plain versions.

``position_grads`` is for a caller that differentiates through positions
(forces, relaxation), as the JAX package's: on the kernel branch the basis
MLP is then the plain chain on ``[B', O, E, d]`` invariants, one basis for
every layer (``basis_mlp_bwd``, #7, gives the invariants no cotangent), and
the spatial conv's backward also returns the window's cotangent
(``spatial_conv_bwd`` with ``window_grad``); with ``fuse_fiber`` nothing
changes (the window is folded into the basis, whose gradient autograd and
``fiber_conv_bwd`` carry). The plain branch differentiates through
positions either way.

``compute_dtype="bfloat16"`` runs the backbone in bfloat16 at the JAX
package's cast points: the lift, the invariants, the LayerNorm statistics
and the readout stay float32; the invariants are cast before the
lane-major transpose on the kernel branch and before the polynomial
expansion on the plain branch; the embedder, the basis MLPs, the spatial
conv and the ConvNext MLPs run in bfloat16, and the residual stream between
layers is bfloat16; with ``fuse_fiber`` the shared basis is bfloat16 and
each layer's ``fiber_conv`` takes the basis, the conv weight, x and the
fiber kernel in bfloat16 and returns float32. ``"float32"`` is the float32
function, and lets ``fuse_convnext`` run in float32. With ``fuse_convnext``
and a compute type, the kernel branch runs each layer's ConvNext MLP tail
and its readout in the ``fused_convnext_mlp`` kernels (#9/#10); the
parameters are the same.

``readout_bf16_operands`` computes the readout, the network's one float32
product under ``compute_dtype="bfloat16"``, as a TPU computes the JAX
package's ``jnp.dot(xcat, wcat)`` at DEFAULT precision: both operands
rounded to bfloat16, the sums in float32. On a CPU JAX computes it in
float32, the port's default. A checkpoint trained on a TPU learned its
readout weights under that rounding and is served with it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch import nn

from arreau_tpu_torch.models.blocks import (
    BasisMLP,
    ConvNextBlock,
    dense,
    scalar_to_sphere,
    sphere_to_scalar,
    sphere_to_vec,
    vec_to_sphere,
)
from arreau_tpu_torch.ops.pbc import NeighborList
from arreau_tpu_torch.ops.windowing import polynomial_cutoff

_EPS = 1e-8
# jax.nn.initializers' truncated-normal std correction for the [-2, 2] cut
_TRUNC_STD = 0.87962566103423978
COMPUTE_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class PonitaConfig:
    input_dim_scalar: int
    input_dim_vec: int
    hidden_dim: int = 200
    basis_dim: int = 256
    degree: int = 3
    num_layers: int = 5
    widening_factor: int = 4
    layer_scale: Optional[float] = 1e-6
    multiple_readouts: bool = True
    radius: Optional[float] = 5.0  # None: no window
    num_ori: int = 16
    output_dim_scalar: int = 0
    output_dim_vec: int = 0
    output_dim_global_scalar: int = 0
    output_dim_global_vec: int = 0
    output_dim_edge_scalar: int = 0
    # per-edge scalar invariants after the two spatial ones: 4 = the diffusion
    # task's [dist, 3 lattice cosines], 0 = none
    num_edge_scalar_features: int = 4
    expected_degree: float = 8.0
    # None = kernel branch on CUDA, plain branch on CPU; True/False = force
    use_kernels: Optional[bool] = None
    # kernel branch: the spatial conv and the fiber mixing in one call (#1)
    fuse_fiber: bool = False
    # True = biases on both basis Dense layers, "in" = dense_in only, False = none
    basis_bias: "bool | str" = True
    # something differentiates through positions (window and attribute
    # cotangents): the kernel branch takes the plain basis MLP and the
    # spatial conv's window cotangent
    position_grads: bool = False
    # None = float32; "bfloat16" runs the Dense layers, convs and the residual
    # stream in bfloat16 (parameters, LayerNorm statistics and readouts stay
    # float32); "float32" is the float32 function as a compute type
    compute_dtype: Optional[str] = None
    # kernel branch with a compute type: the ConvNext MLP tail and the
    # layer's readout in one kernel pair (fused_convnext_mlp)
    fuse_convnext: bool = False
    # the readout product from bfloat16 operands with float32 sums, as a TPU
    # computes the JAX package's float32 readout at DEFAULT precision
    readout_bf16_operands: bool = False

    @property
    def output_dim(self) -> int:
        return (self.output_dim_scalar + self.output_dim_vec + self.output_dim_global_vec
                + self.output_dim_global_scalar)


class FiberBundleInputs(NamedTuple):
    scalar: torch.Tensor  # [B, A, F_s]
    vec: torch.Tensor  # [B, A, V, D], V may be 0
    neighbors: NeighborList
    atom_mask: torch.Tensor  # [B, A]
    lattice: torch.Tensor  # [B, 3, 3]; read only with num_edge_scalar_features > 0
    ori_grid: torch.Tensor  # [O, D], D = 3 (S^2) or 2 (S^1)


class PonitaOutputs(NamedTuple):
    node_scalar: torch.Tensor  # [B, A, out_s]
    node_vec: torch.Tensor  # [B, A, out_v, D]
    global_scalar: torch.Tensor  # [B, out_gs]
    global_vec: Optional[torch.Tensor] = None  # [B, out_gv, D] where out_gv > 0
    edge_scalar: tuple = ()  # per reading layer [B, A, K, out_es] where out_es > 0


def pick_tile(batch: int, atoms: int, target: int = 256) -> int:
    """Largest divisor T of ``batch`` with T * atoms <= target (min 1)."""
    best = 1
    for t in range(1, batch + 1):
        if batch % t == 0 and t * atoms <= target:
            best = t
    return best


def tile_senders(src: torch.Tensor, mask: torch.Tensor, tile: int) -> torch.Tensor:
    """``src``/``mask [B, A, K]`` -> tile-local senders ``[B', E]`` int32 in
    k-major rows ``e = k*TA + t*A + a``, -1 on empty slots: the index form of
    the JAX package's one-hot gather matrix (``make_gather_matrix``)."""
    B, A, K = src.shape
    offset = (torch.arange(tile, device=src.device) * A)[None, :, None, None]
    local = src.reshape(B // tile, tile, A, K) + offset
    local = torch.where(mask.reshape(B // tile, tile, A, K), local, -1)
    return local.permute(0, 3, 1, 2).reshape(B // tile, K * tile * A).to(torch.int32).contiguous()


def fiber_bundle_invariants(neighbors: NeighborList, ori_grid: torch.Tensor):
    """(spatial ``[B, A, K, O, 2]``, fiber ``[O, O, 1]``, dists ``[B, A,
    K]``): the parallel and orthogonal components of each edge direction
    against each grid orientation, and the grid's pairwise inner products.
    On a 2-D grid (S^1) the orthogonal component keeps its sign,
    ``-dir_x ori_y + dir_y ori_x`` (SO(2) sees chirality); on S^2 it is the
    norm of the rejection, with an eps under the root for a finite gradient
    on empty (zero-direction) slots."""
    direction = neighbors.direction
    inv1 = torch.einsum("bakd,od->bako", direction, ori_grid)[..., None]
    if ori_grid.shape[-1] == 2:
        inv2 = (-direction[..., None, 0] * ori_grid[:, 1]
                + direction[..., None, 1] * ori_grid[:, 0])[..., None]
    else:
        rej = direction[..., None, :] - inv1 * ori_grid
        inv2 = torch.sqrt(torch.sum(rej**2, dim=-1, keepdim=True) + _EPS**2)
    spatial = torch.cat([inv1, inv2], dim=-1)
    fiber = torch.einsum("od,pd->op", ori_grid, ori_grid)[..., None]
    return spatial, fiber, neighbors.dist


def lattice_edge_scalars(neighbors: NeighborList, lattice: torch.Tensor) -> torch.Tensor:
    """``[B, A, K, 4]``: edge length and the cosines between the edge and
    each lattice row (zeros on empty slots)."""
    direction = neighbors.direction
    dir_norm = torch.linalg.norm(direction, dim=-1, keepdim=True)
    lat_norm = torch.linalg.norm(lattice, dim=-1)
    dots = torch.einsum("bakd,brd->bakr", direction, lattice)
    denom = torch.clamp(dir_norm * lat_norm[:, None, None, :], min=_EPS)
    return torch.cat([neighbors.dist[..., None], dots / denom], dim=-1)


class PonitaFiberBundle(nn.Module):
    def __init__(self, config: PonitaConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.readout_bf16_operands and cfg.fuse_convnext:
            raise NotImplementedError("readout_bf16_operands with fuse_convnext: the fused "
                                      "kernels compute their readout from float32 weights")
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(COMPUTE_DTYPES)}, "
                             f"got {cfg.compute_dtype!r}")
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        bb_in = cfg.basis_bias is True or cfg.basis_bias == "in"
        bb_out = cfg.basis_bias is True
        # invariants per edge and orientation: 2 spatial + the edge scalars
        self.basis_fn = BasisMLP(2 + cfg.num_edge_scalar_features, cfg.hidden_dim,
                                 cfg.basis_dim, cfg.degree, use_bias=bb_in, out_bias=bb_out)
        self.fiber_basis_fn = BasisMLP(1, cfg.hidden_dim, cfg.basis_dim, cfg.degree,
                                       use_bias=bb_in, out_bias=bb_out)
        self.x_embedder = nn.Linear(cfg.input_dim_scalar + cfg.input_dim_vec, cfg.hidden_dim,
                                    bias=False)
        self.layers = nn.ModuleList(
            ConvNextBlock(cfg.basis_dim, cfg.hidden_dim, cfg.widening_factor, cfg.layer_scale,
                          cfg.fuse_fiber, cfg.fuse_convnext)
            for _ in range(cfg.num_layers)
        )
        # keyed by layer index: without multiple_readouts only the last layer reads out
        self.readouts = nn.ModuleDict(
            {
                str(i): nn.Linear(cfg.hidden_dim, cfg.output_dim)
                for i in range(cfg.num_layers)
                if cfg.multiple_readouts or i == cfg.num_layers - 1
            }
        )
        if cfg.output_dim_edge_scalar:
            self.edge_readouts = nn.ModuleDict(
                {i: nn.Linear(cfg.hidden_dim + cfg.num_edge_scalar_features,
                              cfg.output_dim_edge_scalar) for i in self.readouts})

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the JAX package's distributions:
        lecun-normal Dense kernels, the conv kernel scaled by
        ``1/sqrt(expected_degree)``, zero biases, constant layer scale."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("conv.kernel"):
                fan_in, scale = p.shape[0], 1.0 / math.sqrt(self.config.expected_degree)
            elif leaf == "weight" and p.dim() == 2:
                fan_in, scale = p.shape[1], 1.0
            elif leaf == "weight":  # LayerNorm scale
                p.fill_(1.0)
                continue
            elif leaf == "layer_scale":
                p.fill_(self.config.layer_scale)
                continue
            else:  # biases
                p.zero_()
                continue
            std = math.sqrt(scale / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)

    def forward(self, inputs: FiberBundleInputs) -> PonitaOutputs:
        cfg = self.config
        cdt = self.dtype
        nb = inputs.neighbors
        ori_grid = inputs.ori_grid
        num_ori = ori_grid.shape[0]
        need_messages = cfg.output_dim_edge_scalar > 0
        use_kernels = cfg.use_kernels
        if use_kernels is None:
            use_kernels = inputs.scalar.device.type == "cuda" and not need_messages
        elif use_kernels and need_messages:
            raise ValueError("use_kernels=True with output_dim_edge_scalar: the edge readouts "
                             "need the per-edge messages, which only the plain branch forms")

        # ---- lift features to the sphere ----
        lifted = [scalar_to_sphere(inputs.scalar, num_ori)]
        if inputs.vec is not None and inputs.vec.shape[-2] > 0:
            lifted.append(vec_to_sphere(inputs.vec, ori_grid))
        x = torch.cat(lifted, dim=-1)  # [B, A, O, F]

        # ---- invariants and kernel bases ----
        spatial_attr, fiber_attr, dists = fiber_bundle_invariants(nb, ori_grid)
        edge_scalars = None
        if cfg.num_edge_scalar_features > 0:
            edge_scalars = scalar_to_sphere(lattice_edge_scalars(nb, inputs.lattice), num_ori)
            attr = torch.cat([spatial_attr, edge_scalars], dim=-1)
        else:
            attr = spatial_attr
        window = polynomial_cutoff(dists, cfg.radius)  # [B, A, K]
        B, A, K, O, d = attr.shape

        if use_kernels:
            tile = pick_tile(B, A, target=128)
            Bp, TA = B // tile, tile * A
            E = K * TA
            attr = attr.reshape(Bp, tile, A, K, O, d)
            # window [B, A, K] -> k-major rows [B', E], e = k*TA + t*A + a
            win = window.reshape(Bp, tile, A, K).permute(0, 3, 1, 2).reshape(Bp, E)
            if cfg.fuse_fiber or cfg.position_grads:
                # [B', O, E, d] invariants through the plain basis MLP, one
                # basis for every layer; windowed here with fuse_fiber, in the
                # spatial conv otherwise
                attr = attr.permute(0, 4, 3, 1, 2, 5).reshape(Bp, O, E, d)
                if cdt is not None:
                    attr = attr.to(cdt)
                basis = self.basis_fn(attr, cdt)
                if cfg.fuse_fiber:
                    basis = basis * win[:, None, :, None].to(basis.dtype)
                    conv_window = None
                else:
                    conv_window = win.contiguous()
                kernel_bases = (basis,) * len(self.layers)
            else:
                # lane-major [B', O, d, E], cast to the compute type before the
                # transpose as the JAX package does
                attrT = attr.to(cdt) if cdt is not None else attr
                attrT = attrT.permute(0, 4, 5, 3, 1, 2).reshape(Bp, O, d, E).contiguous()
                kernel_bases = self.basis_fn.forward_kernel_layout(attrT, len(self.layers))
                conv_window = win.contiguous()
            conv_src, conv_mask = tile_senders(nb.src, nb.mask, tile), None
            x = x.reshape(Bp, tile, A, O, -1).permute(0, 3, 1, 2, 4).reshape(Bp, O, TA, -1)
        else:
            # cast before the polynomial expansion, as the JAX package does
            basis = self.basis_fn(attr.to(cdt) if cdt is not None else attr, cdt)
            kernel_bases = (basis * window[..., None, None].to(basis.dtype),) * len(self.layers)
            conv_src, conv_mask, conv_window = nb.src, nb.mask, None
        # the fiber invariants stay float32 into the features (cast at the Dense)
        fiber_kernel_basis = self.fiber_basis_fn(fiber_attr, cdt)  # [O, O, D]

        # ---- embed, interaction layers, readouts ----
        x = dense(self.x_embedder, x, cdt)
        xs, fused, edge_readouts = [], [], []
        for i, layer in enumerate(self.layers):
            readout_i = self.readouts[str(i)] if str(i) in self.readouts else None
            x, r, *messages = layer(x, kernel_bases[i], fiber_kernel_basis, conv_src, conv_mask,
                                    conv_window, kernel_layout=use_kernels, dtype=cdt,
                                    readout=readout_i, position_grads=cfg.position_grads,
                                    return_messages=need_messages)
            if need_messages and readout_i is not None:
                parts = [messages[0].float()] + ([] if edge_scalars is None else [edge_scalars])
                edge_in = torch.cat(parts, dim=-1)
                edge_readouts.append(sphere_to_scalar(self.edge_readouts[str(i)](edge_in)))
            if r is not None:
                fused.append(r)
            elif readout_i is not None:
                xs.append((x, readout_i))
        if fused:
            # the fused kernels' float32 readouts, averaged as the JAX package does
            readout = sum(fused) / len(fused)
        else:
            # mean over layers of x_i W_i^T + b_i, as one matmul over the
            # concatenated layers; a bfloat16 xcat times the float32 weights
            # is a float32 product (JAX's type promotion)
            wcat = torch.cat([lin.weight for _, lin in xs], dim=1)
            xcat = torch.cat([xi for xi, _ in xs], dim=-1).to(wcat.dtype)
            if cfg.readout_bf16_operands:
                xcat = xcat.to(torch.bfloat16).float()
                wcat = wcat.to(torch.bfloat16).float()
            readout = (xcat @ wcat.t() + sum(lin.bias for _, lin in xs)) / len(xs)
        if use_kernels:
            out = readout.shape[-1]
            readout = readout.reshape(Bp, O, tile, A, out).permute(0, 2, 3, 1, 4)
            readout = readout.reshape(B, A, O, out)

        # ---- split heads and project off the sphere ----
        s0 = cfg.output_dim_scalar
        s1 = s0 + cfg.output_dim_vec
        s2 = s1 + cfg.output_dim_global_vec
        gs = sphere_to_scalar(readout[..., s2:])
        global_vec = None
        if cfg.output_dim_global_vec:
            gv = sphere_to_vec(readout[..., s1:s2], ori_grid)  # [B, A, out_gv, D]
            global_vec = torch.where(inputs.atom_mask[..., None, None], gv, 0.0).sum(dim=1)
        return PonitaOutputs(
            node_scalar=sphere_to_scalar(readout[..., :s0]),
            node_vec=sphere_to_vec(readout[..., s0:s1], ori_grid),
            global_scalar=torch.where(inputs.atom_mask[..., None], gs, 0.0).sum(dim=1),
            global_vec=global_vec,
            edge_scalar=tuple(edge_readouts),
        )
