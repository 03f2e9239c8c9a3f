"""Data and tensor parallelism on ``torch.distributed``; counterpart of
``arreau_tpu/parallel/mesh.py``.

The port runs one process per card, launched by ``python -m
torch.distributed.run`` (torchrun), where the JAX package runs one process
per host over all of its devices. :func:`maybe_initialize_distributed`
reads torchrun's environment, :func:`make_mesh` lays the ranks out as a
``("data",)`` or ``("data", "model")`` mesh, as the JAX package's devices.

Data parallelism (DP): data rank r of n holds rows ``r::n`` of every global
batch (the loader's multi-host stride split, ``data/crystal.py``;
:func:`shard_batch` for the other tasks), and the noise of a step is drawn
for the global batch on every rank from the same generator and sliced the
same way, so a DP step computes the one-process step on the global batch.
The gradients are all-reduced over the data group after ``backward``
(``train/loop.py``): summed where the loss divides by counts of the global
batch (the diffusion loss: ``global_denominators``), averaged where it is a
plain mean over shards of equal size (the backbone tasks).

Tensor parallelism (TP), Megatron-style, over the model group: the
kernel-basis MLPs' ``dense_in`` and the ConvNext blocks' ``linear_1`` are
split by output features (their weight and bias), ``dense_out`` and
``linear_2`` by input features (their weight; the bias stays whole and is
added after the sum). :func:`param_partition_dim` is the plan (JAX's
``param_partition_spec``); :func:`shard_state` cuts the parameters, before
the optimizer and the EMA are built, so AdamW's moments and the EMA
shadows hold the same shards, as optax's follow JAX's shardings. The
ranks of one model group hold the same rows. On the plain branch a split
pair is the local column product, GELU, the local row product and
:func:`reduce_from_model` (all-reduce forward, identity backward), with
:func:`copy_to_model` (identity forward, all-reduce backward) on its input;
the CUDA kernels take whole weights, which :func:`gather_from_model`
gathers at the kernel boundary (its backward slices the weight's cotangent
back to the shard), as JAX's ``shard_map`` boundary gathers them
(``models/blocks.py``). JAX's ``kernel_partitioning`` / ``shard_map_kernel``
have no counterpart: each rank runs the kernels on its own rows, which is
what they arrange for a Pallas call inside a sharded program.

A checkpoint keeps the one-card layout: ``train/checkpoint.py`` gathers the
shards to save and cuts them again to restore.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

COL_SPLIT = frozenset({"dense_in", "linear_1"})  # split by output features
ROW_SPLIT = frozenset({"dense_out", "linear_2"})  # split by input features


def maybe_initialize_distributed(device="cuda") -> tuple[int, int]:
    """``(rank, world_size)``. Under torchrun (``RANK`` and ``WORLD_SIZE`` in
    the environment, with ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
    it joins the process group, once; a process started without a launcher
    gets ``(0, 1)`` and nothing changes. On ``cuda`` each rank takes card
    ``LOCAL_RANK % device_count()``; the backend is NCCL when every local
    rank has a card of its own, gloo where ranks share a card or run on the
    CPU (NCCL refuses two ranks on one device). It prints the backend."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 0, 1
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend, why = "gloo", "on the CPU"
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % cards)
        if local_world <= cards:
            backend, why = "nccl", "one card per rank"
        else:
            why = f"{local_world} ranks share {cards} card(s)"
    dist.init_process_group(backend, rank=rank, world_size=world)
    if rank == 0:
        print(f"torch.distributed: {world} rank(s), backend {backend} ({why})", flush=True)
    return rank, world


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``(data, model)`` mesh and the process groups
    of its row (``model_group``: the ranks holding the same rows) and
    column (``data_group``: the ranks holding the same shards). The default
    is one process."""

    data_size: int = 1
    model_size: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None
    device_mesh: Any = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that prints, logs, profiles and writes files."""
        return self.data_rank == 0 and self.model_rank == 0

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None and self.data_size * self.model_size > 1


def make_mesh(model_size: int = 1) -> Mesh:
    """A 1-D ``("data",)`` mesh over every rank, or with ``model_size > 1``
    a 2-D ``("data", "model")`` mesh (rank = data * model_size + model, the
    JAX package's ``reshape(-1, model_size)``), built with
    ``init_device_mesh``. Without a process group it is the one-process
    mesh."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_size > 1 and world % model_size != 0:
        raise ValueError(f"{world} devices not divisible by model_size={model_size}")
    if not dist.is_initialized():
        return Mesh()
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if model_size > 1:
        dm = init_device_mesh(device_type, (world // model_size, model_size),
                              mesh_dim_names=("data", "model"))
        return Mesh(world // model_size, model_size, dm.get_local_rank("data"),
                    dm.get_local_rank("model"), dm.get_group("data"), dm.get_group("model"), dm)
    dm = init_device_mesh(device_type, (world,), mesh_dim_names=("data",))
    return Mesh(world, 1, dm.get_local_rank("data"), 0, dm.get_group("data"), None, dm)


# ---------------- the tensor-parallel plan ----------------


def param_partition_dim(name: str, ndim: int) -> Optional[int]:
    """The dimension of the port's parameter ``name`` (of rank ``ndim``)
    split over the model axis, or None (replicated): JAX's
    ``param_partition_spec`` read through the transposed ``nn.Linear``
    weights (JAX kernel axis 1 = torch dim 0)."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    module, leaf = parts[-2], parts[-1]
    if module in COL_SPLIT and ((leaf == "weight" and ndim == 2) or (leaf == "bias" and ndim == 1)):
        return 0
    if module in ROW_SPLIT and leaf == "weight" and ndim == 2:
        return 1
    return None


def state_shardings(module: torch.nn.Module) -> dict[str, int]:
    """``{parameter name: split dimension}`` of ``module``'s split
    parameters; the same names key AdamW's moments and the EMA."""
    plan = {}
    for name, p in module.named_parameters():
        dim = param_partition_dim(name, p.dim())
        if dim is not None:
            plan[name] = dim
    return plan


def shard_state(model, mesh: Mesh) -> None:
    """Put task ``model`` (its ``.model`` module) on ``mesh``: ``model.mesh``
    is set for the loss and the training step, and under TP every split
    parameter is cut to this rank's shard and its owner module (a
    ``BasisMLP`` or ``ConvNextBlock``) runs its TP forward. Call it after
    the parameters are initialised or loaded and before the optimizer and
    the EMA are built."""
    model.mesh = mesh
    if mesh is None or mesh.model_size == 1:
        return
    module = model.model
    owners = dict(module.named_modules())
    for name, dim in state_shardings(module).items():
        owner_name = name.rsplit(".", 2)[0]
        owner = owners[owner_name]
        if not hasattr(owner, "tp"):
            raise NotImplementedError(f"{owner_name} ({type(owner).__name__}) has no "
                                      "tensor-parallel forward")
        p = dict(module.named_parameters())[name]
        if p.shape[dim] % mesh.model_size:
            raise ValueError(f"{name}: dimension {dim} of {tuple(p.shape)} not divisible by "
                             f"model_size={mesh.model_size}")
        p.data = local_shard(p.data, dim, mesh)
        p.grad = None
        owner.tp = mesh


def local_shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a whole tensor split along ``dim``."""
    return t.chunk(mesh.model_size, dim)[mesh.model_rank].contiguous()


def whole(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every model rank's shard (a collective)."""
    parts = [torch.empty_like(t) for _ in range(mesh.model_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim)


def whole_state(tensors: dict, plan: dict, mesh: Optional[Mesh]) -> dict:
    """``{name: tensor}`` with the split entries gathered whole."""
    if mesh is None or mesh.model_size == 1:
        return dict(tensors)
    return {n: whole(t, plan[n], mesh) if n in plan else t for n, t in tensors.items()}


def sharded_state(tensors: dict, plan: dict, mesh: Optional[Mesh]) -> dict:
    """``{name: tensor}`` with the split entries cut to this rank's shard."""
    if mesh is None or mesh.model_size == 1:
        return dict(tensors)
    return {n: local_shard(t, plan[n], mesh) if n in plan else t for n, t in tensors.items()}


@contextlib.contextmanager
def whole_parameters(module: torch.nn.Module, mesh: Optional[Mesh]):
    """Inside, the split parameters of ``module`` hold whole tensors (the
    one-card layout, e.g. for loading a checkpoint); on exit each holds its
    shard of what it holds then."""
    if mesh is None or mesh.model_size == 1:
        yield
        return
    plan = state_shardings(module)
    params = dict(module.named_parameters())
    for name, dim in plan.items():
        params[name].data = whole(params[name].data, dim, mesh)
    try:
        yield
    finally:
        for name, dim in plan.items():
            params[name].data = local_shard(params[name].data, dim, mesh)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return whole(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return local_shard(g, ctx.dim, ctx.mesh), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a column-split layer: identity, with the input's
    cotangent summed over the model group."""
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The output of a row-split layer: the partial products summed over the
    model group; the cotangent passes whole."""
    return _ReduceFromModel.apply(x, mesh.model_group)


def gather_from_model(w: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """A split weight whole, for a kernel that takes whole weights; the
    weight's cotangent (the same on every rank of the model group, which
    holds the same rows) is sliced back to this rank's shard."""
    return _GatherFromModel.apply(w, dim, mesh)


# ---------------- data parallelism ----------------


def data_parallel(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.data_size > 1


def shard_rows(x, mesh: Optional[Mesh], dim: int = 0):
    """Rows ``data_rank::data_size`` of ``x`` along ``dim`` (a tensor or a
    numpy array); ``x`` itself without data parallelism."""
    if not data_parallel(mesh):
        return x
    rows = x[(slice(None),) * dim + (slice(mesh.data_rank, None, mesh.data_size),)]
    return rows.contiguous() if torch.is_tensor(rows) else rows


def shard_batch(batch, mesh: Optional[Mesh]):
    """The data rank's rows of every field of a batch (a NamedTuple)."""
    if not data_parallel(mesh):
        return batch
    return type(batch)(*(shard_rows(x, mesh) for x in batch))


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch from every data rank's rows (the inverse of
    :func:`shard_rows` on dim 0), on every rank."""
    if not data_parallel(mesh):
        return x
    if x.dtype == torch.bool:  # gloo has no bool collectives
        return gather_rows(x.to(torch.uint8), mesh).bool()
    parts = [torch.empty_like(x) for _ in range(mesh.data_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.stack(parts, dim=1).reshape(-1, *x.shape[1:])


def data_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over the data group (no gradient); ``x`` itself without
    data parallelism."""
    if not data_parallel(mesh):
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.data_group)
    return x


def data_mean(metrics: dict, mesh: Optional[Mesh]) -> dict:
    """Scalar metrics averaged over the data group (one all-reduce)."""
    if not data_parallel(mesh) or not metrics:
        return metrics
    keys = list(metrics)
    summed = data_sum(torch.stack([metrics[k].detach().float() for k in keys]), mesh)
    return dict(zip(keys, summed / mesh.data_size))


def reduce_gradients(module: torch.nn.Module, mesh: Optional[Mesh], mean: bool) -> None:
    """All-reduce every parameter's gradient over the data group, as one
    flat bucket: summed, or averaged with ``mean``. Split parameters are
    reduced with the ranks that hold the same shard."""
    if not data_parallel(mesh):
        return
    params = list(module.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    if mean:
        flat /= mesh.data_size
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p)
        offset += n


def model_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the model group (no gradient)."""
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.model_group)
    return x


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.distributed:
        dist.barrier()


def broadcast_from_main(obj, mesh: Optional[Mesh]):
    """Rank 0's ``obj`` on every rank (a picklable value)."""
    if mesh is None or not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@contextlib.contextmanager
def main_first(mesh: Optional[Mesh]):
    """Rank 0 runs the body first (e.g. writes a dataset), then the others."""
    if mesh is None or not mesh.distributed:
        yield
        return
    if not mesh.is_main:
        dist.barrier()
    try:
        yield
    finally:
        if mesh.is_main:
            dist.barrier()
