"""One rank of the port's multi-rank CPU tests (``tests/test_torch_parallel.py``).

Started as torchrun starts a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` in the environment), with gloo on the CPU:

    python tests/torch_parallel_worker.py <scenario>[,<scenario>...] <directory>

It reads the inputs the test wrote under ``<directory>`` and writes its
results there; it imports no JAX (the test holds the results against the
JAX package). Scenarios: ``dp`` (a 2-rank diffusion step, kernel and plain
branch), ``nbody`` (a 2-rank N-body step), ``generate`` (the generate CLI
with ``--data_parallel``), ``tp`` (a data 2 x model 2 step on the kernel
branch, the plain branch and ``fuse_convnext``), ``train_cli`` (the
training CLI at data 2 x model 2, recording which rank wrote what under the
checkpoint directory), ``task_clis`` (the four backbone tasks' training
CLIs, data-parallel).
"""

from __future__ import annotations

import builtins
import dataclasses
import io
import json
import os
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from arreau_tpu_torch.models.ponita import PonitaFiberBundle  # noqa: E402
from arreau_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh,
    maybe_initialize_distributed,
    shard_batch,
    shard_state,
    state_shardings,
    whole_state,
)
from arreau_tpu_torch.tasks.diffusion import (  # noqa: E402
    CrystalBatch,
    DiffusionConfig,
    DiffusionModel,
    LossNoise,
)
from arreau_tpu_torch.train.loop import train_step  # noqa: E402
from arreau_tpu_torch.train.optim import AdamW  # noqa: E402
from arreau_tpu_torch.train.state import EMA  # noqa: E402

LR = 1e-3
EMA_DECAY = 0.9


def diffusion_step(inputs: dict, mesh, config: dict, fuse_convnext: bool = False) -> dict:
    """One training step of the port's diffusion model from ``inputs``
    (``tests/test_torch_parallel.py:diffusion_inputs``) on ``mesh``: the
    global batch's rows and noise of this rank. Returns the metrics, the
    reduced gradients and the parameters and EMA after the step, whole, and
    the local shapes of the split parameters."""
    model = DiffusionModel(DiffusionConfig(**config), device="cpu",
                           fourier_w=inputs["fourier_w"])
    if fuse_convnext:
        model.model = PonitaFiberBundle(dataclasses.replace(model.model.config,
                                                            fuse_convnext=True))
    model.model.load_state_dict(inputs["params"])
    shard_state(model, mesh)
    optimizer = AdamW(model.model, lambda count: LR, grad_clip=0.5, mesh=mesh)
    ema = EMA(model.model, EMA_DECAY)
    batch = shard_batch(CrystalBatch(*inputs["batch"]), mesh)
    noise = LossNoise(**inputs["noise"]).rows(mesh)
    metrics = train_step(model, optimizer, ema, batch, noise)
    plan = state_shardings(model.model)
    grads = {n: p.grad for n, p in model.model.named_parameters()}
    return {
        "metrics": {k: v.item() for k, v in metrics.items()},
        "grads": whole_state(grads, plan, mesh),
        "params": whole_state({n: p.detach() for n, p in model.model.named_parameters()},
                              plan, mesh),
        "ema": whole_state(ema.params, plan, mesh),
        "local_shapes": {n: tuple(p.shape) for n, p in model.model.named_parameters()
                         if n in plan},
        "mesh": None if mesh is None else [mesh.data_size, mesh.model_size, mesh.data_rank,
                                           mesh.model_rank],
        "real_atoms": int(batch.atom_mask.sum()),
    }


def run_dp(out: Path, rank: int) -> None:
    inputs = torch.load(out / "dp_inputs.pt", weights_only=False)
    mesh = make_mesh()
    for branch, use_kernels in (("kernel", True), ("plain", False)):
        result = diffusion_step(inputs, mesh, {**inputs["config"], "use_pallas": use_kernels})
        torch.save(result, out / f"dp_{branch}_rank{rank}.pt")


def run_tp(out: Path, rank: int) -> None:
    inputs = torch.load(out / "dp_inputs.pt", weights_only=False)
    mesh = make_mesh(model_size=2)
    cases = {"kernel": ({"use_pallas": True}, False), "plain": ({"use_pallas": False}, False),
             "fuse_convnext": ({"use_pallas": True, "compute_dtype": "float32"}, True)}
    for name, (config, fuse_convnext) in cases.items():
        result = diffusion_step(inputs, mesh, {**inputs["config"], **config}, fuse_convnext)
        torch.save(result, out / f"tp_{name}_rank{rank}.pt")


def run_nbody(out: Path, rank: int) -> None:
    from arreau_tpu_torch.tasks.nbody import NBodyBatch, NBodyConfig, NBodyModel

    inputs = torch.load(out / "nbody_inputs.pt", weights_only=False)
    mesh = make_mesh()
    model = NBodyModel(NBodyConfig(**inputs["config"]), device="cpu")
    model.model.load_state_dict(inputs["params"])
    shard_state(model, mesh)
    optimizer = AdamW(model.model, lambda count: LR, grad_clip=0.5, mesh=mesh)
    metrics = train_step(model, optimizer, None, shard_batch(NBodyBatch(*inputs["batch"]), mesh))
    torch.save({"metrics": {k: v.item() for k, v in metrics.items()},
                "grads": {n: p.grad for n, p in model.model.named_parameters()},
                "params": {n: p.detach() for n, p in model.model.named_parameters()}},
               out / f"nbody_rank{rank}.pt")


def run_generate(out: Path, rank: int) -> None:
    from arreau_tpu_torch.cli import generate

    args = json.loads((out / "generate_args.json").read_text())
    generate.main(args)


def run_train_cli(out: Path, rank: int) -> None:
    """The training CLI, with every write under the checkpoint directory
    recorded (``open`` for writing, ``os.replace``, ``os.makedirs``)."""
    from arreau_tpu_torch.cli import train_diffusion

    args = json.loads((out / "train_cli_args.json").read_text())
    ckpt = os.path.abspath(args[args.index("--checkpoint_dir") + 1])
    writes = []

    def under(path) -> bool:
        return os.path.abspath(os.fspath(path)).startswith(ckpt)

    real_open, real_replace, real_makedirs = builtins.open, os.replace, os.makedirs

    def opening(file, mode="r", *a, **k):
        if isinstance(file, (str, os.PathLike)) and any(c in mode for c in "wax+") and under(file):
            writes.append(os.path.relpath(os.fspath(file), ckpt))
        return real_open(file, mode, *a, **k)

    def replacing(src, dst, *a, **k):
        if under(dst):
            writes.append(os.path.relpath(os.fspath(dst), ckpt))
        return real_replace(src, dst, *a, **k)

    def making(path, *a, **k):
        if under(path):
            writes.append(os.path.relpath(os.fspath(path), ckpt))
        return real_makedirs(path, *a, **k)

    builtins.open = io.open = opening
    os.replace, os.makedirs = replacing, making
    try:
        loss = train_diffusion.main(args)
    finally:
        builtins.open = io.open = real_open
        os.replace, os.makedirs = real_replace, real_makedirs
    (out / f"train_cli_rank{rank}.json").write_text(json.dumps(
        {"writes": sorted(set(writes)), "loss": loss}))


def run_task_clis(out: Path, rank: int) -> None:
    """Each backbone task's training CLI at a tiny size; its return value
    (a test metric) per rank."""
    import importlib

    argv = json.loads((out / "task_cli_args.json").read_text())
    results = {name: importlib.import_module(f"arreau_tpu_torch.cli.{name}").main(args)
               for name, args in argv.items()}
    (out / f"task_clis_rank{rank}.json").write_text(json.dumps(results))


SCENARIOS = {"dp": run_dp, "tp": run_tp, "nbody": run_nbody, "generate": run_generate,
             "train_cli": run_train_cli, "task_clis": run_task_clis}


def main() -> None:
    torch.set_num_threads(1)
    scenarios, out = sys.argv[1].split(","), Path(sys.argv[2])
    rank, world = maybe_initialize_distributed("cpu")
    assert dist.is_initialized() and dist.get_backend() == "gloo" and world > 1
    for name in scenarios:
        SCENARIOS[name](out, rank)
        dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
