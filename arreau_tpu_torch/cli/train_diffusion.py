"""Crystal-diffusion training CLI; counterpart of
``arreau_tpu/cli/train_diffusion.py``, with its knob set.

The loop: bucketed batches -> noise -> PBC graph -> backbone (kernel branch
on the card) -> losses -> backward through the kernels' backward passes ->
clip -> AdamW -> EMA. A 0.7/0.15/0.15 random split; validation every
``--val_interval`` epochs with ``last``, ``best`` and ranked saves; a final
test pass with the best checkpoint. Runs on ``--device`` (default
``cuda``; it never falls back to the CPU). Checkpoints are the port's own
(``train/checkpoint.py``): ``arreau_tpu_torch.cli.generate
--checkpoint_dir <checkpoint_dir> --tag best`` samples from one (its EMA
weights when ``--ema`` kept them). Batches are collated and copied to the
device in a thread, two ahead of the step (``utils.prefetch_to_device``);
the noise is drawn on the main thread. ``--seed`` gives the JAX CLI's
random streams: the key ``PRNGKey(seed)`` split into the chain key and the
init key (the parameters Flax's ``model.init`` draws), one split a training
step (the step's key, and under ``--train_augm`` the rotation key split off
it) and one a validation or test batch, every draw taken from its key as
the JAX loss takes it (``tasks/diffusion.py``). ``--log`` logs to wandb where it
imports (else stdout only, as the JAX CLI); ``--profiler torch`` writes a
``torch.profiler`` Chrome trace of the first timed epoch (epoch 1) under
``profile_results/``.

    python -m arreau_tpu_torch.cli.train_diffusion --dataset synthetic \\
        --batch_size 256 --hidden_dim 200 --max_steps 100

``--dataset alexandria`` (the default) reads every
``alexandria_ps_0*.h5`` shard under ``--data_dir`` (``data/prep.py`` makes
them; ``data/hdf5.py`` reads them, no ``h5py``), ``alexandria-dev`` the
take-10 shard alone (train, valid and test alike), ``synthetic`` the
synthetic training distribution, and ``eval-equivariance`` trains on one
crystal of the take-10 shard (or a synthetic one where there is none) and
validates on its 90-degree rotation with the timestep pinned at
``EVAL_EQUIVARIANCE_TIMESTEP`` (``exploration/verify_equivariance.py``).

Data and tensor parallelism (``parallel/mesh.py``), one process per card:

    python -m torch.distributed.run --nproc_per_node 4 \
        -m arreau_tpu_torch.cli.train_diffusion --model_parallel 2 ...

runs a ``(data 2, model 2)`` mesh: each data rank loads its stride of every
globally decided batch (batch sizes a multiple of the data ranks), draws
the global batch's noise and takes its rows; the kernel-basis and ConvNext
MLPs are split over the model ranks. NCCL where each rank has a card of
its own, gloo where ranks share one or run on the CPU (``--device cpu``).
Rank 0 alone prints, logs, profiles and writes checkpoints (in the one-card
layout); every rank resumes from them.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from arreau_tpu_torch.cli.common import parse_bool, silent
from arreau_tpu_torch.data.crystal import (
    DEFAULT_BUCKETS,
    BucketedLoader,
    CrystalDataset,
    alexandria_shards,
    random_split,
)
from arreau_tpu_torch.data.synthetic import synthetic_packed
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.parallel.mesh import (
    make_mesh,
    maybe_initialize_distributed,
    shard_state,
)
from arreau_tpu_torch.tasks.diffusion import (
    DiffusionConfig,
    DiffusionModel,
    batch_to_device,
    draw_loss_noise,
    rotate_batch,
)
from arreau_tpu_torch.train.checkpoint import CheckpointManager, diffusion_meta
from arreau_tpu_torch.train.loop import eval_step, gather_metrics, train_step
from arreau_tpu_torch.train.metrics import (
    EpochTimer,
    JsonlLogger,
    MeanMetrics,
    exact_loss,
    weighted_update,
)
from arreau_tpu_torch.train.optim import AdamW, cosine_warmup_schedule
from arreau_tpu_torch.train.state import EMA
from arreau_tpu_torch.utils import prefetch_to_device


def _parse_basis_bias(value: str):
    """Tri-state --basis_bias: True | False | in."""
    v = value.strip().strip("'\"")
    if v in ("True", "true", "1"):
        return True
    if v in ("False", "false", "0"):
        return False
    if v == "in":
        return "in"
    raise argparse.ArgumentTypeError(f"--basis_bias must be True, False or in (got {value!r})")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the joint crystal diffusion model")
    p.add_argument("--epochs", type=int, default=10000)
    p.add_argument("--warmup", type=int, default=10, help="warmup epochs")
    p.add_argument("--batch_size", type=int, default=100,
                   help="crystals per batch at the 16-atom bucket; other buckets scale to an "
                        "equal node budget")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-10)
    p.add_argument("--log", type=parse_bool, default=False,
                   help="wandb logging (stdout only where wandb does not import)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel ranks per data rank (under torchrun)")
    p.add_argument("--val_interval", type=int, default=5)
    p.add_argument("--max_steps", type=int, default=None, help="optional hard step cap")
    p.add_argument("--train_augm", type=parse_bool, default=False,
                   help="random SO(3) rotation augmentation of the lattice")
    p.add_argument("--dataset", type=str, default="alexandria",
                   choices=["alexandria", "alexandria-dev", "eval-equivariance", "synthetic"])
    p.add_argument("--data_dir", type=str, default="datasets/alexandria_hdf5")
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--max_neighbors", type=int, default=8)
    p.add_argument("--num_ori", type=int, default=16)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--basis_dim", type=int, default=256)
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--widening_factor", type=int, default=4)
    p.add_argument("--layer_scale", type=float, default=1e-6)
    p.add_argument("--multiple_readouts", type=parse_bool, default=True)
    p.add_argument("--num_timesteps", type=int, default=1000)
    p.add_argument("--mask_prob", type=float, default=0.02,
                   help="D3PM per-step mask-transition probability")
    p.add_argument("--diffuse_angles", type=parse_bool, default=True,
                   help="VP-diffuse the sin/cos-encoded lattice angles with the lengths "
                        "(False: the reference's fixed angles)")
    p.add_argument("--angle_loss_weight", type=float, default=1.0)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--profiler", type=str, default=None, choices=[None, "torch"],
                   help="'torch' writes a torch.profiler trace of the first timed epoch under "
                        "profile_results/")
    p.add_argument("--ema", type=float, default=None, help="EMA decay (e.g. 0.99); default off")
    p.add_argument("--synthetic_size", type=int, default=2000)
    p.add_argument("--resume", type=parse_bool, default=True,
                   help="resume from <checkpoint_dir>/last if present")
    p.add_argument("--debug_nans", type=parse_bool, default=False,
                   help="autograd anomaly detection (slow)")
    p.add_argument("--compute_dtype", type=str, default=None, choices=[None, "bfloat16"],
                   help="bfloat16 Dense layers, convs and residual stream (params and "
                        "LayerNorm statistics stay float32); default float32")
    p.add_argument("--buckets", type=str, default=None,
                   help="comma-separated max-atom bucket ladder")
    p.add_argument("--basis_bias", type=_parse_basis_bias, default=True,
                   help="basis-MLP Dense biases: True (both), in (dense_in only), False")
    p.add_argument("--stacked_readout", type=parse_bool, default=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    return p.parse_args(argv)


EVAL_EQUIVARIANCE_TIMESTEP = 5


def build_datasets(args):
    """(dataset, split indices, z-table, pinned timestep or None)."""
    if args.dataset == "synthetic":
        ds = synthetic_packed(args.synthetic_size, seed=args.seed)
        splits = random_split(len(ds), [0.7, 0.15, 0.15], args.seed)
        return ds, {"train": splits[0], "valid": splits[1], "test": splits[2]}, ds.z_table, None
    if args.dataset == "alexandria-dev":
        ds = CrystalDataset([os.path.join(args.data_dir, "alexandria_ps_000_take10.h5")])
        idx = np.arange(len(ds))
        return ds, {"train": idx, "valid": idx, "test": idx}, ds.z_table, None
    if args.dataset == "eval-equivariance":
        from arreau_tpu_torch.exploration.verify_equivariance import build_equivariance_datasets

        return build_equivariance_datasets(args.data_dir)
    paths = alexandria_shards(args.data_dir)
    if not paths:
        raise FileNotFoundError(
            f"no alexandria shards under {args.data_dir}; run arreau_tpu_torch/data/prep.py "
            "or use --dataset synthetic")
    ds = CrystalDataset(paths)
    splits = random_split(len(ds), [0.7, 0.15, 0.15], args.seed)
    return ds, {"train": splits[0], "valid": splits[1], "test": splits[2]}, ds.z_table, None


def _losses(m: dict) -> str:
    angle = f" angle {m['loss_angle']:.4f}" if "loss_angle" in m else ""
    return (f"{m.get('loss', float('nan')):.4f} (coord {m.get('loss_coord', 0):.4f} "
            f"type {m.get('loss_type', 0):.4f} lattice {m.get('loss_lattice', 0):.4f}{angle})")


def start_profiler(device) -> torch.profiler.profile:
    """A started ``torch.profiler`` over the host and, on CUDA, the device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def stop_profiler(profiler, device, seconds: float) -> None:
    """Stop ``profiler`` after ``seconds`` of wall time (device work waited
    for) and write its Chrome trace under ``profile_results/`` (numbered
    after the files there); on CUDA print the device's idle share of that
    time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs("profile_results", exist_ok=True)
    path = os.path.join("profile_results",
                        f"trace_epoch1_{len(os.listdir('profile_results'))}.json")
    profiler.export_chrome_trace(path)
    print(f"profiler: wrote {path}")
    if device.type == "cuda":
        busy = sum(e.time_range.elapsed_us() for e in profiler.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        print(f"profiler: device busy {busy:.4f} s of {seconds:.4f} s "
              f"(idle share {1 - busy / seconds:.1%})")


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
    torch.autograd.set_detect_anomaly(args.debug_nans)
    # torchrun: join the process group (a no-op in one process); the mesh
    # raises where the ranks do not divide by --model_parallel
    maybe_initialize_distributed(device)
    mesh = make_mesh(model_size=args.model_parallel)
    say = print if mesh.is_main else silent

    dataset, splits, z_table, fixed_t = build_datasets(args)
    cfg = DiffusionConfig(
        num_atomic_states=len(z_table),
        num_timesteps=args.num_timesteps,
        radius=args.radius,
        max_neighbors=args.max_neighbors,
        hidden_dim=args.hidden_dim,
        basis_dim=args.basis_dim,
        degree=args.degree,
        num_layers=args.layers,
        num_ori=args.num_ori,
        widening_factor=args.widening_factor,
        layer_scale=args.layer_scale if args.layer_scale != 0.0 else None,
        multiple_readouts=args.multiple_readouts,
        basis_bias=args.basis_bias,
        stacked_readout=args.stacked_readout,
        mask_prob=args.mask_prob,
        compute_dtype=args.compute_dtype,
        diffuse_angles=args.diffuse_angles,
        angle_loss_weight=args.angle_loss_weight,
    )
    model = DiffusionModel(cfg, device=device)
    buckets = tuple(int(b) for b in args.buckets.split(",")) if args.buckets else DEFAULT_BUCKETS
    # global batch sizes a multiple of the data ranks; each data rank takes
    # its stride of every chunk (the JAX CLI's node_budget and batch_multiple)
    loaders = {
        split: BucketedLoader(dataset, idx, node_budget=args.batch_size * 16, buckets=buckets,
                              seed=args.seed + i, batch_multiple=mesh.data_size,
                              host_index=mesh.data_rank, num_hosts=mesh.data_size)
        for i, (split, idx) in enumerate(splits.items())
    }
    steps_per_epoch = max(loaders["train"].num_batches(), 1)

    key, init_key = prng.split(prng.prng_key(args.seed))
    model.init(init_key, batch_to_device(next(iter(loaders["train"])), device))
    n_params = sum(p.numel() for p in model.model.parameters())
    shard_state(model, mesh)  # before the optimizer and the EMA: they follow the shards
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ranks = (f" | mesh: data {mesh.data_size} x model {mesh.model_size}"
             if mesh.distributed else "")
    say(f"model: {n_params / 1e6:.2f}M params | device: {name} | "
        f"steps/epoch: {steps_per_epoch} | z-table: {len(z_table)} classes{ranks}")

    schedule = cosine_warmup_schedule(args.lr, args.warmup, args.epochs, steps_per_epoch)
    optimizer = AdamW(model.model, schedule, args.weight_decay, grad_clip=0.5, mesh=mesh)
    ema = EMA(model.model, args.ema) if args.ema is not None else None

    train_lengths = np.linalg.norm(dataset.packed.lattices[np.asarray(splits["train"], int)], axis=-1)
    length_stats = {"min": train_lengths.min(), "max": train_lengths.max(),
                    "mean": train_lengths.mean(), "std": train_lengths.std()}
    ckpt = CheckpointManager(args.checkpoint_dir,
                             diffusion_meta(cfg, z_table, length_stats, model.fourier_w), mesh)
    if args.resume and ckpt.has("last"):
        step = ckpt.restore("last", model, optimizer, ema)
        say(f"resumed from {ckpt.path('last')} at step {step}")

    def noise_for(batch, k):
        """The global batch's noise from the key ``k`` (every rank draws
        it), this rank's rows."""
        B, A = batch.atom_types.shape
        return draw_loss_noise(k, B * mesh.data_size, A, cfg.num_atomic_states,
                               cfg.num_timesteps, cfg.diffuse_angles, device,
                               timestep=fixed_t).rows(mesh)

    def device_batches(split: str):
        """The split's batches, collated and copied to the device in a thread
        two ahead of the consumer."""
        return prefetch_to_device(loaders[split], batch_to_device, device, depth=2)

    def evaluate(split: str) -> dict:
        nonlocal key
        pending = []
        for batch in device_batches(split):
            key, k_eval = prng.split(key)
            pending.append(eval_step(model, batch, noise_for(batch, k_eval), ema=ema))
        acc = MeanMetrics()
        for m in gather_metrics(pending):
            weighted_update(acc, m)
        return exact_loss(acc.compute(), args.angle_loss_weight)

    wandb_run = None
    if args.log and mesh.is_main:
        try:
            import wandb

            wandb_run = wandb.init(project="arreau-tpu", name=args.experiment_name,
                                   config=vars(args))
        except ImportError:
            print("wandb not available; logging to stdout only")

    timer = EpochTimer()
    jlog = JsonlLogger(os.path.join(args.checkpoint_dir, "metrics.jsonl") if mesh.is_main
                       else None)
    global_step = optimizer.count
    done = args.max_steps is not None and global_step >= args.max_steps
    # throughput: the training loops' wall time (collation, noise, steps,
    # the epoch's one metrics transfer), from the end of this run's first step
    warm_seconds, warm_steps, first = 0.0, 0, True
    for epoch in range(args.epochs):
        if done:
            break
        timer.epoch_start()
        profiler = None
        if args.profiler == "torch" and epoch == 1 and mesh.is_main:
            profiler = start_profiler(device)
        pending = []
        t_loop = time.perf_counter()
        for batch in device_batches("train"):
            key, k_step = prng.split(key)
            if args.train_augm:
                k_step, k_rot = prng.split(k_step)
                batch = rotate_batch(k_rot, batch, mesh)
            pending.append(train_step(model, optimizer, ema, batch, noise_for(batch, k_step)))
            global_step += 1
            if first:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t_loop, first = time.perf_counter(), False
            else:
                warm_steps += 1
            if args.max_steps is not None and global_step >= args.max_steps:
                done = True
                break
        train_metrics = MeanMetrics()
        for m in gather_metrics(pending):  # waits for the epoch's steps
            weighted_update(train_metrics, m)
        warm_seconds += time.perf_counter() - t_loop
        if profiler is not None:
            stop_profiler(profiler, device, time.perf_counter() - t_loop)
        dt = timer.epoch_end()
        tm = exact_loss(train_metrics.compute(), args.angle_loss_weight)
        lr_now = schedule(optimizer.count)
        say(f"epoch {epoch} | train loss {_losses(tm)} | lr {lr_now:.2e} | {dt:.1f}s")
        if wandb_run:
            wandb_run.log({"epoch": epoch, "lr": lr_now,
                           **{f"train/{k}": v for k, v in tm.items()}})
        jlog.log({"epoch": epoch, "step": optimizer.count, "lr": lr_now, "epoch_s": dt,
                  **{f"train/{k}": v for k, v in tm.items()}})

        if (epoch + 1) % args.val_interval == 0 or epoch == args.epochs - 1:
            v = evaluate("valid")
            say(f"epoch {epoch} | valid loss {_losses(v)}")
            if wandb_run:
                wandb_run.log({f"valid/{k}": val for k, val in v.items()})
            jlog.log({"epoch": epoch, "step": optimizer.count,
                      **{f"valid/{k}": val for k, val in v.items()}})
            ckpt.save("last", model, optimizer, ema)
            ckpt.save_ranked(v.get("loss", float("inf")), optimizer.count, model, optimizer, ema)
        if done:
            ckpt.save("last", model, optimizer, ema)
    if warm_steps > 0:
        say(f"train throughput: {warm_steps / warm_seconds:.3f} steps/s ({warm_steps} warm "
            f"steps, {name})")
    say(timer.summary())

    if ckpt.has("best"):
        ckpt.restore("best", model, optimizer, ema)
    t = evaluate("test")
    say(f"test loss {_losses(t)}")
    if wandb_run:
        wandb_run.log({f"test/{k}": val for k, val in t.items()})
        wandb_run.finish()
    jlog.log({"step": optimizer.count, **{f"test/{k}": val for k, val in t.items()}})
    return t.get("loss")


if __name__ == "__main__":
    main()
