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
weights when ``--ema`` kept them).

    python -m arreau_tpu_torch.cli.train_diffusion --dataset synthetic \\
        --batch_size 256 --hidden_dim 200 --max_steps 100

Only ``--dataset synthetic`` is ported (the Alexandria shards are HDF5,
which the card's machine cannot read); the flags of later slices raise.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from arreau_tpu_torch.cli.generate import parse_bool
from arreau_tpu_torch.data.crystal import DEFAULT_BUCKETS, BucketedLoader, random_split
from arreau_tpu_torch.data.synthetic import synthetic_packed
from arreau_tpu_torch.ops.lattice import rotations_from_normals
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
    p.add_argument("--log", type=parse_bool, default=False, help="wandb logging: not ported")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_parallel", type=int, default=1, help="not ported: must be 1")
    p.add_argument("--val_interval", type=int, default=5)
    p.add_argument("--max_steps", type=int, default=None, help="optional hard step cap")
    p.add_argument("--train_augm", type=parse_bool, default=False,
                   help="random SO(3) rotation augmentation of the lattice")
    p.add_argument("--dataset", type=str, default="alexandria",
                   choices=["alexandria", "alexandria-dev", "eval-equivariance", "synthetic"],
                   help="only synthetic is ported")
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
    p.add_argument("--profiler", type=str, default=None, help="not ported")
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


def _check_ported(args) -> None:
    later = {
        "log": args.log,
        "model_parallel": args.model_parallel != 1,
        "profiler": args.profiler is not None,
        "dataset": args.dataset != "synthetic",
    }
    for flag, used in later.items():
        if used:
            raise NotImplementedError(f"--{flag} is not ported yet")


def build_datasets(args):
    """(dataset, split indices, z-table) of the synthetic dataset."""
    ds = synthetic_packed(args.synthetic_size, seed=args.seed)
    splits = random_split(len(ds), [0.7, 0.15, 0.15], args.seed)
    return ds, {"train": splits[0], "valid": splits[1], "test": splits[2]}, ds.z_table


def _losses(m: dict) -> str:
    angle = f" angle {m['loss_angle']:.4f}" if "loss_angle" in m else ""
    return (f"{m.get('loss', float('nan')):.4f} (coord {m.get('loss_coord', 0):.4f} "
            f"type {m.get('loss_type', 0):.4f} lattice {m.get('loss_lattice', 0):.4f}{angle})")


def main(argv=None):
    args = parse_args(argv)
    _check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
    torch.autograd.set_detect_anomaly(args.debug_nans)

    dataset, splits, z_table = build_datasets(args)
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
    loaders = {
        split: BucketedLoader(dataset, idx, node_budget=args.batch_size * 16, buckets=buckets,
                              seed=args.seed + i)
        for i, (split, idx) in enumerate(splits.items())
    }
    steps_per_epoch = max(loaders["train"].num_batches(), 1)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    model.init(generator, batch_to_device(next(iter(loaders["train"])), device))
    n_params = sum(p.numel() for p in model.model.parameters())
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"model: {n_params / 1e6:.2f}M params | device: {name} | "
          f"steps/epoch: {steps_per_epoch} | z-table: {len(z_table)} classes")

    schedule = cosine_warmup_schedule(args.lr, args.warmup, args.epochs, steps_per_epoch)
    optimizer = AdamW(model.model, schedule, args.weight_decay, grad_clip=0.5)
    ema = EMA(model.model, args.ema) if args.ema is not None else None

    train_lengths = np.linalg.norm(dataset.packed.lattices[np.asarray(splits["train"], int)], axis=-1)
    length_stats = {"min": train_lengths.min(), "max": train_lengths.max(),
                    "mean": train_lengths.mean(), "std": train_lengths.std()}
    ckpt = CheckpointManager(args.checkpoint_dir,
                             diffusion_meta(cfg, z_table, length_stats, model.fourier_w))
    if args.resume and ckpt.has("last"):
        step = ckpt.restore("last", model, optimizer, ema)
        print(f"resumed from {ckpt.path('last')} at step {step}")

    def noise_for(batch):
        B, A = batch.atom_types.shape
        return draw_loss_noise(generator, B, A, cfg.num_atomic_states, cfg.num_timesteps,
                               cfg.diffuse_angles, device)

    def evaluate(split: str) -> dict:
        pending = []
        for host in loaders[split]:
            batch = batch_to_device(host, device)
            pending.append(eval_step(model, batch, noise_for(batch), ema))
        acc = MeanMetrics()
        for m in gather_metrics(pending):
            weighted_update(acc, m)
        return exact_loss(acc.compute(), args.angle_loss_weight)

    timer = EpochTimer()
    jlog = JsonlLogger(os.path.join(args.checkpoint_dir, "metrics.jsonl"))
    global_step = optimizer.count
    done = args.max_steps is not None and global_step >= args.max_steps
    # throughput: the training loops' wall time (collation, noise, steps,
    # the epoch's one metrics transfer), from the end of this run's first step
    warm_seconds, warm_steps, first = 0.0, 0, True
    for epoch in range(args.epochs):
        if done:
            break
        timer.epoch_start()
        pending = []
        t_loop = time.perf_counter()
        for host in loaders["train"]:
            batch = batch_to_device(host, device)
            if args.train_augm:
                normals = torch.randn((batch.lattice.shape[0], 4), generator=generator,
                                      device=device)
                batch = rotate_batch(rotations_from_normals(normals), batch)
            pending.append(train_step(model, optimizer, ema, batch, noise_for(batch)))
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
        dt = timer.epoch_end()
        tm = exact_loss(train_metrics.compute(), args.angle_loss_weight)
        lr_now = schedule(optimizer.count)
        print(f"epoch {epoch} | train loss {_losses(tm)} | lr {lr_now:.2e} | {dt:.1f}s")
        jlog.log({"epoch": epoch, "step": optimizer.count, "lr": lr_now, "epoch_s": dt,
                  **{f"train/{k}": v for k, v in tm.items()}})

        if (epoch + 1) % args.val_interval == 0 or epoch == args.epochs - 1:
            v = evaluate("valid")
            print(f"epoch {epoch} | valid loss {_losses(v)}")
            jlog.log({"epoch": epoch, "step": optimizer.count,
                      **{f"valid/{k}": val for k, val in v.items()}})
            ckpt.save("last", model, optimizer, ema)
            ckpt.save_ranked(v.get("loss", float("inf")), optimizer.count, model, optimizer, ema)
        if done:
            ckpt.save("last", model, optimizer, ema)
    if warm_steps > 0:
        print(f"train throughput: {warm_steps / warm_seconds:.3f} steps/s ({warm_steps} warm "
              f"steps, {name})")
    print(timer.summary())

    if ckpt.has("best"):
        ckpt.restore("best", model, optimizer, ema)
    t = evaluate("test")
    print(f"test loss {_losses(t)}")
    jlog.log({"step": optimizer.count, **{f"test/{k}": val for k, val in t.items()}})
    return t.get("loss")


if __name__ == "__main__":
    main()
