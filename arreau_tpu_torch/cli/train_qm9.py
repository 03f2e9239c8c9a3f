"""QM9 training CLI; counterpart of ``arreau_tpu/cli/train_qm9.py``, with
its flag set and ``--device``.

Reads the raw gdb9 ``.xyz`` directory given as ``--root``; otherwise
``--synthetic_size`` synthetic molecules. The DimeNet split (seed 42),
the z-scored MAE loss with the MAE in the target's units as the metric,
SO(3) augmentation, clip + AdamW + EMA 0.99, validation with the EMA
weights every ``--val_interval`` epochs, ``best``/``last`` checkpoints and
a final test pass on ``best``. Runs on ``--device`` (default ``cuda``; it
never falls back to the CPU).

``--seed`` gives the JAX CLI's random numbers: its parameters, numpy's
shuffles and the rotations of its key chain (``cli/common.py:step_keys``;
a validation or test batch advances the chain by one split).

``--seed`` gives the JAX CLI's random numbers: its parameters, numpy's
shuffles and the rotations of its key chain (``cli/common.py:step_keys``;
a validation or test batch advances the chain by one split).

    python -m arreau_tpu_torch.cli.train_qm9 --epochs 300

Under torchrun (``python -m torch.distributed.run --nproc_per_node N -m
arreau_tpu_torch.cli.train_qm9 ...``) the ranks train data-parallel
(``parallel/mesh.py``): every rank draws the same global batch and
augmentation from the shared seed and takes rows ``r::n`` of it; the loss
is a plain mean over shards of equal size (the MAE over molecules), so the ranks average
their gradients and metrics; rank 0 alone prints and writes.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from arreau_tpu_torch.cli.common import (
    data_parallel_setup,
    parse_bool,
    parse_opt_float,
    step_keys,
)
from arreau_tpu_torch.data.molecules import dimenet_split, load_qm9_xyz_dir, synthetic_molecules
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.ops.grids import random_so3_matrix
from arreau_tpu_torch.parallel.mesh import shard_batch, shard_state
from arreau_tpu_torch.tasks.qm9 import MoleculeBatch, QM9Config, QM9Model, rotate_molecule_batch
from arreau_tpu_torch.train.checkpoint import CheckpointManager
from arreau_tpu_torch.train.loop import eval_step, gather_metrics, train_step
from arreau_tpu_torch.train.metrics import EpochTimer, JsonlLogger, MeanMetrics
from arreau_tpu_torch.train.optim import AdamW, cosine_warmup_schedule
from arreau_tpu_torch.train.state import EMA


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Ponita on QM9 scalar regression")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=96)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--weight_decay", type=float, default=1e-10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val_interval", type=int, default=5)
    p.add_argument("--train_augm", type=parse_bool, default=True)
    p.add_argument("--target", type=str, default="alpha")
    p.add_argument("--root", type=str, default=None, help="path to gdb9 xyz dir")
    p.add_argument("--synthetic_size", type=int, default=2000)
    p.add_argument("--radius", type=parse_opt_float, default=None)
    p.add_argument("--max_neighbors", type=int, default=8)
    p.add_argument("--num_ori", type=int, default=-1, help="-1 = lifted point cloud, 0 = plain")
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--basis_dim", type=int, default=256)
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--widening_factor", type=int, default=4)
    p.add_argument("--layer_scale", type=float, default=0.0)
    p.add_argument("--multiple_readouts", type=parse_bool, default=True)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints-qm9")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--max_atoms", type=int, default=None, help="dense pad size override")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
    mesh, say = data_parallel_setup(device, args.batch_size)

    if args.root:
        data = load_qm9_xyz_dir(args.root, args.target)
    else:
        say("no --root given; using synthetic molecules")
        data = synthetic_molecules(args.synthetic_size, seed=args.seed)
    tr, va, te = dimenet_split(len(data))
    shift = float(np.mean(data.y[tr]))
    scale = float(np.std(data.y[tr]))
    say(f"target {args.target}: shift {shift:.4f} scale {scale:.4f}")

    cfg = QM9Config(
        input_dim=data.one_hot.shape[-1],
        hidden_dim=args.hidden_dim,
        basis_dim=args.basis_dim,
        degree=args.degree,
        num_layers=args.layers,
        widening_factor=args.widening_factor,
        layer_scale=args.layer_scale if args.layer_scale != 0.0 else None,
        multiple_readouts=args.multiple_readouts,
        radius=args.radius,
        max_neighbors=args.max_neighbors,
        lifted=args.num_ori == -1,
    )
    model = QM9Model(cfg, shift, scale, device)
    rng = np.random.default_rng(args.seed)
    max_atoms = args.max_atoms or data.pos.shape[1]
    # the whole set on the device once; a batch is an index into it
    on_device = MoleculeBatch(
        pos=torch.as_tensor(data.pos[:, :max_atoms], dtype=torch.float32, device=device),
        one_hot=torch.as_tensor(data.one_hot[:, :max_atoms], dtype=torch.float32, device=device),
        mask=torch.as_tensor(data.mask[:, :max_atoms], device=device),
        y=torch.as_tensor(data.y, dtype=torch.float32, device=device),
    )
    bs = args.batch_size

    def batches(idx, shuffle):
        order = rng.permutation(idx) if shuffle else idx
        for s in range(0, len(order) - bs + 1, bs):
            chunk = torch.as_tensor(order[s:s + bs], device=device)
            yield MoleculeBatch(*(a[chunk] for a in on_device))

    key, init_key = prng.split(prng.prng_key(args.seed))
    model.init(init_key, next(batches(tr, False)))
    n_params = sum(p.numel() for p in model.model.parameters())
    shard_state(model, mesh)
    steps_per_epoch = max(len(tr) // bs, 1)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"qm9 model: {n_params / 1e6:.2f}M params | steps/epoch {steps_per_epoch}")
    say(f"device: {name}")

    schedule = cosine_warmup_schedule(args.lr, args.warmup, args.epochs, steps_per_epoch)
    optimizer = AdamW(model.model, schedule, args.weight_decay, grad_clip=0.5, mesh=mesh)
    ema = EMA(model.model, 0.99)
    ckpt = CheckpointManager(args.checkpoint_dir,
                             {"config": vars(args), "shift": shift, "scale": scale}, mesh)
    timer = EpochTimer()
    jlog = JsonlLogger(os.path.join(args.checkpoint_dir, "metrics.jsonl") if mesh.is_main
                       else None)

    def evaluate(idx) -> float:
        nonlocal key
        acc = MeanMetrics()
        results = []
        for b in batches(idx, False):
            key, _ = prng.split(key)  # the JAX CLI's k_eval, which its loss leaves unused
            results.append(eval_step(model, shard_batch(b, mesh), ema=ema))
        for m in gather_metrics(results):
            acc.update(m)
        return acc.compute().get("mae", float("nan"))

    best = float("inf")
    global_step = 0
    warm_seconds, warm_steps = 0.0, 0
    for epoch in range(args.epochs):
        timer.epoch_start()
        pending = []
        t_loop = time.perf_counter()
        for batch in batches(tr, True):
            key, k_rot = step_keys(key)
            if args.train_augm:
                batch = rotate_molecule_batch(random_so3_matrix(k_rot, (bs,), device=device), batch)
            pending.append(train_step(model, optimizer, ema, shard_batch(batch, mesh)))
            global_step += 1
            if args.max_steps and global_step >= args.max_steps:
                break
        tm = MeanMetrics()
        for m in gather_metrics(pending):  # waits for the epoch's steps
            tm.update(m)
        t = tm.compute()
        if epoch > 0:  # epoch 0 includes the first steps' allocations
            warm_seconds += time.perf_counter() - t_loop
            warm_steps += len(pending)
        dt = timer.epoch_end()
        say(f"epoch {epoch} | train MAE {t.get('mae', float('nan')):.6f} | {dt:.1f}s",
            flush=True)
        if (epoch + 1) % args.val_interval == 0 or epoch == args.epochs - 1:
            v = evaluate(va)
            say(f"epoch {epoch} | valid MAE {v:.6f}", flush=True)
            jlog.log({"epoch": epoch, "step": global_step, "valid/mae": v})
            ckpt.save("last", model, optimizer, ema)
            if v < best:
                best = v
                ckpt.save("best", model, optimizer, ema)
        if args.max_steps and global_step >= args.max_steps:
            break

    if warm_steps > 0:
        say(f"train throughput: {warm_steps / warm_seconds:.3f} steps/s ({warm_steps} warm "
            f"steps, {name})")
    say(timer.summary())
    if ckpt.has("best"):
        ckpt.restore("best", model, optimizer, ema)
    test_mae = evaluate(te)
    say(f"test MAE {test_mae:.6f}")
    jlog.log({"step": global_step, "test/mae": test_mae})
    return test_mae


if __name__ == "__main__":
    main()
