"""MNIST-superpixels training CLI (the 2-D R^2 x S^1 task); counterpart of
``arreau_tpu/cli/train_mnist.py``, with its flag set and ``--device``.

Reads raw MNIST idx files when ``--data_dir`` has them (train, and the
test file halved into valid and test); otherwise ``--synthetic_size``
synthetic stroke images through the same SLIC pipeline, split 0.8/0.1/0.1.
Ten-class classification with cross-entropy and accuracy, SO(2)
augmentation, the Sparsify threshold as a mask, clip + AdamW + EMA 0.99,
validation with the EMA weights every ``--val_interval`` epochs, a final
test pass on ``best``. Runs on ``--device`` (default ``cuda``; it never
falls back to the CPU).

    python -m arreau_tpu_torch.cli.train_mnist --synthetic_size 4000 --epochs 50

Under torchrun (``python -m torch.distributed.run --nproc_per_node N -m
arreau_tpu_torch.cli.train_mnist ...``) the ranks train data-parallel
(``parallel/mesh.py``): every rank draws the same global batch and
augmentation from the shared seed and takes rows ``r::n`` of it; the loss
is a plain mean over shards of equal size (the cross-entropy over
images), so the ranks average their gradients and metrics; rank 0 alone
prints and writes.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from arreau_tpu_torch.cli.common import data_parallel_setup, parse_bool, parse_opt_float
from arreau_tpu_torch.data.mnist import load_mnist_superpixels, synthetic_superpixels
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.ops.grids import random_so2_matrix
from arreau_tpu_torch.parallel.mesh import shard_batch, shard_state
from arreau_tpu_torch.tasks.mnist import (
    Mnist2DBatch,
    MnistConfig,
    MnistModel,
    rotate_mnist_batch,
)
from arreau_tpu_torch.train.checkpoint import CheckpointManager
from arreau_tpu_torch.train.loop import eval_step, gather_metrics, train_step
from arreau_tpu_torch.train.metrics import EpochTimer, JsonlLogger, MeanMetrics
from arreau_tpu_torch.train.optim import AdamW, cosine_warmup_schedule
from arreau_tpu_torch.train.state import EMA


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Ponita on MNIST point clouds (2D)")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--warmup", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=96)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--weight_decay", type=float, default=1e-10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val_interval", type=int, default=5)
    p.add_argument("--train_augm", type=parse_bool, default=True)
    p.add_argument("--data_dir", type=str, default=None, help="dir with raw MNIST idx files")
    p.add_argument("--synthetic_size", type=int, default=2000)
    p.add_argument("--num_nodes", type=int, default=75)
    p.add_argument("--radius", type=parse_opt_float, default=10.0)
    p.add_argument("--max_neighbors", type=int, default=8)
    p.add_argument("--num_ori", type=int, default=10)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--basis_dim", type=int, default=128)
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--widening_factor", type=int, default=4)
    p.add_argument("--layer_scale", type=float, default=0.0)
    p.add_argument("--multiple_readouts", type=parse_bool, default=True)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints-mnist")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    return p.parse_args(argv)


def load_data(args) -> dict:
    if args.data_dir:
        train = load_mnist_superpixels(args.data_dir, "train", args.num_nodes)
        test = load_mnist_superpixels(args.data_dir, "test", args.num_nodes)
        n_val = len(test) // 2
        return {"train": train, "valid": type(test)(*(a[:n_val] for a in test)),
                "test": type(test)(*(a[n_val:] for a in test))}
    print("no --data_dir given; using synthetic stroke images -> SLIC superpixels")
    full = synthetic_superpixels(args.synthetic_size, seed=args.seed, num_nodes=args.num_nodes)
    n = len(full)
    cut1, cut2 = int(n * 0.8), int(n * 0.9)
    return {"train": type(full)(*(a[:cut1] for a in full)),
            "valid": type(full)(*(a[cut1:cut2] for a in full)),
            "test": type(full)(*(a[cut2:] for a in full))}


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
    mesh, say = data_parallel_setup(device, args.batch_size)

    data = {split: Mnist2DBatch(
        pos=torch.as_tensor(ex.pos, dtype=torch.float32, device=device),
        value=torch.as_tensor(ex.value, dtype=torch.float32, device=device),
        mask=torch.as_tensor(ex.mask, dtype=torch.bool, device=device),
        label=torch.as_tensor(ex.label, dtype=torch.long, device=device),
    ) for split, ex in load_data(args).items()}
    cfg = MnistConfig(
        hidden_dim=args.hidden_dim,
        basis_dim=args.basis_dim,
        degree=args.degree,
        num_layers=args.layers,
        num_ori=args.num_ori,
        widening_factor=args.widening_factor,
        layer_scale=args.layer_scale if args.layer_scale != 0.0 else None,
        multiple_readouts=args.multiple_readouts,
        radius=args.radius,
        max_neighbors=args.max_neighbors,
    )
    model = MnistModel(cfg, device)
    rng = np.random.default_rng(args.seed)
    bs = args.batch_size

    def batches(split, shuffle):
        ex = data[split]
        n = len(ex.label)
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - bs + 1, bs):
            chunk = torch.as_tensor(idx[s:s + bs], device=device)
            yield Mnist2DBatch(*(a[chunk] for a in ex))

    # a key chain from the seed; the JAX CLI's own chain is not followed yet
    key, init_key = prng.split(prng.prng_key(args.seed))
    model.init(init_key, next(batches("train", False)))
    n_params = sum(p.numel() for p in model.model.parameters())
    shard_state(model, mesh)
    steps_per_epoch = max(len(data["train"].label) // bs, 1)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"mnist model: {n_params / 1e6:.2f}M params | steps/epoch {steps_per_epoch}")
    say(f"device: {name}")

    schedule = cosine_warmup_schedule(args.lr, max(args.warmup, 1e-6), args.epochs,
                                      steps_per_epoch)
    optimizer = AdamW(model.model, schedule, args.weight_decay, grad_clip=0.5, mesh=mesh)
    ema = EMA(model.model, 0.99)
    ckpt = CheckpointManager(args.checkpoint_dir, {"config": vars(args)}, mesh)
    timer = EpochTimer()
    jlog = JsonlLogger(os.path.join(args.checkpoint_dir, "metrics.jsonl") if mesh.is_main
                       else None)

    def evaluate(split: str) -> dict:
        acc = MeanMetrics()
        for m in gather_metrics([eval_step(model, shard_batch(b, mesh), ema=ema)
                                 for b in batches(split, False)]):
            acc.update(m)
        return acc.compute()

    best = 0.0
    global_step = 0
    warm_seconds, warm_steps = 0.0, 0
    for epoch in range(args.epochs):
        timer.epoch_start()
        pending = []
        t_loop = time.perf_counter()
        for batch in batches("train", True):
            if args.train_augm:
                key, k_rot = prng.split(key)
                batch = rotate_mnist_batch(random_so2_matrix(k_rot, (len(batch.pos),), device=device),
                                          batch)
            pending.append(train_step(model, optimizer, ema, shard_batch(batch, mesh)))
            global_step += 1
            if args.max_steps and global_step >= args.max_steps:
                break
        tm = MeanMetrics()
        for m in gather_metrics(pending):  # waits for the epoch's steps
            tm.update(m)
        t = tm.compute()
        if epoch > 0:  # epoch 0 builds the kernels
            warm_seconds += time.perf_counter() - t_loop
            warm_steps += len(pending)
        dt = timer.epoch_end()
        say(f"epoch {epoch} | train acc {t.get('accuracy', 0):.4f} "
            f"nll {t.get('loss', 0):.4f} | {dt:.1f}s", flush=True)
        if (epoch + 1) % args.val_interval == 0 or epoch == args.epochs - 1:
            v = evaluate("valid").get("accuracy", 0.0)
            say(f"epoch {epoch} | valid acc {v:.4f}", flush=True)
            jlog.log({"epoch": epoch, "step": global_step, "valid/acc": v})
            ckpt.save("last", model, optimizer, ema)
            if v > best:
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
    acc = evaluate("test").get("accuracy", float("nan"))
    say(f"test accuracy {acc:.4f}")
    jlog.log({"step": global_step, "test/acc": acc})
    return acc


if __name__ == "__main__":
    main()
