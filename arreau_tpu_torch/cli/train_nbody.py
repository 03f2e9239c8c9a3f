"""N-body training CLI; counterpart of ``arreau_tpu/cli/train_nbody.py``,
with its flag set and ``--device``.

The dataset (``nbody_small``: 10000/2000/2000 charged 5-body trajectories,
trained on a 3000 subset) is simulated on the device into ``--data_dir``
when its npz files are absent. Each step draws a batch of systems, rotates
it at random (``--train_augm``), builds the fully connected graph and runs
the Ponita backbone (kernel branch on the card) or ``--model egnn``, then
clip + AdamW + EMA 0.99; validation every ``--val_interval`` epochs with
the EMA weights, ``last``/``best`` checkpoints, a final test pass on
``best``. Runs on ``--device`` (default ``cuda``; it never falls back to
the CPU).

``--seed`` gives the JAX CLI's random numbers: its parameters, shuffles and
rotations, drawn from its key chain (``ops/prng.py``; the bulk draws on the
card through the threefry kernel). The JAX CLI has two chains, and the port
follows the one the JAX CLI would take with the same flags:

- the scan chain (``--scan_epoch`` true, or by default in one process), as
  the JAX CLI's epoch as one ``lax.scan``: an epoch takes ``key, k_ep =
  split(key)`` and ``kp, k_loop = split(k_ep)``, shuffles with
  ``jax.random.permutation(kp, n_train)`` (its first ``steps_per_epoch x
  batch_size`` systems), and each step splits ``k_loop, k_rot, k_step =
  split(k_loop, 3)``; a validation or test pass takes one ``key, k_eval =
  split(key)``;
- the per-batch chain (``--max_steps``, ``--scan_epoch false``, or by
  default under torchrun with more than one rank): numpy's
  ``rng.permutation`` an epoch, ``key, k_rot, k_step = split(key, 3)`` a
  step, ``key, k_eval = split(key)`` a validation or test batch.

Either way the port runs one eager step at a time; "scan" names the order
of the draws.

    python -m arreau_tpu_torch.cli.train_nbody --epochs 10000 --val_interval 20 \\
        --batch_size 100 --lr 1e-3

Under torchrun (``python -m torch.distributed.run --nproc_per_node N -m
arreau_tpu_torch.cli.train_nbody ...``) the ranks train data-parallel
(``parallel/mesh.py``): every rank draws the same global batch and
augmentation from the shared seed and takes rows ``r::n`` of it; the loss
is a plain mean over shards of equal size (the MSE over systems and coordinates; the
dataset is simulated by rank 0, then read by the others), so the ranks average
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
    parse_opt_bool,
    parse_opt_float,
)
from arreau_tpu_torch.data.nbody import load_or_generate
from arreau_tpu_torch.kernels import threefry
from arreau_tpu_torch.models.egnn import EGNNConfig, EGNNNBody
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.ops.grids import random_so3_matrix
from arreau_tpu_torch.parallel.mesh import main_first, shard_batch, shard_state
from arreau_tpu_torch.tasks.nbody import (
    NBodyBatch,
    NBodyConfig,
    NBodyModel,
    rotate_nbody_batch,
)
from arreau_tpu_torch.train.checkpoint import CheckpointManager
from arreau_tpu_torch.train.loop import eval_step, gather_metrics, train_step
from arreau_tpu_torch.train.metrics import EpochTimer, JsonlLogger, MeanMetrics
from arreau_tpu_torch.train.optim import AdamW, cosine_warmup_schedule
from arreau_tpu_torch.train.state import EMA


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Ponita on charged N-body dynamics")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--weight_decay", type=float, default=1e-10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val_interval", type=int, default=5)
    p.add_argument("--train_augm", type=parse_bool, default=True)
    p.add_argument("--max_training_samples", type=int, default=3000)
    p.add_argument("--generate_train", type=int, default=10000,
                   help="trajectories to simulate for the train file when the dataset is absent "
                        "(valid/test get 1/5 each)")
    p.add_argument("--dataset", type=str, default="nbody_small")
    p.add_argument("--data_dir", type=str, default="datasets/nbody")
    p.add_argument("--model", type=str, default="ponita", choices=("ponita", "egnn"),
                   help="'egnn' trains the EGNN baseline (models/egnn.py)")
    p.add_argument("--radius", type=parse_opt_float, default=None)
    p.add_argument("--num_ori", type=int, default=16)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--basis_dim", type=int, default=256)
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--widening_factor", type=int, default=4)
    p.add_argument("--layer_scale", type=float, default=0.0)
    p.add_argument("--multiple_readouts", type=parse_bool, default=True)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints-nbody")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--scan_epoch", type=parse_opt_bool, default=None,
                   help="draw the JAX CLI's scan-path key chain (an epoch's shuffle from "
                        "jax.random.permutation, three keys a step). Default (None): on in "
                        "one process. --max_steps always takes the per-batch chain (numpy "
                        "shuffles), overriding scan_epoch")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    return p.parse_args(argv)


def build_model(args, device):
    if args.model == "egnn":
        return EGNNNBody(EGNNConfig(hidden_dim=args.hidden_dim, num_layers=args.layers), device)
    cfg = NBodyConfig(
        hidden_dim=args.hidden_dim,
        basis_dim=args.basis_dim,
        degree=args.degree,
        num_layers=args.layers,
        num_ori=args.num_ori,
        widening_factor=args.widening_factor,
        layer_scale=args.layer_scale if args.layer_scale != 0.0 else None,
        multiple_readouts=args.multiple_readouts,
        radius=args.radius,
    )
    return NBodyModel(cfg, device)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
    mesh, say = data_parallel_setup(device, args.batch_size)

    splits = {}
    for split in ("train", "valid", "test"):
        with main_first(mesh):  # rank 0 simulates a missing dataset
            ex = load_or_generate(
                args.data_dir, split, num_train=max(args.generate_train, args.max_training_samples),
                dataset_name=args.dataset, seed=43, device=device,
                max_samples=args.max_training_samples if split == "train" else None)
        splits[split] = [torch.as_tensor(a, dtype=torch.float32, device=device)
                         for a in (ex.loc0, ex.vel0, ex.charges, ex.loc_end)]
    model = build_model(args, device)
    rng = np.random.default_rng(args.seed)
    bs = args.batch_size

    def batches(split, shuffle):
        arrays = splits[split]
        n = len(arrays[0])
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - bs + 1, bs):
            chunk = torch.as_tensor(idx[s:s + bs], device=device)
            yield NBodyBatch(*(a[chunk] for a in arrays))

    key, init_key = prng.split(prng.prng_key(args.seed))
    model.init(init_key, next(batches("train", False)))
    n_params = sum(p.numel() for p in model.model.parameters())
    shard_state(model, mesh)
    n_train = len(splits["train"][0])
    steps_per_epoch = max(n_train // bs, 1)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"nbody model: {n_params / 1e6:.2f}M params | steps/epoch {steps_per_epoch}")
    say(f"device: {name}")
    single = mesh.data_size * mesh.model_size == 1
    use_scan = (single if args.scan_epoch is None else args.scan_epoch) and args.max_steps is None
    if args.scan_epoch is True and args.max_steps is not None:
        say("NOTE: --scan_epoch=True is ignored because --max_steps requires the per-batch "
            "chain (the scanned epoch cannot stop mid-epoch).")

    schedule = cosine_warmup_schedule(args.lr, args.warmup, args.epochs, steps_per_epoch)
    optimizer = AdamW(model.model, schedule, args.weight_decay, grad_clip=0.5, mesh=mesh)
    ema = EMA(model.model, 0.99)
    ckpt = CheckpointManager(args.checkpoint_dir, {"config": vars(args)}, mesh)
    timer = EpochTimer()
    jlog = JsonlLogger(os.path.join(args.checkpoint_dir, "metrics.jsonl") if mesh.is_main
                       else None)

    def evaluate(split: str) -> float:
        """The split's MSE on the EMA weights; advances the key chain as the
        JAX CLI's pass does (its keys go unused: no augmentation)."""
        nonlocal key
        acc = MeanMetrics()
        results = []
        for b in batches(split, False):
            if not use_scan:
                key, _ = prng.split(key)
            results.append(eval_step(model, shard_batch(b, mesh), ema=ema))
        if use_scan:
            key, _ = prng.split(key)
        for m in gather_metrics(results):
            acc.update(m)
        return acc.compute().get("mse", float("nan"))

    def epoch_batches():
        """(batch, k_rot) of an epoch's training steps, from the chain."""
        nonlocal key
        if not use_scan:
            for batch in batches("train", True):
                key, k_rot, _ = prng.split(key, 3)
                yield batch, k_rot
            return
        key, k_ep = prng.split(key)
        kp, k_loop = prng.split(k_ep)
        idx = threefry.permutation(kp, n_train, device)[:steps_per_epoch * bs]
        arrays = splits["train"]
        for s in range(steps_per_epoch):
            k_loop, k_rot, _ = prng.split(k_loop, 3)
            chunk = idx[s * bs:(s + 1) * bs]
            yield NBodyBatch(*(a[chunk] for a in arrays)), k_rot

    best = float("inf")
    global_step = 0
    warm_seconds, warm_steps = 0.0, 0
    log_every = 1 if args.epochs <= 500 else args.val_interval
    for epoch in range(args.epochs):
        timer.epoch_start()
        pending = []
        t_loop = time.perf_counter()
        for batch, k_rot in epoch_batches():
            if args.train_augm:
                rotations = random_so3_matrix(k_rot, (len(batch.pos),), device=device)
                batch = rotate_nbody_batch(rotations, batch)
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
        if epoch % log_every == 0 or epoch == args.epochs - 1:
            say(f"epoch {epoch} | train MSE {t.get('mse', float('nan')):.6f} | {dt:.1f}s",
                flush=True)

        if (epoch + 1) % args.val_interval == 0 or epoch == args.epochs - 1:
            v = evaluate("valid")
            say(f"epoch {epoch} | valid MSE {v:.6f}", flush=True)
            jlog.log({"epoch": epoch, "step": global_step, "train/mse": t.get("mse"),
                      "epoch_s": dt, "valid/mse": v})
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
    test_mse = evaluate("test")
    say(f"test MSE {test_mse:.6f}")
    jlog.log({"step": global_step, "test/mse": test_mse})
    return test_mse


if __name__ == "__main__":
    main()
