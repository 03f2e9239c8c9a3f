"""MD17 energy and force training CLI; counterpart of
``arreau_tpu/cli/train_md17.py``, with its flag set and ``--device``.

Reads a revised-MD17 npz given as ``--npz`` (kcal/mol converted to meV);
otherwise ``--synthetic_size`` synthetic molecules with analytic forces.
Shift the training energies' mean, scale the RMS of the training forces,
the loss E-MSE / lambda_F + F-MSE (the forces -dE/dpos, so a training step
is a double backward), SO(3) augmentation, clip + AdamW + EMA 0.99,
validation with the EMA weights every ``--val_interval`` epochs (``best``
by the force MAE), and a test pass on ``best`` averaged over
``--repeats`` random rotations. Runs on ``--device`` (default ``cuda``; it
never falls back to the CPU).

``--seed`` gives the JAX CLI's random numbers: its parameters, numpy's
shuffles and the rotations of its key chain (``cli/common.py:step_keys``;
a validation or test batch advances the chain by one split) and the test's
rotations (``split(k_eval, repeats)``, one key a repeat).

    python -m arreau_tpu_torch.cli.train_md17 --epochs 300

Under torchrun (``python -m torch.distributed.run --nproc_per_node N -m
arreau_tpu_torch.cli.train_md17 ...``) the ranks train data-parallel
(``parallel/mesh.py``): every rank draws the same global batch and
augmentation from the shared seed and takes rows ``r::n`` of it; the loss
is a plain mean over shards of equal size (the energy MSE over frames, the force MSE
over real atoms, frames of one molecule having the same atoms; the forces
are ``torch.autograd.grad`` inside each rank), so the ranks average
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
from arreau_tpu_torch.data.molecules import (
    MoleculeExamples,
    load_rmd17_npz,
    synthetic_molecules,
)
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.ops.grids import random_so3_matrix
from arreau_tpu_torch.parallel.mesh import data_mean, shard_batch, shard_rows, shard_state
from arreau_tpu_torch.tasks.md17 import (
    KCAL_TO_MEV,
    MD17Batch,
    MD17Config,
    MD17Model,
    rotate_md17_batch,
)
from arreau_tpu_torch.train.checkpoint import CheckpointManager
from arreau_tpu_torch.train.loop import eval_step, gather_metrics, train_step
from arreau_tpu_torch.train.metrics import EpochTimer, JsonlLogger, MeanMetrics
from arreau_tpu_torch.train.optim import AdamW, cosine_warmup_schedule
from arreau_tpu_torch.train.state import EMA


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Ponita on MD17 energy+force")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--weight_decay", type=float, default=1e-10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val_interval", type=int, default=5)
    p.add_argument("--train_augm", type=parse_bool, default=True)
    p.add_argument("--npz", type=str, default=None, help="path to an rMD17 npz file")
    p.add_argument("--target", type=str, default="aspirin")
    p.add_argument("--lambda_F", type=float, default=500.0)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--train_size", type=int, default=950)
    p.add_argument("--val_size", type=int, default=50)
    p.add_argument("--synthetic_size", type=int, default=1200)
    p.add_argument("--radius", type=parse_opt_float, default=None)
    p.add_argument("--max_neighbors", type=int, default=8)
    p.add_argument("--num_ori", type=int, default=-1)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--basis_dim", type=int, default=256)
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--widening_factor", type=int, default=4)
    p.add_argument("--layer_scale", type=float, default=0.0)
    p.add_argument("--multiple_readouts", type=parse_bool, default=True)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints-md17")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
    mesh, say = data_parallel_setup(device, args.batch_size)

    if args.npz:
        data = load_rmd17_npz(args.npz)
        # kcal/mol -> meV, as the reference's transform (MoleculeExamples's
        # __len__, the number of molecules, breaks its _replace)
        data = MoleculeExamples(data.pos, data.one_hot, data.mask, data.y * KCAL_TO_MEV,
                                data.forces * KCAL_TO_MEV)
    else:
        say("no --npz given; using synthetic molecules with analytic forces")
        data = synthetic_molecules(args.synthetic_size, seed=args.seed, with_forces=True)

    rng = np.random.default_rng(args.seed)
    perm = rng.permutation(len(data))
    tr = perm[:args.train_size]
    va = perm[args.train_size:args.train_size + args.val_size]
    te = perm[args.train_size + args.val_size:]
    shift = float(np.mean(data.y[tr]))
    scale = float(np.sqrt(np.mean(data.forces[tr] ** 2)))
    say(f"md17 shift {shift:.3f} scale {scale:.3f}")

    cfg = MD17Config(
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
        lambda_F=args.lambda_F,
        lifted=args.num_ori == -1,
    )
    model = MD17Model(cfg, shift, scale, device)
    # the whole set on the device once; a batch is an index into it
    on_device = MD17Batch(
        pos=torch.as_tensor(data.pos, dtype=torch.float32, device=device),
        one_hot=torch.as_tensor(data.one_hot, dtype=torch.float32, device=device),
        mask=torch.as_tensor(data.mask, device=device),
        energy=torch.as_tensor(data.y, dtype=torch.float32, device=device),
        force=torch.as_tensor(data.forces, dtype=torch.float32, device=device),
    )
    bs = args.batch_size

    def batches(idx, shuffle):
        order = rng.permutation(idx) if shuffle else idx
        for s in range(0, len(order) - bs + 1, bs):
            chunk = torch.as_tensor(order[s:s + bs], device=device)
            yield MD17Batch(*(a[chunk] for a in on_device))

    key, init_key = prng.split(prng.prng_key(args.seed))
    model.init(init_key, next(batches(tr, False)))
    n_params = sum(p.numel() for p in model.model.parameters())
    shard_state(model, mesh)
    steps_per_epoch = max(len(tr) // bs, 1)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"md17 model: {n_params / 1e6:.2f}M params | steps/epoch {steps_per_epoch}")
    say(f"device: {name}")

    schedule = cosine_warmup_schedule(args.lr, args.warmup, args.epochs, steps_per_epoch)
    optimizer = AdamW(model.model, schedule, args.weight_decay, grad_clip=0.5, mesh=mesh)
    ema = EMA(model.model, 0.99)
    ckpt = CheckpointManager(args.checkpoint_dir,
                             {"config": vars(args), "shift": shift, "scale": scale}, mesh)
    timer = EpochTimer()
    jlog = JsonlLogger(os.path.join(args.checkpoint_dir, "metrics.jsonl") if mesh.is_main
                       else None)

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
                batch = rotate_md17_batch(random_so3_matrix(k_rot, (bs,), device=device), batch)
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
        say(f"epoch {epoch} | train E-MAE {t.get('mae_energy', 0):.4f} "
            f"F-MAE {t.get('mae_force', 0):.4f} | {dt:.1f}s", flush=True)
        if (epoch + 1) % args.val_interval == 0 or epoch == args.epochs - 1:
            vm = MeanMetrics()
            results = []
            for b in batches(va, False):
                key, _ = prng.split(key)  # the JAX CLI's k_eval, which its loss leaves unused
                results.append(eval_step(model, shard_batch(b, mesh), ema=ema))
            for m in gather_metrics(results):
                vm.update(m)
            v = vm.compute()
            vf = v.get("mae_force", float("nan"))
            say(f"epoch {epoch} | valid E-MAE {v.get('mae_energy', 0):.4f} F-MAE {vf:.4f}",
                flush=True)
            jlog.log({"epoch": epoch, "step": global_step,
                      "valid/mae_energy": v.get("mae_energy"), "valid/mae_force": vf})
            ckpt.save("last", model, optimizer, ema)
            if vf < best:
                best = vf
                ckpt.save("best", model, optimizer, ema)
        if args.max_steps and global_step >= args.max_steps:
            break

    if warm_steps > 0:
        say(f"train throughput: {warm_steps / warm_seconds:.3f} steps/s ({warm_steps} warm "
            f"steps, {name})")
    say(timer.summary())

    # test with rotation-repeat averaging, on the EMA weights
    if ckpt.has("best"):
        ckpt.restore("best", model, optimizer, ema)
    e_maes, f_maes = [], []
    with ema.swapped_in(model.model), torch.no_grad():
        for batch in batches(te, False):
            # one rotation key a repeat: split(k_eval, repeats), one launch for all
            key, k_eval = prng.split(key)
            rotations = random_so3_matrix(prng.split(k_eval, args.repeats), (bs,), device=device)
            results = model.test_repeats(shard_batch(batch, mesh), shard_rows(rotations, mesh, 1))
            # [repeats, 2] energy and force MAEs, averaged over equal shards
            maes = data_mean({"mae": torch.stack([torch.stack(r) for r in results])}, mesh)["mae"]
            e_maes.append([float(r[0]) for r in maes])
            f_maes.append([float(r[1]) for r in maes])
    if e_maes:
        e_avg, f_avg = np.mean(e_maes, axis=0), np.mean(f_maes, axis=0)
        for r in range(args.repeats):
            say(f"test MAE x{r + 1}: energy {e_avg[r]:.4f} force {f_avg[r]:.4f}")
        jlog.log({"step": global_step, "test/mae_energy": float(e_avg[-1]),
                  "test/mae_force": float(f_avg[-1])})
        return float(f_avg[-1])
    return None


if __name__ == "__main__":
    main()
