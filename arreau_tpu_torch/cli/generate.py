"""Crystal generation CLI; counterpart of ``arreau_tpu/cli/generate.py``.

Reads a checkpoint directory as the JAX CLI does: ``<checkpoint_dir>/meta.json``
(the JAX package's schema: ``config``, ``z_table_zs``, optional
``fourier_w`` and ``length_stats``; and the port's optional
``readout_bf16_operands``, set for a checkpoint trained on a TPU, see
``models/ponita.py``) and the parameters of one tag
(``--tag``, default ``last``): ``<checkpoint_dir>/<tag>/ema_params.npz``
when ``--use_ema`` (the default) and that file exists, else
``<checkpoint_dir>/<tag>/params.npz`` (the parameter tree, flat and
``'/'``-joined, see ``interop/from_jax.py``). It runs the reverse sampler in
batches on ``--device`` (default ``cuda``; it never falls back to the CPU)
and writes ``crystals.h5`` (``inference/io.py``). A ``meta.json`` config with ``fuse_fiber``
set serves through the fused fiber conv kernels. ``--quality_ref`` (a
packed HDF5 shard, or ``synthetic[:size[:seed]]``) adds the sample-quality
report against that training set (``inference/quality.py``), printed and
written to ``quality.json``; ``--num_atoms_dist ref`` draws each crystal's
atom count from that set's histogram. ``--gif`` samples the last batch with snapshots
every ``--snapshot_every`` steps (the dense chain only), renders them under
``sampling_steps/`` and writes ``sampling.gif``; ``--visualize`` renders the
first four crystals (``crystal_{i}.png``); ``--show_bonds`` draws bonds in
both. The renders need matplotlib and PIL (``inference/visualize.py``),
checked before any sampling.

``--data_parallel`` (the default) under torchrun samples every batch over
the ranks (``parallel/mesh.py``): each rank draws the whole batch's noise
from the shared seed and samples its rows ``r::n``; rank 0 gathers the
crystals and alone writes and prints. A batch the ranks do not divide is
sampled whole on every rank (the JAX CLI's message). One process with more
than one visible card raises: the port runs a process per card.

    python -m torch.distributed.run --nproc_per_node 2 \
        -m arreau_tpu_torch.cli.generate --checkpoint_dir ckpt --batch_size 128 ...

    python -m arreau_tpu_torch.cli.generate --checkpoint_dir ckpt --tag best \\
        --batch_size 128 --num_atoms_per_sample 8 --num_crystals 256 \\
        --sample_steps 50 --out_dir out
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import numpy as np
import torch

from arreau_tpu_torch.cli.common import silent
from arreau_tpu_torch.data.atoms import AtomicNumberTable
from arreau_tpu_torch.data.crystal import CrystalDataset
from arreau_tpu_torch.inference.io import concat_results, from_dense_batch, save_sample_results
from arreau_tpu_torch.interop.from_jax import load_params_npz, params_from_jax
from arreau_tpu_torch.parallel.mesh import (
    Mesh,
    gather_rows,
    make_mesh,
    maybe_initialize_distributed,
    shard_rows,
)
from arreau_tpu_torch.tasks.diffusion import CrystalBatch, DiffusionConfig, DiffusionModel


def parse_bool(value: str) -> bool:
    if value.lower() in ("1", "true", "yes", "y"):
        return True
    if value.lower() in ("0", "false", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {value}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Generate crystals from a trained model")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--tag", type=str, default="last", help="checkpoint tag (last/best)")
    p.add_argument("--num_crystals", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--num_atoms_per_sample", type=int, default=4)
    p.add_argument("--use_ema", type=parse_bool, default=True,
                   help="sample the tag's EMA weights (ema_params.npz) when it has them")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="out")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    p.add_argument("--type_temperature", type=float, default=1.0,
                   help="gumbel scale for D3PM type draws (1.0 = reference semantics, "
                        "0.0 = posterior argmax)")
    p.add_argument("--sample_steps", type=int, default=None,
                   help="strided sampling over S levels; default: the full T-step chain")
    p.add_argument("--ddim_eta", type=float, default=0.0,
                   help="strided-mode stochasticity: 0 = deterministic DDIM, 1 = ancestral")
    p.add_argument("--constant_atomic_symbols", type=str, default=None,
                   help="comma-separated element symbols to pin atom types (e.g. 'C,C,C,C')")
    p.add_argument("--clip_denoised", type=parse_bool, default=True,
                   help="clamp the lattice-length x0-prediction to the checkpoint's "
                        "length_stats envelope")
    p.add_argument("--data_parallel", type=parse_bool, default=True,
                   help="data-parallel sampling over the ranks of a torchrun launch (the JAX "
                        "CLI's default); one process samples on its one device")
    p.add_argument("--visualize", type=parse_bool, default=False,
                   help="render the first four crystals to crystal_{i}.png (matplotlib, PIL)")
    p.add_argument("--show_bonds", type=parse_bool, default=False)
    p.add_argument("--gif", type=parse_bool, default=False,
                   help="render the sampling trajectory of the last batch as a GIF")
    p.add_argument("--snapshot_every", type=int, default=10)
    p.add_argument("--quality_ref", type=str, default=None,
                   help="training-data reference for the sample-quality report: a packed "
                        "HDF5 path, or 'synthetic[:size[:seed]]' to regenerate the synthetic "
                        "training set; writes <out_dir>/quality.json")
    p.add_argument("--num_atoms_dist", choices=["fixed", "ref"], default="fixed",
                   help="per-crystal atom counts: 'fixed' = num_atoms_per_sample each; 'ref' = "
                        "drawn from the --quality_ref histogram, capped at "
                        "num_atoms_per_sample (the pad size)")
    return p.parse_args(argv)


def reference_dataset(quality_ref: str):
    """The training set ``--quality_ref`` names: an HDF5 shard (its z-table
    its own Zs), or ``synthetic[:size[:seed]]`` (default size 2000, seed 0)."""
    if not quality_ref.startswith("synthetic"):
        return CrystalDataset([quality_ref])
    from arreau_tpu_torch.data.synthetic import synthetic_packed

    parts = quality_ref.split(":")
    size = int(parts[1]) if len(parts) > 1 else 2000
    seed = int(parts[2]) if len(parts) > 2 else 0
    return synthetic_packed(size, seed=seed)


@functools.lru_cache(maxsize=1)
def reference_stats(ds) -> dict:
    """``dataset_reference_stats`` of the training set ``ds``, kept for the
    last set asked for: they take most of a report's time, and a caller
    may report several results against one set."""
    from arreau_tpu_torch.inference.quality import dataset_reference_stats

    return dataset_reference_stats(ds.packed, ds.type_indices, len(ds.z_table))


def quality_from_results(result, z_table, ds) -> dict:
    """The sample-quality report of ``result`` against the training set
    ``ds`` (``reference_dataset``; the JAX CLI's report, key for key)."""
    from arreau_tpu_torch.inference.quality import quality_report

    ref = reference_stats(ds)
    return quality_report(
        gen_frac=result.frac_x,
        gen_types=z_table.zs_to_indices(result.atomic_numbers),
        gen_lattices=result.lattice,
        gen_idx_start=result.idx_start,
        gen_num_atoms=result.num_atoms,
        ref_lengths=ref["lengths"],
        ref_angles=ref["angles"],
        num_types=len(z_table),
        ref_type_mi=ref["type_mi"],
        ref_coord_hist=ref["coord_hist"],
        ref_mean_num_atoms=ref["mean_num_atoms"],
        ref_fingerprints=ref["fingerprints"],
    ) | {"ref_min_dist_violation_rate": ref["min_dist_violation_rate"]}


def params_path(checkpoint_dir: str, tag: str, use_ema: bool) -> str:
    """The tag's ``ema_params.npz`` when ``use_ema`` and it exists, else its
    ``params.npz`` (the JAX CLI's choice between ``ema_params`` and ``params``)."""
    ema = os.path.join(checkpoint_dir, tag, "ema_params.npz")
    if use_ema and os.path.exists(ema):
        return ema
    return os.path.join(checkpoint_dir, tag, "params.npz")


def load_model(checkpoint_dir: str, tag: str, use_ema: bool, device, say=print):
    """(model, z_table, meta) from ``<checkpoint_dir>/meta.json`` and the
    parameters :func:`params_path` picks."""
    with open(os.path.join(checkpoint_dir, "meta.json")) as f:
        meta = json.load(f)
    model = DiffusionModel(DiffusionConfig(**meta["config"]), device=device,
                           fourier_w=meta.get("fourier_w"),
                           readout_bf16_operands=meta.get("readout_bf16_operands", False))
    path = params_path(checkpoint_dir, tag, use_ema)
    params_from_jax(model, load_params_npz(path))
    say(f"loaded {path}")
    return model, AtomicNumberTable(meta["z_table_zs"]), meta


def length_bounds_from_meta(meta: dict):
    """Training-envelope clamp for the lattice-length x0-prediction, widened
    by half the data range on each side."""
    stats = meta.get("length_stats")
    if not stats:
        return None
    lo, hi = stats["min"], stats["max"]
    margin = 0.5 * max(hi - lo, 1.0)
    return (lo - margin, hi + margin)


def main(argv=None):
    args = parse_args(argv)
    if args.gif or args.visualize:
        # the renders need matplotlib and PIL: fail here, not after sampling
        from arreau_tpu_torch.inference.visualize import require_renderers

        require_renderers()
    if args.num_atoms_dist == "ref" and not args.quality_ref:
        raise SystemExit("--num_atoms_dist ref requires --quality_ref")
    # a missing or unreadable reference fails here, before any sampling
    reference = reference_dataset(args.quality_ref) if args.quality_ref else None
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
    _, world = maybe_initialize_distributed(device)
    if args.data_parallel and world == 1 and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"--data_parallel over {torch.cuda.device_count()} visible CUDA devices in one "
            "process: launch one process per card with `python -m torch.distributed.run "
            "--nproc_per_node N -m arreau_tpu_torch.cli.generate ...`, or pass "
            "--data_parallel false")
    mesh = make_mesh()
    main = mesh.is_main  # rank 0 alone prints and writes
    say = print if main else silent
    # the JAX CLI shards only over more than one device (its n_dev > 1)
    if not args.data_parallel or mesh.data_size == 1:
        mesh = Mesh()
    elif args.batch_size % mesh.data_size:
        say(f"batch_size {args.batch_size} not divisible by {mesh.data_size} devices; "
            "sampling on one device (pad batch_size to enable DP)")
        mesh = Mesh()
    else:
        say(f"data-parallel sampling over {mesh.data_size} devices")

    model, z_table, meta = load_model(args.checkpoint_dir, args.tag, args.use_ema, device,
                                      say)
    length_bounds = length_bounds_from_meta(meta) if args.clip_denoised else None
    if args.clip_denoised and length_bounds is None:
        say("checkpoint has no length_stats; clip_denoised disabled")

    constant_atoms = None
    if args.constant_atomic_symbols:
        symbols = args.constant_atomic_symbols.split(",")
        idx = torch.as_tensor(z_table.symbols_to_indices(symbols), device=device)
        constant_atoms = idx.expand(args.batch_size, len(symbols))
        args.num_atoms_per_sample = len(symbols)

    # size-matched generation: per-crystal atom counts drawn from the
    # reference's histogram, capped at the pad size, as the JAX CLI draws them
    draw_counts = None
    if args.num_atoms_dist == "ref":
        ref_counts = np.minimum(np.asarray(reference.packed.num_atoms), args.num_atoms_per_sample)
        rng_counts = np.random.default_rng(args.seed + 1)

        def draw_counts():
            return torch.as_tensor(rng_counts.choice(ref_counts, size=args.batch_size),
                                   dtype=torch.long, device=device)

    T = model.config.num_timesteps
    strided = args.sample_steps is not None and args.sample_steps < T - 1
    if args.gif and strided:
        say("gif snapshots are not supported with --sample_steps; disabling gif")
        args.gif = False
    generator = torch.Generator(device=device).manual_seed(args.seed)
    results = []
    snapshots = None
    remaining = args.num_crystals
    t_gen0, n_timed = None, 0  # the throughput clock starts after the first batch
    local_batch = args.batch_size // mesh.data_size
    while remaining > 0:
        num_atoms = draw_counts() if draw_counts is not None else None
        gif = args.gif and remaining <= args.batch_size
        kwargs = dict(constant_atoms=None if constant_atoms is None
                      else shard_rows(constant_atoms, mesh),
                      length_bounds=length_bounds, type_temperature=args.type_temperature,
                      num_atoms=None if num_atoms is None else shard_rows(num_atoms, mesh),
                      # the whole batch's noise from the shared generator, this rank's rows
                      noise=model.draw_noise(generator, args.batch_size, args.num_atoms_per_sample,
                                             None if gif else args.sample_steps).rows(mesh))
        if gif:
            # the last batch: the dense chain with snapshots for the GIF
            batch_out, snapshots = model.sample(local_batch, args.num_atoms_per_sample,
                                                snapshot_every=args.snapshot_every, **kwargs)
        else:
            batch_out = model.sample(local_batch, args.num_atoms_per_sample,
                                     sample_steps=args.sample_steps, ddim_eta=args.ddim_eta,
                                     **kwargs)
        batch_out = CrystalBatch(*(gather_rows(t, mesh) for t in batch_out))
        take = min(args.batch_size, remaining)
        results.append(from_dense_batch(CrystalBatch(*(t[:take] for t in batch_out)), z_table))
        remaining -= take
        if t_gen0 is None:
            t_gen0 = time.perf_counter()
        else:
            n_timed += take
        say(f"generated {args.num_crystals - remaining}/{args.num_crystals}")
    if n_timed > 0:
        dt = time.perf_counter() - t_gen0
        n_steps = args.sample_steps if strided else T
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        say(f"sampler throughput: {n_timed / dt * 60:.0f} crystals/min "
            f"({n_steps} reverse steps, warm, {name})")
    result = concat_results(results)
    if not main:
        return result

    if snapshots:
        from arreau_tpu_torch.inference.visualize import generate_gif, vis_crystal_during_sampling

        snap_dir = os.path.join(args.out_dir, "sampling_steps")
        for timestep, snap in snapshots:
            vis_crystal_during_sampling(
                z_table, snap.atom_types[0].cpu().numpy(), snap.lattice[0].cpu().numpy(),
                snap.frac_x[0].cpu().numpy(), os.path.join(snap_dir, f"step_{timestep}"),
                args.show_bonds)
        generate_gif(snap_dir, os.path.join(args.out_dir, "sampling.gif"), prefix="step")
        print(f"wrote {args.out_dir}/sampling.gif")

    out_path = os.path.join(args.out_dir, "crystals.h5")
    save_sample_results(out_path, result)
    print(f"saved {result.num_crystals} crystals to {out_path}")

    if args.quality_ref:
        report = quality_from_results(result, z_table, reference)
        print("sample quality vs training data:")
        for k, v in report.items():
            print(f"  {k}: {v:.4f}")
        qpath = os.path.join(args.out_dir, "quality.json")
        with open(qpath, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {qpath}")

    if args.visualize:
        from arreau_tpu_torch.inference.visualize import plot_crystal

        for i in range(min(result.num_crystals, 4)):
            frac, zs, lat = result.crystal(i)
            plot_crystal(frac, zs, lat, os.path.join(args.out_dir, f"crystal_{i}.png"),
                         show_bonds=args.show_bonds)
        print(f"rendered PNGs under {args.out_dir}")
    return result


if __name__ == "__main__":
    main()
