"""Export a trained sampler as a ``torch.export`` serving artifact;
counterpart of ``arreau_tpu/cli/export_sampler.py``, with its flags and
defaults and the port's ``--device`` (default ``cuda``; it never falls back
to the CPU).

Usage::

    python -m arreau_tpu_torch.cli.export_sampler --checkpoint_dir ckpt \\
        --out out/sampler.pt2 --batch_size 100 --num_atoms_per_sample 8 --sample_steps 100

Serving (torch, with ``arreau_tpu_torch.kernels`` importable)::

    from arreau_tpu_torch.inference.export import load_exported
    call, sidecar = load_exported("out/sampler.pt2")
    frac, types, lattice = call(7)   # seed

See :mod:`arreau_tpu_torch.inference.export`.
"""

from __future__ import annotations

import argparse

import torch

from arreau_tpu_torch.cli.common import parse_bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export the sampler with torch.export")
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--tag", type=str, default="best")
    p.add_argument("--use_ema", type=parse_bool, default=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_atoms_per_sample", type=int, default=8)
    p.add_argument("--sample_steps", type=int, default=100,
                   help="strided (DDIM-family) reverse steps (default 100, the JAX export's "
                        "serving point); pass 0 for the full T-step chain")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--type_temperature", type=float, default=1.0)
    p.add_argument("--variable_num_atoms", type=parse_bool, default=False,
                   help="export the size-matched serving variant: the program takes "
                        "num_atoms int64[B] per call (counts <= num_atoms_per_sample = pad size)")
    p.add_argument("--out", type=str, required=True, help="output artifact path")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the program is exported for and runs on; 'cuda' raises "
                        "where CUDA is unavailable")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available; pass --device cpu")
    from arreau_tpu_torch.inference.export import export_sampler

    sidecar = export_sampler(
        args.checkpoint_dir,
        args.out,
        tag=args.tag,
        use_ema=args.use_ema,
        batch_size=args.batch_size,
        num_atoms_per_sample=args.num_atoms_per_sample,
        sample_steps=args.sample_steps or None,  # 0 -> the full chain
        ddim_eta=args.ddim_eta,
        type_temperature=args.type_temperature,
        variable_num_atoms=args.variable_num_atoms,
        device=device,
    )
    chain = (f"strided S={args.sample_steps} (DDIM eta={args.ddim_eta})" if args.sample_steps
             else "full ancestral chain")
    print(f"exported {args.checkpoint_dir}/{args.tag} -> {args.out} "
          f"({sidecar['bytes'] / 1e6:.2f} MB, platforms {sidecar['platforms']}, "
          f"{sidecar['batch_size']}x{sidecar['num_atoms_per_sample']} crystals/call, "
          f"serving point: {chain}; export {sidecar['export_seconds']:.2f} s)")
    return sidecar


if __name__ == "__main__":
    main()
