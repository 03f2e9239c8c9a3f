"""Convert a reference (PyTorch Lightning) PONITA_DIFFUSION ``.ckpt`` into a
checkpoint directory of the port; counterpart of
``arreau_tpu/cli/import_checkpoint.py``, with its arguments. A file
conversion on the CPU: it launches nothing on a card.

    python -m arreau_tpu_torch.cli.import_checkpoint --ckpt path/to/epoch=...-step=....ckpt \\
        --out_dir checkpoints-imported
    python -m arreau_tpu_torch.cli.generate --checkpoint_dir checkpoints-imported --tag best ...

The parameter map and the approximations it inherits are in
:mod:`arreau_tpu_torch.interop.torch_import`. The loader unpickles the
whole file: convert only checkpoints you trust.
"""

from __future__ import annotations

import argparse

from arreau_tpu_torch.interop.torch_import import convert_reference_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Import a reference PONITA_DIFFUSION .ckpt")
    p.add_argument("--ckpt", type=str, required=True, help="reference Lightning .ckpt path")
    p.add_argument("--out_dir", type=str, required=True, help="output checkpoint directory")
    p.add_argument("--tag", type=str, default="best", help="tag to save under (default: best)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    meta = convert_reference_checkpoint(args.ckpt, args.out_dir, tag=args.tag)
    cfg = meta["config"]
    print(
        f"imported {args.ckpt} -> {args.out_dir}/{args.tag} "
        f"(hidden {cfg['hidden_dim']}, basis {cfg['basis_dim']}, "
        f"{cfg['num_layers']} layers, {cfg['num_ori']} orientations, "
        f"{cfg['num_atomic_states']} atomic states)"
    )
    print(f"generate with: python -m arreau_tpu_torch.cli.generate --checkpoint_dir "
          f"{args.out_dir} --tag {args.tag}")
    return meta


if __name__ == "__main__":
    main()
