#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (orbax, ``arreau_tpu``) into the
layout the PyTorch port's generate CLI reads.

Run from the repository root, where the JAX package and orbax import:

    python3 convert_jax_checkpoint.py --checkpoint_dir out/r4/ckpt_ang_on \\
        --tag best --out_dir ported_ckpt/ang_on --readout_bf16_operands true

It restores the tag as ``arreau_tpu/cli/generate.py:load_model`` does
(``CheckpointManager.restore_raw``, the dict or the TrainState-tuple
layout) and writes:

- ``<out_dir>/meta.json``: the checkpoint's ``config``, ``z_table_zs`` and
  ``length_stats``, and ``fourier_w``, the time embedding's frequencies as
  the JAX model holds them (``DiffusionModel.fourier_w``, or the meta's own
  ``fourier_w`` where it carries one), so the port never relies on its
  own draw for them; ``ori_grid``, the JAX model's S^2 orientation grid
  (``arreau_tpu/ops/grids.py:cached_grid_s2`` at the config's ``num_ori``,
  float64), which the port's own draw reproduces only within 2e-9; and
  ``readout_bf16_operands`` where
  ``--readout_bf16_operands`` is true: the port then computes the readout
  from bfloat16 operands, as a TPU computes the JAX package's float32
  readout at DEFAULT precision (``arreau_tpu_torch/models/ponita.py``). Set
  it for a checkpoint trained on a TPU;
- ``<out_dir>/<tag>/params.npz``: the parameter tree, flat and
  ``'/'``-joined (``arreau_tpu_torch/interop/from_jax.py:save_params_npz``),
  float32 as stored, compressed; and ``ema_params.npz`` beside it where the
  checkpoint holds EMA weights and ``--use_ema`` is true (the default, as
  the JAX CLI's).

Before writing, the tree is loaded into the port's model on the CPU: a
parameter that the port's name table does not map fails the conversion.
This script imports both packages; nothing in the port imports it.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from arreau_tpu_torch.cli.common import parse_bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Convert a JAX checkpoint for the PyTorch port")
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--tag", type=str, default="last", help="checkpoint tag (last/best)")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--use_ema", type=parse_bool, default=True,
                   help="also write the tag's EMA weights (ema_params.npz) where it has them")
    p.add_argument("--readout_bf16_operands", type=parse_bool, default=False,
                   help="serve the readout from bfloat16 operands, as the checkpoint's TPU "
                        "computed it; true for a checkpoint trained on a TPU")
    return p.parse_args(argv)


def restore_trees(checkpoint_dir: str, tag: str):
    """(meta, params tree, EMA tree or None, fourier_w) of one tag, read as
    the JAX generate CLI reads them."""
    from arreau_tpu.tasks.diffusion import DiffusionConfig, DiffusionModel
    from arreau_tpu.train.checkpoint import CheckpointManager

    ckpt = CheckpointManager(checkpoint_dir)
    meta = ckpt.load_meta()
    raw = ckpt.restore_raw(tag)
    if isinstance(raw, (list, tuple)):  # TrainState tuple order
        params_tree, ema_tree = raw[1], raw[3]
    else:
        params_tree, ema_tree = raw["params"], raw.get("ema_params")
    if meta.get("fourier_w") is not None:
        fourier_w = np.asarray(meta["fourier_w"], np.float32)
    else:
        fourier_w = np.asarray(DiffusionModel(DiffusionConfig(**meta["config"])).fourier_w,
                               np.float32)
    return meta, params_tree, ema_tree, fourier_w


def jax_ori_grid(meta: dict) -> np.ndarray:
    """The JAX model's S^2 grid for the checkpoint's config, ``[num_ori,
    3]`` float64."""
    from arreau_tpu.ops.grids import cached_grid_s2
    from arreau_tpu.tasks.diffusion import DiffusionConfig

    return cached_grid_s2(DiffusionConfig(**meta["config"]).num_ori)


def check_tree(meta: dict, tree, fourier_w) -> None:
    """Load ``tree`` into the port's model on the CPU; raises where a
    parameter on either side is not matched."""
    from arreau_tpu_torch.interop.from_jax import params_from_jax
    from arreau_tpu_torch.tasks.diffusion import DiffusionConfig, DiffusionModel

    model = DiffusionModel(DiffusionConfig(**meta["config"]), device="cpu", fourier_w=fourier_w)
    params_from_jax(model, tree)


def convert(checkpoint_dir: str, tag: str, out_dir: str, use_ema: bool = True,
            readout_bf16_operands: bool = False) -> list[str]:
    """Write the port's checkpoint of one tag; returns the files written."""
    from arreau_tpu_torch.interop.from_jax import save_params_npz

    meta, params_tree, ema_tree, fourier_w = restore_trees(checkpoint_dir, tag)
    trees = {"params": params_tree}
    if use_ema and ema_tree is not None:
        trees["ema_params"] = ema_tree
    for tree in trees.values():
        check_tree(meta, tree, fourier_w)

    os.makedirs(os.path.join(out_dir, tag), exist_ok=True)
    out_meta = {"config": meta["config"], "z_table_zs": meta["z_table_zs"]}
    if meta.get("length_stats") is not None:
        out_meta["length_stats"] = meta["length_stats"]
    out_meta["fourier_w"] = [float(w) for w in fourier_w]
    out_meta["ori_grid"] = jax_ori_grid(meta).tolist()
    if readout_bf16_operands:
        out_meta["readout_bf16_operands"] = True
    written = [os.path.join(out_dir, "meta.json")]
    with open(written[0], "w") as f:
        json.dump(out_meta, f, indent=2)
        f.write("\n")
    for name, tree in trees.items():
        path = os.path.join(out_dir, tag, f"{name}.npz")
        save_params_npz(path, tree)
        written.append(path)
    return written


def main(argv=None):
    args = parse_args(argv)
    for path in convert(args.checkpoint_dir, args.tag, args.out_dir, args.use_ema,
                        args.readout_bf16_operands):
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
