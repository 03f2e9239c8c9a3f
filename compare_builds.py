#!/usr/bin/env python3
"""Bit-for-bit comparison of the float32 CUDA kernels of this checkout with
those of another checkout of the port (an earlier commit), on one NVIDIA GPU.

Run from the repository root, with the other checkout unpacked into a
directory (for example ``git archive <commit> | tar -x -C other``):

    python3 compare_builds.py other

Captures, with this checkout's model, the float32 inputs of #3
``spatial_conv`` and #8 ``basis_h1`` in one sampler forward (128 x 8 atoms),
of #3, #8, #4 ``spatial_conv_bwd`` and #7 ``basis_mlp_bwd`` in one training
step (256 crystals x 16 atoms, hidden 200), and of #1 ``fiber_conv`` and #2
``fiber_conv_bwd`` in one ``fuse_fiber`` training step, as ``chip_smoke.py``
does. Then it calls each kernel wrapper of this checkout twice and the
other checkout's once on the same tensors (each checkout builds its own
kernel library into its own ``build/``). Every output that is the same on
both calls of this checkout must equal the other's bit for bit
(``torch.equal``); an output that varies from call to call (a sum in no
fixed order) is reported with both differences. Exits non-zero if an output
that must be equal differs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as smoke

PACKAGE = "arreau_tpu_torch"
# kernel wrapper -> the module of the port's kernels that defines it
MODULES = {"spatial_conv": "spatial_conv", "spatial_conv_bwd": "spatial_conv",
           "basis_h1": "basis_h1", "basis_mlp_bwd": "basis_mlp",
           "fiber_conv": "fiber_conv", "fiber_conv_bwd": "fiber_conv"}


def captured_inputs(dev) -> dict:
    """{(path, kernel name): wrapper arguments} of the first call of each
    float32 kernel on the three paths."""
    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.data.crystal import pack_dense_batch
    from arreau_tpu_torch.tasks.diffusion import (
        DiffusionConfig,
        DiffusionModel,
        batch_to_device,
        draw_loss_noise,
        draw_sampler_noise,
    )

    cfg = DiffusionConfig(num_atomic_states=len(synthetic_z_table()))
    captured = {}
    model = DiffusionModel(cfg, device=dev)
    model.model.init_parameters(torch.Generator(device=dev).manual_seed(smoke.SEED))
    noise = draw_sampler_noise(torch.Generator(device=dev).manual_seed(smoke.SEED), 1, smoke.BATCH,
                               smoke.ATOMS, cfg.num_atomic_states, "monoclinic", False, dev)
    with torch.inference_mode():
        inputs = smoke.first_step_inputs(model, noise)
        with smoke.capturing() as args:
            model.predict_scores(*inputs)
    captured.update({("serving", name): a for name, a in args.items()})

    batch = batch_to_device(pack_dense_batch(*smoke.training_chunk()), dev)
    train_cfg = dataclasses.replace(cfg, hidden_dim=smoke.TRAIN_HIDDEN, diffuse_angles=True)
    for path, c in (("training", train_cfg),
                    ("fuse_fiber training", dataclasses.replace(train_cfg, fuse_fiber=True))):
        model = DiffusionModel(c, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(smoke.SEED), batch)
        noise = draw_loss_noise(torch.Generator(device=dev).manual_seed(smoke.SEED),
                                *batch.atom_types.shape, c.num_atomic_states, c.num_timesteps,
                                True, dev)
        with smoke.capturing() as args:
            model.loss(batch, noise)[0].backward()
        captured.update({(path, name): a for name, a in args.items()})
        del model
    return captured


def run_kernels(captured: dict) -> dict:
    """{key: output tuple} of the wrappers of the package in ``sys.modules``."""
    outputs = {}
    with torch.no_grad():
        for (path, name), args in captured.items():
            module = importlib.import_module(f"{PACKAGE}.kernels.{MODULES[name]}")
            outputs[path, name] = smoke.as_tuple(getattr(module, name)(*args))
    torch.cuda.synchronize()
    return outputs


@contextlib.contextmanager
def package_from(root: Path):
    """While active, ``import arreau_tpu_torch`` imports the copy in ``root``."""
    def loaded():
        return [k for k in sys.modules if k.split(".")[0] == PACKAGE]

    saved = {k: sys.modules.pop(k) for k in loaded()}
    sys.path.insert(0, str(root))
    try:
        package = importlib.import_module(PACKAGE)
        if not Path(package.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"{PACKAGE} came from {package.__file__}, not from {root}")
        yield
    finally:
        sys.path.remove(str(root))
        for k in loaded():
            del sys.modules[k]
        sys.modules.update(saved)


def differences(want: dict, got: dict) -> dict:
    """{(key, output index): None where bit-equal, else max |difference|}."""
    diffs = {}
    for key, outs in want.items():
        for i, (a, b) in enumerate(zip(outs, got[key])):
            equal = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            diffs[key, i] = None if equal else (a.float() - b.float()).abs().max().item()
    return diffs


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_builds: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    other = Path(argv[0]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from arreau_tpu_torch.kernels import build

    print(f"this checkout's nvcc build: {build.build_library():.2f} s")
    captured = captured_inputs(dev)
    print(f"captured {len(captured)} kernel calls: {sorted(captured)}")
    ours = run_kernels(captured)
    again = differences(ours, run_kernels(captured))
    with package_from(other):
        other_build = importlib.import_module(f"{PACKAGE}.kernels.build")
        print(f"{other}'s nvcc build: {other_build.build_library():.2f} s")
        theirs = differences(ours, run_kernels(captured))
    same = True
    for (key, i), diff in theirs.items():
        a = ours[key][i]
        line = (f"{key[0]} {key[1]} output {i} {tuple(a.shape)} {a.dtype}: "
                f"{'equal' if diff is None else f'differs by up to {diff:.3e}'} in {other.name}")
        if again[key, i] is not None:
            # an output that varies between two calls of one build (sums in no
            # fixed order) has no bits to hold the other build to
            line += f"; varies run to run in this build, by up to {again[key, i]:.3e}"
        else:
            same &= diff is None
        print(line)
    print("every output that is the same on every call is equal bit for bit" if same
          else "some outputs differ")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
