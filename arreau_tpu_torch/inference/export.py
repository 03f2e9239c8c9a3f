"""Serving export: the whole reverse-diffusion sampler as one
``torch.export`` program; counterpart of ``arreau_tpu/inference/export.py``.

``torch.export`` captures the sampler of a checkpoint (its EMA weights by
default): the model code, the schedules, the reverse chain unrolled step
by step (strided or the full chain), the final lattice decode, and the
weights, saved with the program. The hand-written kernels stay in the
graph as the operators ``torch.ops.arreau_tpu_torch.*``
(``kernels/__init__.py`` registers them). A serving host loads and runs
the program with torch and an importable ``arreau_tpu_torch.kernels``
(which registers the operators and, at the first launch, builds the
kernel library): no checkpoint and no Python model definition.

A ``torch.Generator`` cannot live inside a program, so the program takes
the sampler's random numbers as inputs: the fields of
:class:`~arreau_tpu_torch.tasks.diffusion.SamplerNoise` named in the
sidecar's ``inputs`` (``angles`` only without ``diffuse_angles``), and
with ``variable_num_atoms`` the per-crystal counts ``num_atoms int64[B]``
last. It returns ``(frac_x [B, A, 3], atom_types [B, A], lattice [B, 3,
3])``. :func:`load_exported` wraps it into ``call(seed[, num_atoms])``,
which draws the noise as :meth:`DiffusionModel.sample` draws it from
``torch.Generator(device).manual_seed(seed)``, so that ``call(seed)``
gives that call's crystals.

Artifact layout: ``<out>`` holds the program (``torch.export.save``) and
``<out>.json`` a sidecar with the JAX export's keys (the calling
convention, shapes, the z-table for decoding type indices, the sampler
configuration, ``platforms`` ``["cuda"]`` or ``["cpu"]``) and the port's
(``inputs``, ``noise_steps``, ``num_atomic_states``, ``lattice_type``,
``diffuse_angles``, ``length_bounds``, ``export_seconds``). The program is
exported on the model's device and runs there.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch
from torch import nn

import arreau_tpu_torch.kernels  # noqa: F401  (registers the operators a loaded program calls)
from arreau_tpu_torch.tasks.diffusion import SamplerNoise, draw_sampler_noise, strided_levels

NOISE_FIELDS = ("ang_enc0", "lengths0", "frac0", "lattice", "angle", "pos", "types")
LATTICE_TYPE = "monoclinic"  # the sampler's default prior, as the JAX export's


class SamplerProgram(nn.Module):
    """The sampler as a module of its random numbers (``inputs``), for
    ``torch.export``; the backbone's parameters are its own."""

    def __init__(self, model, batch_size: int, num_atoms_per_sample: int, inputs: tuple,
                 **sample_kwargs):
        super().__init__()
        self.net = model.model
        self.model = model
        self.shape = (batch_size, num_atoms_per_sample)
        self.inputs = inputs
        self.sample_kwargs = sample_kwargs

    def forward(self, *args):
        given = dict(zip(self.inputs, args))
        num_atoms = given.pop("num_atoms", None)
        noise = SamplerNoise(angles=given.pop("angles", None), **given)
        batch = self.model._sample_impl(*self.shape, noise=noise, num_atoms=num_atoms,
                                        lattice_type=LATTICE_TYPE, **self.sample_kwargs)
        return batch.frac_x, batch.atom_types, batch.lattice


def noise_steps(num_timesteps: int, sample_steps: Optional[int]) -> int:
    """Reverse steps the sampler takes: the strided chain's pairs below
    ``T - 1`` steps, else the full chain's ``T - 1``."""
    if sample_steps is not None and sample_steps < num_timesteps - 1:
        return len(strided_levels(num_timesteps, sample_steps)) - 1
    return num_timesteps - 1


def export_sampler(
    checkpoint_dir: str,
    out_path: str,
    tag: str = "best",
    use_ema: bool = True,
    batch_size: int = 16,
    num_atoms_per_sample: int = 8,
    sample_steps: Optional[int] = None,
    ddim_eta: float = 0.0,
    type_temperature: float = 1.0,
    variable_num_atoms: bool = False,
    device="cuda",
) -> dict:
    """Export the sampler of ``checkpoint_dir/tag`` for ``batch_size`` x
    ``num_atoms_per_sample`` crystals on ``device`` into ``out_path`` (and
    the ``.json`` sidecar); returns the sidecar. The lattice-length clamp is
    the checkpoint's ``length_stats`` envelope where it has one, as the JAX
    export's. ``variable_num_atoms``: the program also takes the per-crystal
    counts ``num_atoms int64[B]`` (at most ``num_atoms_per_sample``, the pad
    size); padded slots diffuse inertly."""
    from arreau_tpu_torch.cli.generate import length_bounds_from_meta, load_model

    model, z_table, meta = load_model(checkpoint_dir, tag, use_ema, device)
    cfg, dev = model.config, model.device
    length_bounds = length_bounds_from_meta(meta)
    B, A = batch_size, num_atoms_per_sample
    S = noise_steps(cfg.num_timesteps, sample_steps)
    inputs = NOISE_FIELDS + (() if cfg.diffuse_angles else ("angles",))
    example = draw_sampler_noise(torch.Generator(device=dev).manual_seed(0), S, B, A,
                                 cfg.num_atomic_states, LATTICE_TYPE, cfg.diffuse_angles, dev)
    args = [getattr(example, name) for name in inputs]
    if variable_num_atoms:
        inputs += ("num_atoms",)
        args.append(torch.full((B,), A, dtype=torch.long, device=dev))
    program = SamplerProgram(model, B, A, inputs, length_bounds=length_bounds,
                             type_temperature=type_temperature, sample_steps=sample_steps,
                             ddim_eta=ddim_eta)
    t0 = time.perf_counter()
    # no_grad, not inference_mode (which torch.export does not take)
    with torch.no_grad():
        exported = torch.export.export(program, tuple(args))
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(exported, out_path)
    noise = ", ".join(f"{name}: {'int64[B]' if name == 'num_atoms' else 'float32'}"
                      for name in inputs)
    sidecar = {
        "calling_convention": (
            f"program({noise}) -> (frac_x [B,A,3] f32, atom_types [B,A] int64, "
            "lattice [B,3,3] f32)"
            + ("; slots >= num_atoms[b] are padding" if variable_num_atoms else "")
            + "; load with torch.export.load after importing arreau_tpu_torch.kernels (it "
            "registers the kernels' operators; the first CUDA launch builds libkernels.so), "
            "no checkpoint or model code needed; arreau_tpu_torch.inference.export."
            "load_exported(path) gives call(seed[, num_atoms]), the noise drawn from "
            "torch.Generator(device).manual_seed(seed)"),
        "variable_num_atoms": variable_num_atoms,
        "batch_size": B,
        "num_atoms_per_sample": A,
        "sample_steps": sample_steps,
        "ddim_eta": ddim_eta,
        "type_temperature": type_temperature,
        "use_ema": use_ema,
        "platforms": [dev.type],
        "z_table_zs": [int(z) for z in z_table.zs],
        "num_timesteps": int(cfg.num_timesteps),
        "bytes": os.path.getsize(out_path),
        "inputs": list(inputs),
        "noise_steps": S,
        "num_atomic_states": int(cfg.num_atomic_states),
        "lattice_type": LATTICE_TYPE,
        "diffuse_angles": bool(cfg.diffuse_angles),
        "length_bounds": list(length_bounds) if length_bounds is not None else None,
        "export_seconds": seconds,
    }
    with open(out_path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)
    return sidecar


def load_exported(path: str):
    """Load an exported sampler; returns ``(call, sidecar)``. ``call(seed[,
    num_atoms])`` draws the program's noise from
    ``torch.Generator(device).manual_seed(seed)`` on the program's device and
    returns ``(frac_x, atom_types, lattice)`` there."""
    with open(path + ".json") as f:
        sidecar = json.load(f)
    program = torch.export.load(path).module()
    device = torch.device(sidecar["platforms"][0])
    B, A = sidecar["batch_size"], sidecar["num_atoms_per_sample"]

    def call(seed: int, num_atoms=None):
        if (num_atoms is None) == sidecar["variable_num_atoms"]:
            raise ValueError("pass num_atoms exactly when the program was exported with "
                             "variable_num_atoms")
        noise = draw_sampler_noise(torch.Generator(device=device).manual_seed(int(seed)),
                                   sidecar["noise_steps"], B, A, sidecar["num_atomic_states"],
                                   sidecar["lattice_type"], sidecar["diffuse_angles"], device)
        args = [getattr(noise, name) for name in sidecar["inputs"] if name != "num_atoms"]
        if num_atoms is not None:
            args.append(torch.as_tensor(num_atoms, dtype=torch.long, device=device))
        with torch.no_grad():
            return program(*args)

    return call, sidecar
