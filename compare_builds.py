#!/usr/bin/env python3
"""Comparison of the CUDA kernels of this checkout with those of another
checkout of the port (an earlier commit), on one NVIDIA GPU.

Run from the repository root, with the other checkout unpacked into a
directory (for example ``git archive <commit> | tar -x -C other``):

    python3 compare_builds.py other

Captures, with this checkout's model, the float32 inputs of #3
``spatial_conv`` and #8 ``basis_h1`` in one sampler forward (128 x 8 atoms),
of #3, #8, #4 ``spatial_conv_bwd`` and #7 ``basis_mlp_bwd`` in one training
step (256 crystals x 16 atoms, hidden 200), and of #1 ``fiber_conv`` and #2
``fiber_conv_bwd`` in one ``fuse_fiber`` training step, as ``chip_smoke.py``
does, and the same two training steps in bfloat16; and, on the
``fuse_convnext`` path in bfloat16 with layer scale 1 (as ``chip_smoke.py``),
the inputs of #9 ``convnext_mlp`` in one sampler forward and of #9 and #10
``convnext_mlp_bwd`` in one training step, and the latter cast to float32;
and, through ``BasisMLP(fused=True, use_bias=False)`` on the invariants a
``fuse_fiber`` sampler forward and training step hand their basis MLP (as
``chip_smoke.py:fused_basis_calls``), the inputs of #5 ``fused_basis_mlp``
at both shapes and of #6 ``fused_basis_mlp_bwd`` at the training shape, in
float32 and bfloat16; and the inputs of #3 and of #4 with its window
cotangent (``window_grad``) in one training step of a backbone built with
``position_grads=True``, float32 and bfloat16; and the inputs of #3, #8, #4
and #7 in one N-body training step (100 systems of 5 bodies, the N-body
CLI's model). Then it calls each kernel wrapper of
this checkout twice and the other checkout's once on the same tensors
(each checkout builds its own kernel library into its own ``build/``).
The rules:

- every output of this checkout is the same on both calls (``torch.equal``):
  no kernel sums in an order that changes from call to call;
- the kernel instantiations whose arithmetic this build changed
  (``REDESIGNED``: #9 and #10 in bfloat16, on wgmma and TMA) are held
  within ``chip_smoke.KERNEL_REL_TOL`` of each output's scale in float32 and
  ``BF16_KERNEL_REL_TOL`` in bfloat16 (whose float32 outputs follow
  bfloat16 roundings too, as ``chip_smoke.py`` holds them);
- every other output equals the other build's bit for bit;
- the wrappers of ``REDESIGNED`` and ``TIMED`` (none in this build) are
  timed with CUDA events in this process on the calls both builds take,
  this build's before and after the other's twice, with the host's
  microseconds a call beside; the kernels the port calls through their
  PyTorch operators (``OPERATORS``, #3 and #8) through the operator
  (``torch.ops.arreau_tpu_torch.*``) in both builds, as the model calls
  them;
- end to end, in the same order: a training step (256 x 16, hidden 200)
  and a sampler forward (128 x 8) in float32 and in bfloat16, and an
  N-body training step, each build's model on the same seeded weights and
  inputs (``time_paths``).

Exits non-zero if a rule fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as smoke
from arreau_tpu_torch.ops import prng

PACKAGE = "arreau_tpu_torch"
# kernel wrapper -> the module of the port's kernels that defines it
MODULES = {"spatial_conv": "spatial_conv", "spatial_conv_bwd": "spatial_conv",
           "basis_h1": "basis_h1", "basis_mlp_bwd": "basis_mlp",
           "fiber_conv": "fiber_conv", "fiber_conv_bwd": "fiber_conv",
           "convnext_mlp": "convnext_mlp", "convnext_mlp_bwd": "convnext_mlp",
           "fused_basis_mlp": "fused_basis_mlp", "fused_basis_mlp_bwd": "fused_basis_mlp"}
# kernels whose arithmetic differs from the builds before this one's in the
# instantiations of the element types given (held to a tolerance; their
# other instantiations bit for bit), and kernels whose source changed without
# a change of arithmetic (held bit for bit); both timed in both builds
REDESIGNED = {"convnext_mlp": (torch.bfloat16,), "convnext_mlp_bwd": (torch.bfloat16,)}
TIMED = ()
# forward kernels the port calls through their PyTorch operators since the
# operators were registered: timed through the operator in this build and
# through the wrapper in the other
OPERATORS = ("spatial_conv", "basis_h1")
HOST_CALLS = 50
# a training step or sampler forward: PATH_BLOCKS blocks of PATH_RUNS timed calls
# (each after 3 warm-up calls); the host's other load only adds time, so the
# fastest block is the steadiest reading, the median beside it
PATH_BLOCKS, PATH_RUNS = 5, 10


def nbody_batch(dev):
    """100 seeded systems of 5 charged bodies (the N-body CLI's batch size),
    as the package in ``sys.modules`` takes them."""
    from arreau_tpu_torch.tasks.nbody import NBodyBatch

    g = torch.Generator().manual_seed(smoke.SEED)
    pos, vel, shift = (torch.randn((100, 5, 3), generator=g) for _ in range(3))
    charges = torch.where(torch.rand((100, 5), generator=g) < 0.5, -1.0, 1.0)
    return NBodyBatch(*(t.to(dev) for t in (pos, vel, charges, pos + 0.1 * shift)))


def nbody_model(dev):
    """The N-body CLI's model (``NBodyConfig()``) on seeded weights."""
    from arreau_tpu_torch.tasks.nbody import NBodyConfig, NBodyModel

    model = NBodyModel(NBodyConfig(), dev)
    model.init(prng.prng_key(smoke.SEED))
    return model


def captured_inputs(dev) -> dict:
    """{(path, kernel name): wrapper arguments} of the first call of each
    kernel on the nine paths, and of #5/#6's calls in both types."""
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
    model.model.init_parameters(prng.prng_key(smoke.SEED))
    noise = draw_sampler_noise(prng.prng_key(smoke.SEED), 1, smoke.BATCH,
                               smoke.ATOMS, cfg.num_atomic_states, "monoclinic", False, dev)
    with torch.inference_mode():
        inputs = smoke.first_step_inputs(model, noise)
        with smoke.capturing() as args:
            model.predict_scores(*inputs)
    captured.update({("serving", name): a for name, a in args.items()})
    # the invariants a fuse_fiber backbone hands its basis MLP, for #5/#6
    basis_attrs = {}
    model = DiffusionModel(dataclasses.replace(cfg, fuse_fiber=True), device=dev)
    model.model.init_parameters(prng.prng_key(smoke.SEED))
    with torch.inference_mode(), smoke.basis_input(model, basis_attrs, "serve"):
        model.predict_scores(*smoke.first_step_inputs(model, noise))

    batch = batch_to_device(pack_dense_batch(*smoke.training_chunk()), dev)
    train_cfg = dataclasses.replace(cfg, hidden_dim=smoke.TRAIN_HIDDEN, diffuse_angles=True)
    bf16_cfg = dataclasses.replace(train_cfg, compute_dtype="bfloat16")
    for path, c in (("training", train_cfg),
                    ("fuse_fiber training", dataclasses.replace(train_cfg, fuse_fiber=True)),
                    ("bf16 training", bf16_cfg),
                    ("fuse_fiber bf16 training", dataclasses.replace(bf16_cfg, fuse_fiber=True))):
        model = DiffusionModel(c, device=dev)
        model.init(prng.prng_key(smoke.SEED), batch)
        noise = draw_loss_noise(prng.prng_key(smoke.SEED),
                                *batch.atom_types.shape, c.num_atomic_states, c.num_timesteps,
                                True, dev)
        with smoke.capturing() as args, smoke.basis_input(model, basis_attrs, "train"):
            model.loss(batch, noise)[0].backward()
        captured.update({(path, name): a for name, a in args.items()})
        del model
    # plain tensors (the serving capture ran in inference mode); the first
    # fuse_fiber step's, float32
    basis_attrs = {k: v.clone() for k, v in basis_attrs.items()}
    for dtype in (torch.float32, torch.bfloat16):
        calls, _ = smoke.fused_basis_calls(basis_attrs, dtype, f"fused basis {dtype}")
        for shape, args in calls.items():
            captured.update({(f"fused basis {dtype} {shape}", name): a
                             for name, a in args.items()})

    # fuse_convnext in bfloat16, layer scale 1 (so that the MLP weighs in out)
    cn_cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", layer_scale=1.0)
    model = DiffusionModel(cn_cfg, device=dev)
    model.model = smoke.fused_convnext_backbone(model)
    model.model.init_parameters(prng.prng_key(smoke.SEED))
    noise = draw_sampler_noise(prng.prng_key(smoke.SEED), 1, smoke.BATCH,
                               smoke.ATOMS, cfg.num_atomic_states, "monoclinic", False, dev)
    with torch.inference_mode():
        inputs = smoke.first_step_inputs(model, noise)
        with smoke.capturing() as args:
            model.predict_scores(*inputs)
    captured.update({("fuse_convnext serving", name): a for name, a in args.items()
                     if name.startswith("convnext")})
    model = DiffusionModel(dataclasses.replace(bf16_cfg, layer_scale=1.0), device=dev)
    model.model = smoke.fused_convnext_backbone(model)
    model.init(prng.prng_key(smoke.SEED), batch)
    noise = draw_loss_noise(prng.prng_key(smoke.SEED),
                            *batch.atom_types.shape, cfg.num_atomic_states, cfg.num_timesteps,
                            True, dev)
    with smoke.capturing() as args:
        model.loss(batch, noise)[0].backward()
    for name, a in args.items():
        if name.startswith("convnext"):
            captured["fuse_convnext bf16 training", name] = a
            captured["fuse_convnext float32 training", name] = tuple(
                t.detach().float() if torch.is_tensor(t) else t for t in a)

    # position_grads: #3, and #4 with the window cotangent (the backbone built
    # with the flag, as a caller that differentiates through positions does)
    for path, c in (("position_grads training", train_cfg),
                    ("position_grads bf16 training", bf16_cfg)):
        model = DiffusionModel(c, device=dev)
        model.model = smoke.position_grads_backbone(model)
        model.init(prng.prng_key(smoke.SEED), batch)
        noise = draw_loss_noise(prng.prng_key(smoke.SEED),
                                *batch.atom_types.shape, c.num_atomic_states, c.num_timesteps,
                                True, dev)
        with smoke.capturing() as args:
            model.loss(batch, noise)[0].backward()
        captured.update({(path, name): a for name, a in args.items()})
        del model

    model = nbody_model(dev)
    with smoke.capturing() as args:
        model.loss(nbody_batch(dev))[0].backward()
    captured.update({("nbody training", name): a for name, a in args.items()})
    return captured


def wrapper(name: str):
    """Kernel wrapper ``name`` of the package in ``sys.modules``."""
    return getattr(importlib.import_module(f"{PACKAGE}.kernels.{MODULES[name]}"), name)


def run_kernels(captured: dict) -> dict:
    """{key: output tuple} of the wrappers of the package in ``sys.modules``."""
    outputs = {}
    with torch.no_grad():
        for (path, name), args in captured.items():
            outputs[path, name] = smoke.as_tuple(wrapper(name)(*args))
    torch.cuda.synchronize()
    return outputs


def host_us(fn, args) -> float:
    """Host microseconds a call of ``fn`` takes to return (launches queue
    behind each other; the device is waited for after)."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn(*args)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / HOST_CALLS * 1e6


def time_redesigned(captured: dict) -> dict:
    """{key: (ms per call, host microseconds per call)} of the package's
    wrappers of the REDESIGNED and TIMED kernels, the OPERATORS kernels
    through their operators."""
    times = {}
    with torch.no_grad():
        for (path, name), args in captured.items():
            if name not in (*REDESIGNED, *TIMED, *OPERATORS):
                continue
            fn = wrapper(name)
            if name in OPERATORS:
                fn = getattr(torch.ops.arreau_tpu_torch, name)
            times[path, name] = (smoke.cuda_ms(lambda: fn(*args)), host_us(fn, args))
    return times


def block_ms(fn) -> tuple:
    """(fastest, median) of PATH_BLOCKS CUDA-event means of PATH_RUNS calls."""
    blocks = sorted(smoke.cuda_ms(fn, runs=PATH_RUNS) for _ in range(PATH_BLOCKS))
    return blocks[0], blocks[len(blocks) // 2]


def time_paths(dev) -> dict:
    """{path: (fastest, median) ms per call} of a training step (256 x 16,
    hidden 200, ``diffuse_angles``) and a sampler forward (128 x 8) in
    float32 and bfloat16, and of an N-body training step (float32), the
    models, optimizer and step of the package in ``sys.modules`` on seeded
    weights (``block_ms``: CUDA events, the host's launch gaps included)."""
    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.data.crystal import pack_dense_batch
    from arreau_tpu_torch.tasks.diffusion import (
        DiffusionConfig,
        DiffusionModel,
        batch_to_device,
        draw_loss_noise,
        draw_sampler_noise,
    )
    from arreau_tpu_torch.train.loop import train_step
    from arreau_tpu_torch.train.optim import AdamW

    cfg = DiffusionConfig(num_atomic_states=len(synthetic_z_table()))
    batch = batch_to_device(pack_dense_batch(*smoke.training_chunk()), dev)
    times = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=None if dtype == "float32" else dtype)
        model = DiffusionModel(c, device=dev)
        model.model.init_parameters(prng.prng_key(smoke.SEED))
        noise = draw_sampler_noise(prng.prng_key(smoke.SEED), 1, smoke.BATCH, smoke.ATOMS,
                                   c.num_atomic_states, "monoclinic", False, dev)
        with torch.inference_mode():
            inputs = smoke.first_step_inputs(model, noise)
            times[f"{dtype} sampler forward"] = block_ms(lambda: model.predict_scores(*inputs))
        c = dataclasses.replace(c, hidden_dim=smoke.TRAIN_HIDDEN, diffuse_angles=True)
        model = DiffusionModel(c, device=dev)
        model.init(prng.prng_key(smoke.SEED), batch)
        noise = draw_loss_noise(prng.prng_key(smoke.SEED), *batch.atom_types.shape,
                                c.num_atomic_states, c.num_timesteps, True, dev)
        optimizer = AdamW(model.model, lambda count: 1e-3, weight_decay=1e-10)
        times[f"{dtype} training step"] = block_ms(
            lambda: train_step(model, optimizer, None, batch, noise))
        del model, optimizer
    model, nbody = nbody_model(dev), nbody_batch(dev)
    optimizer = AdamW(model.model, lambda count: 1e-3, weight_decay=1e-10)
    times["float32 nbody training step"] = block_ms(
        lambda: train_step(model, optimizer, None, nbody))
    return times


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


def reregister_operators() -> None:
    """Registers this checkout's operators again: importing the other
    checkout's package re-registered ``torch.ops.arreau_tpu_torch.*`` with
    its wrappers (``torch.library.custom_op`` replaces an operator of the
    same name), which would then call this checkout's kernel library with
    the other's argument lists."""
    for module in sorted(set(MODULES.values())):
        importlib.reload(importlib.import_module(f"{PACKAGE}.kernels.{module}"))


def differences(want: dict, got: dict) -> dict:
    """{(key, output index): None where bit-equal, else max |difference|}."""
    diffs = {}
    for key, outs in want.items():
        for i, (a, b) in enumerate(zip(outs, got[key])):
            if a is None or b is None:  # an output without a readout
                if (a is None) != (b is None):
                    raise RuntimeError(f"{key} output {i}: None in one build only")
                diffs[key, i] = None
                continue
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
    ours_ms, ours_paths = time_redesigned(captured), time_paths(dev)
    with package_from(other):
        other_build = importlib.import_module(f"{PACKAGE}.kernels.build")
        print(f"{other}'s nvcc build: {other_build.build_library():.2f} s")
        theirs = differences(ours, run_kernels(captured))
        theirs_ms = [time_redesigned(captured) for _ in range(2)]
        theirs_paths = [time_paths(dev) for _ in range(2)]
    reregister_operators()
    ours_ms = [ours_ms, time_redesigned(captured)]
    ours_paths = [ours_paths, time_paths(dev)]
    ok = True
    for (key, i), diff in theirs.items():
        a = ours[key][i]
        if a is None:
            continue
        line = (f"{key[0]} {key[1]} output {i} {tuple(a.shape)} {a.dtype}: "
                f"{'equal' if diff is None else f'differs by up to {diff:.3e}'} in {other.name}")
        if again[key, i] is not None:
            line += f"; VARIES from call to call in this build, by up to {again[key, i]:.3e}"
            ok = False
        bf16 = any(torch.is_tensor(t) and t.dtype == torch.bfloat16 for t in captured[key])
        if (torch.bfloat16 if bf16 else torch.float32) in REDESIGNED.get(key[1], ()):
            tol = smoke.BF16_KERNEL_REL_TOL if bf16 else smoke.KERNEL_REL_TOL
            rel = (diff or 0.0) / max(a.float().abs().max().item(), 1e-30)
            line += f" (rel {rel:.3e}, tolerance {tol:g})"
            ok &= rel <= tol
        else:
            ok &= diff is None
        print(line)
    for key in ours_ms[0]:
        mine = sum(t[key][0] for t in ours_ms) / 2
        old = sum(t[key][0] for t in theirs_ms) / 2
        how = "operator" if key[1] in OPERATORS else "wrapper"
        print(f"{key[0]} {key[1]}: this build's {how} {ours_ms[0][key][0]:.4f} / "
              f"{ours_ms[1][key][0]:.4f} ms, {other.name}'s {how} {theirs_ms[0][key][0]:.4f} / "
              f"{theirs_ms[1][key][0]:.4f} ms (CUDA events, {smoke.TIMED_RUNS} calls each): "
              f"{old / mine:.2f}x; host {ours_ms[0][key][1]:.1f} / {ours_ms[1][key][1]:.1f} us a "
              f"call against {theirs_ms[0][key][1]:.1f} / {theirs_ms[1][key][1]:.1f} "
              f"({HOST_CALLS} calls)")
    for path in ours_paths[0]:
        mine = min(t[path][0] for t in ours_paths)
        old = min(t[path][0] for t in theirs_paths)
        print(f"{path}: this build " + " / ".join(f"{t[path][0]:.4f} ({t[path][1]:.4f})"
                                                 for t in ours_paths) +
              f" ms, {other.name}'s " + " / ".join(f"{t[path][0]:.4f} ({t[path][1]:.4f})"
                                                   for t in theirs_paths) +
              f" ms (fastest (median) of {PATH_BLOCKS} blocks of {PATH_RUNS} calls, CUDA "
              f"events; this build first and last): fastest {old / mine:.3f}x")
    print("every rule holds" if ok else "a rule failed")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
