#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: the sampler and
the training path of the crystal-diffusion model, on the default conv
path, on the fused fiber conv path (``fuse_fiber``), in bfloat16
(``compute_dtype="bfloat16"``), on the fused ConvNext path
(``fuse_convnext``, bfloat16) and on the fused fiber conv path in
bfloat16, and ``BasisMLP(fused=True)``, every CUDA kernel against its
plain PyTorch version; the trained flagship checkpoint, served with the
JAX flagship report's command, its sample quality held to a gate; the
N-body and MNIST-superpixels backbone tasks through their training CLIs,
N-body's valid MSE held to a gate; gradients through atom positions
(``position_grads``: #4's window cotangent); the QM9 and MD17
point-cloud tasks through their training CLIs; and the sampler's and
trainer's remaining surface: snapshot sampling, the renders, the serving
export (#3/#8 as PyTorch operators in a ``torch.export`` program) and the
training CLI's ``--log`` and ``--profiler torch``; and a reference
Lightning checkpoint imported and served, the conv-kernel calibration, the
equivariance check, the sampler diagnosis and the EDA tools; and data and
tensor parallelism (``arreau_tpu_torch/parallel``) on the one card: NCCL at
world size 1, and gloo ranks sharing the card; and the crystal data on disk
(HDF5 shards and ``crystals.h5``, read and written without h5py); and the
ConvNext blocks rematerialised in the backward (``remat``).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its elapsed seconds and raising on any failure:

1. device: requires CUDA; prints the card's name and power limit (nvidia-smi).
2. build: builds the port's CUDA kernels (one nvcc process per source, all
   at once, then one link) or loads a current build; starts cuobjdump on
   the library in the background for phase 43.
3. serving kernels: captures the inputs each forward kernel gets in one
   full-width forward of the sampler (batch 128 x 8 atoms), holds both
   against their plain PyTorch versions and times kernel, plain version and
   a library yardstick with CUDA events.
4. sampler path: writes a seeded full-width checkpoint (random weights;
   ``meta.json`` and ``last/params.npz``) and runs the generate CLI on it:
   256 crystals, batch 128 x 8 atoms, 50 strided steps. Checks the crystals
   and that every forward went through both forward kernels and no other
   (launch counts, set to 0 just before the path).
5. forward reference: one backbone forward of the full-width model on
   realistic crystals, CUDA kernel branch against the plain branch on the
   CPU, on one neighbour list.
6. training kernels: captures the inputs of all four kernels (forwards
   spatial_conv and basis_h1, backwards spatial_conv_bwd and basis_mlp_bwd)
   in one training step at the canonical shape (256 crystals x 16 atoms,
   hidden 200), holds each against its plain version and times it.
7. training step: one training step's time at that batch (CUDA events) and
   where it goes (torch.profiler: the device's busy share and its largest
   kernels).
8. training reference: one training step's loss terms and every parameter
   gradient on the card's kernel branch against the CPU's plain branch, on
   one neighbour list.
9. training path: the training CLI on the synthetic dataset at batch 256,
   hidden 200, for TRAIN_STEPS steps. Checks that every step launched each
   forward kernel once per layer / once, and each backward kernel once per
   layer / once, and that every loss is finite; prints steps/s.
10. trained sampling: the generate CLI on the checkpoint the training path
   wrote (``--tag best``, its EMA weights where it kept them).
11. fiber kernels: captures the fused fiber conv's inputs (#1) in one
   ``fuse_fiber`` sampler forward (128 x 8) and #1's and #2's in one
   ``fuse_fiber`` training step (256 x 16), holds both against their plain
   versions and times kernel, plain version and library chain.
12. fiber sampler path: the sampler path on a ``fuse_fiber`` checkpoint:
   every forward launches #1 once per layer and no other kernel.
13. fiber training: one ``fuse_fiber`` training step on the card's kernel
   branch against the CPU's plain branch (as phase 8), then the step time
   at 256 x 16, its launches (#1 and #2 once per layer, no other kernel)
   and its profile (as phase 7).
14. bf16 kernels: the bfloat16 instantiations of #3 and #8 on one bfloat16
   sampler forward (128 x 8) and of #3, #8, #4 and #7 on one bfloat16
   training step (256 x 16), each against its bfloat16 plain version
   (1e-2 of each output's scale), timed; bounds at the bf16 tensor-core
   rate.

Every kernel (all ten run their products on the tensor cores) is also
called twice on its captured inputs, in both types (phases 3, 6, 11, 14,
17, 19, 21): every output must repeat bit for bit. Every float32 bound is
taken at the 3xTF32 rate (TF32X3_FLOP_PER_S), every bf16 bound at the bf16
tensor-core rate. Every step profile lists #4's, #2's, #7's and #10's
inner launches by name and time.
15. bf16 training reference: one bfloat16 training step, card kernel branch
   against CPU plain branch (loss terms 5e-3, gradients 5e-2), without and
   with ``fuse_convnext``.
16. bf16 training path: the training CLI with ``--compute_dtype bfloat16``
   (as phase 9: 5/1/5/1 launches of #3/#8/#4/#7 a step, no other kernel),
   then the step time and profile at 256 x 16; and the generate CLI on its
   checkpoint (``--tag best``: 5 of #3 and 1 of #8 a forward).
17. convnext kernels: #9 on one ``fuse_convnext`` bfloat16 sampler forward
   and #9/#10 on one such training step (layer scale 1, so that the MLP
   weighs in ``out``), with and without the readout, against their plain
   versions, timed; and the float32 instantiations on the same values.
18. fuse_convnext path: a bfloat16 ``fuse_convnext`` training step (5 of
   #9, #10, #3 and #4, 1 of #8 and #7, nothing else), its time and
   profile; then 256 crystals through ``DiffusionModel.sample`` (5 of #9
   and #3 and 1 of #8 a forward).
19. fiber bf16 kernels: the bfloat16 instantiations of #1 on one
   ``fuse_fiber`` bfloat16 sampler forward and of #1/#2 on one such
   training step, against their bfloat16 plain versions, timed.
20. fuse_fiber bf16 path: a ``fuse_fiber`` bfloat16 training step, card
   kernel branch against CPU plain branch (as phase 15), its time, its
   launches (#1 and #2 once per layer, no other kernel) and profile; then
   the generate CLI on a checkpoint whose ``meta.json`` carries
   ``fuse_fiber`` and ``compute_dtype="bfloat16"`` (5 of #1 a forward).
21. fused basis kernels: ``BasisMLP(fused=True, use_bias=False)`` at the
   canonical basis width, weights from numpy, on the invariants phase 11
   captured (training and serving shapes), float32 and bfloat16: one
   launch of #5 a forward and of #6 a backward and no plain version, then
   each kernel against its plain version and a second call of its own,
   timed beside the library chain.
22. trained flagship: the generate CLI on the trained flagship checkpoint
   (``ported_ckpt/ang_on``, the JAX package's ``out/r4/ckpt_ang_on`` tag
   ``best`` converted by ``convert_jax_checkpoint.py``; bfloat16,
   ``diffuse_angles``, its readout from bfloat16 operands as on the TPU it
   was trained on) with the JAX flagship report's command: 500
   crystals in batches of 100 x 8 atoms, 100 strided steps, no length
   clamp, the quality report against ``synthetic:20000:0``. Checks that
   every forward launched the bfloat16 #3 once per layer and the bfloat16
   #8 once and no other kernel, prints the shape, the warm crystals/min
   over batches 2-5 and the call's wall time, the report's 18 values
   beside the JAX report's; then the process_results CLI on those crystals
   on the card, which must lower the mean soft-sphere energy; and raises if
   a value left its gate (FLAGSHIP_GATE).
23. backbone tasks: nbody: the dataset's train split (10000 systems)
   drawn on the card from JAX's key, ``split(PRNGKey(43))[1]``, against
   ``prng.py``'s draws (charges bit for bit, positions and velocities
   within STREAM_NORMAL_ULP), and the default chain's first shuffle of the
   3000 training systems (``jax.random.permutation``, two sorting rounds)
   against ``prng.permutation`` bit for bit; the threefry kernel at their
   shapes (a round's bits [3000] beside ``torch.randperm``, the normals
   [10000, 5, 3]); then the N-body training CLI with the JAX Makefile's
   ``train-nbody`` recipe cut at 1200 steps (40 epochs, the per-batch
   chain; the dataset simulated on the card from JAX's keys into a
   temporary directory): every step launched 5 of #3 and #4 and 1 of #8
   and #7 and nothing else, and the valid MSE at epoch 39 is within
   NBODY_GATE_MSE; then #3/#8/#4/#7 captured in one full-width step (B'=4,
   TA=125, d=2) against their plain versions (``*_nbody`` records), one
   batch card kernel branch against CPU plain branch (forward, loss, every
   gradient), the step's time and profile; then the default (scan) chain,
   2 epochs without ``--max_steps``: the same launches a step, 2 threefry
   launches an epoch (the shuffle's rounds) and 1 a step (the rotations),
   the loss finite and falling; then 60 steps of ``--model egnn`` (no
   kernel; the loss finite and falling).
24. backbone tasks: mnist: the MNIST training CLI at full width on 960
   synthetic digits for 40 steps on the JAX CLI's chain (4/4/1/1 launches
   a step, the loss finite and falling), the four kernels at its shapes
   (B'=96, TA=75, C=64, ``*_mnist`` records), one batch card against CPU,
   the step's time.
25. position gradients: the diffusion backbone built with
   ``position_grads=True`` at the training shape (256 x 16, hidden 200),
   float32 and bfloat16: #4 with its window cotangent captured in one
   training step against its plain version and a second call of its own,
   timed (``spatial_conv_bwd_dwin*`` records); the step's launches (5 of #3
   and of #4, nothing else), time, profile and peak memory; the gradient of
   a scalar of the scores with respect to the fractional coordinates and
   lattice lengths on 32 crystals of 8 atoms, card kernel branch against CPU
   plain branch on one graph topology (1e-3 of scale float32, 5e-2 bf16).
26. backbone tasks: qm9: the QM9 training CLI on its synthetic defaults
   (2000 molecules, batch 96, full width) for 48 steps on the JAX CLI's
   chain: no kernel launch,
   the loss finite and falling; 8 molecules card against CPU (loss and
   every parameter gradient); a step's time, profile and peak memory.
27. backbone tasks: md17: the same for the MD17 CLI (1200 molecules, batch
   16, lambda_F 500, 40 steps; the test's rotations one key a repeat), the
   forces card against CPU too, and the gradients those of a double
   backward.
28. snapshot sampling: the trained flagship's dense chain (999 steps) on
   16 x 8 with a snapshot every 10 steps: 100 snapshots labelled 989, 979,
   ..., 9, 0, 5 bf16 #3 and 1 bf16 #8 a forward and nothing else, the final
   batch equal bit for bit to the chain without snapshots; its seconds.
29. renders: where matplotlib and PIL import, generate ``--gif --visualize
   --show_bonds`` on the flagship (16 x 8): ``sampling.gif``, its 100
   frames and the crystals' PNGs; where either does not, generate ``--gif``
   raises its ImportError before any kernel launch. It prints which ran.
30. serving export: export_sampler on the flagship at 100 x 8, 10 strided
   steps, fixed and ``variable_num_atoms``: no launch in the export; the
   artifact (``load_exported``, ``call(0)``) launches 10 x (5 #3 + 1 #8)
   and nothing else and gives the in-process sampler's crystals from the
   same seed (types equal, frac and lattice within 1e-6; bit for bit
   reported); export seconds, artifact bytes, crystals/min of the artifact
   against the in-process sampler over 3 warm calls.
31. training CLI leftovers: the training CLI at batch 256, hidden 200, two
   epochs, ``--log true --profiler torch``: the notice of a missing wandb,
   a non-empty Chrome trace of epoch 1 naming the port's kernels, steps/s
   and the device's idle share beside the 35-step phase's steps/s (both
   prefetch their batches).
32. reference import: the seeded full-width model (``DiffusionConfig``
   defaults) written as a Lightning-shaped ``.ckpt`` under the reference's
   key names (with the hyper-parameter namespace and an object whose class
   does not import), converted by ``python -m
   arreau_tpu_torch.cli.import_checkpoint`` in a subprocess, then generate
   on the result (256 crystals, 128 x 8, 50 steps): the imported weights
   (``params.npz`` and ``ema_params.npz``) equal the source's bit for bit,
   5 #3 and 1 #8 a forward and nothing else, and the crystals equal bit for
   bit those of generate on the source weights from the same seed; the
   import's seconds and both runs' warm crystals/min.
33. calibration: ``calibrate_conv_kernels`` on one noisy batch's backbone
   inputs at the training cell (256 x 16, hidden 200, float32, layer scale
   1), on the card
   (5 #3 and 1 #8, nothing else) and on the CPU's plain branch with the
   same weights and neighbour list: stds and rescaled kernels within
   KERNEL_REL_TOL; each layer's std before and after.
34. equivariance check: (a) the port's ``verify_equivariance.main()``, the
   JAX tool's command (40 epochs, hidden 32, 2 layers, 8 orientations):
   2 #3, 2 #4, 1 #8 and 1 #7 a training step and nothing else, 2 #3 and 1
   #8 an evaluation forward and each of the comparison's 128 forwards; (b)
   ``compare_components`` on the trained flagship (bf16, 64 shared draws,
   5 bf16 #3 and 1 bf16 #8 a forward); both tables beside the JAX TPU log's
   (``JAX_EQUIVARIANCE_TPU``), the gaps printed, not gated; 4 draws of each
   on the card against the CPU's plain branch on one topology, every loss
   term (float32: KERNEL_REL_TOL of the term; bf16: BF16_DRAW_REL_TOL of
   the draw's total loss).
35. sampler diagnosis: ``diagnose_sampler`` on the flagship at 64 x 8, the
   dense chain's 999 steps recorded every 25: 5 bf16 #3 and 1 bf16 #8 a step
   and nothing else, 7 threefry draws for the whole chain, every record
   finite and written; its noise the JAX tool's own chain (``PRNGKey(0)``
   split into the prior's keys and a loop key, one split of it a step):
   the prior and the first and last steps' fields against ``prng.py``'s
   draws (uniforms bit for bit, normals within STREAM_NORMAL_ULP); its
   first 3 steps on the card against the CPU's plain branch with the same
   noise on one topology (BF16_DRAW_REL_TOL of scale); the JSON's path and
   the chain's seconds.
36. EDA tools: ``dataset_stats`` on 2000 synthetic crystals,
   ``vp_prior_check`` (its gate must print PASS), ``lattice_eda`` (its
   statistics, then the renderer branch taken) and ``view_crystals
   generated`` on phase 32's ``crystals.h5`` (its ImportError before any
   work where the card has no matplotlib).
37. NCCL, world size 1: the training CLI at the training cell (256 x 16,
   hidden 200, basis 256, 5 layers, 16 orientations, ``diffuse_angles``,
   10 steps) under ``python -m torch.distributed.run --nproc_per_node 1``
   (NCCL) and without the launcher, same seed: every step's metrics bit
   for bit.
38. DP on one card: 2 gloo ranks sharing the card (the script launches
   itself as the ranks, ``chip_smoke.py --rank dp DIR``), data 2: one
   training step at the training cell (256 crystals globally, 128 a rank),
   float32 and bfloat16, against the one-process card step on the same
   batch and noise (loss terms 1e-5 relative; gradients and parameters
   after the step 1e-3 of scale, bf16 5e-2); 5/1/5/1 launches of
   #3/#8/#4/#7 on each rank; each rank's step milliseconds; then generate
   ``--data_parallel true`` on 2 ranks at 128 x 8, S = 50, against one
   process (integer fields equal, coordinates and lattices within 1e-4).
39. TP on one card: 4 gloo ranks, data 2 x model 2: a float32 step on the
   default branch and a bfloat16 ``fuse_convnext`` step (#9/#10 on weights
   gathered whole) against the one-process card step (the same gates; the
   bf16 loss terms 1e-3), the local shape of a split weight, the launches
   and step milliseconds of each rank.
40. HDF5 data (no h5py): (a) every ``out/**/crystals.h5`` of the checkout
   through the port's reader (``data/hdf5.py``), and the quality report of
   ``out/r4/q_ang_s100`` recomputed against its recorded ``--quality_ref
   synthetic:20000:0`` and held to its ``quality.json`` (1e-12); (b) an
   Alexandria-schema ``json.bz2`` of 2000 synthetic crystals through
   ``data/prep.py`` (its shard and take-10 shard bit for bit), and
   ``synthetic:20000:0`` written as a packed shard by ``write_packed_h5``,
   read back bit for bit (load seconds and MB/s), and a 100000-crystal
   shard's read against ``np.load`` of the same arrays; (c) the training
   CLI at the training cell (256 x 16, hidden 200) for HDF5_STEPS steps on
   ``--dataset alexandria`` (the prepped shard) and on ``--dataset
   synthetic`` (the same crystals): 5/1/5/1 launches of #3/#8/#4/#7 a step
   and nothing else, the metrics bit for bit where the z-tables agree, the
   steps/s of both; (d) generate on the shard run's checkpoint with
   ``--quality_ref <shard> --num_atoms_dist ref``: 5 #3 and 1 #8 a forward,
   its ``crystals.h5`` read back bit for bit, its report equal to the one
   against ``synthetic:20000:0``; then process_results on that file.
41. remat: the training cell (256 x 16, hidden 200, ``diffuse_angles``)
   with ``remat`` off and on, the same seeded weights and noise, float32,
   bfloat16 and ``fuse_convnext`` bfloat16: the loss terms bit for bit and
   every gradient within REMAT_GRAD_REL_TOL of its scale (printed: bit for
   bit or not); a step's launches (with ``remat`` 10 of #3, and of #9
   under ``fuse_convnext``; #8/#4/#7/#10 unchanged) over the counted and
   the timed steps; the peak memory of one loss and backward and the step
   time (CUDA events, 5 steps), both ways.
42. jax streams: the threefry kernel (JAX's random bits, uniforms and
   normals, float32 and bfloat16, for many keys a launch) at the sampler's
   bulk shape (the flagship's full chain: 999 steps' keys, 128 x 8 atoms,
   its 9 classes) and at the training shape (256 x 16) against its plain
   version on the card and ``ops/prng.py``'s numpy: bits and uniforms bit
   for bit, normals within 3 ulp; its time per launch beside the plain
   version's and ``torch.rand``/``torch.randn``'s. Then generate ``--seed
   0`` on the flagship with the JAX TPU run's command (``out/r4/q_ang_on``:
   500 crystals, 100 x 8, the full chain): the first batch's key split off
   ``PRNGKey(0)`` and its noise at steps 0 and 998 ``prng.py``'s for JAX's
   chain, 5 bf16 #3 and 1 bf16 #8 a forward and 7 threefry draws a batch;
   and how many crystals equal that run's (printed, no gate).
43. SASS check: in cuobjdump's SASS of the built library (dumped while the
   phases above ran), every instantiation of #8's and #7's kernels in both
   types and of #3's and #4's issues warpgroup products (HGMMA) and, but
   for the weight gradients whose threads stage both operands (#4's and #7's
   float32 dW), TMA loads (UTMALDG).

Every sampler and training path also counts the threefry kernel's
launches apart from the backbone's kernels (the noise is drawn before a
forward or a step): 7 a sampler batch, 5 a loss with ``diffuse_angles``
(4 without), checked wherever a phase runs ``sampler_path`` or
``counted_training``.

The last two lines are the kernels' JSON record (training-shape numbers;
``launches`` from the training paths, ``launches_sampler`` from the
sampler paths; bfloat16 instantiations as entries of their own, named
``*_bf16``; #9/#10 in bfloat16, their float32 instantiation, serving
shape and no-readout call beside; #5/#6 ``fused_basis_mlp*`` with the
launches of phase 21; ``*_nbody`` and ``*_mnist`` with the launches of
their CLI runs; ``spatial_conv_bwd_dwin*`` with the launches of phase 25's
steps; ``spatial_conv_bf16`` and ``basis_h1_bf16`` also with those of
phases 28, 30, 34 and 35; ``spatial_conv`` and ``basis_h1`` with those of
phases 32 and 33, and those two with #4/#7 with phase 34's; #3/#8/#4/#7
with ``launches_dp`` and ``launches_tp``, one count a rank, of phases 38
and 39, and #9/#10 with phase 39's; #3/#8/#4/#7 with ``launches_hdf5``
from phase 40's shard run; ``threefry`` with the launches of phases 9
and 4, of phase 42's full chain and of phase 23's scan chain, and its time
at the sampler's bulk shape, each field's in ``fields``, phase 23's N-body
shapes among them) and the result
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of the
repository beside it, the script exits non-zero before printing either.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from functools import reduce
from pathlib import Path

import numpy as np
import torch

from arreau_tpu_torch.ops import prng

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, and the dense
# bfloat16 tensor cores (the bound of the same work in bfloat16)
HBM_BYTES_PER_S = 3.35e12
# float32 products on the TF32 tensor cores (495 TFLOP/s) as 3xTF32, three
# TF32 products each: the rate every float32 kernel of the port is designed
# for (all ten run their products on the tensor cores)
TF32X3_FLOP_PER_S = 495e12 / 3
BF16_FLOP_PER_S = 989e12
TIMED_RUNS = 20
KERNEL_REL_TOL = 1e-4  # max |kernel - plain| / max |plain|: float32, other summation order
# bfloat16 kernel against its bfloat16 plain version: both sum in float32 and
# round at the same points, but a value next to a rounding boundary may
# round the other way (one bf16 ulp, 2^-8) and carry
BF16_KERNEL_REL_TOL = 1e-2
# a bfloat16 training step, card kernel branch against CPU plain branch: loss
# terms 5e-3 relative, every gradient 5e-2 of its largest entry (the two
# branches round at different points, as the JAX package's two do)
BF16_LOSS_REL_TOL = 5e-3
BF16_GRAD_REL_TOL = 5e-2
# a fuse_fiber training step's loss terms, card kernel branch vs CPU plain
# branch (the default path measured 7e-6 on the H100, PERF.md)
FIBER_LOSS_REL_TOL = 1e-5
# a training step's gradients, card kernel branch vs CPU plain branch: each
# parameter's max |difference| over its max |gradient| (float32 forward and
# backward through five layers in other summation orders)
GRAD_REL_TOL = 1e-3
BATCH, ATOMS, CRYSTALS, STEPS, SEED = 128, 8, 256, 50, 0
TRAIN_BATCH, TRAIN_HIDDEN, TRAIN_STEPS = 256, 200, 35  # 35 steps = 5 epochs of the synthetic set
# the trained flagship: the JAX package's checkpoint out/r4/ckpt_ang_on (tag
# best; bfloat16, diffuse_angles) converted by convert_jax_checkpoint.py, and
# the command of the JAX package's flagship quality report
FLAGSHIP = Path(__file__).resolve().parent / "ported_ckpt" / "ang_on"
# the HDF5 data phase: the committed crystals.h5 files under out/, the flagship
# report's crystals and their recorded reference, the training steps of each run
OUT = Path(__file__).resolve().parent / "out"
Q_ANG_S100 = OUT / "r4" / "q_ang_s100"
QUALITY_REF = "synthetic:20000:0"
HDF5_STEPS = 10
# threefry launches: a sampler batch draws its prior (angles or Bravais
# angles, lengths, coordinates) and its chain's four per-step fields
# (lattice, angle, coordinate normals, type uniforms) with one launch each;
# a loss its timesteps' bits, coordinate normals, type uniforms, lattice
# normals and, with diffuse_angles, angle normals
SAMPLER_DRAWS = 7
LOSS_DRAWS = {False: 4, True: 5}
FLAGSHIP_BATCH, FLAGSHIP_CRYSTALS, FLAGSHIP_STEPS = 100, 500, 100
# snapshot sampling (the flagship's dense chain, 16 crystals, a snapshot every
# 10 steps) and the serving export (the flagship's shape, 10 strided steps)
SNAPSHOT_BATCH, SNAPSHOT_EVERY, EXPORT_STEPS, EXPORT_TIMED_CALLS = 16, 10, 10, 3
# the training CLI's steps/s by its extra arguments (training_path)
CLI_RATES: dict = {}
FLAGSHIP_ARGS = [
    "--tag", "best", "--use_ema", "false", "--num_crystals", str(FLAGSHIP_CRYSTALS),
    "--batch_size", str(FLAGSHIP_BATCH), "--num_atoms_per_sample", str(ATOMS),
    "--clip_denoised", "false", "--sample_steps", str(FLAGSHIP_STEPS),
    "--quality_ref", "synthetic:20000:0", "--seed", str(SEED), "--device", "cuda",
]
# that report (out/r4/q_ang_s100/quality.json: the JAX package on a TPU in
# bfloat16, threefry noise), for comparison; the port's noise differs, so
# distributions and not values agree
JAX_FLAGSHIP_QUALITY = {
    "w1_lengths": 0.28462230018028467, "w1_angles_deg": 5.893216259985447,
    "gen_length_mean": 5.506813536726705, "gen_length_std": 1.8370363995707106,
    "ref_length_mean": 5.489797486362468, "length_in_range_frac": 0.9733333333333334,
    "min_dist_violation_rate": 0.124, "type_geometry_mi": 1.5466350093255676,
    "ref_type_geometry_mi": 2.0794279876374215, "coordination_tv_dist": 0.13523183556405355,
    "gen_mean_coordination": 3.4037499999999996, "ref_mean_coordination": 3.8286806883365196,
    "gen_mean_num_atoms": 8.0, "ref_mean_num_atoms": 12.97975, "coordination_comparable": 1.0,
    "uniqueness_frac": 1.0, "novelty_frac": 1.0, "ref_min_dist_violation_rate": 0.284,
}
# the quality gate, fixed from the JAX records alone: each band lies between
# the flagship (two JAX chains of the checkpoint: S=100 and the full chain)
# and the angles-fixed checkpoint (W1 lengths 1.448, W1 angles 15.99,
# violations 0.412, MI 0.656, mean length 4.12), so a wrong weight map, a lost
# angle diffusion or a broken bf16 path lands outside
FLAGSHIP_GATE = {  # field: (least, most)
    "w1_lengths": (None, 0.45),
    "w1_angles_deg": (None, 8.0),
    "min_dist_violation_rate": (None, 0.20),
    "type_geometry_mi": (1.25, None),
    "gen_length_mean": (5.51 - 0.30, 5.51 + 0.30),
    "uniqueness_frac": (0.95, None),
}


class Phase:
    """Prints a phase's name and, when it ends, its elapsed seconds."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        print(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s", flush=True)


class Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Mean milliseconds per call over ``runs`` calls, after warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensors_of(*items) -> list:
    """The tensors among ``items``, lists and tuples opened."""
    out = []
    for item in items:
        if torch.is_tensor(item):
            out.append(item)
        elif isinstance(item, (list, tuple)):
            out.extend(tensors_of(*item))
    return out


def nbytes(*items) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_of(*items))


def as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def training_chunk():
    """(synthetic set, chunk, bucket): the 16-atom bucket's fullest batch at
    the node budget TRAIN_BATCH x 16, 256 crystals (B' = 32 super-crystals
    of 128 atoms)."""
    from arreau_tpu_torch.data.crystal import BucketedLoader
    from arreau_tpu_torch.data.synthetic import synthetic_packed

    dataset = synthetic_packed(2000, seed=SEED)
    loader = BucketedLoader(dataset, np.arange(len(dataset)), node_budget=TRAIN_BATCH * 16)
    bucket, chunk = max(((b, c) for b, c in loader.chunks() if b == 16),
                        key=lambda bc: int((bc[1] >= 0).sum()))
    return dataset, chunk, bucket


def first_step_inputs(model, noise):
    """``predict_scores`` arguments of the sampler's first step."""
    B, A = noise.frac0.shape[:2]
    cfg, dev = model.config, model.device
    types = torch.full((B, A), cfg.num_atomic_states - 1, device=dev)
    return (noise.frac0, torch.nn.functional.one_hot(types, cfg.num_atomic_states).float(),
            torch.full((B,), cfg.num_timesteps - 1, device=dev), torch.full((B,), A, device=dev),
            noise.lengths0, noise.angles, torch.ones((B, A), dtype=torch.bool, device=dev))


def kernel_sites():
    """{kernel name: (module, attribute)} where the port looks each kernel
    wrapper up when it runs: the forwards' operators and the backwards'
    autograd Functions, eager or in a program ``torch.export`` saved."""
    from arreau_tpu_torch.kernels import (
        basis_h1,
        basis_mlp,
        convnext_mlp,
        fiber_conv,
        fused_basis_mlp,
        spatial_conv,
    )

    return {"spatial_conv": (spatial_conv, "spatial_conv"),
            "spatial_conv_bwd": (spatial_conv, "spatial_conv_bwd"),
            "basis_h1": (basis_h1, "basis_h1"),
            "basis_mlp_bwd": (basis_mlp, "basis_mlp_bwd"),
            "fiber_conv": (fiber_conv, "fiber_conv"),
            "fiber_conv_bwd": (fiber_conv, "fiber_conv_bwd"),
            "convnext_mlp": (convnext_mlp, "convnext_mlp"),
            "convnext_mlp_bwd": (convnext_mlp, "convnext_mlp_bwd"),
            "fused_basis_mlp": (fused_basis_mlp, "fused_basis_mlp"),
            "fused_basis_mlp_bwd": (fused_basis_mlp, "fused_basis_mlp_bwd")}


def wrappers() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in kernel_sites().items()}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    """Every kernel's count to 0, the threefry kernel's included."""
    from arreau_tpu_torch.kernels import threefry

    for fn in wrappers().values():
        fn.launches = 0
    threefry.threefry.launches = 0


def threefry_launches() -> int:
    """The threefry kernel's launches since the last reset. It is counted
    apart from ``kernel_sites()``: the noise is drawn outside the backbone's
    forwards and steps whose launches those checks hold."""
    from arreau_tpu_torch.kernels import threefry

    return threefry.threefry.launches


class Recorder:
    """Stands in for a kernel wrapper: keeps the arguments of its first call
    (and, given ``dtypes``, the element type of every call's first
    argument) and passes every call on. Its ``launches`` is the wrapper's
    (a wrapper counts through its module-level name, which is this object
    meanwhile)."""

    def __init__(self, fn, captured: dict, name: str, dtypes: dict | None = None):
        self.fn, self.captured, self.name, self.dtypes = fn, captured, name, dtypes

    def __call__(self, *args):
        self.captured.setdefault(self.name, args)
        if self.dtypes is not None:
            self.dtypes.setdefault(self.name, set()).add(args[0].dtype)
        return self.fn(*args)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


@contextlib.contextmanager
def capturing(dtypes: dict | None = None):
    """Records the arguments of the first call of each kernel wrapper (and
    into ``dtypes`` the element types each was called with)."""
    captured = {}
    originals = wrappers()
    for name, (mod, attr) in kernel_sites().items():
        setattr(mod, attr, Recorder(originals[name], captured, name, dtypes))
    try:
        yield captured
    finally:
        for name, (mod, attr) in kernel_sites().items():
            setattr(mod, attr, originals[name])


def conv_library(basis, w, x, src, win):
    """The spatial conv as a chain of library calls: the per-edge kernel by
    bmm, then gather, multiply, sum (PyTorch has no one call for it)."""
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    kern = torch.bmm(basis.reshape(Bp * O, E, D), w.expand(Bp * O, D, C))
    kern = kern.view(Bp, O, E, C) * win[:, None, :, None].to(kern.dtype)
    live = ((src >= 0) & (src < TA))[:, None, :, None]
    idx = torch.where(live, src[:, None, :, None], 0).long().expand(Bp, O, E, C)
    msg = torch.where(live, kern * torch.gather(x, 2, idx), 0.0)
    return msg.view(Bp, O, E // TA, TA, C).sum(dim=2)


def check_kernel(name, kernel, plain, library, args, flops, source, replaces, tol, peak):
    """Hold ``kernel`` against ``plain`` on ``args`` (every output within
    ``tol`` of that output's scale; an output the plain version gives as
    None the kernel must give as None; a second call's outputs equal the
    first's bit for bit), then time kernel, plain version and library
    yardstick; returns the kernel's JSON record, its bound taken at the
    ``peak`` operation rate (a time below the bound fails)."""
    out_k, out_p = as_tuple(kernel(*args)), as_tuple(plain(*args))
    torch.cuda.synchronize()
    again = as_tuple(kernel(*args))
    torch.cuda.synchronize()
    same = [a is None or torch.equal(a, b) for a, b in zip(out_k, again)]
    print(f"{name}: a second call's outputs equal the first's bit for bit: {same}")
    if not all(same):
        raise RuntimeError(f"{name} gave other bits on a second call")
    del again
    err = 0.0
    for i, (a, b) in enumerate(zip(out_k, out_p)):
        if b is None:
            if a is not None:
                raise RuntimeError(f"{name} output {i}: the plain version gives None")
            continue
        if a.dtype != b.dtype:
            raise RuntimeError(f"{name} output {i}: {a.dtype}, the plain version's {b.dtype}")
        e, scale = (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()
        if not scale > 0:
            raise RuntimeError(f"{name} output {i}: the plain version's output is all zero")
        print(f"{name} output {i}: max_abs_err {e:.3e}, max |plain| {scale:.3e}, "
              f"rel {e / scale:.3e} (tolerance {tol:g})")
        if not math.isfinite(e) or e > tol * scale:
            raise RuntimeError(f"{name} disagrees with its plain version")
        err = max(err, e)
    ms, plain_ms, lib_ms = cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args)), cuda_ms(library)
    b_ms, b_by = bound_ms(nbytes(args, out_p), flops, peak)
    print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by} at {peak / 1e12:.0f} TFLOP/s)")
    if ms < b_ms:
        raise RuntimeError(f"{name}: {ms:.4f} ms is below its bound {b_ms:.4f} ms")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def basis_source(name: str, dtype) -> str:
    """#8's or #7's entry source, both types on Hopper's wgmma and TMA
    (bfloat16: ``csrc/basis_sm90.cuh``; float32: ``csrc/basis_f32_sm90.cuh``)."""
    return f"arreau_tpu_torch/csrc/{name}_sm90.cu"


# #8's and #7's kernels in bfloat16 (csrc/basis_sm90.cuh) and float32
# (csrc/basis_f32_sm90.cuh), and #3's and #4's in both types
# (csrc/conv_sm90.cuh), as cuobjdump names them
SM90_KERNELS = ("h1_kernel", "rows_kernel", "dw2_kernel", "dw1_kernel", "f32_h1_kernel",
                "f32_rows_kernel", "f32_dw_kernel", "sconv_fwd_kernel", "sconv_kern_kernel",
                "sconv_dbasis_kernel", "sconv_dw_kernel", "cnx_fwd_kernel", "cnx_rows_kernel",
                "cnx_dw_kernel")
# (kernel, element type, or None for every instantiation) of the kernels
# whose operands the threads stage, not TMA: #4's float32 dW and float32
# #7's weight gradients transpose both as they stage them (tf32 wgmma takes
# K-major operands only; a TMA-fed float32 #7 dW was slower, PERF.md §6)
SM90_THREAD_STAGED = (("sconv_dw_kernel", "float"), ("f32_dw_kernel", None))


def start_sass_dump():
    """cuobjdump's SASS of the built library, started in the background into
    a temporary file: (process, path), or None where the toolkit has no
    cuobjdump. ``sass_check`` reads it."""
    from arreau_tpu_torch.kernels import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    fd, path = tempfile.mkstemp(suffix=".sass")
    with open(fd, "w") as out:
        process = subprocess.Popen([str(tool), "-sass", str(build.LIB_PATH)], stdout=out,
                                   stderr=subprocess.DEVNULL)

    def stop():  # at exit, had a phase failed before the check
        if process.poll() is None:
            process.kill()
            process.wait()
        Path(path).unlink(missing_ok=True)

    atexit.register(stop)
    return process, Path(path)


def sass_check(dump) -> None:
    """Every instantiation of #8's and #7's kernels (both types), of #3's and
    #4's kernels and of bfloat16 #9's and #10's in the built library issues
    warpgroup products (HGMMA) and, but for SM90_THREAD_STAGED, TMA loads
    (UTMALDG), as the SASS ``start_sass_dump`` wrote shows; prints the
    counts. Skipped, with a line, where the toolkit has no cuobjdump."""
    if dump is None:
        print("cuobjdump not found: the SASS is not checked")
        return
    process, path = dump
    try:
        if process.wait(timeout=300) != 0:
            raise RuntimeError(f"cuobjdump failed ({process.returncode})")
        counts: dict = {}
        function = None
        with open(path) as sass:
            for line in sass:
                if "Function :" in line:
                    m = re.search(r"\d(" + "|".join(SM90_KERNELS) + r")I(\w+?)EEv", line)
                    # (kernel, its template arguments: "208,256", "bf16,112,1")
                    function = None
                    if m:
                        args = m.group(2)
                        kind = ("bf16," if args.startswith("13__nv_bfloat16") else
                                "float," if args.startswith("f") else "")
                        function = (m.group(1), kind + ",".join(
                            re.findall(r"\d+", args.replace("13__nv_bfloat16", ""))))
                    if function:
                        counts[function] = {"HGMMA": 0, "UTMALDG": 0}
                elif function:
                    for op in ("HGMMA", "UTMALDG"):
                        counts[function][op] += op in line
    finally:
        if process.poll() is None:
            process.kill()
            process.wait()
        path.unlink(missing_ok=True)
    for kernel in SM90_KERNELS:
        found = {k[1]: v for k, v in counts.items() if k[0] == kernel}
        print(f"SASS {kernel}: " + ", ".join(f"<{t}> {v['HGMMA']} HGMMA, {v['UTMALDG']} UTMALDG"
                                              for t, v in sorted(found.items())))
        if not found or not all(
                v["HGMMA"] and (v["UTMALDG"] or (kernel, t.split(",")[0]) in SM90_THREAD_STAGED
                                or (kernel, None) in SM90_THREAD_STAGED)
                for t, v in found.items()):
            raise RuntimeError(f"{kernel}: an instantiation without HGMMA or UTMALDG in its SASS")


def forward_kernel_records(args, label, suffix="", tol=KERNEL_REL_TOL, peak=TF32X3_FLOP_PER_S):
    """Records of the two forward kernels (#3, #8) on captured arguments,
    named with ``suffix`` (``_bf16`` for the bfloat16 instantiations). Both
    run on the tensor cores: their bounds are taken at ``peak`` (3xTF32 in
    float32), and both must repeat their outputs bit for bit."""
    from arreau_tpu_torch.kernels.basis_h1 import basis_h1, basis_h1_plain
    from arreau_tpu_torch.kernels.spatial_conv import spatial_conv, spatial_conv_plain
    from arreau_tpu_torch.models.blocks import polynomial_features

    basis, w, x, src, win = args["spatial_conv"]
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    n_valid = int(((src >= 0) & (src < TA)).sum())
    print(f"{label}: spatial_conv shapes B'={Bp} O={O} E={E} TA={TA} K={E // TA} D={D} C={C}, "
          f"{n_valid}/{Bp * E} edge slots filled")
    conv = check_kernel(
        "spatial_conv" + suffix, spatial_conv, spatial_conv_plain,
        lambda: conv_library(basis, w, x, src, win), args["spatial_conv"],
        O * n_valid * (2 * D * C + 3 * C),
        "arreau_tpu_torch/csrc/spatial_conv_sm90.cu", "arreau_tpu/ops/pallas_conv.py:298", tol, peak
    )
    attrT, w1, b1, degree = args["basis_h1"]
    d = attrT.shape[2]
    F_, H = w1.shape
    print(f"{label}: basis_h1 shapes B'={Bp} O={O} d={d} E={E} F={F_} H={H}")
    poly = polynomial_features(attrT.transpose(-1, -2), degree).reshape(-1, F_)
    h1 = check_kernel(
        "basis_h1" + suffix, basis_h1, basis_h1_plain, lambda: torch.addmm(b1, poly, w1),
        args["basis_h1"], O * n_valid * (2 * F_ * H + H),  # rows of filled edge slots
        basis_source("basis_h1", attrT.dtype), "arreau_tpu/ops/pallas_basis.py:397", tol, peak
    )
    return conv, h1, n_valid


def backward_kernel_records(args, n_valid, suffix="", tol=KERNEL_REL_TOL,
                            peak=TF32X3_FLOP_PER_S):
    """Records of the two backward kernels (#4, #7) on captured arguments;
    the library yardstick is autograd's backward through the library chain
    of the same forward. Both run on the tensor cores: their bounds are
    taken at ``peak`` (3xTF32 in float32), and both must repeat their
    outputs bit for bit."""
    from arreau_tpu_torch.kernels.basis_mlp import basis_mlp_bwd, basis_mlp_bwd_plain
    from arreau_tpu_torch.kernels.spatial_conv import spatial_conv_bwd, spatial_conv_bwd_plain
    from arreau_tpu_torch.models.blocks import gelu, polynomial_features

    basis, w, x, src, win, g = args["spatial_conv_bwd"]
    Bp, O, E, D = basis.shape
    C = x.shape[3]
    leaves = [t.detach().requires_grad_() for t in (basis, w, x)]
    with torch.enable_grad():
        out = conv_library(*leaves, src, win)
    conv_bwd = check_kernel(
        "spatial_conv_bwd" + suffix, spatial_conv_bwd, spatial_conv_bwd_plain,
        lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), args["spatial_conv_bwd"],
        O * n_valid * (6 * D * C + 5 * C),
        "arreau_tpu_torch/csrc/spatial_conv_bwd_sm90.cu", "arreau_tpu/ops/pallas_conv.py:331", tol,
        peak
    )
    del out, leaves

    attrT, w1, b1, w2, b2, degree, gs = args["basis_mlp_bwd"]
    F_, H = w1.shape
    print(f"basis_mlp_bwd shapes: B'={Bp} O={O} E={E} F={F_} H={H} D={w2.shape[1]}, "
          f"{len(gs)} cotangents")
    poly = polynomial_features(attrT.transpose(-1, -2), degree).reshape(-1, F_)
    leaves = [t.detach().requires_grad_() for t in (w1, b1, w2, b2)]
    with torch.enable_grad():
        lib_basis = gelu(torch.addmm(leaves[3], gelu(torch.addmm(leaves[1], poly, leaves[0])),
                                     leaves[2]))
    flat_gs = [t.reshape(lib_basis.shape) for t in gs]
    mlp_bwd = check_kernel(
        "basis_mlp_bwd" + suffix, basis_mlp_bwd, basis_mlp_bwd_plain,
        lambda: torch.autograd.grad(lib_basis, leaves, reduce(torch.add, flat_gs), retain_graph=True),
        args["basis_mlp_bwd"], O * n_valid * 2 * (2 * F_ * H + 3 * H * w2.shape[1]),
        basis_source("basis_mlp_bwd", attrT.dtype), "arreau_tpu/ops/pallas_basis.py:289", tol,
        peak
    )
    return conv_bwd, mlp_bwd


def fiber_library(basis, w, x, src, fiber_kernel):
    """The fused fiber conv as a chain of library calls: the spatial conv's
    chain with a unit window, then the fiber mixing as one einsum."""
    ones = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    return torch.einsum("botc,opc->bptc", conv_library(basis, w, x, src, ones), fiber_kernel)


def fiber_records(args, label, suffix="", tol=KERNEL_REL_TOL, peak=TF32X3_FLOP_PER_S):
    """Records of #1 (and of #2 where ``args`` holds its inputs: a training
    step, whose forward also stores the spatial conv for the backward) on
    captured arguments, named with ``suffix`` (``_bf16`` for the bfloat16
    instantiations); the backward's library yardstick is autograd's
    backward through :func:`fiber_library`. Both run their products on the
    tensor cores: their bounds are taken at ``peak`` (3xTF32 in float32),
    and both must repeat their outputs bit for bit."""
    from arreau_tpu_torch.kernels.fiber_conv import (
        fiber_conv,
        fiber_conv_bwd,
        fiber_conv_bwd_plain,
        fiber_conv_plain,
    )

    basis, w, x, src, fk, save = args["fiber_conv"]
    Bp, O, E, D = basis.shape
    TA, C = x.shape[2], x.shape[3]
    P = fk.shape[1]
    n_valid = int(((src >= 0) & (src < TA)).sum())
    mixing = 2 * Bp * O * P * TA * C  # the fiber mixing; the backward's g_o and dKf each as much
    print(f"{label}: fiber_conv shapes B'={Bp} O={O} P={P} E={E} TA={TA} K={E // TA} D={D} "
          f"C={C}, {n_valid}/{Bp * E} edge slots filled")
    records = [check_kernel(
        "fiber_conv" + suffix, fiber_conv, fiber_conv_plain,
        lambda: fiber_library(basis, w, x, src, fk), args["fiber_conv"],
        O * n_valid * (2 * D * C + 2 * C) + mixing,
        "arreau_tpu_torch/csrc/fiber_conv.cu", "arreau_tpu/ops/pallas_conv.py:82", tol, peak
    )]
    if "fiber_conv_bwd" in args:
        basis, w, x, src, fk, g, _ = args["fiber_conv_bwd"]
        leaves = [t.detach().requires_grad_() for t in (basis, w, x, fk)]
        with torch.enable_grad():
            out = fiber_library(leaves[0], leaves[1], leaves[2], src, leaves[3])
        # dbasis, dW and dx: three edge products, as the spatial conv's backward
        records.append(check_kernel(
            "fiber_conv_bwd" + suffix, fiber_conv_bwd, fiber_conv_bwd_plain,
            lambda: torch.autograd.grad(out, leaves, g.to(out.dtype), retain_graph=True),
            args["fiber_conv_bwd"], O * n_valid * (6 * D * C + 5 * C) + 2 * mixing,
            "arreau_tpu_torch/csrc/fiber_conv_bwd.cu", "arreau_tpu/ops/pallas_conv.py:108", tol,
            peak
        ))
        del out, leaves
    return records


def convnext_library(xc, res, ln_s, ln_b, w1, b1, w2, b2, gamma, wr=None, br=None):
    """The fused ConvNext MLP as a chain of library calls in the compute
    type: layer_norm, linear, tanh-GELU, linear, scale and add, and the
    float32 readout linear."""
    F = torch.nn.functional
    dt = res.dtype
    y = F.layer_norm(xc, (xc.shape[-1],), ln_s, ln_b, eps=1e-5).to(dt)
    h = F.gelu(F.linear(y, w1.t(), b1), approximate="tanh")
    out = res + gamma.to(dt) * F.linear(h, w2.t(), b2)
    return out, (F.linear(out.float(), wr.t(), br) if wr is not None else None)


def convnext_records(args, label, tol, peak):
    """Records of #9 (and of #10 where ``args`` holds its inputs: a training
    step) on captured arguments, each with its no-readout call checked and
    timed beside it; the backward's library yardstick is autograd's backward
    through :func:`convnext_library`. Both run their products on the tensor
    cores: their bounds are taken at ``peak`` (3xTF32 in float32), and every
    call must repeat its outputs bit for bit."""
    from arreau_tpu_torch.kernels.convnext_mlp import (
        convnext_mlp,
        convnext_mlp_bwd,
        convnext_mlp_bwd_plain,
        convnext_mlp_plain,
    )

    fargs = args["convnext_mlp"]
    xc, res, w1, wr = fargs[0], fargs[1], fargs[4], fargs[9]
    C, W = w1.shape
    M, R = xc.numel() // C, wr.shape[1]
    print(f"{label}: convnext_mlp shapes M={M} rows ({tuple(xc.shape)}) C={C} W={W} R={R}, "
          f"compute type {res.dtype}")
    # a check passes a kernel that returns out = res unless the MLP's share
    # of out exceeds the tolerance
    out = convnext_mlp_plain(*fargs)[0].float()
    share = (out - res.float()).abs().max().item() / out.abs().max().item()
    print(f"{label}: the MLP's share of out {share:.3e} (must exceed the tolerance {tol:g})")
    if not share > tol:
        raise RuntimeError(f"{label}: the MLP's share of out is within the tolerance")
    del out
    sm90 = res.dtype == torch.bfloat16  # bfloat16 on wgmma (convnext_sm90.cuh)
    src = f"arreau_tpu_torch/csrc/convnext_mlp{'_sm90' if sm90 else ''}.cu"
    rep = "arreau_tpu/ops/pallas_convnext.py:61"
    fwd = check_kernel("convnext_mlp", convnext_mlp, convnext_mlp_plain,
                       lambda: convnext_library(*fargs), fargs, 2 * M * (2 * C * W + C * R),
                       src, rep, tol, peak)
    bare = fargs[:9] + (None, None)
    fwd["no_readout"] = check_kernel("convnext_mlp", convnext_mlp, convnext_mlp_plain,
                                     lambda: convnext_library(*bare), bare, 4 * M * C * W, src,
                                     rep, tol, peak)
    records = [fwd]
    if "convnext_mlp_bwd" in args:
        bargs = args["convnext_mlp_bwd"]
        src = f"arreau_tpu_torch/csrc/convnext_mlp_bwd{'_sm90' if sm90 else ''}.cu"
        rep = "arreau_tpu/ops/pallas_convnext.py:78"

        def library_bwd(call_args):
            leaves = [t.detach().requires_grad_() for t in call_args[:11] if t is not None]
            with torch.enable_grad():
                out, r = convnext_library(*leaves, *([None, None] if len(leaves) == 9 else []))
            outs, cots = [out], [call_args[11]]
            if r is not None:
                outs.append(r)
                cots.append(call_args[12])
            return lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True)

        bwd = check_kernel("convnext_mlp_bwd", convnext_mlp_bwd, convnext_mlp_bwd_plain,
                           library_bwd(bargs), bargs, 2 * M * (6 * C * W + 2 * C * R), src, rep,
                           tol, peak)
        # without the readout, the cotangent the readout adds to out's
        # (the captured layer is the last: its out feeds only its readout)
        g_nr = (bargs[11].float() + bargs[12] @ bargs[9].t()).to(bargs[11].dtype)
        bare = bargs[:9] + (None, None, g_nr, None)
        bwd["no_readout"] = check_kernel("convnext_mlp_bwd", convnext_mlp_bwd,
                                         convnext_mlp_bwd_plain, library_bwd(bare), bare,
                                         12 * M * C * W, src, rep, tol, peak)
        records.append(bwd)
    return records


@contextlib.contextmanager
def basis_input(model, store: dict, key: str):
    """Keeps in ``store[key]`` the invariants ``[B', O, E, d]`` that a
    ``fuse_fiber`` backbone hands its basis MLP (its first call)."""
    handle = model.model.basis_fn.register_forward_pre_hook(
        lambda module, a: store.setdefault(key, a[0].detach()))
    try:
        yield
    finally:
        handle.remove()


def basis_library(attr, w1, w2, degree):
    """The fused basis MLP as a chain of library calls in the compute type:
    polynomial features, linear, tanh-GELU, linear, tanh-GELU."""
    from arreau_tpu_torch.models.blocks import polynomial_features

    F = torch.nn.functional
    h = F.gelu(F.linear(polynomial_features(attr, degree), w1.t()), approximate="tanh")
    return F.gelu(F.linear(h, w2.t()), approximate="tanh")


FUSED_BASIS = dict(d=6, degree=3, H=TRAIN_HIDDEN, D=256)  # the canonical basis width


def fused_basis_calls(attrs: dict, dtype, label: str) -> tuple[dict, dict]:
    """#5 and #6 through ``BasisMLP(fused=True, use_bias=False)`` at the
    canonical basis width (d = 6, degree 3, F = 258, H = TRAIN_HIDDEN, D =
    256), its weights made with numpy from SEED and carried by the JAX-tree
    loader, in ``dtype``: one forward at the serving shape and one forward
    and backward at the training shape (``attrs["serve"|"train"]``), each
    launching its kernel once and no plain version (counts set to 0 just
    before; raises otherwise). Returns ({shape: {kernel: the arguments of
    its call}}, {shape: launch counts})."""
    from arreau_tpu_torch.interop.from_jax import basis_mlp_params_from_jax
    from arreau_tpu_torch.kernels import fused_basis_mlp as fbm
    from arreau_tpu_torch.models.blocks import BasisMLP

    d, degree, H, D = (FUSED_BASIS[k] for k in ("d", "degree", "H", "D"))
    F_ = d + d**2 + d**3
    rng = np.random.default_rng(SEED)
    tree = {"dense_in": {"kernel": rng.normal(size=(F_, H)) / math.sqrt(F_)},
            "dense_out": {"kernel": rng.normal(size=(H, D)) / math.sqrt(H)}}
    module = BasisMLP(d, H, D, degree, use_bias=False, fused=True)
    basis_mlp_params_from_jax(module, tree)
    module = module.to(attrs["train"].device)
    cdt = None if dtype == torch.float32 else dtype
    plain_calls = {"fused_basis_mlp_plain": 0, "fused_basis_mlp_bwd_plain": 0}
    plain_fns = {name: getattr(fbm, name) for name in plain_calls}

    def counted(name):
        def call(*a):
            plain_calls[name] += 1
            return plain_fns[name](*a)
        return call

    captured, counts = {}, {}
    try:
        for name in plain_calls:
            setattr(fbm, name, counted(name))
        for shape in ("serve", "train"):
            attr = attrs[shape]
            g = torch.tensor(np.random.default_rng(SEED + 1).normal(size=(*attr.shape[:3], D)),
                             dtype=dtype, device=attr.device)
            reset_launch_counts()
            with capturing() as args, torch.enable_grad():
                out = module(attr, cdt)
                if shape == "train":
                    out.backward(g)
            torch.cuda.synchronize()
            counts[shape] = launch_counts()
            captured[shape] = args
            want = {name: 0 for name in counts[shape]}
            want.update(fused_basis_mlp=1, fused_basis_mlp_bwd=int(shape == "train"))
            print(f"{label} {shape} {tuple(attr.shape)}: launches {counts[shape]}, plain "
                  f"versions called {plain_calls}")
            if counts[shape] != want or any(plain_calls.values()) or out.dtype != dtype:
                raise RuntimeError(f"BasisMLP(fused=True) launched {counts[shape]} and called "
                                   f"{plain_calls} ({out.dtype}), not {want} and no plain version")
            del out
    finally:
        for name, fn in plain_fns.items():
            setattr(fbm, name, fn)
    module.zero_grad(set_to_none=True)
    return captured, counts


def fused_basis_records(attrs: dict, dtype, label: str, tol: float, peak: float) -> list:
    """#5 and #6 on the calls of :func:`fused_basis_calls`: each kernel
    against its plain version on the arguments it got, timed beside the
    library chain (and autograd through it for #6). Returns the two
    records."""
    from arreau_tpu_torch.kernels import fused_basis_mlp as fbm

    d, degree, H, D = (FUSED_BASIS[k] for k in ("d", "degree", "H", "D"))
    F_ = d + d**2 + d**3
    captured, counts = fused_basis_calls(attrs, dtype, label)
    suffix = "" if dtype == torch.float32 else "_bf16"
    records = {}
    for shape, args in captured.items():
        attr, w1, w2, _ = args["fused_basis_mlp"]
        rows = attr.numel() // d
        print(f"{label} {shape}: fused_basis_mlp rows={rows} d={d} F={F_} H={H} D={D}, "
              f"{attr.dtype}")
        records[shape] = check_kernel(
            "fused_basis_mlp" + suffix, fbm.fused_basis_mlp, fbm.fused_basis_mlp_plain,
            lambda: basis_library(attr, w1, w2, degree), args["fused_basis_mlp"],
            2 * rows * (F_ * H + H * D), "arreau_tpu_torch/csrc/fused_basis_mlp.cu",
            "arreau_tpu/ops/pallas_basis.py:108", tol, peak)
    fwd = records["train"]
    fwd["launches"] = counts["train"]["fused_basis_mlp"]
    fwd["serve"] = {k: records["serve"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                     "max_abs_err")}
    fwd["serve"]["launches"] = counts["serve"]["fused_basis_mlp"]

    bargs = captured["train"]["fused_basis_mlp_bwd"]
    attr, w1, w2, _, g = bargs
    rows = attr.numel() // d
    leaves = [t.detach().requires_grad_() for t in (w1, w2)]
    with torch.enable_grad():
        out = basis_library(attr, *leaves, degree)
    bwd = check_kernel(
        "fused_basis_mlp_bwd" + suffix, fbm.fused_basis_mlp_bwd, fbm.fused_basis_mlp_bwd_plain,
        lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), bargs,
        2 * rows * (2 * F_ * H + 3 * H * D), "arreau_tpu_torch/csrc/fused_basis_mlp_bwd.cu",
        "arreau_tpu/ops/pallas_basis.py:119", tol, peak)
    bwd["launches"] = counts["train"]["fused_basis_mlp_bwd"]
    with torch.no_grad():  # ten calls: the trace may miss the first launches
        profile_step(lambda: fbm.fused_basis_mlp(*captured["train"]["fused_basis_mlp"]),
                     fwd["ms"], 10, "fused_basis_mlp" + suffix)
        profile_step(lambda: fbm.fused_basis_mlp_bwd(*bargs), bwd["ms"], 10,
                     "fused_basis_mlp_bwd" + suffix)
    return [fwd, bwd]


def write_checkpoint(ckpt: Path, cfg, model, z_table) -> dict:
    """A checkpoint directory as generate reads it: ``meta.json`` and the
    tag ``last`` with ``params.npz``; returns the meta."""
    from arreau_tpu_torch.interop.from_jax import params_to_jax, save_params_npz

    (ckpt / "last").mkdir(parents=True)
    meta = {
        "config": dataclasses.asdict(cfg),
        "z_table_zs": [int(z) for z in z_table.zs],
        # the synthetic training data's lattice lengths are U(3, 8) angstrom
        "length_stats": {"min": 3.0, "max": 8.0},
    }
    (ckpt / "meta.json").write_text(json.dumps(meta, indent=2))
    save_params_npz(str(ckpt / "last" / "params.npz"), params_to_jax(model.model))
    return meta


def sampler_path(ckpt: Path, out_dir: Path, meta: dict, z_table, card: str,
                 per_forward: dict, tag: str = "last") -> dict:
    """The generate CLI on ``ckpt`` (``--tag``): CRYSTALS crystals, batch
    BATCH x ATOMS, STEPS strided steps. Checks the crystals and that every
    forward launched ``per_forward`` kernels and no other (counts set to 0
    just before); returns the launch counts."""
    from arreau_tpu_torch.cli import generate
    from arreau_tpu_torch.inference.io import load_sample_results
    from arreau_tpu_torch.tasks.diffusion import strided_levels

    reset_launch_counts()
    t0 = time.perf_counter()
    generate.main([
        "--checkpoint_dir", str(ckpt), "--batch_size", str(BATCH),
        "--num_atoms_per_sample", str(ATOMS), "--num_crystals", str(CRYSTALS),
        "--sample_steps", str(STEPS), "--seed", str(SEED), "--out_dir", str(out_dir),
        "--device", "cuda", "--tag", tag,
    ])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    T = meta["config"]["num_timesteps"]
    batches = math.ceil(CRYSTALS / BATCH)
    forwards = batches * (len(strided_levels(T, STEPS)) - 1)
    draws = threefry_launches()
    print(f"forwards {forwards}: launches {counts}; threefry {draws} "
          f"({SAMPLER_DRAWS} a batch of {batches})")
    want = {name: per_forward.get(name, 0) * forwards for name in counts}
    if counts != want:
        raise RuntimeError(f"the sampler path launched {counts}, not {want}")
    if draws != SAMPLER_DRAWS * batches:
        raise RuntimeError(f"the sampler path drew through threefry {draws} times, not "
                           f"{SAMPLER_DRAWS * batches}")
    counts = {**counts, "threefry": draws}
    crystal_checks(load_sample_results(str(out_dir / "crystals.h5")), z_table, CRYSTALS,
                   ATOMS, generate.length_bounds_from_meta(meta) or (0.0, math.inf))
    print(f"sampler path: {CRYSTALS} crystals in {wall:.2f} s wall, checkpoint load and first "
          f"batch included ({CRYSTALS / wall * 60:.0f} crystals/min on {card})")
    return counts


def mean_soft_sphere_energy(result) -> float:
    """The mean over crystals of the soft-sphere energy that process_results
    relaxes, on the card."""
    from arreau_tpu_torch.cli.process_results import densify
    from arreau_tpu_torch.inference.relax import _soft_sphere_energy

    frac, mask = densify(result)
    dev = torch.device("cuda")
    return _soft_sphere_energy(torch.as_tensor(frac, dtype=torch.float32, device=dev),
                               torch.as_tensor(result.lattice, dtype=torch.float32, device=dev),
                               torch.as_tensor(mask, device=dev)).mean().item()


def flagship_path(out_dir: Path, card: str) -> dict:
    """The generate CLI on the trained flagship checkpoint with the flagship
    command (FLAGSHIP_ARGS): checks that every forward launched the bfloat16
    #3 once per layer and the bfloat16 #8 once and no other kernel (counts
    set to 0 just before), the crystals, and the quality report against the
    gate; then the process_results CLI on its crystals on the card, which
    must lower the mean soft-sphere energy and keep every coordinate in
    [0, 1). Raises after the relaxation if the report left the gate.
    Returns the launch counts."""
    from arreau_tpu_torch.cli import generate, process_results
    from arreau_tpu_torch.data.atoms import AtomicNumberTable
    from arreau_tpu_torch.inference.io import load_sample_results
    from arreau_tpu_torch.tasks.diffusion import strided_levels

    meta = json.loads((FLAGSHIP / "meta.json").read_text())
    if (meta["config"]["compute_dtype"] != "bfloat16" or not meta["config"]["diffuse_angles"]
            or meta.get("readout_bf16_operands") is not True):
        raise RuntimeError("the flagship checkpoint's meta.json lost its compute_dtype, "
                           "diffuse_angles or readout_bf16_operands")
    dtypes, tee = {}, Tee(sys.stdout)
    reset_launch_counts()
    t0 = time.perf_counter()
    with capturing(dtypes) as args, contextlib.redirect_stdout(tee):
        generate.main(["--checkpoint_dir", str(FLAGSHIP), *FLAGSHIP_ARGS,
                       "--out_dir", str(out_dir)])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    forwards = math.ceil(FLAGSHIP_CRYSTALS / FLAGSHIP_BATCH) * (
        len(strided_levels(meta["config"]["num_timesteps"], FLAGSHIP_STEPS)) - 1)
    L = meta["config"]["num_layers"]
    want = {name: {"spatial_conv": L, "basis_h1": 1}.get(name, 0) * forwards for name in counts}
    print(f"forwards {forwards}: launches {counts}; element types {dtypes}")
    if counts != want:
        raise RuntimeError(f"the flagship path launched {counts}, not {want}")
    if dtypes != {"spatial_conv": {torch.bfloat16}, "basis_h1": {torch.bfloat16}}:
        raise RuntimeError(f"the flagship path's kernels ran in {dtypes}, not bfloat16 alone")
    basis, _, x = args["spatial_conv"][:3]
    print(f"shape at {FLAGSHIP_BATCH} x {ATOMS}: B'={basis.shape[0]} TA={x.shape[2]} "
          f"E={basis.shape[2]} (O={basis.shape[1]}, D={basis.shape[3]}, C={x.shape[3]})")
    del args
    crystal_checks(load_sample_results(str(out_dir / "crystals.h5")),
                   AtomicNumberTable(meta["z_table_zs"]), FLAGSHIP_CRYSTALS, ATOMS, (0.0, math.inf))
    rate = re.search(r"sampler throughput: ([0-9.]+) crystals/min", tee.buf.getvalue())
    if rate is None:
        raise RuntimeError("the generate CLI printed no throughput")
    print(f"flagship: {FLAGSHIP_CRYSTALS} crystals, {float(rate.group(1)):.0f} crystals/min warm "
          f"over batches 2-{FLAGSHIP_CRYSTALS // FLAGSHIP_BATCH}; {wall:.2f} s wall for the whole "
          f"call (checkpoint load, first batch and quality report included) on {card}")

    report = json.loads((out_dir / "quality.json").read_text())
    if list(report) != list(JAX_FLAGSHIP_QUALITY):
        raise RuntimeError(f"the quality report's keys {list(report)} are not the JAX report's")
    failed = []
    print(f"{'field':<28} {'port':>12} {'JAX':>12}  gate")
    for key, jax_value in JAX_FLAGSHIP_QUALITY.items():
        value = report[key]
        lo, hi = FLAGSHIP_GATE.get(key, (None, None))
        ok = math.isfinite(value) and (lo is None or value >= lo) and (hi is None or value <= hi)
        gate = " and ".join(f"{op} {bound:g}" for op, bound in ((">=", lo), ("<=", hi))
                            if bound is not None)
        if not ok:
            failed.append(key)
        print(f"{key:<28} {value:>12.6f} {jax_value:>12.6f}  {gate}{'' if ok else '  FAILED'}")

    # the relaxation runs whatever the gate said, so that one run shows both
    t0 = time.perf_counter()
    process_results.main(["--in_path", str(out_dir / "crystals.h5"), "--device", "cuda"])
    seconds = time.perf_counter() - t0
    relaxed = load_sample_results(str(out_dir / "crystals_relaxed.h5"))
    e0, e1 = (mean_soft_sphere_energy(r) for r in (load_sample_results(
        str(out_dir / "crystals.h5")), relaxed))
    in_cell = bool(np.all((relaxed.frac_x >= 0) & (relaxed.frac_x < 1)))
    print(f"process_results: mean soft-sphere energy {e0:.6f} -> {e1:.6f}, coordinates in "
          f"[0, 1): {in_cell}, {seconds:.2f} s wall (200 steps, {relaxed.num_crystals} crystals)")
    if not (e1 < e0 and in_cell and relaxed.num_crystals == FLAGSHIP_CRYSTALS):
        raise RuntimeError("process_results did not relax the flagship's crystals")
    if failed:
        raise RuntimeError(f"the flagship's quality left its gate: {failed}")
    return counts


# the JAX package's TPU run of the flagship's full chain (out/r4/queue1.sh,
# step 4: 500 crystals in batches of 100 x 8, 999 steps, seed 0)
Q_ANG_ON = OUT / "r4" / "q_ang_on"
STREAM_ARGS = [
    "--tag", "best", "--use_ema", "false", "--num_crystals", str(FLAGSHIP_CRYSTALS),
    "--batch_size", str(FLAGSHIP_BATCH), "--num_atoms_per_sample", str(ATOMS),
    "--clip_denoised", "false", "--seed", str(SEED), "--device", "cuda",
]
STREAM_NORMAL_ULP = 3  # a normal against prng.py's: XLA's erf_inv, fused multiply-adds
# H100 SXM (NVIDIA's Hopper architecture whitepaper: 132 SMs, each with 64
# INT32 lanes and four schedulers of one 32-lane instruction a clock; 1.98
# GHz, at which 132 x 128 x 2 x 1.98e9 is the data sheet's 67 TFLOP/s in
# float32): shifts and logic on the INT32 lanes, and every instruction,
# float32 with a fused multiply-add as one, at the issue rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
# the threefry hash's 32-bit operations an element (csrc/threefry.cu), as
# (shifts and logic, all): 20 rounds of an add, a rotate and a xor, the
# third key word (one three-input xor), the two words xored, and two key
# words added before the rounds and after each group of four (12 adds, the
# group count folded into a three-input add): 42 of 74. Adds may issue on
# the float pipes (as integer multiply-adds), so only the shifts and logic
# are bound to the INT32 lanes. A uniform adds a shift and an or, and a
# subtract, a fused multiply-add and a max; a normal at least ~35 float
# operations more (log1p's or log's polynomial, erf_inv's 9 terms, products)
THREEFRY_OPS = {"bits": (42, 74), "uniform": (44, 79), "normal": (44, 114)}


def ulp_gap(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance of two float tensors in float32 units in the last place."""
    a, b = a.float().contiguous().view(torch.int32), b.float().contiguous().view(torch.int32)
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


THREEFRY_MODES = (("bits", torch.float32), ("uniform", torch.float32),
                  ("uniform", torch.bfloat16), ("normal", torch.float32),
                  ("normal", torch.bfloat16))


def threefry_records(label: str, keys: np.ndarray, shape: tuple, modes=THREEFRY_MODES) -> dict:
    """The threefry kernel for ``keys`` ``[K, 2]`` and ``shape`` against its
    plain version (on the card) and ``prng.py``'s numpy on the first and
    last keys: bits, and uniforms and normals in float32 and bfloat16 (or
    the ``(mode, dtype)`` of ``modes``); bits and uniforms bit for bit,
    normals within STREAM_NORMAL_ULP; then its time per launch beside the
    plain version's and ``torch.randint``/``torch.rand``/``torch.randn`` of
    the same shape (and, for bits of one key, ``torch.randperm`` of its
    length). Returns the records by label, mode and type."""
    from arreau_tpu_torch.kernels.threefry import keys_tensor, threefry, threefry_plain

    records = {}
    kt = keys_tensor(keys, "cuda")
    for mode, dtype in modes:
        got = threefry(kt, shape, mode, dtype)
        plain = threefry_plain(kt, shape, mode, dtype)
        torch.cuda.synchronize()
        again = threefry(kt, shape, mode, dtype)
        np_dt = {torch.float32: np.float32, torch.bfloat16: prng.BF16}[dtype]
        host = []
        for row in (0, len(keys) - 1):
            if mode == "bits":
                host.append(torch.from_numpy(prng.random_bits(keys[row], 32, shape).astype(np.int64)))
            else:
                draw = prng.uniform if mode == "uniform" else prng.normal
                host.append(torch.from_numpy(draw(keys[row], shape, np_dt)))
        name = f"{label} {mode} {str(dtype).removeprefix('torch.')}"
        gap_plain = ulp_gap(got, plain) if mode != "bits" else int(not torch.equal(got, plain))
        gap_np = max((ulp_gap(got[i].cpu(), h) if mode != "bits"
                      else int(not torch.equal(got[i].cpu(), h)))
                     for i, h in zip((0, len(keys) - 1), host))
        tol = STREAM_NORMAL_ULP if mode == "normal" else 0
        print(f"threefry {name} {tuple(got.shape)}: against the plain version {gap_plain} ulp, "
              f"against prng.py (keys 0 and {len(keys) - 1}) {gap_np} ulp (tolerance {tol}); "
              f"a second call equal: {torch.equal(got, again)}")
        if max(gap_plain, gap_np) > tol or not torch.equal(got, again):
            raise RuntimeError(f"threefry {name} is not JAX's draw")
        out_bytes = got.numel() * (4 if mode == "bits" else got.element_size())
        ms = cuda_ms(lambda: threefry(kt, shape, mode, dtype))
        plain_ms = cuda_ms(lambda: threefry_plain(kt, shape, mode, dtype), runs=3)
        full = (len(keys), *shape)
        library = ((lambda: torch.randint(0, 2**31, full, device="cuda", dtype=torch.int32))
                   if mode == "bits" else
                   (lambda: torch.rand(full, device="cuda", dtype=dtype)) if mode == "uniform"
                   else (lambda: torch.randn(full, device="cuda", dtype=dtype)))
        lib_ms = cuda_ms(library)
        logic, ops = THREEFRY_OPS[mode]
        b_ms, b_by = bound_ms(out_bytes + kt.numel() * 4, got.numel(),
                              min(INT32_OPS_PER_S / logic, ISSUE_OPS_PER_S / ops))
        print(f"threefry {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if ms < b_ms:
            raise RuntimeError(f"threefry {name}: {ms:.4f} ms is below its bound {b_ms:.4f} ms")
        records[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "max_abs_err": float(
                             (got.double() - plain.double()).abs().max().item()),
                         "ulp": max(gap_plain, gap_np)}
        if mode == "bits" and len(keys) == 1 and len(shape) == 1:
            records[name]["randperm_ms"] = cuda_ms(
                lambda: torch.randperm(shape[0], device="cuda"))
            print(f"threefry {name}: torch.randperm({shape[0]}) "
                  f"{records[name]['randperm_ms']:.4f} ms")
        del got, plain, again
    return records


def circular_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = np.abs(a - b) % 1.0
    return np.minimum(d, 1.0 - d)


def jax_streams_phase(tmp: Path, card: str, records: dict) -> None:
    """The threefry kernel at the sampler's bulk shape (the flagship's full
    chain: S = 999 steps of 128 x 8 atoms, its 9 classes) and the training
    shape (256 x 16) against its plain version and ``prng.py``; then the
    generate CLI with ``--seed 0`` on the flagship with the JAX TPU run's
    command (``Q_ANG_ON``): the noise it drew for the first batch's step 0
    and step S-1 is ``prng.py``'s for JAX's chain, every forward launched 5
    bf16 #3 and 1 bf16 #8 and every batch 7 threefry draws; and prints how
    many crystals match that run's (equal types; the median gaps of the
    others: no gate, the TPU took bfloat16 products and an older JAX)."""
    from arreau_tpu_torch.cli import generate
    from arreau_tpu_torch.inference.io import load_sample_results
    from arreau_tpu_torch.tasks import diffusion
    from arreau_tpu_torch.tasks.diffusion import sampler_step_keys

    meta = json.loads((FLAGSHIP / "meta.json").read_text())
    T, C, L = (meta["config"][k] for k in ("num_timesteps", "num_atomic_states", "num_layers"))
    S = T - 1
    batch_key = prng.split(prng.prng_key(SEED))[1]  # the CLI's first batch
    k_loop = prng.split(batch_key, 4)[3]
    steps = sampler_step_keys(k_loop, S)  # [S, 4, 2]
    loss_keys = prng.split(prng.prng_key(SEED), 5)  # a loss's k_t, k_pos, k_type, ...
    timed = {}
    for label, keys, shape in (("sampler types", steps[:, 2], (BATCH, ATOMS, C)),
                               ("sampler positions", steps[:, 1], (BATCH, ATOMS, 3)),
                               ("training types", loss_keys[2:3], (TRAIN_BATCH, 16, C)),
                               ("training positions", loss_keys[1:2], (TRAIN_BATCH, 16, 3))):
        timed.update(threefry_records(label, keys, shape))

    captured = []
    draw = diffusion.DiffusionModel.draw_noise

    def recording(self, *a, **kw):
        noise = draw(self, *a, **kw)
        if not captured:
            captured.append((a, kw, noise))
        return noise

    reset_launch_counts()
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    try:
        diffusion.DiffusionModel.draw_noise = recording
        with contextlib.redirect_stdout(tee):
            generate.main(["--checkpoint_dir", str(FLAGSHIP), *STREAM_ARGS,
                           "--out_dir", str(tmp / "out")])
    finally:
        diffusion.DiffusionModel.draw_noise = draw
    wall = time.perf_counter() - t0
    counts, draws = launch_counts(), threefry_launches()
    batches = FLAGSHIP_CRYSTALS // FLAGSHIP_BATCH
    want = flagship_launches(batches * S, L)
    print(f"generate --seed {SEED}, the full chain: launches {counts}; threefry {draws}")
    if counts != want or draws != SAMPLER_DRAWS * batches:
        raise RuntimeError(f"the full chain launched {counts} and {draws} threefry draws, not "
                           f"{want} and {SAMPLER_DRAWS * batches}")
    (a, _, noise) = captured[0]
    if not np.array_equal(np.asarray(a[0]), batch_key):
        raise RuntimeError("the first batch's key is not split off PRNGKey(seed) as JAX's CLI")
    gaps = {}
    for s in (0, S - 1):
        lat, pos, typ, ang = (steps[s, i] for i in range(4))
        want_fields = {"lattice": prng.normal(lat, (FLAGSHIP_BATCH, 3)),
                       "pos": prng.normal(pos, (FLAGSHIP_BATCH, ATOMS, 3)),
                       "types": prng.uniform(typ, (FLAGSHIP_BATCH, ATOMS, C)),
                       "angle": prng.normal(ang, (FLAGSHIP_BATCH, 6))}
        for name, w in want_fields.items():
            gaps[f"{name}[{s}]"] = ulp_gap(getattr(noise, name)[s].cpu(), torch.from_numpy(w))
    print(f"the first batch's noise against prng.py's for JAX's chain (ulp): {gaps}")
    if any(v > (0 if k.startswith("types") else STREAM_NORMAL_ULP) for k, v in gaps.items()):
        raise RuntimeError("generate --seed 0 did not draw JAX's stream")
    rate = re.search(r"sampler throughput: ([0-9.]+) crystals/min", tee.buf.getvalue())
    print(f"full chain: {FLAGSHIP_CRYSTALS} crystals of {ATOMS} atoms, {S} steps, "
          f"{float(rate.group(1)) if rate else float('nan'):.1f} crystals/min warm, "
          f"{wall:.2f} s wall on {card}")

    got = load_sample_results(str(tmp / "out" / "crystals.h5"))
    tpu = load_sample_results(str(Q_ANG_ON / "crystals.h5"))
    same = [np.array_equal(got.crystal(i)[1], tpu.crystal(i)[1]) for i in range(got.num_crystals)]
    frac_gap = [float(np.median(circular_gap(got.crystal(i)[0], tpu.crystal(i)[0])))
                for i in range(got.num_crystals)]
    len_gap = np.abs(np.linalg.norm(got.lattice, axis=-1) - np.linalg.norm(tpu.lattice, axis=-1))
    print(f"against the JAX package's TPU run ({Q_ANG_ON.relative_to(OUT.parent)}, no gate): "
          f"{sum(same)} of {got.num_crystals} crystals with every type equal; median frac gap "
          f"{np.median(frac_gap):.4f}, median lattice length gap {np.median(len_gap):.4f} A "
          f"(crystals with equal types: {np.median(np.array(frac_gap)[same]) if any(same) else float('nan'):.4f} "
          f"and {np.median(len_gap[np.array(same)]) if any(same) else float('nan'):.4f} A)")

    rec = timed["sampler types uniform float32"]
    records["threefry"] = {
        "name": "threefry", "route": "cuda", "source": "arreau_tpu_torch/csrc/threefry.cu",
        "replaces": "none: jax.random's threefry2x32 through XLA (no pallas_call)",
        **records.get("threefry", {}),  # the launches of the sampler and training paths
        "launches_full_chain": draws,
        **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")},
        "shape": f"[{S}, {BATCH}, {ATOMS}, {C}] uniform float32",
        "fields": {**records.get("threefry", {}).get("fields", {}),
                   **threefry_fields(timed)},
    }


def threefry_fields(timed: dict) -> dict:
    """The ``fields`` of the threefry record from threefry_records' records."""
    return {k: {f: v[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms", "ulp",
                                  "randperm_ms") if f in v}
            for k, v in timed.items()}


@contextlib.contextmanager
def shared_graphs(graphs: list, replay_on=None):
    """Record every PBC neighbour list the diffusion model builds into
    ``graphs``, or, with ``replay_on`` (a device), hand them back in order on
    that device: a card run and a CPU run on one topology."""
    from arreau_tpu_torch.ops.pbc import NeighborList
    from arreau_tpu_torch.tasks import diffusion

    build = diffusion.pbc_neighbor_list
    replay = iter(graphs)

    def record(*a):
        graphs.append(build(*a))
        return graphs[-1]

    def replayed(*a):
        return NeighborList(*(x.to(replay_on) for x in next(replay)))

    diffusion.pbc_neighbor_list = record if replay_on is None else replayed
    try:
        yield
    finally:
        diffusion.pbc_neighbor_list = build


def training_reference(ref_cfg, z_table, seed: int, loss_rel_tol: float,
                       grad_rel_tol: float = GRAD_REL_TOL, fuse_convnext: bool = False) -> None:
    """One training step's loss terms and every parameter gradient at full
    width on 32 crystals of 8 atoms: the card's kernel branch (with
    ``fuse_convnext``: its backbone built so) against the CPU's plain
    branch, both given the neighbour list the CPU built."""
    from arreau_tpu_torch.data.synthetic import make_synthetic_batch
    from arreau_tpu_torch.tasks.diffusion import (
        DiffusionModel,
        LossNoise,
        batch_to_device,
        draw_loss_noise,
    )

    dev = torch.device("cuda")
    B = 32
    host = make_synthetic_batch(np.random.default_rng(seed), z_table, B, ATOMS)
    model = DiffusionModel(ref_cfg, device=dev)
    if fuse_convnext:
        model.model = fused_convnext_backbone(model)
    model.model.init_parameters(prng.prng_key(seed))
    plain = DiffusionModel(dataclasses.replace(ref_cfg, use_pallas=False), device="cpu")
    plain.model.load_state_dict({k: v.cpu() for k, v in model.model.state_dict().items()})
    noise = draw_loss_noise(prng.prng_key(seed), B, ATOMS,
                            ref_cfg.num_atomic_states, ref_cfg.num_timesteps, True, "cpu")
    graphs = []
    with shared_graphs(graphs):
        want_loss, want_m = plain.loss(batch_to_device(host, "cpu"), noise)
        want_loss.backward()
    card_noise = LossNoise(**{f.name: getattr(noise, f.name).to(dev)
                              for f in dataclasses.fields(noise)})
    with shared_graphs(graphs, replay_on=dev):
        got_loss, got_m = model.loss(batch_to_device(host, dev), card_noise)
        got_loss.backward()
    for name, value in want_m.items():
        err, scale = abs(got_m[name].item() - value.item()), abs(value.item())
        print(f"{name}: card {got_m[name].item():.6f}, cpu {value.item():.6f}, "
              f"rel {err / max(scale, 1e-3):.3e} (tolerance {loss_rel_tol:g})")
        if not err <= loss_rel_tol * max(scale, 1e-3):
            raise RuntimeError(f"{name}: the card's loss disagrees with the CPU's")
    worst = 0.0
    want_grads = dict(plain.model.named_parameters())
    for name, p in model.model.named_parameters():
        want = want_grads[name].grad
        err = (p.grad.cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        if not (scale > 0 and err <= grad_rel_tol * scale):
            raise RuntimeError(f"gradient of {name}: max_abs_err {err:.3e}, max |cpu| "
                               f"{scale:.3e} (tolerance {grad_rel_tol:g} rel)")
        worst = max(worst, err / scale)
    print(f"{graphs[0].mask.sum().item()} edges; {len(want_grads)} parameter gradients, "
          f"worst max_abs_err / max |cpu| {worst:.3e} (tolerance {grad_rel_tol:g})")


def fused_convnext_backbone(model):
    """A backbone like ``model``'s with ``fuse_convnext=True``: how a caller
    reaches the fused ConvNext path (DiffusionConfig has no such field, in
    either package)."""
    from arreau_tpu_torch.models.ponita import PonitaFiberBundle

    cfg = dataclasses.replace(model.model.config, fuse_convnext=True)
    return PonitaFiberBundle(cfg).to(model.device).eval()


# the launches inside #4 (spatial_conv_bwd.cu), #2 (fiber_conv_bwd.cu), #7
# (basis_sm90.cuh, basis_f32_sm90.cuh), #6 (basis_mlp_bwd.cuh), #10
# (convnext_mlp_bwd.cu, convnext_sm90.cuh) and #5 (fused_basis_mlp.cu), by
# the kernel function names a profile shows; the split sum is shared with
# every other split-K weight gradient (#7, #10, #6 and #2's dKf), and
# float32 #7's first pass with #8 (f32_h1_kernel)
BWD_INNER_KERNELS = {"::basis_h1_kernel<": "the h1 product of #6 or #5 "
                                          "(H1Out 1: #6, 2: #5)",
                     "::sm90::h1_kernel<": "#8 in bf16 (wgmma, TMA)",
                     "::basis_weight_copy_kernel<": "#8/#7: the weights' K-major copies, once "
                                                   "for each state of a weight",
                     "::basis32::f32_h1_kernel<": "#8, or #7's first pass, in float32 (tf32 "
                                                 "wgmma, TMA)",
                     "::basis32::f32_rows_kernel<": "#7 in float32: dpre2 (Pass 0) and dpre1 "
                                                   "(Pass 1) row passes",
                     "::basis32::dpre2_scale_kernel": "#7 in float32: dpre2 times the "
                                                     "cotangents' sum (streaming pass)",
                     "::basis32::f32_dw_kernel<": "#7 in float32: dW2 and dW1 split-K partials",
                     "::sm90::rows_kernel<": "#7 in bf16: h1, dpre2, dpre1 per row tile",
                     "::sm90::dw2_kernel<": "#7 in bf16: dW2 split-K partials",
                     "::sm90::dw1_kernel<": "#7 in bf16: dW1 split-K partials",
                     "::basis_out_kernel<": "#5 gelu(h @ W2)",
                     "::basis_dpre2_kernel<": "#6 db_pre",
                     "::wide_rows_partial_kernel<": "#6 dW2, float32 #10 [dW2; db2] and [dW1; "
                                                    "db1] split-K partials",
                     "::basis_dpre1_kernel<": "#6 dh_pre",
                     "::basis_dw1_partial_kernel<": "#6 dW1 split-K partials",
                     "::conv90::weights_kernel<": "#3/#4: W's K-major copies, once for each "
                                                 "version of W (wgmma, TMA)",
                     "::sconv_gxw_kernel<": "#4 gxw (edge cotangent, 16-byte chunks)",
                     "::sconv_dbasis_kernel<": "#4 dbasis (wgmma, TMA)",
                     "::sconv_dw_kernel<": "#4 dW split-K partials (wgmma; bf16 MN-major by "
                                           "TMA, float32 staged transposed)",
                     "::sconv_kern_kernel<": "#4 dxc (per-edge kernel on wgmma; with dwin its "
                                             "halves' partials too)",
                     "::dwin_sum_kernel": "#4 dwin (partials summed over o and the halves)",
                     "::gxw_kernel<": "#2 gxw (edge cotangent)",
                     "::dbasis_kernel<": "#2 dbasis",
                     "::dw_partial_kernel<": "#2 dW split-K partials",
                     "sum_splits_kernel": "split sum (#4 dW and every split-K pass)",
                     "::dx_terms_kernel<": "#2 dxc (per-edge kernel and dx terms)",
                     "::dx_kernel<": "#4/#2 dx (each sender's run)",
                     "::fiber_cotangent_kernel<": "#2 g_o",
                     "::fiber_kernel_grad_partial": "#2 dKf partials",
                     "::convnext_bwd_rows_kernel<": "float32 #10 rows (forward, dm, dpre1, dyln, "
                                                    "dxc)",
                     "::cnx_cotangent_kernel": "bf16 #10 g_total and dres",
                     "::cnx_rows_kernel<": "bf16 #10 rows (wgmma: forward, dm, dpre1, dyln, dxc)",
                     "::cnx_dw_kernel<": "bf16 #10 [dW2; db2] and [dW1; db1] split-K partials "
                                         "(wgmma, MN-major by TMA)",
                     "::cnx_readout_dw_kernel": "bf16 #10 [dWr; dbr] split partials",
                     "::cnx_weights_kernel": "#9/#10 bf16: the weights' K-major copies, each call's",
                     "::sum_blocks_kernel": "#10 sums of the row blocks' (tiles') partials"}


def profile_step(one_step, step_ms: float, steps: int = 3, what: str = "step") -> None:
    """Where a training step's (or, ``what``, a kernel call's) time goes: a
    torch.profiler trace of ``steps`` calls, the device's busy share, its
    largest kernels and each of #4's, #2's, #7's, #10's, #5's and #6's inner
    launches. A trace of a few short calls can miss the first launches (the
    device trace starts late), which lowers the busy share it reads."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
    by_name: dict = {}
    calls: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            calls[e.name] = calls.get(e.name, 0) + 1
    device_ms = sum(by_name.values()) / steps
    if device_ms > 0:
        print(f"device busy {device_ms:.4f} ms per {what} of {step_ms:.4f} ms "
              f"(busy share {device_ms / step_ms:.1%}, idle share {1 - device_ms / step_ms:.1%}); "
              f"{len(by_name)} distinct device activities; the largest, ms per {what}:")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {ms / steps:9.4f}  {name[:110]}")
        for key, label in BWD_INNER_KERNELS.items():
            for name, ms in by_name.items():
                if key in name:
                    # per launch too: the trace may miss a short call's first launches
                    print(f"  inner launch {label}: {ms / steps:.4f} ms per {what} in "
                          f"{calls[name] / steps:g} launches, {ms / calls[name]:.4f} ms a "
                          f"launch ({name[:80]})")
    else:
        print("device busy share: not measured (the profiler recorded no device activity)")


def crystal_checks(result, z_table, n, atoms, bounds) -> None:
    lengths = np.linalg.norm(result.lattice, axis=-1)
    lo, hi = bounds
    checks = {
        f"{n} crystals": result.num_crystals == n,
        f"{atoms} atoms each": bool(np.all(result.num_atoms == atoms))
        and len(result.frac_x) == n * atoms,
        "finite": all(np.isfinite(a).all() for a in (result.frac_x, result.lattice)),
        "frac in [0, 1)": bool(np.all((result.frac_x >= 0) & (result.frac_x < 1))),
        "lengths positive and clamped": bool(np.all((lengths > 0) & (lengths >= lo - 1e-4)
                                                    & (lengths <= hi + 1e-4))),
        "types in the z-table": bool(np.isin(result.atomic_numbers, z_table.zs).all()),
    }
    print("checks: " + ", ".join(f"{k} {'ok' if v else 'FAILED'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise RuntimeError("generated crystals failed their checks")


def training_path(ckpt: Path, extra_args: list, want_step: dict, card: str) -> dict:
    """The training CLI on the synthetic dataset at batch TRAIN_BATCH, hidden
    TRAIN_HIDDEN, for TRAIN_STEPS steps (``extra_args`` appended). Checks
    that every step launched ``want_step`` kernels and no other (counts set
    to 0 just before) and that every loss is finite; prints steps/s and
    returns the launch counts of the whole run."""
    t0 = time.perf_counter()
    per_step, step_metrics, rate, test_loss = counted_training([
        "--dataset", "synthetic", "--batch_size", str(TRAIN_BATCH),
        "--hidden_dim", str(TRAIN_HIDDEN), "--warmup", "0",
        "--max_steps", str(TRAIN_STEPS), "--seed", str(SEED),
        "--checkpoint_dir", str(ckpt), "--device", "cuda", *extra_args,
    ])
    wall = time.perf_counter() - t0
    train_counts = launch_counts()
    want_step = {name: want_step.get(name, 0) for name in train_counts}
    bad = [i for i, c in enumerate(per_step) if c != want_step]
    print(f"{len(per_step)} steps; launches per step {per_step[0] if per_step else None}; "
          f"launches in the whole run (evaluation forwards included) {train_counts}")
    if len(per_step) != TRAIN_STEPS or bad:
        raise RuntimeError(f"steps {bad} did not launch {want_step}")
    values = np.array([list(m.values()) for m in step_metrics])
    if not np.isfinite(values).all() or not math.isfinite(test_loss):
        raise RuntimeError("a training loss is not finite")
    CLI_RATES[" ".join(extra_args)] = rate
    print(f"training path {' '.join(extra_args)}: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, "
          f"hidden {TRAIN_HIDDEN} in {wall:.2f} s wall (build of the data, evaluation and "
          f"checkpoints included); {rate:.3f} steps/s warm on {card}")
    return {**train_counts, "threefry": threefry_launches()}


def counted_training(argv: list) -> tuple[list, list, float, float]:
    """The training CLI on ``argv`` (counts set to 0 just before): each
    step's launches and metrics, the steps/s it printed and what it
    returned (the test loss). The threefry kernel's launches (the noise is
    drawn before each training and evaluation step) must be LOSS_DRAWS a
    loss and one more a training step under ``--train_augm`` (the
    rotations)."""
    from arreau_tpu_torch.cli import train_diffusion

    per_step, metrics, step, evaluate = [], [], train_diffusion.train_step, \
        train_diffusion.eval_step
    evals = []

    def counted_step(*a, **kw):
        before = launch_counts()
        m = step(*a, **kw)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        metrics.append(m)  # read after the run: no synchronisation between steps
        return m

    def counted_eval(*a, **kw):
        evals.append(1)
        return evaluate(*a, **kw)

    reset_launch_counts()
    tee = Tee(sys.stdout)
    try:
        train_diffusion.train_step, train_diffusion.eval_step = counted_step, counted_eval
        with contextlib.redirect_stdout(tee):
            test_loss = train_diffusion.main(argv)
    finally:
        train_diffusion.train_step, train_diffusion.eval_step = step, evaluate
    rate = re.search(r"train throughput: ([0-9.]+) steps/s", tee.buf.getvalue())
    if rate is None:
        raise RuntimeError("the training CLI printed no throughput")
    args = train_diffusion.parse_args(argv)
    per_loss = LOSS_DRAWS[args.diffuse_angles]
    draws = threefry_launches()
    want = per_loss * (len(per_step) + len(evals)) + len(per_step) * int(args.train_augm)
    print(f"threefry: {draws} launches over {len(per_step)} training and {len(evals)} "
          f"evaluation steps ({per_loss} a loss, 1 more a training step under --train_augm)")
    if draws != want:
        raise RuntimeError(f"the training CLI drew through threefry {draws} times, not {want}")
    metrics = [{k: v.item() for k, v in m.items()} for m in metrics]
    return per_step, metrics, float(rate.group(1)), test_loss


def step_time(model, batch, noise, label: str, want_step: dict, kernels_ms: float) -> float:
    """One training step's launches (``want_step`` and no other kernel), its
    time at ``batch`` (CUDA events) and where it goes (profile_step);
    returns the step's milliseconds. ``noise`` is the diffusion loss's
    (None for a task whose loss takes the batch alone)."""
    from arreau_tpu_torch.train.loop import train_step
    from arreau_tpu_torch.train.optim import AdamW

    optimizer = AdamW(model.model, lambda count: 1e-3, weight_decay=1e-10)
    loss_args = () if noise is None else (noise,)

    def one_step():
        train_step(model, optimizer, None, batch, *loss_args)

    reset_launch_counts()
    one_step()
    first = launch_counts()
    want = {name: want_step.get(name, 0) for name in first}
    print(f"launches of one {label} step: {first}")
    if first != want:
        raise RuntimeError(f"a {label} step launched {first}, not {want}")
    step_ms = cuda_ms(one_step, runs=5)
    counts = launch_counts()
    steps = 1 + 3 + 5  # the counted step, cuda_ms's warm-up and timed steps
    if counts != {name: n * steps for name, n in want.items()}:
        raise RuntimeError(f"{steps} {label} steps launched {counts}")
    print(f"{label} training step at {tuple(batch[0].shape[:2])}: {step_ms:.4f} ms (CUDA "
          f"events, 5 steps), of which the kernels' launches {kernels_ms:.4f} ms "
          f"({kernels_ms / step_ms:.1%})")
    profile_step(one_step, step_ms)
    return step_ms, counts


# ---------------- the backbone tasks: N-body and MNIST superpixels ----------------

# the JAX package's Makefile recipe train-nbody (10000 epochs, valid every 20,
# batch 100, lr 1e-3) cut at 40 epochs of 30 steps
NBODY_ARGS = ["--epochs", "10000", "--val_interval", "20", "--batch_size", "100", "--lr", "1e-3",
              "--max_steps", "1200"]
NBODY_GATE_EPOCH = 39
# the gate on the valid MSE at epoch 39, fixed from the JAX records alone:
# between the JAX Ponita run of that recipe (0.006759, out/r2/nbody_lr1e3.log)
# and the JAX EGNN baseline at the same epoch (0.011975, out/r2/nbody_egnn2.log)
NBODY_GATE_MSE = 0.0100
EGNN_STEPS = 60
# the dataset's key (generate_nbody_npz's seed, the CLI's), its train split's
# size (--generate_train) and the systems the CLI trains on
NBODY_DATA_SEED, NBODY_SIMS, NBODY_TRAIN = 43, 10000, 3000
# the default (scan) chain's short run: 2 epochs of 30 steps, no --max_steps
NBODY_SCAN_EPOCHS = 2
# the backbone tasks' gradient check: each parameter within GRAD_REL_TOL of
# the larger of its own largest gradient and this share of the largest of all
TASK_GRAD_FLOOR = 1e-4
# 960 synthetic digits: 768 train (8 steps of 96), one batch each of valid and test
MNIST_ARGS = ["--synthetic_size", "960", "--max_steps", "40", "--val_interval", "5"]
# one step of either task: the spatial conv and its backward once a layer,
# the basis MLP's first layer and backward once (N-body 5 layers, MNIST 4)
NBODY_STEP = {"spatial_conv": 5, "spatial_conv_bwd": 5, "basis_h1": 1, "basis_mlp_bwd": 1}
MNIST_STEP = {"spatial_conv": 4, "spatial_conv_bwd": 4, "basis_h1": 1, "basis_mlp_bwd": 1}


def task_cli(cli, argv: list, want_step: dict, label: str) -> tuple[str, dict, list]:
    """A task's training CLI (``cli.main(argv)``), every step counted:
    returns (its standard output, the launch counts of the whole run,
    evaluation forwards included, and each step's metrics). Raises if a
    step launched other than ``want_step`` (counts set to 0 just before)."""
    per_step, step_metrics = [], []
    step = cli.train_step

    def counted_step(*a, **kw):
        before = launch_counts()
        metrics = step(*a, **kw)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        step_metrics.append(metrics)
        return metrics

    reset_launch_counts()
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    try:
        cli.train_step = counted_step
        with contextlib.redirect_stdout(tee):
            cli.main([*argv, "--device", "cuda"])
    finally:
        cli.train_step = step
    counts = launch_counts()
    want = {name: want_step.get(name, 0) for name in counts}
    bad = [i for i, c in enumerate(per_step) if c != want]
    print(f"{label}: {len(per_step)} steps in {time.perf_counter() - t0:.2f} s wall (data, "
          f"evaluation and checkpoints included); launches per step "
          f"{per_step[0] if per_step else None}; in the whole run {counts}")
    if bad:
        raise RuntimeError(f"{label}: steps {bad[:5]} did not launch {want}")
    return tee.buf.getvalue(), counts, step_metrics


def falling_losses(step_metrics: list, label: str, window: int = 10) -> None:
    """Every step's loss finite, and the mean of the last ``window`` below
    that of the first."""
    losses = torch.stack([m["loss"] for m in step_metrics]).float().cpu()
    first, last = losses[:window].mean().item(), losses[-window:].mean().item()
    print(f"{label}: loss over the first {window} steps {first:.6f}, over the last {last:.6f}")
    if not torch.isfinite(losses).all() or not last < first:
        raise RuntimeError(f"{label}: the loss is not finite and falling")


def branch_reference(card, cpu, batch, outputs, label: str) -> None:
    """One batch through ``card`` (a task on the card: the kernel branch)
    and ``cpu`` (the same task on the CPU's plain branch, given the card
    model's parameters), both on the neighbour list the CPU built: the
    forward (``outputs(model, batch, inputs)``) within KERNEL_REL_TOL of its
    scale, the loss within KERNEL_REL_TOL, every parameter gradient within
    GRAD_REL_TOL of its largest entry."""
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    dev = card.device
    batch_cpu = type(batch)(*(t.cpu() for t in batch))
    inputs_cpu = cpu.build_inputs(batch_cpu)
    inputs = inputs_cpu._replace(
        neighbors=type(inputs_cpu.neighbors)(*(t.to(dev) for t in inputs_cpu.neighbors)),
        **{f: getattr(inputs_cpu, f).to(dev)
           for f in ("scalar", "vec", "atom_mask", "lattice", "ori_grid")})
    with torch.no_grad():
        got, want = outputs(card, batch, inputs).cpu(), outputs(cpu, batch_cpu, inputs_cpu)
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    print(f"{label} forward: kernel branch (cuda) vs plain branch (cpu): max_abs_err {err:.3e}, "
          f"max |plain| {scale:.3e} (tolerance {KERNEL_REL_TOL:g} rel)")
    if not err <= KERNEL_REL_TOL * scale:
        raise RuntimeError(f"{label}: the kernel branch's forward disagrees with the plain branch")
    for model in (card, cpu):
        model.model.zero_grad(set_to_none=True)
    got_loss = card.loss(batch, inputs)[0]
    want_loss = cpu.loss(batch_cpu, inputs_cpu)[0]
    got_loss.backward()
    want_loss.backward()
    err = abs(got_loss.item() - want_loss.item())
    print(f"{label} loss: card {got_loss.item():.8f}, cpu {want_loss.item():.8f}, rel "
          f"{err / abs(want_loss.item()):.3e} (tolerance {KERNEL_REL_TOL:g})")
    if not err <= KERNEL_REL_TOL * abs(want_loss.item()):
        raise RuntimeError(f"{label}: the card's loss disagrees with the CPU's")
    worst = 0.0
    want_grads = dict(cpu.model.named_parameters())
    largest = max(p.grad.abs().max().item() for p in want_grads.values())
    for name, p in card.model.named_parameters():
        want = want_grads[name].grad
        err, scale = (p.grad.cpu() - want).abs().max().item(), want.abs().max().item()
        # a bias every orientation shares reaches a vector head only through
        # the grid's mean direction: its gradient cancels to ~0, so hold it to
        # a floor of TASK_GRAD_FLOOR of the largest gradient
        if not (scale > 0 and err <= GRAD_REL_TOL * max(scale, TASK_GRAD_FLOOR * largest)):
            raise RuntimeError(f"{label}: gradient of {name}: max_abs_err {err:.3e}, max |cpu| "
                               f"{scale:.3e} (tolerance {GRAD_REL_TOL:g} rel, floor "
                               f"{TASK_GRAD_FLOOR:g} of {largest:.3e})")
        worst = max(worst, err / max(scale, TASK_GRAD_FLOOR * largest))
    print(f"{label}: {len(want_grads)} parameter gradients, worst max_abs_err / max(max |cpu|, "
          f"{TASK_GRAD_FLOOR:g} x largest) {worst:.3e} (tolerance {GRAD_REL_TOL:g})")
    for model in (card, cpu):
        model.model.zero_grad(set_to_none=True)


def task_kernels(model, batch, label: str, suffix: str) -> dict:
    """Records of #3, #8, #4 and #7 on the inputs of one training step of
    ``model`` at ``batch``, named with ``suffix``."""
    with capturing() as args:
        model.loss(batch)[0].backward()
    model.model.zero_grad(set_to_none=True)
    with torch.no_grad():
        conv, h1, n_valid = forward_kernel_records(args, label, suffix)
        conv_bwd, mlp_bwd = backward_kernel_records(args, n_valid, suffix)
    return {r["name"]: r for r in (conv, h1, conv_bwd, mlp_bwd)}


def nbody_streams(records: dict) -> None:
    """The N-body CLI's draws on the card against ``prng.py``'s on the host:
    the train split's initial states as ``generate_nbody_npz(seed=43)``
    draws them (charges bit for bit; positions, velocities within
    STREAM_NORMAL_ULP), the default chain's first shuffle of
    NBODY_TRAIN systems (``jax.random.permutation``, bit for bit); then the
    threefry kernel at their shapes (a permutation round's bits, the
    dataset's normals), timed."""
    from arreau_tpu_torch.data.nbody import draw_charged
    from arreau_tpu_torch.kernels import threefry as tf

    train_key = prng.split(prng.prng_key(NBODY_DATA_SEED))[1]
    loc, vel, charges = (t.cpu() for t in draw_charged(train_key, NBODY_SIMS, device="cuda"))
    k_q, k_loc, k_vel = prng.split(train_key, 3)
    want_charges = np.where(prng.bernoulli(k_q, 0.5, (NBODY_SIMS, 5)), 1.0, -1.0)
    want_vel = prng.normal(k_vel, (NBODY_SIMS, 5, 3))
    want_vel = want_vel * np.float32(0.5) / np.linalg.norm(want_vel, axis=-1, keepdims=True)
    gaps = {"loc": ulp_gap(loc, torch.from_numpy(prng.normal(k_loc, (NBODY_SIMS, 5, 3)))),
            "vel": ulp_gap(vel, torch.from_numpy(want_vel.astype(np.float32)))}
    same_charges = np.array_equal(charges.numpy(), want_charges)
    print(f"nbody train split ({NBODY_SIMS} systems) drawn on the card against prng.py: charges "
          f"equal {same_charges}, positions {gaps['loc']} ulp, velocities {gaps['vel']} ulp "
          f"(tolerance {STREAM_NORMAL_ULP})")
    if not same_charges or max(gaps.values()) > STREAM_NORMAL_ULP:
        raise RuntimeError("the N-body initial states on the card are not JAX's draws")
    key = prng.split(prng.prng_key(SEED))[0]  # the CLI's chain after its init key
    kp = prng.split(prng.split(key)[1])[0]  # the first epoch's shuffle key
    got = tf.permutation(kp, NBODY_TRAIN, "cuda").cpu().numpy()
    same = np.array_equal(got, prng.permutation(kp, NBODY_TRAIN))
    print(f"nbody epoch 0 shuffle of {NBODY_TRAIN} ({prng.permutation_rounds(NBODY_TRAIN)} "
          f"rounds) on the card equal to prng.permutation: {same}")
    if not same:
        raise RuntimeError("the card's permutation is not jax.random.permutation's")
    round_key = prng.split(kp)[1]  # the first round's sort keys
    timed = {**threefry_records("nbody permutation", round_key[None], (NBODY_TRAIN,),
                                (("bits", torch.float32),)),
             **threefry_records("nbody dataset", k_loc[None], (NBODY_SIMS, 5, 3),
                                (("normal", torch.float32),))}
    records.setdefault("threefry", {}).setdefault("fields", {}).update(threefry_fields(timed))


def nbody_phase(tmp: Path, card: str, records: dict) -> None:
    """The N-body task: its draws on the card against ``prng.py``'s, the
    quality run through the training CLI (gated; the per-batch chain), its
    kernels at its shapes, the kernel branch against the plain branch, the
    step time, a short run of the default (scan) chain, then the EGNN
    baseline."""
    from arreau_tpu_torch.cli import train_nbody
    from arreau_tpu_torch.data.nbody import load_nbody_split
    from arreau_tpu_torch.tasks.nbody import NBodyBatch, NBodyConfig, NBodyModel

    data_dir, dev = tmp / "nbody", torch.device("cuda")
    nbody_streams(records)
    out, counts, _ = task_cli(train_nbody, [*NBODY_ARGS, "--data_dir", str(data_dir),
                                            "--checkpoint_dir", str(tmp / "ckpt_nbody")],
                              NBODY_STEP, "nbody")
    valid = re.search(rf"epoch {NBODY_GATE_EPOCH} \| valid MSE ([0-9.]+)", out)
    test = re.search(r"test MSE ([0-9.naninf]+)", out)
    if valid is None or test is None:
        raise RuntimeError("the N-body CLI printed no valid MSE at the gate's epoch or no test MSE")
    valid_mse, test_mse = float(valid.group(1)), float(test.group(1))
    print(f"nbody quality: valid MSE at epoch {NBODY_GATE_EPOCH} {valid_mse:.6f} (gate <= "
          f"{NBODY_GATE_MSE}; JAX Ponita 0.006759, JAX EGNN 0.011975), test MSE {test_mse:.6f} "
          f"on {card}")
    if not valid_mse <= NBODY_GATE_MSE or not math.isfinite(test_mse):
        raise RuntimeError(f"N-body valid MSE {valid_mse} left its gate {NBODY_GATE_MSE}")

    ex = load_nbody_split(str(data_dir), "train", max_samples=100)
    batch = NBodyBatch(*(torch.as_tensor(a, dtype=torch.float32, device=dev)
                         for a in (ex.loc0, ex.vel0, ex.charges, ex.loc_end)))
    model = NBodyModel(NBodyConfig(), dev)
    model.init(prng.prng_key(SEED))
    nbody = task_kernels(model, batch, "nbody 100x5", "_nbody")
    for name, record in nbody.items():
        record["launches"] = counts[name.removesuffix("_nbody")]
    records.update(nbody)
    branch_reference(model, NBodyModel(NBodyConfig(use_pallas=False), "cpu"), batch,
                     lambda m, b, i: m.predict_positions(b, i), "nbody")
    kernels_ms = sum(nbody[k + "_nbody"]["ms"] * n for k, n in NBODY_STEP.items())
    step_time(model, batch, None, "nbody", NBODY_STEP, kernels_ms)
    del model

    scan_args = [a for a in NBODY_ARGS if a not in ("--max_steps", "1200")]
    scan_args[scan_args.index("--epochs") + 1] = str(NBODY_SCAN_EPOCHS)
    out, counts, metrics = task_cli(train_nbody, [
        *scan_args, "--warmup", "0", "--data_dir", str(data_dir),
        "--checkpoint_dir", str(tmp / "ckpt_scan")], NBODY_STEP, "nbody scan chain")
    steps, draws = len(metrics), threefry_launches()
    want_draws = NBODY_SCAN_EPOCHS * prng.permutation_rounds(NBODY_TRAIN) + steps
    print(f"nbody scan chain: {steps} steps, threefry {draws} launches (a permutation round's "
          f"bits twice an epoch, a step's rotations; want {want_draws})")
    if steps != NBODY_SCAN_EPOCHS * (NBODY_TRAIN // 100) or draws != want_draws \
            or "NOTE" in out:
        raise RuntimeError("the N-body CLI's default chain did not run its epochs' draws")
    falling_losses(metrics, "nbody scan chain")
    records["threefry"]["launches_nbody_scan"] = draws

    _, counts, metrics = task_cli(train_nbody, [
        "--model", "egnn", "--hidden_dim", "64", "--layers", "4", "--max_steps", str(EGNN_STEPS),
        "--data_dir", str(data_dir), "--checkpoint_dir", str(tmp / "ckpt_egnn")], {}, "egnn")
    if len(metrics) != EGNN_STEPS:
        raise RuntimeError(f"egnn: {len(metrics)} steps, not {EGNN_STEPS}")
    falling_losses(metrics, "egnn")


def mnist_phase(tmp: Path, card: str, records: dict) -> None:
    """The MNIST-superpixels task: the training CLI at full width for 40
    steps (loss finite and falling), its kernels at its shapes, the kernel
    branch against the plain branch, the step time."""
    from arreau_tpu_torch.cli import train_mnist
    from arreau_tpu_torch.data.mnist import synthetic_superpixels
    from arreau_tpu_torch.tasks.mnist import Mnist2DBatch, MnistConfig, MnistModel

    dev = torch.device("cuda")
    _, counts, metrics = task_cli(train_mnist, [*MNIST_ARGS, "--checkpoint_dir",
                                                str(tmp / "ckpt_mnist")], MNIST_STEP, "mnist")
    falling_losses(metrics, "mnist", window=8)

    ex = synthetic_superpixels(96, seed=SEED + 1)
    batch = Mnist2DBatch(torch.as_tensor(ex.pos, device=dev), torch.as_tensor(ex.value, device=dev),
                         torch.as_tensor(ex.mask, device=dev),
                         torch.as_tensor(ex.label, dtype=torch.long, device=dev))
    model = MnistModel(MnistConfig(), dev)
    model.init(prng.prng_key(SEED))
    mnist = task_kernels(model, batch, "mnist 96x75", "_mnist")
    for name, record in mnist.items():
        record["launches"] = counts[name.removesuffix("_mnist")]
    records.update(mnist)
    branch_reference(model, MnistModel(MnistConfig(use_pallas=False), "cpu"), batch,
                     lambda m, b, i: m.logits(b, i), "mnist")
    kernels_ms = sum(mnist[k + "_mnist"]["ms"] * n for k, n in MNIST_STEP.items())
    step_time(model, batch, None, "mnist", MNIST_STEP, kernels_ms)


# ---------------- gradients through positions: position_grads, #4's dwin ----------------

# a position-gradient step of the diffusion backbone: #3 and #4 (with the
# window cotangent) once a layer, neither #8 nor #7 (the plain basis MLP)
POSITION_STEP = {"spatial_conv": 5, "spatial_conv_bwd": 5}


def position_grads_backbone(model):
    """A backbone like ``model``'s with ``position_grads=True``: how a caller
    that differentiates through positions builds it (DiffusionConfig has no
    such field, in either package)."""
    from arreau_tpu_torch.models.ponita import PonitaFiberBundle

    cfg = dataclasses.replace(model.model.config, position_grads=True)
    return PonitaFiberBundle(cfg).to(model.device)


def fixed_topology_graph(graph):
    """A stand-in for ``pbc_neighbor_list``: ``graph``'s senders, images and
    slot mask, the lengths and directions recomputed from the caller's
    positions and lattice (differentiable in both; an eps-free square root
    only on filled slots), so that two devices differentiate one graph."""
    from arreau_tpu_torch.ops.pbc import SUPERCELLS, NeighborList

    def build(cart, lattice, atom_mask, radius, max_neighbors):
        dev, (B, A, K) = cart.device, graph.src.shape
        src, image, mask = (t.to(dev) for t in (graph.src, graph.image, graph.mask))
        offsets = torch.einsum("ci,bij->bcj", torch.as_tensor(SUPERCELLS, dtype=cart.dtype,
                                                              device=dev), lattice)
        sender = torch.gather(cart, 1, src.reshape(B, A * K, 1).expand(B, A * K, 3))
        shift = torch.gather(offsets, 1, image.reshape(B, A * K, 1).expand(B, A * K, 3))
        direction = (sender + shift).reshape(B, A, K, 3) - cart[:, :, None, :]
        direction = torch.where(mask[..., None], direction, 0.0)
        sq = torch.where(mask, torch.sum(direction**2, dim=-1), 1.0)
        return NeighborList(src, image, torch.where(mask, torch.sqrt(sq), 0.0), direction, mask)

    return build


def window_cotangent_record(args, n_valid, suffix, tol, peak) -> dict:
    """#4 with its window cotangent (the captured call, ``window_grad``
    True) against its plain version, timed; the library yardstick is
    autograd's backward through the library chain with respect to the basis,
    w, x and the window."""
    from arreau_tpu_torch.kernels.spatial_conv import spatial_conv_bwd, spatial_conv_bwd_plain

    basis, w, x, src, win, g, window_grad = args["spatial_conv_bwd"]
    if window_grad is not True:
        raise RuntimeError("the position_grads path called #4 without its window cotangent")
    O, D, C = basis.shape[1], basis.shape[3], x.shape[3]
    leaves = [t.detach().requires_grad_() for t in (basis, w, x, win)]
    with torch.enable_grad():
        out = conv_library(leaves[0], leaves[1], leaves[2], src, leaves[3])
    return check_kernel(
        "spatial_conv_bwd_dwin" + suffix, spatial_conv_bwd, spatial_conv_bwd_plain,
        lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), args["spatial_conv_bwd"],
        O * n_valid * (6 * D * C + 8 * C),
        "arreau_tpu_torch/csrc/spatial_conv_bwd_sm90.cu", "arreau_tpu/ops/pallas_conv.py:331", tol,
        peak)


def position_reference(ref_cfg, seed: int, tol: float) -> None:
    """The gradient of a scalar of the scores with respect to the fractional
    coordinates and the lattice lengths, at full width on 32 crystals of 8
    atoms: the card's kernel branch with ``position_grads`` (5 #3 and 5 #4
    with the window cotangent, nothing else) against the CPU's plain
    branch, one graph topology (``fixed_topology_graph``), each gradient
    within ``tol`` of its largest entry."""
    from arreau_tpu_torch.tasks import diffusion
    from arreau_tpu_torch.tasks.diffusion import DiffusionModel

    dev, B = torch.device("cuda"), 32
    g = torch.Generator().manual_seed(seed)
    lengths = 3.0 + 5.0 * torch.rand((B, 3), generator=g)
    angles = torch.deg2rad(75.0 + 30.0 * torch.rand((B, 3), generator=g))
    frac = torch.rand((B, ATOMS, 3), generator=g)
    types = torch.nn.functional.one_hot(
        torch.randint(0, ref_cfg.num_atomic_states - 1, (B, ATOMS), generator=g),
        ref_cfg.num_atomic_states).float()
    t = torch.randint(1, ref_cfg.num_timesteps + 1, (B,), generator=g)
    num_atoms, mask = torch.full((B,), ATOMS), torch.ones((B, ATOMS), dtype=torch.bool)
    model = DiffusionModel(ref_cfg, device=dev)
    model.model = position_grads_backbone(model)
    model.model.init_parameters(prng.prng_key(seed))
    plain = DiffusionModel(dataclasses.replace(ref_cfg, use_pallas=False), device="cpu")
    plain.model.load_state_dict({k: v.cpu() for k, v in model.model.state_dict().items()})
    weights = None
    build_graph = diffusion.pbc_neighbor_list
    graphs, grads = [], {}
    try:
        diffusion.pbc_neighbor_list = lambda *a: graphs.append(build_graph(*a)) or graphs[-1]
        with torch.no_grad():
            plain._build_inputs(frac, types, t, num_atoms, lengths, angles, mask)
        diffusion.pbc_neighbor_list = fixed_topology_graph(graphs[0])
        for name, m, d in (("cpu", plain, "cpu"), ("cuda", model, dev)):
            leaves = (frac.to(d).requires_grad_(), lengths.to(d).requires_grad_())
            reset_launch_counts()
            outs = m.predict_scores(leaves[0], types.to(d), t.to(d), num_atoms.to(d), leaves[1],
                                    angles.to(d), mask.to(d))
            if weights is None:
                wg = torch.Generator().manual_seed(seed + 1)
                weights = [torch.randn(o.shape, generator=wg) for o in outs]
            s = sum((o * w.to(d)).sum() for o, w in zip(outs, weights))
            grads[name] = [x.cpu() for x in torch.autograd.grad(s, leaves)]
            counts = launch_counts()
    finally:
        diffusion.pbc_neighbor_list = build_graph
    want = {name: POSITION_STEP.get(name, 0) for name in counts}
    if counts != want:
        raise RuntimeError(f"a position-gradient forward and backward launched {counts}, not {want}")
    for label, got, ref in zip(("d/d frac", "d/d lengths"), grads["cuda"], grads["cpu"]):
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        print(f"{label}: kernel branch (cuda) vs plain branch (cpu), {B}x{ATOMS}: max_abs_err "
              f"{err:.3e}, max |cpu| {scale:.3e}, rel {err / scale:.3e} (tolerance {tol:g})")
        if not (scale > 0 and err <= tol * scale):
            raise RuntimeError(f"{label}: the card's position gradient disagrees with the CPU's")
    print(f"{graphs[0].mask.sum().item()} edges; launches of the card's forward and backward "
          f"{counts}")


def position_phase(dataset, chunk, bucket, train_cfg, card: str, records: dict) -> None:
    """The diffusion backbone with ``position_grads`` at the training shape,
    float32 and bfloat16: #4 with its window cotangent (and #3) captured in
    one training step, held against their plain versions and timed; the
    step's launches, time and profile; then the position gradient of the
    scores, card against CPU (``position_reference``)."""
    from arreau_tpu_torch.data.crystal import pack_dense_batch
    from arreau_tpu_torch.tasks.diffusion import DiffusionModel, batch_to_device, draw_loss_noise

    dev = torch.device("cuda")
    batch = batch_to_device(pack_dense_batch(dataset, chunk, bucket), dev)
    for dtype, suffix, tol, peak, ref_tol in (
            (None, "", KERNEL_REL_TOL, TF32X3_FLOP_PER_S, GRAD_REL_TOL),
            ("bfloat16", "_bf16", BF16_KERNEL_REL_TOL, BF16_FLOP_PER_S, BF16_GRAD_REL_TOL)):
        cfg = dataclasses.replace(train_cfg, compute_dtype=dtype)
        model = DiffusionModel(cfg, device=dev)
        model.model = position_grads_backbone(model)
        model.init(prng.prng_key(SEED), batch)
        noise = draw_loss_noise(prng.prng_key(SEED),
                                *batch.atom_types.shape, cfg.num_atomic_states, cfg.num_timesteps,
                                True, dev)
        with capturing() as args:
            model.loss(batch, noise)[0].backward()
        model.model.zero_grad(set_to_none=True)
        with torch.no_grad():
            basis, _, x, src = args["spatial_conv"][:4]
            TA = x.shape[2]
            n_valid = int(((src >= 0) & (src < TA)).sum())
            print(f"position_grads {dtype or 'float32'} {TRAIN_BATCH}x{bucket}: B'={basis.shape[0]} "
                  f"O={basis.shape[1]} E={basis.shape[2]} TA={TA} D={basis.shape[3]} "
                  f"C={x.shape[3]}, {n_valid} edge slots filled")
            record = window_cotangent_record(args, n_valid, suffix, tol, peak)
        del args
        kernels_ms = 5 * (record["ms"] + records["spatial_conv" + suffix]["ms"])
        torch.cuda.reset_peak_memory_stats()
        _, counts = step_time(model, batch, noise, f"position_grads {dtype or 'float32'}",
                              POSITION_STEP, kernels_ms)
        print(f"peak device memory of the position_grads steps: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {card}")
        record["launches"] = counts["spatial_conv_bwd"]
        records[record["name"]] = record
        del model, noise
        torch.cuda.empty_cache()
        position_reference(dataclasses.replace(cfg, layer_scale=1.0), SEED + 3, ref_tol)


# ---------------- the backbone tasks: QM9 and MD17 (no kernel) ----------------

# the JAX CLIs' synthetic defaults (QM9: 2000 molecules, batch 96; MD17: 1200,
# batch 16, lambda_F 500; both hidden 128, basis 256, 5 layers, K 8) with the
# gate runs' 300 epochs, cut at 48 steps (3 epochs) and 40 steps (epoch 0)
QM9_ARGS = ["--epochs", "300", "--max_steps", "48", "--val_interval", "1"]
MD17_ARGS = ["--epochs", "300", "--max_steps", "40", "--val_interval", "1"]
POINT_CLOUD_BATCH = 8  # molecules of the card-against-CPU comparison


def fixed_radius_graph(graph):
    """A stand-in for ``radius_neighbor_list``: ``graph``'s senders and slot
    mask, the lengths and directions recomputed from the caller's positions
    (differentiable, finite on empty slots), so that two devices
    differentiate one graph."""
    from arreau_tpu_torch.ops.pbc import NeighborList

    def build(pos, mask, radius, max_neighbors, loop=True):
        dev, (B, N, K) = pos.device, graph.src.shape
        src, slot = graph.src.to(dev), graph.mask.to(dev)
        sender = torch.gather(pos, 1, src.reshape(B, N * K, 1).expand(B, N * K, pos.shape[-1]))
        direction = sender.reshape(B, N, K, -1) - pos[:, :, None, :]
        direction = torch.where(slot[..., None], direction, 0.0)
        sq = torch.where(slot, torch.sum(direction**2, dim=-1), 1.0)
        return NeighborList(src, torch.zeros_like(src), torch.where(slot, torch.sqrt(sq), 0.0),
                            direction, slot)

    return build


def point_cloud_reference(card, cpu, batch, label: str, forces: bool) -> None:
    """One batch through ``card`` (a QM9 or MD17 task on the card) and
    ``cpu`` (the same on the CPU, given the card's parameters), one graph
    topology (``fixed_radius_graph`` of the CPU's): the loss within
    KERNEL_REL_TOL, every parameter gradient within GRAD_REL_TOL of the
    larger of its largest entry and TASK_GRAD_FLOOR of the largest of all;
    with ``forces``, the forces (-dE/dpos, outside a graph) within
    GRAD_REL_TOL of their scale, and the gradients those of a double
    backward."""
    from arreau_tpu_torch.tasks import qm9

    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    batch_cpu = type(batch)(*(t.cpu() for t in batch))
    build_graph = qm9.radius_neighbor_list
    graph = build_graph(batch_cpu.pos, batch_cpu.mask, cpu.config.radius or 1000.0,
                        cpu.config.max_neighbors, loop=False)
    try:
        qm9.radius_neighbor_list = fixed_radius_graph(graph)
        if forces:
            with torch.no_grad():
                (_, got), (_, want) = (card.predict_energy_and_force(batch),
                                       cpu.predict_energy_and_force(batch_cpu))
            err, scale = (got.cpu() - want).abs().max().item(), want.abs().max().item()
            print(f"{label} forces: card vs cpu, max_abs_err {err:.3e}, max |cpu| {scale:.3e} "
                  f"(tolerance {GRAD_REL_TOL:g} rel)")
            if not err <= GRAD_REL_TOL * scale:
                raise RuntimeError(f"{label}: the card's forces disagree with the CPU's")
        for model in (card, cpu):
            model.model.zero_grad(set_to_none=True)
        got_loss, want_loss = card.loss(batch)[0], cpu.loss(batch_cpu)[0]
        got_loss.backward()
        want_loss.backward()
    finally:
        qm9.radius_neighbor_list = build_graph
    err = abs(got_loss.item() - want_loss.item())
    print(f"{label} loss: card {got_loss.item():.8f}, cpu {want_loss.item():.8f}, rel "
          f"{err / abs(want_loss.item()):.3e} (tolerance {KERNEL_REL_TOL:g})")
    if not err <= KERNEL_REL_TOL * abs(want_loss.item()):
        raise RuntimeError(f"{label}: the card's loss disagrees with the CPU's")
    want_grads = dict(cpu.model.named_parameters())
    largest = max(p.grad.abs().max().item() for p in want_grads.values())
    worst = 0.0
    for name, p in card.model.named_parameters():
        want = want_grads[name].grad
        err, scale = (p.grad.cpu() - want).abs().max().item(), want.abs().max().item()
        bound = max(scale, TASK_GRAD_FLOOR * largest)
        if not err <= GRAD_REL_TOL * bound:
            raise RuntimeError(f"{label}: gradient of {name}: max_abs_err {err:.3e}, max |cpu| "
                               f"{scale:.3e} (tolerance {GRAD_REL_TOL:g} rel)")
        worst = max(worst, err / bound)
    print(f"{label}: {len(want_grads)} parameter gradients, worst max_abs_err / max(max |cpu|, "
          f"{TASK_GRAD_FLOOR:g} x largest) {worst:.3e} (tolerance {GRAD_REL_TOL:g})")
    for model in (card, cpu):
        model.model.zero_grad(set_to_none=True)


def point_cloud_phase(tmp: Path, card: str, task: str) -> None:
    """QM9 or MD17 (``task``): the training CLI at full width on its
    synthetic defaults, cut short (no kernel launches, the loss finite and
    falling); one batch card against CPU; a step's time, profile and peak
    device memory at the CLI's batch."""
    from arreau_tpu_torch.cli import train_md17, train_qm9
    from arreau_tpu_torch.data.molecules import synthetic_molecules
    from arreau_tpu_torch.tasks.md17 import MD17Batch, MD17Config, MD17Model
    from arreau_tpu_torch.tasks.qm9 import MoleculeBatch, QM9Config, QM9Model

    dev = torch.device("cuda")
    md17 = task == "md17"
    cli, argv = (train_md17, MD17_ARGS) if md17 else (train_qm9, QM9_ARGS)
    out, _, metrics = task_cli(cli, [*argv, "--checkpoint_dir", str(tmp / f"ckpt_{task}")], {},
                               task)
    falling_losses(metrics, task, window=8)
    rate = re.search(r"train throughput: ([0-9.]+) steps/s", out)
    print(f"{task} CLI: " + (f"{rate.group(1)} steps/s warm on {card}" if rate else
                             "no warm epoch (the run ends inside epoch 0)"))

    data = synthetic_molecules(1200 if md17 else 2000, seed=SEED, with_forces=md17)
    B = 16 if md17 else 96
    fields = (data.pos, data.one_hot, data.mask, data.y) + ((data.forces,) if md17 else ())
    batch = (MD17Batch if md17 else MoleculeBatch)(*(
        torch.as_tensor(a[:B], dtype=None if a.dtype == bool else torch.float32, device=dev)
        for a in fields))
    shift, scale = float(np.mean(data.y)), float(np.std(data.y))
    Model, Config = (MD17Model, MD17Config) if md17 else (QM9Model, QM9Config)
    model = Model(Config(input_dim=data.one_hot.shape[-1]), shift, scale, dev)
    model.init(prng.prng_key(SEED))
    small = type(batch)(*(t[:POINT_CLOUD_BATCH] for t in batch))
    point_cloud_reference(model, Model(model.config, shift, scale, "cpu"), small, task, md17)
    torch.cuda.reset_peak_memory_stats()
    step_time(model, batch, None, task, {}, 0.0)
    print(f"{task} peak device memory of the steps at batch {B}: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {card}")


def flagship_model():
    """(model, z-table, meta) of the trained flagship on the card, its raw
    weights (the flagship command's ``--use_ema false``)."""
    from arreau_tpu_torch.cli import generate

    return generate.load_model(str(FLAGSHIP), "best", False, "cuda")


def flagship_launches(forwards: int, L: int) -> dict:
    """5 bf16 #3 and 1 bf16 #8 a forward of the flagship, no other kernel."""
    return {name: {"spatial_conv": L, "basis_h1": 1}.get(name, 0) * forwards
            for name in launch_counts()}


def snapshot_labels(num_timesteps: int) -> list:
    """The labels of the dense chain's snapshots every SNAPSHOT_EVERY steps:
    T - 1 - steps done (T = 1000: 989, 979, ..., 9, 0)."""
    return list(range(num_timesteps - 1 - SNAPSHOT_EVERY, 0, -SNAPSHOT_EVERY)) + [0]


def snapshot_phase(card: str, records: dict) -> None:
    """The flagship's dense chain (999 steps) on SNAPSHOT_BATCH x ATOMS with a
    snapshot every SNAPSHOT_EVERY steps from seed SEED: 100 snapshots labelled
    989, ..., 9, 0; bf16 #3 and #8 alone, once a layer / once a forward; the
    final batch equal bit for bit to the chain without snapshots."""
    from arreau_tpu_torch.inference.io import from_dense_batch

    model, z_table, _ = flagship_model()
    cfg = model.config
    T, L = cfg.num_timesteps, cfg.num_layers
    dtypes = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    with capturing(dtypes):
        batch, snaps = model.sample(SNAPSHOT_BATCH, ATOMS, snapshot_every=SNAPSHOT_EVERY,
                                    key=prng.prng_key(SEED))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, want = launch_counts(), flagship_launches(T - 1, L)
    print(f"snapshot chain: {T - 1} forwards, launches {counts}; element types {dtypes}")
    if counts != want:
        raise RuntimeError(f"the snapshot chain launched {counts}, not {want}")
    if dtypes != {"spatial_conv": {torch.bfloat16}, "basis_h1": {torch.bfloat16}}:
        raise RuntimeError(f"the snapshot chain's kernels ran in {dtypes}, not bfloat16 alone")
    labels, want_labels = [t for t, _ in snaps], snapshot_labels(T)
    print(f"{len(snaps)} snapshots labelled {labels[:3]} ... {labels[-3:]}")
    if labels != want_labels:
        raise RuntimeError(f"snapshot labels {labels}, not {want_labels}")
    t0 = time.perf_counter()
    plain = model.sample(SNAPSHOT_BATCH, ATOMS,
                         key=prng.prng_key(SEED))
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0
    same = {name: torch.equal(getattr(batch, name), getattr(plain, name))
            for name in plain._fields}
    print(f"final batch equals the chain without snapshots bit for bit: {same}")
    if not all(same.values()):
        raise RuntimeError("snapshot sampling changed the chain's result")
    for _, snap in snaps:
        if not (torch.isfinite(snap.frac_x).all() and torch.isfinite(snap.lattice).all()):
            raise RuntimeError("a snapshot is not finite")
    crystal_checks(from_dense_batch(batch, z_table), z_table, SNAPSHOT_BATCH, ATOMS,
                   (0.0, math.inf))
    print(f"snapshot sampling: {SNAPSHOT_BATCH} x {ATOMS}, {T - 1} steps, {seconds:.2f} s with "
          f"snapshots, {plain_seconds:.2f} s without, on {card}")
    for name in ("spatial_conv", "basis_h1"):
        records[name + "_bf16"]["launches_snapshots"] = counts[name]


def renders_phase(tmp: Path, card: str) -> None:
    """generate ``--gif --visualize --show_bonds`` on the flagship
    (SNAPSHOT_BATCH x ATOMS) where matplotlib and PIL import: the GIF, its
    frames and the crystals' PNGs exist; where either does not, generate
    ``--gif`` raises its ImportError before any kernel launch."""
    from arreau_tpu_torch.cli import generate
    from arreau_tpu_torch.inference.visualize import require_renderers

    argv = ["--checkpoint_dir", str(FLAGSHIP), "--tag", "best", "--use_ema", "false",
            "--num_crystals", str(SNAPSHOT_BATCH), "--batch_size", str(SNAPSHOT_BATCH),
            "--num_atoms_per_sample", str(ATOMS), "--clip_denoised", "false",
            "--seed", str(SEED), "--device", "cuda", "--out_dir", str(tmp),
            "--gif", "true", "--visualize", "true", "--show_bonds", "true"]
    try:
        require_renderers()
        missing = None
    except ImportError as e:
        missing = e
    reset_launch_counts()
    if missing is not None:
        print(f"renders: branch 'no renderer' ({missing}); generate --gif must raise it before "
              "any kernel launch")
        try:
            generate.main(argv)
        except ImportError as e:
            print(f"generate raised ImportError: {e}")
        else:
            raise RuntimeError("generate --gif ran without matplotlib or PIL")
        counts = launch_counts()
        print(f"launches {counts}")
        if any(counts.values()):
            raise RuntimeError("generate launched kernels before raising its ImportError")
        return
    print("renders: branch 'render' (matplotlib and PIL import)")
    t0 = time.perf_counter()
    generate.main(argv)
    seconds = time.perf_counter() - t0
    labels = snapshot_labels(json.loads((FLAGSHIP / "meta.json").read_text())["config"][
        "num_timesteps"])
    want = (["sampling.gif"] + [f"crystal_{i}.png" for i in range(4)]
            + [f"sampling_steps/step_{t}.png" for t in labels])
    found = [w for w in want if (tmp / w).is_file() and (tmp / w).stat().st_size > 0]
    frames = len(list((tmp / "sampling_steps").glob("step_*.png")))
    print(f"rendered in {seconds:.2f} s: {len(found)} of the {len(want)} files (sampling.gif, "
          f"4 crystals, {len(labels)} frames); {frames} frames in sampling_steps/")
    if found != want or frames != len(labels):
        raise RuntimeError("generate --gif --visualize did not write its files")


def dispatched_ops(fn) -> dict:
    """{ATen operator: calls} dispatched while ``fn()`` runs (the host's
    work a call, operator by operator)."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.calls


def export_phase(tmp: Path, card: str, records: dict, steps: int = EXPORT_STEPS,
                 variants: tuple = (False, True)) -> None:
    """export_sampler on the flagship at FLAGSHIP_BATCH x ATOMS, ``steps``
    strided steps, fixed and ``variable_num_atoms``: the export launches no
    kernel; ``load_exported`` and ``call(SEED)`` launch 5 bf16 #3 and 1 bf16
    #8 a step and nothing else, and give the in-process sampler's crystals
    from the same seed (types equal, frac and lattice within 1e-6; bit for
    bit is reported); export seconds, artifact bytes and crystals/min of
    the artifact against the in-process sampler over EXPORT_TIMED_CALLS warm
    calls. The JAX export's serving point, S = 100, by hand: ``python3 -c
    'import chip_smoke as s, pathlib, tempfile; s.export_phase(pathlib.Path(
    tempfile.mkdtemp()), "", {}, steps=100, variants=(False,))'``."""
    from arreau_tpu_torch.cli import export_sampler, generate
    from arreau_tpu_torch.inference.export import load_exported

    model, _, meta = flagship_model()
    bounds = generate.length_bounds_from_meta(meta)
    L = model.config.num_layers
    B = FLAGSHIP_BATCH
    for variable in variants:
        label = "variable_num_atoms" if variable else "fixed"
        out = tmp / f"sampler_{label}.pt2"
        reset_launch_counts()
        t0 = time.perf_counter()
        sidecar = export_sampler.main([
            "--checkpoint_dir", str(FLAGSHIP), "--tag", "best", "--use_ema", "false",
            "--batch_size", str(B), "--num_atoms_per_sample", str(ATOMS),
            "--sample_steps", str(steps), "--variable_num_atoms", str(variable).lower(),
            "--out", str(out), "--device", "cuda"])
        wall = time.perf_counter() - t0
        traced = launch_counts()
        if any(traced.values()):
            raise RuntimeError(f"the export launched kernels: {traced}")
        t0 = time.perf_counter()
        call, _ = load_exported(str(out))
        load_s = time.perf_counter() - t0
        counts_arg = None
        if variable:
            counts_arg = torch.as_tensor(np.random.default_rng(SEED).integers(1, ATOMS + 1, B),
                                         device="cuda")
        S = sidecar["noise_steps"]

        def artifact():
            return call(SEED, counts_arg) if variable else call(SEED)

        def in_process():
            return model.sample(B, ATOMS, key=prng.prng_key(SEED), sample_steps=steps,
                                length_bounds=bounds, num_atoms=counts_arg)

        reset_launch_counts()
        got = artifact()
        torch.cuda.synchronize()
        counts, want = launch_counts(), flagship_launches(S, L)
        print(f"{label} artifact: {S} steps, launches {counts}")
        if counts != want:
            raise RuntimeError(f"the artifact launched {counts}, not {want}")
        ref = in_process()
        types_equal = torch.equal(got[1], ref.atom_types)
        errs = [(a.double() - b.double()).abs().max().item()
                for a, b in ((got[0], ref.frac_x), (got[2], ref.lattice))]
        bits = all(torch.equal(a, b)
                   for a, b in zip(got, (ref.frac_x, ref.atom_types, ref.lattice)))
        print(f"{label} artifact against the in-process sampler, seed {SEED}: types equal "
              f"{types_equal}, max |frac diff| {errs[0]:.3e}, max |lattice diff| {errs[1]:.3e} "
              f"(tolerance 1e-6), bit for bit {bits}")
        if not (types_equal and max(errs) <= 1e-6):
            raise RuntimeError(f"the {label} artifact disagrees with the in-process sampler")
        if not variable:
            ops = {"artifact": dispatched_ops(artifact), "in-process": dispatched_ops(in_process)}
            n = {k: sum(v.values()) for k, v in ops.items()}
            diff = sorted(set(ops["artifact"]) | set(ops["in-process"]),
                          key=lambda op: -abs(ops["artifact"][op] - ops["in-process"][op]))
            print(f"ATen operators dispatched a call: artifact {n['artifact']}, in-process "
                  f"{n['in-process']} ({n['artifact'] / n['in-process']:.3f}x); the largest "
                  "differences (artifact, in-process): " + ", ".join(
                      f"{op} {ops['artifact'][op]}/{ops['in-process'][op]}" for op in diff[:8]))
        rates = {}
        for name, fn in (("artifact", artifact), ("in-process", in_process)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(EXPORT_TIMED_CALLS):
                fn()
            torch.cuda.synchronize()
            rates[name] = EXPORT_TIMED_CALLS * B / (time.perf_counter() - t0) * 60
        print(f"{label} export: {sidecar['export_seconds']:.2f} s in torch.export ({wall:.2f} s "
              f"for the CLI, checkpoint load and save included), artifact {sidecar['bytes']} "
              f"bytes, load {load_s:.2f} s; {rates['artifact']:.0f} crystals/min from the "
              f"artifact, {rates['in-process']:.0f} in-process ({EXPORT_TIMED_CALLS} warm calls "
              f"of {B} x {ATOMS}, {S} steps) on {card}")
        if not variable:
            for name in ("spatial_conv", "basis_h1"):
                records.setdefault(name + "_bf16", {})["launches_export"] = counts[name]


def training_leftovers_phase(tmp: Path, card: str) -> None:
    """The training CLI at batch TRAIN_BATCH, hidden TRAIN_HIDDEN for two
    epochs with ``--log true --profiler torch`` in ``tmp``: the notice of a
    missing wandb (or its run, offline), a non-empty Chrome trace of epoch 1
    under ``profile_results/`` naming the forward and backward kernels, and
    the steps/s and the device's idle share of epoch 1 beside the 35-step
    CLI phase's steps/s (both prefetching)."""
    import os

    from arreau_tpu_torch.cli import train_diffusion

    os.environ["WANDB_MODE"] = "offline"  # a wandb run (the card's machine has wandb) stays local
    tee = Tee(sys.stdout)
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(tmp), contextlib.redirect_stdout(tee):
        loss = train_diffusion.main([
            "--dataset", "synthetic", "--batch_size", str(TRAIN_BATCH),
            "--hidden_dim", str(TRAIN_HIDDEN), "--epochs", "2", "--warmup", "0",
            "--val_interval", "1", "--seed", str(SEED), "--checkpoint_dir", str(tmp / "ckpt"),
            "--device", "cuda", "--log", "true", "--profiler", "torch"])
    wall = time.perf_counter() - t0
    out = tee.buf.getvalue()
    wandb = "wandb not available; logging to stdout only" in out
    print(f"--log: {'the notice (no wandb)' if wandb else 'a wandb run, offline'}")
    if not wandb and "wandb" not in sys.modules:
        raise RuntimeError("--log printed no notice and started no wandb run")
    traces = sorted((tmp / "profile_results").glob("*.json"))
    if len(traces) != 1 or traces[0].stat().st_size == 0:
        raise RuntimeError(f"--profiler torch wrote {traces}, not one trace")
    text = traces[0].read_text()
    named = {k: k in text for k in ("sconv_fwd_kernel", "f32_h1_kernel", "sconv_dbasis_kernel",
                                    "f32_rows_kernel")}
    print(f"trace {traces[0].name}: {traces[0].stat().st_size} bytes; kernels named {named}")
    if not all(named.values()):
        raise RuntimeError("the trace does not name the port's kernels")
    rate = re.search(r"train throughput: ([0-9.]+) steps/s", out)
    idle = re.search(r"idle share ([0-9.]+)%", out)
    if rate is None or idle is None or not math.isfinite(loss):
        raise RuntimeError("the training CLI printed no throughput or idle share")
    counts = launch_counts()
    if not all(counts[k] > 0 for k in ("spatial_conv", "basis_h1", "spatial_conv_bwd",
                                        "basis_mlp_bwd")):
        raise RuntimeError(f"the training CLI missed a kernel: {counts}")
    print(f"training CLI with --log --profiler torch: {float(rate.group(1)):.3f} steps/s warm "
          f"(epoch 1 profiled), device idle share {idle.group(1)}% of epoch 1, {wall:.2f} s wall; "
          f"the 35-step CLI phase: {CLI_RATES.get('', float('nan')):.3f} steps/s (both prefetch) "
          f"on {card}")


# ---------------- fifteenth slice: import, calibration, exploration tools ----------------

# the JAX package's equivariance check on a TPU (out/r5/equivariance_tpu.log:
# the same command's tiny model, 64 shared draws at timestep 5): (original,
# rotated, gap) per loss term
JAX_EQUIVARIANCE_TPU = {"loss_coord": (0.0019, 0.0019, "0.00%"),
                        "loss_type": (1.9483, 1.9483, "0.00%"),
                        "loss_lattice": (0.0317, 0.0317, "0.00%"),
                        "loss_angle": (0.2586, 0.2586, "0.00%"),
                        "loss": (2.2404, 2.2404, "0.00%")}
EQUIV_STEP = {"spatial_conv": 2, "spatial_conv_bwd": 2, "basis_h1": 1, "basis_mlp_bwd": 1}
EQUIV_FORWARD = {"spatial_conv": 2, "basis_h1": 1}
EQUIV_REFERENCE_DRAWS = 4
# one bf16 forward of one crystal (or a few sampler steps), card kernel
# branch against CPU plain branch: the two round at different points (5e-2
# of scale, the bf16 gradient tolerance)
BF16_DRAW_REL_TOL = 5e-2
DIAG_BATCH, DIAG_EVERY, DIAG_REFERENCE_STEPS = 64, 25, 3


def reference_state_dict(model, z_table) -> dict:
    """The port model's weights under the reference's (Lightning
    PONITA_DIFFUSION) key names: the table of ``interop/torch_import.py``
    read backwards, every ``nn.Linear`` weight as ``[out, in]``; with the
    buffers the importer drops (``callibrated``) and zero-width edge
    readouts."""
    from arreau_tpu_torch.interop.from_jax import _flatten, params_to_jax

    flat = {k: torch.from_numpy(v) for k, v in _flatten(params_to_jax(model.model)).items()}

    def put(ours: str, theirs: str, transpose: bool):
        value = flat.pop(f"params/{ours}")
        sd[theirs] = value.t().contiguous() if transpose else value

    sd: dict = {"z_table_zs": torch.tensor([int(z) for z in z_table.zs]),
                "t_emb.gaussian_fourier_proj_w": model.fourier_w.detach().cpu().clone()}
    for ours, theirs in (("basis_fn", "model.basis_fn"), ("fiber_basis_fn", "model.fiber_basis_fn")):
        for dense, index in (("dense_in", 1), ("dense_out", 3)):
            put(f"{ours}/{dense}/kernel", f"{theirs}.{index}.weight", True)
            put(f"{ours}/{dense}/bias", f"{theirs}.{index}.bias", False)
    put("x_embedder/kernel", "model.x_embedder.weight", True)
    cfg = model.config
    for i in range(cfg.num_layers):
        t = f"model.interaction_layers.{i}"
        put(f"layer_{i}/conv/kernel", f"{t}.conv.kernel.weight", True)
        put(f"layer_{i}/conv/fiber_kernel/kernel", f"{t}.conv.fiber_kernel.weight", True)
        put(f"layer_{i}/conv/bias", f"{t}.conv.bias", False)
        sd[f"{t}.conv.callibrated"] = torch.tensor(True)
        put(f"layer_{i}/norm/scale", f"{t}.norm.weight", False)
        put(f"layer_{i}/norm/bias", f"{t}.norm.bias", False)
        for lin in ("linear_1", "linear_2"):
            put(f"layer_{i}/{lin}/kernel", f"{t}.{lin}.weight", True)
            put(f"layer_{i}/{lin}/bias", f"{t}.{lin}.bias", False)
        put(f"layer_{i}/layer_scale", f"{t}.layer_scale", False)
        put(f"readout_{i}/kernel", f"model.read_out_layers.{i}.weight", True)
        put(f"readout_{i}/bias", f"model.read_out_layers.{i}.bias", False)
        sd[f"model.edge_readout_layers.{i}.weight"] = torch.zeros((0, cfg.hidden_dim + 4))
        sd[f"model.edge_readout_layers.{i}.bias"] = torch.zeros((0,))
    if flat:
        raise RuntimeError(f"weights without a reference name: {sorted(flat)}")
    return sd


def write_reference_ckpt(path: Path, model, z_table) -> None:
    """A Lightning-shaped ``.ckpt`` of ``model``: the state_dict under the
    reference's names, the hyper-parameter namespace, and an object whose
    class does not import when the file is loaded (as the reference's
    ``AtomicNumberTable``)."""
    import argparse
    import types

    cfg = model.config
    args = argparse.Namespace(hidden_dim=cfg.hidden_dim, basis_dim=cfg.basis_dim,
                              layers=cfg.num_layers, num_ori=cfg.num_ori, degree=cfg.degree,
                              num_timesteps=cfg.num_timesteps, radius=cfg.radius,
                              max_neighbors=cfg.max_neighbors,
                              widening_factor=cfg.widening_factor, layer_scale=cfg.layer_scale,
                              multiple_readouts=cfg.multiple_readouts, lr=1e-3, epochs=10)
    name = "reference_only_pkg"
    fake = types.ModuleType(name)

    class AtomicNumberTable:
        def __init__(self, zs):
            self.zs = zs

    AtomicNumberTable.__module__, AtomicNumberTable.__qualname__ = name, "AtomicNumberTable"
    fake.AtomicNumberTable = AtomicNumberTable
    sys.modules[name] = fake
    try:
        torch.save({"state_dict": reference_state_dict(model, z_table),
                    "hyper_parameters": {"args": args,
                                         "z_table": AtomicNumberTable(list(z_table.zs))},
                    "epoch": 3, "global_step": 123}, str(path))
    finally:
        del sys.modules[name]  # the class no longer imports: the loader must stub it


def import_phase(tmp: Path, card: str, records: dict) -> None:
    """A reference ``.ckpt`` of the seeded full-width model through the
    import CLI (a subprocess, as a user runs it) and generate on the result:
    the imported weights equal the source's bit for bit, every forward
    launches L #3 and one #8 and nothing else, and the crystals equal bit for
    bit those generate gives on the source weights (a checkpoint with the
    same meta) from the same seed."""
    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.inference.io import load_sample_results
    from arreau_tpu_torch.interop.from_jax import (
        _flatten,
        load_params_npz,
        params_to_jax,
        save_params_npz,
    )
    from arreau_tpu_torch.tasks.diffusion import DiffusionConfig, DiffusionModel

    z_table = synthetic_z_table()
    cfg = DiffusionConfig(num_atomic_states=len(z_table))
    model = DiffusionModel(cfg, device="cuda")
    model.model.init_parameters(prng.prng_key(SEED))
    ckpt = tmp / "reference.ckpt"
    write_reference_ckpt(ckpt, model, z_table)
    print(f"reference checkpoint {ckpt.name}: {ckpt.stat().st_size} bytes "
          f"(hidden {cfg.hidden_dim}, basis {cfg.basis_dim}, {cfg.num_layers} layers, "
          f"{cfg.num_ori} orientations)")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "arreau_tpu_torch.cli.import_checkpoint",
                           "--ckpt", str(ckpt), "--out_dir", str(tmp / "imported")],
                          capture_output=True, text=True, timeout=300,
                          cwd=Path(__file__).resolve().parent)
    seconds = time.perf_counter() - t0
    print(proc.stdout.strip())
    if proc.returncode != 0:
        raise RuntimeError(f"import_checkpoint failed:\n{proc.stderr[-4000:]}")
    print(f"import: {seconds:.2f} s wall for the CLI process (interpreter and torch start "
          f"included), on the host")
    source = _flatten(params_to_jax(model.model))
    meta = json.loads((tmp / "imported" / "meta.json").read_text())
    for name in ("params.npz", "ema_params.npz"):
        imported = _flatten(load_params_npz(str(tmp / "imported" / "best" / name)))
        same = imported.keys() == source.keys() and all(
            np.array_equal(imported[k], v) for k, v in source.items())
        print(f"imported {name} equals the source weights bit for bit: {same}")
        if not same:
            raise RuntimeError(f"the imported {name} is not the source model's")

    # the source weights, served with the imported checkpoint's meta
    (tmp / "source" / "best").mkdir(parents=True)
    (tmp / "source" / "meta.json").write_text(json.dumps(meta))
    save_params_npz(str(tmp / "source" / "best" / "params.npz"), params_to_jax(model.model))
    del model
    L = cfg.num_layers
    results = {}
    for name in ("imported", "source"):
        tee = Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            counts = sampler_path(tmp / name, tmp / f"out_{name}", meta, z_table, card,
                                  {"spatial_conv": L, "basis_h1": 1}, tag="best")
        if name == "imported":
            for kernel in ("spatial_conv", "basis_h1"):
                records[kernel]["launches_import"] = counts[kernel]
        rate = re.search(r"sampler throughput: ([0-9.]+) crystals/min", tee.buf.getvalue())
        results[name] = vars(load_sample_results(str(tmp / f"out_{name}" / "crystals.h5")))
        print(f"{name}: {float(rate.group(1)) if rate else float('nan'):.0f} crystals/min warm "
              f"on {card}")
    same = {k: np.array_equal(results["imported"][k], results["source"][k])
            for k in results["source"]}
    print(f"imported checkpoint's crystals equal the source weights' bit for bit: {same}")
    if not all(same.values()):
        raise RuntimeError("the imported checkpoint samples other crystals than its source")


def calibration_phase(card: str, records: dict) -> None:
    """``calibrate_conv_kernels`` on one noisy training batch's backbone
    inputs (the training cell), on the card through the kernels (L #3, one
    #8, nothing else) and on the CPU's plain branch with the same weights
    and the same neighbour list: the stds within KERNEL_REL_TOL of each
    other, the rescaled kernels within KERNEL_REL_TOL of their scale."""
    import copy

    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.data.crystal import pack_dense_batch
    from arreau_tpu_torch.models.calibrate import calibrate_conv_kernels
    from arreau_tpu_torch.ops.pbc import NeighborList
    from arreau_tpu_torch.tasks.diffusion import (
        DiffusionConfig,
        DiffusionModel,
        batch_to_device,
        draw_loss_noise,
    )

    dev = torch.device("cuda")
    # layer scale 1 (not the init's 1e-6), so that each layer's conv weighs in
    # its output's std and a rescale moves the layers after it
    cfg = DiffusionConfig(num_atomic_states=len(synthetic_z_table()), hidden_dim=TRAIN_HIDDEN,
                          diffuse_angles=True, layer_scale=1.0)
    dataset, chunk, bucket = training_chunk()
    batch = batch_to_device(pack_dense_batch(dataset, chunk, bucket), dev)
    model = DiffusionModel(cfg, device=dev)
    model.init(prng.prng_key(SEED), batch)
    noise = draw_loss_noise(prng.prng_key(SEED),
                            *batch.atom_types.shape, cfg.num_atomic_states, cfg.num_timesteps,
                            True, dev)
    captured = []
    handle = model.model.register_forward_pre_hook(lambda m, args: captured.append(args[0]))
    with torch.no_grad():
        model.loss(batch, noise)
    handle.remove()
    inputs = captured[0]
    plain = DiffusionModel(dataclasses.replace(cfg, use_pallas=False), device="cpu")
    plain.model.load_state_dict({k: v.cpu() for k, v in model.model.state_dict().items()})
    cpu_inputs = inputs._replace(
        neighbors=NeighborList(*(a.cpu() for a in inputs.neighbors)),
        **{f: getattr(inputs, f).cpu() for f in ("scalar", "vec", "atom_mask", "lattice",
                                                  "ori_grid")})
    print(f"training cell {TRAIN_BATCH} x {bucket}: neighbours "
          f"{tuple(inputs.neighbors.mask.shape)}, scalar features {tuple(inputs.scalar.shape)}, "
          f"{int(inputs.neighbors.mask.sum())} edges")

    reset_launch_counts()
    t0 = time.perf_counter()
    stds = calibrate_conv_kernels(model.model, inputs)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launch_counts()
    L = cfg.num_layers
    want = {name: {"spatial_conv": L, "basis_h1": 1}.get(name, 0) for name in counts}
    print(f"calibration on the card: {card_s:.3f} s, launches {counts}")
    if counts != want:
        raise RuntimeError(f"the calibration probe launched {counts}, not {want}")
    for kernel in ("spatial_conv", "basis_h1"):
        records[kernel]["launches_calibration"] = counts[kernel]
    t0 = time.perf_counter()
    want_stds = calibrate_conv_kernels(plain.model, cpu_inputs)
    print(f"calibration on the CPU (plain branch): {time.perf_counter() - t0:.3f} s")
    after = calibrate_conv_kernels(copy.deepcopy(model.model), inputs)
    print(f"{'layer':<10} {'std (card)':>14} {'std (cpu)':>14} {'after (card)':>14}")
    for name, std in stds.items():
        print(f"{name:<10} {std:>14.8f} {want_stds[name]:>14.8f} {after[name]:>14.8f}")
        if not abs(std - want_stds[name]) <= KERNEL_REL_TOL * abs(want_stds[name]):
            raise RuntimeError(f"{name}: the card's std disagrees with the CPU's")
    got = dict(model.model.named_parameters())
    for name, p in plain.model.named_parameters():
        err = (got[name].detach().cpu() - p.detach()).abs().max().item()
        scale = p.detach().abs().max().item()
        if not err <= KERNEL_REL_TOL * scale:
            raise RuntimeError(f"{name}: card {err:.3e} from the CPU (scale {scale:.3e})")
    print(f"rescaled kernels and every other parameter: card within {KERNEL_REL_TOL:g} of the "
          f"CPU's scale, on {card}")


def component_reference(ckpt: Path, tol: float, label: str, of_total: bool) -> None:
    """The first EQUIV_REFERENCE_DRAWS draws (seed 0) of the equivariance
    comparison on the card (the checkpoint's kernel branch) against the
    CPU's plain branch, per crystal, on the CPU's neighbour lists: every
    loss term within ``tol`` of max(|term|, 1e-3), or with ``of_total`` of
    the draw's total loss. bf16 takes ``of_total``: a term that is the
    square of a small residual (the trained flagship's lattice term, ~4e-4)
    carries its prediction's rounding magnified by prediction over residual,
    and the coordinate scores of a nearly clean crystal (t = 5) cancel over
    the orientations; the two branches round at different points."""
    from arreau_tpu_torch.cli import generate
    from arreau_tpu_torch.data.crystal import pack_dense_batch
    from arreau_tpu_torch.exploration import verify_equivariance as ve
    from arreau_tpu_torch.tasks.diffusion import LossNoise, batch_to_device, draw_loss_noise

    card = generate.load_model(str(ckpt), "best", False, "cuda")[0]
    cpu = generate.load_model(str(ckpt), "best", False, "cpu")[0]
    cfg = card.config
    ds = ve.build_equivariance_datasets("datasets/alexandria_hdf5")[0]
    max_atoms = int(ds.packed.num_atoms.max())
    draws = [draw_loss_noise(k, 1, max_atoms, cfg.num_atomic_states, cfg.num_timesteps,
                             cfg.diffuse_angles, "cuda", ve.EVAL_EQUIVARIANCE_TIMESTEP)
             for k in prng.split(prng.prng_key(0), EQUIV_REFERENCE_DRAWS)]
    cpu_draws = [LossNoise(**{f.name: None if getattr(n, f.name) is None
                              else getattr(n, f.name).cpu() for f in dataclasses.fields(n)})
                 for n in draws]
    worst = {}
    for idx in (0, 1):
        host = pack_dense_batch(ds, np.array([idx]), max_atoms)
        graphs: list = []
        with shared_graphs(graphs):
            want = ve.component_draws(cpu, batch_to_device(host, "cpu"), cpu_draws)
        with shared_graphs(graphs, replay_on=torch.device("cuda")):
            got = ve.component_draws(card, batch_to_device(host, "cuda"), draws)
        for k in ve.COMPONENTS:
            if k not in want:
                continue
            a, b = got[k].cpu(), want[k]
            err = (a - b).abs()
            scale = want["loss"].abs() if of_total else torch.clamp(b.abs(), min=1e-3)
            worst[k] = max(worst.get(k, 0.0), (err / scale).max().item())
            if not bool((err <= tol * scale).all()):
                raise RuntimeError(f"{label}, crystal {idx}, {k}: card {a.tolist()} against "
                                   f"cpu {b.tolist()} (tolerance {tol:g})")
    print(f"{label}: {len(draws)} draws x 2 crystals, card against the CPU's plain branch on one "
          f"topology, each term's worst error over "
          f"{'the total loss' if of_total else 'max(|term|, 1e-3)'} (tolerance {tol:g}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def equivariance_table(label: str, orig: dict, rot: dict) -> None:
    print(f"{label}: {'component':<14}{'original':>12}{'rotated':>12}{'rel gap':>10}   "
          f"JAX on a TPU (out/r5/equivariance_tpu.log)")
    for comp, (ja, jb, jgap) in JAX_EQUIVARIANCE_TPU.items():
        if comp not in orig:
            continue
        a, b = orig[comp], rot[comp]
        gap = abs(a - b) / max(abs(a), 1e-9)
        print(f"{label}: {comp:<14}{a:>12.6f}{b:>12.6f}{gap:>10.2e}   {ja:.4f} {jb:.4f} {jgap}")


def equivariance_phase(tmp: Path, card: str, records: dict) -> None:
    """(a) The port's ``verify_equivariance.main()`` (the JAX tool's command:
    40 epochs, hidden 32, 2 layers, 8 orientations) on the card: every
    training step launches EQUIV_STEP and no other kernel, every validation
    forward EQUIV_FORWARD, the comparison 128 forwards of EQUIV_FORWARD;
    (b) ``compare_components`` on the trained flagship (bf16,
    ``diffuse_angles``), 64 shared draws. Each beside the JAX TPU log; the
    first EQUIV_REFERENCE_DRAWS draws of each, card against CPU. The gaps are
    printed, not gated."""
    from arreau_tpu_torch.cli import train_diffusion
    from arreau_tpu_torch.exploration import verify_equivariance as ve

    per_step, per_eval, after_training = [], [], {}
    steps = {"train_step": train_diffusion.train_step, "eval_step": train_diffusion.eval_step}
    train_main = ve.train_main

    def counted(name, record):
        def call(*a, **kw):
            before = launch_counts()
            out = steps[name](*a, **kw)
            after = launch_counts()
            record.append({k: after[k] - before[k] for k in after})
            return out
        return call

    def counted_train_main(argv):
        out = train_main(argv)
        after_training.update(launch_counts())
        return out

    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        train_diffusion.train_step = counted("train_step", per_step)
        train_diffusion.eval_step = counted("eval_step", per_eval)
        ve.train_main = counted_train_main
        with contextlib.chdir(tmp):
            orig, rot = ve.main(["--device", "cuda"])
    finally:
        train_diffusion.train_step = steps["train_step"]
        train_diffusion.eval_step = steps["eval_step"]
        ve.train_main = train_main
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want_step = {k: EQUIV_STEP.get(k, 0) for k in counts}
    want_eval = {k: EQUIV_FORWARD.get(k, 0) for k in counts}
    comparison = {k: counts[k] - after_training[k] for k in counts}
    want_comparison = {k: 2 * 64 * EQUIV_FORWARD.get(k, 0) for k in counts}
    print(f"eval-equivariance: {len(per_step)} training steps, {len(per_eval)} evaluation "
          f"forwards, {wall:.2f} s wall (training, checkpoints and the comparison); launches per "
          f"step {per_step[0]}, per evaluation forward {per_eval[0]}, in the comparison "
          f"{comparison}")
    if len(per_step) != 40 or any(c != want_step for c in per_step):
        raise RuntimeError(f"a training step did not launch {want_step}")
    if not per_eval or any(c != want_eval for c in per_eval):
        raise RuntimeError(f"an evaluation forward did not launch {want_eval}")
    if comparison != want_comparison:
        raise RuntimeError(f"the comparison launched {comparison}, not {want_comparison}")
    for kernel in EQUIV_STEP:
        records[kernel]["launches_equivariance"] = counts[kernel]
    equivariance_table("(a) eval-equivariance", orig, rot)
    component_reference(tmp / ve.CKPT_DIR, KERNEL_REL_TOL, "(a) float32", of_total=False)

    reset_launch_counts()
    dtypes = {}
    t0 = time.perf_counter()
    with capturing(dtypes):
        orig, rot = ve.compare_components(str(FLAGSHIP), device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    meta = json.loads((FLAGSHIP / "meta.json").read_text())["config"]
    counts, want = launch_counts(), flagship_launches(2 * 64, meta["num_layers"])
    print(f"(b) flagship: 128 forwards in {seconds:.2f} s, launches {counts}, types {dtypes}")
    if counts != want or dtypes != {"spatial_conv": {torch.bfloat16},
                                    "basis_h1": {torch.bfloat16}}:
        raise RuntimeError(f"the flagship comparison launched {counts} in {dtypes}, not {want}")
    for kernel in EQUIV_FORWARD:
        records[kernel + "_bf16"]["launches_equivariance"] = counts[kernel]
    equivariance_table("(b) flagship", orig, rot)
    component_reference(FLAGSHIP, BF16_DRAW_REL_TOL, "(b) bf16 flagship", of_total=True)


def diagnosis_phase(tmp: Path, card: str, records: dict) -> None:
    """``diagnose_sampler`` on the flagship at DIAG_BATCH x ATOMS, the dense
    chain's 999 steps recorded every DIAG_EVERY: 5 bf16 #3 and 1 bf16 #8 a
    step and nothing else, every record finite; then its first
    DIAG_REFERENCE_STEPS steps on the card against the CPU's plain branch
    with the same injected noise on one topology (5e-2 of scale)."""
    from arreau_tpu_torch.cli import generate
    from arreau_tpu_torch.exploration import diagnose_sampler as ds
    from arreau_tpu_torch.tasks.diffusion import SamplerNoise

    out = tmp / "diag_sampler.json"
    dtypes, captured = {}, []
    draw = ds.draw_diagnosis_noise

    def recording(*a, **kw):
        captured.append(draw(*a, **kw))
        return captured[-1]

    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        ds.draw_diagnosis_noise = recording
        with capturing(dtypes):
            chain = ds.main(["--checkpoint_dir", str(FLAGSHIP), "--num_samples", str(DIAG_BATCH),
                             "--num_atoms_per_sample", str(ATOMS), "--record_every",
                             str(DIAG_EVERY), "--out", str(out), "--device", "cuda"])
    finally:
        ds.draw_diagnosis_noise = draw
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    meta = json.loads((FLAGSHIP / "meta.json").read_text())["config"]
    T, L, C = meta["num_timesteps"], meta["num_layers"], meta["num_atomic_states"]
    counts, want = launch_counts(), flagship_launches(T - 1, L)
    draws = threefry_launches()
    print(f"diagnosis: {T - 1} steps at {DIAG_BATCH} x {ATOMS} in {seconds:.2f} s (checkpoint "
          f"load and reference set included) on {card}; launches {counts}; types {dtypes}; "
          f"threefry {draws}")
    if counts != want or dtypes != {"spatial_conv": {torch.bfloat16},
                                    "basis_h1": {torch.bfloat16}} or draws != SAMPLER_DRAWS:
        raise RuntimeError(f"the diagnosis launched {counts} in {dtypes} and {draws} threefry "
                           f"draws, not {want} and {SAMPLER_DRAWS}")
    # its noise: the JAX tool's own chain off PRNGKey(seed), as prng.py draws it
    noise = captured[0]
    k_ang, k_len, k_frac, k_loop = prng.split(prng.prng_key(SEED), 4)
    steps = ds.diagnosis_step_keys(k_loop, T - 1)
    B = DIAG_BATCH
    gaps = {"lengths0": ulp_gap(noise.lengths0.cpu(),
                                torch.from_numpy(prng.normal(k_len, (B, 3)))),
            "frac0": ulp_gap(noise.frac0.cpu(), torch.from_numpy(prng.normal(k_frac, (B, ATOMS, 3))))}
    if meta["diffuse_angles"]:  # the flagship's: the prior's angle encodings are normals
        gaps["ang_enc0"] = ulp_gap(noise.ang_enc0.cpu(),
                                   torch.from_numpy(prng.normal(k_ang, (B, 6))))
    for s in (0, T - 2):
        lat, pos, typ, ang = (steps[s, i] for i in range(4))
        for name, w in {"lattice": prng.normal(lat, (B, 3)), "pos": prng.normal(pos, (B, ATOMS, 3)),
                        "types": prng.uniform(typ, (B, ATOMS, C)),
                        "angle": prng.normal(ang, (B, 6))}.items():
            gaps[f"{name}[{s}]"] = ulp_gap(getattr(noise, name)[s].cpu(), torch.from_numpy(w))
    print(f"diagnosis noise against prng.py's for the JAX tool's chain (ulp): {gaps}")
    if any(v > (0 if k.startswith("types") else STREAM_NORMAL_ULP) for k, v in gaps.items()):
        raise RuntimeError("the diagnosis did not draw the JAX tool's stream")
    for kernel in ("spatial_conv", "basis_h1"):
        records[kernel + "_bf16"]["launches_diagnosis"] = counts[kernel]
    saved = json.loads(out.read_text())
    finite = all(math.isfinite(v) for r in saved["records"] for v in r.values())
    print(f"{out.name}: {len(saved['records'])} records (t = {saved['records'][0]['t']} ... "
          f"{saved['records'][-1]['t']}), all finite: {finite}; last {chain[-1]}")
    if not finite or saved["records"] != chain or len(chain) != (T - 1) // DIAG_EVERY + 2:
        raise RuntimeError("the diagnosis records are not finite, complete and written")

    card_model = generate.load_model(str(FLAGSHIP), "best", False, "cuda")[0]
    cpu_model = generate.load_model(str(FLAGSHIP), "best", False, "cpu")[0]
    noise = ds.draw_diagnosis_noise(prng.prng_key(SEED), DIAG_REFERENCE_STEPS, DIAG_BATCH, ATOMS,
                                    C, meta["diffuse_angles"], "cuda")
    cpu_noise = SamplerNoise(**{f.name: None if getattr(noise, f.name) is None
                                else getattr(noise, f.name).cpu()
                                for f in dataclasses.fields(noise)})
    l0 = ds.reference_lengths("synthetic:20000:0")
    graphs: list = []
    with shared_graphs(graphs):
        _, want_state = ds.diagnose(cpu_model, cpu_noise, *l0, DIAG_EVERY, DIAG_REFERENCE_STEPS,
                                    verbose=False)
    with shared_graphs(graphs, replay_on=torch.device("cuda")):
        _, got_state = ds.diagnose(card_model, noise, *l0, DIAG_EVERY, DIAG_REFERENCE_STEPS,
                                   verbose=False)
    for name in ("lengths", "ang_enc", "pred_x0", "frac"):
        a, b = got_state[name].float().cpu(), want_state[name].float()
        d = (a - b).abs()
        if name == "frac":  # on the circle: 0 and 1 - ulp are neighbours
            d = torch.minimum(d, 1 - d)
        err, scale = d.max().item(), b.abs().max().item()
        print(f"first {DIAG_REFERENCE_STEPS} steps, {name}: card against cpu max_abs_err "
              f"{err:.3e}, scale {scale:.3e} (tolerance {BF16_DRAW_REL_TOL:g} of scale)")
        if not err <= BF16_DRAW_REL_TOL * scale:
            raise RuntimeError(f"the diagnosis' {name} on the card disagrees with the CPU's")
    agree = (got_state["types"].cpu() == want_state["types"]).float().mean().item()
    print(f"first {DIAG_REFERENCE_STEPS} steps, types: {agree:.4f} of the atoms agree")
    if agree < 0.9:
        raise RuntimeError("the diagnosis' types on the card disagree with the CPU's")


def eda_phase(tmp: Path, crystals: Path, card: str) -> None:
    """dataset_stats on 2000 synthetic crystals; vp_prior_check (its own gate
    must print PASS); lattice_eda (its statistics, then the renderer branch
    it took); view_crystals ``generated`` on ``crystals``: its ImportError
    before any work where the renderers do not import, else its PNG."""
    from arreau_tpu_torch.exploration import (
        dataset_stats,
        lattice_eda,
        view_crystals,
        vp_prior_check,
    )
    from arreau_tpu_torch.inference.visualize import require_renderers

    stats = dataset_stats.main(["--synthetic_size", "2000"])
    if stats["num_crystals"] != 2000:
        raise RuntimeError("dataset_stats did not count 2000 crystals")
    reset_launch_counts()
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        ok = vp_prior_check.main(["--out_dir", str(tmp / "eda"), "--device", "cuda"])
        lattice_eda.main(["--out_dir", str(tmp / "eda"), "--device", "cuda"])
    text = tee.buf.getvalue()
    if not ok or "PASS" not in text.splitlines():
        raise RuntimeError("vp_prior_check: the terminal marginal FAILED its N(0, 1) check")
    branch = "plots skipped" if "plots skipped" in text else "rendered"
    print(f"vp_prior_check: PASS; lattice_eda: branch '{branch}'")
    try:
        require_renderers()
        missing = None
    except ImportError as e:
        missing = e
    out = tmp / "crystal_vis"
    argv = ["generated", "--crystal_file", str(crystals), "--index", "0", "1",
            "--out_dir", str(out)]
    if missing is None:
        view_crystals.main(argv)
        if not (out / "generated_1.png").is_file():
            raise RuntimeError("view_crystals wrote no PNG")
        print("view_crystals: rendered generated_0.png and generated_1.png")
        return
    try:
        view_crystals.main(argv)
    except ImportError as e:
        print(f"view_crystals: ImportError before any work ({e})")
    else:
        raise RuntimeError("view_crystals ran without matplotlib or PIL")
    if out.exists():
        raise RuntimeError("view_crystals did work before its ImportError")


# ---------------- data and tensor parallelism on one card ----------------

# the training cell (256 x 16, hidden 200, basis 256, 5 layers, 16
# orientations, diffuse_angles) through the training CLI, 10 steps
PARALLEL_CLI_ARGS = [
    "--dataset", "synthetic", "--batch_size", str(TRAIN_BATCH), "--hidden_dim", str(TRAIN_HIDDEN),
    "--basis_dim", "256", "--layers", "5", "--num_ori", "16", "--diffuse_angles", "true",
    "--warmup", "0", "--max_steps", "10", "--seed", str(SEED), "--device", "cuda",
]
# a step over ranks against the one-process step on the same batch and noise:
# loss terms (relative), gradients and parameters after the step (each within
# this share of its largest entry)
DP_LOSS_REL_TOL = 1e-5
DP_PARAM_REL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# under TP in bfloat16 the plain branch's row-split products (the fiber
# basis MLP, every ConvNext layer off fuse_convnext) are float32 partial sums
# over the model ranks, rounded to bfloat16 once summed, where one card
# rounds its own float32 accumulation: a sum next to a rounding boundary
# takes the neighbouring bfloat16 (one ulp, 2^-8) and the loss terms move
# ~1e-5 (measured on an H100: 2.75e-05 on loss_coord, PERF.md §6)
TP_BF16_LOSS_REL_TOL = 1e-3
# AdamW's first update is lr * g / (|g| + eps): the sign of g wherever |g| >>
# eps, so an entry whose gradient is at its roundoff (either sign, on one
# process as on several) moves by 2 lr either way; the parameter gate reads
# the entries whose one-process gradient exceeds this share of its tensor's
# largest (the gradients themselves are gated whole)
PARAM_GRAD_FLOOR = 1e-4
# generate --data_parallel over 2 ranks against one process (50 strided steps)
DP_SAMPLER_ATOL = 1e-4
PARALLEL_TIMEOUT = 600
DEFAULT_STEP = {"spatial_conv": 5, "basis_h1": 1, "spatial_conv_bwd": 5, "basis_mlp_bwd": 1}
CONVNEXT_STEP = {**DEFAULT_STEP, "convnext_mlp": 5, "convnext_mlp_bwd": 5}


def run_ranks(n: int, task: str, out: Path) -> float:
    """``chip_smoke.py --rank task out`` on ``n`` ranks through
    ``python -m torch.distributed.run`` (its process group and every rank
    stopped at the end or at PARALLEL_TIMEOUT); returns the wall seconds.
    The ranks talk over the loopback device."""
    import os
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
           "--master_addr", "localhost", "--master_port", str(port),
           str(Path(__file__).resolve()), "--rank", task, str(out)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, env=env,
                            start_new_session=True)
    try:
        rc = proc.wait(timeout=PARALLEL_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if rc != 0:
        raise RuntimeError(f"{n} ranks of '{task}' exited with {rc}")
    return time.perf_counter() - t0


def recorded_training(argv: list) -> list:
    """The training CLI's per-step metrics ({name: float}) on ``argv``."""
    from arreau_tpu_torch.cli import train_diffusion

    steps, step = [], train_diffusion.train_step

    def recording(*a, **kw):
        metrics = step(*a, **kw)
        steps.append(metrics)
        return metrics

    train_diffusion.train_step = recording
    try:
        train_diffusion.main(argv)
    finally:
        train_diffusion.train_step = step
    return [{k: v.item() for k, v in m.items()} for m in steps]


def parallel_step(mesh, compute_dtype, fuse_convnext: bool) -> dict:
    """One training step of the training cell's model (layer scale 1, so the
    layers weigh in the gradients) on the 256 x 16 chunk, on ``mesh``: the
    rank's rows and its rows of the whole batch's noise, the parameters
    split under TP. Returns the loss metrics, the step's launches, the
    gradients and parameters after the step gathered whole (on the host),
    the local shape of one split weight and the mean of 3 more steps'
    milliseconds (host clock around a synchronised step)."""
    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.data.crystal import pack_dense_batch
    from arreau_tpu_torch.parallel.mesh import shard_batch, shard_state, state_shardings, whole_state
    from arreau_tpu_torch.tasks.diffusion import (
        DiffusionConfig,
        DiffusionModel,
        batch_to_device,
        draw_loss_noise,
    )
    from arreau_tpu_torch.train.loop import train_step
    from arreau_tpu_torch.train.optim import AdamW

    dev = torch.device("cuda")
    cfg = DiffusionConfig(num_atomic_states=len(synthetic_z_table()), hidden_dim=TRAIN_HIDDEN,
                          diffuse_angles=True, layer_scale=1.0, compute_dtype=compute_dtype)
    model = DiffusionModel(cfg, device=dev)
    if fuse_convnext:
        model.model = fused_convnext_backbone(model)
    model.model.init_parameters(prng.prng_key(SEED + 3))
    dataset, chunk, bucket = training_chunk()
    batch = batch_to_device(pack_dense_batch(dataset, chunk, bucket), dev)
    noise = draw_loss_noise(prng.prng_key(SEED + 3),
                            *batch.atom_types.shape, cfg.num_atomic_states, cfg.num_timesteps,
                            True, dev)
    shard_state(model, mesh)
    optimizer = AdamW(model.model, lambda count: 1e-3, mesh=mesh)
    batch, noise = shard_batch(batch, mesh), noise.rows(mesh)
    reset_launch_counts()
    metrics = train_step(model, optimizer, None, batch, noise)
    counts = launch_counts()
    plan = state_shardings(model.model)
    named = dict(model.model.named_parameters())
    # host copies now: the timed steps below update the parameters in place
    grads = {n: g.cpu().clone()
             for n, g in whole_state({n: p.grad for n, p in named.items()}, plan, mesh).items()}
    params = {n: p.cpu().clone()
              for n, p in whole_state({n: p.detach() for n, p in named.items()}, plan,
                                      mesh).items()}
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(model, optimizer, None, batch, noise)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "launches": counts,
            "grads": grads, "params": params,
            "split": tuple(named["layers.0.linear_1.weight"].shape),
            "whole": tuple(params["layers.0.linear_1.weight"].shape),
            "rows": int(batch.atom_types.shape[0]), "step_ms": sum(times) / len(times)}


def rank_main(task: str, out: Path) -> int:
    """One rank of a parallel phase (``chip_smoke.py --rank task out`` under
    torchrun): ``nccl1`` the training CLI's per-step metrics; ``dp`` (2
    ranks, data 2) a float32 and a bfloat16 step, then generate
    ``--data_parallel``; ``tp`` (4 ranks, data 2 x model 2) a float32 step
    and a bfloat16 ``fuse_convnext`` step. Each rank writes its results
    under ``out``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.distributed as dist

    from arreau_tpu_torch.cli import generate
    from arreau_tpu_torch.parallel.mesh import make_mesh, maybe_initialize_distributed

    if task == "nccl1":
        steps = recorded_training([*PARALLEL_CLI_ARGS, "--checkpoint_dir", str(out / "ck_nccl")])
        rank = dist.get_rank()
        torch.save({"steps": steps, "backend": dist.get_backend(), "world": dist.get_world_size()},
                   out / f"nccl1_rank{rank}.pt")
        dist.destroy_process_group()
        return 0
    rank, _ = maybe_initialize_distributed("cuda")
    mesh = make_mesh(model_size=2 if task == "tp" else 1)
    cases = ((("float32", None, False), ("bfloat16", "bfloat16", False)) if task == "dp"
             else (("float32", None, False), ("bfloat16", "bfloat16", True)))
    results = {"backend": dist.get_backend(),
               "mesh": [mesh.data_size, mesh.model_size, mesh.data_rank, mesh.model_rank]}
    for label, dtype, fuse in cases:
        results[label] = parallel_step(mesh, dtype, fuse)
        torch.cuda.empty_cache()
    if task == "dp":
        reset_launch_counts()
        generate.main(json.loads((out / "generate_args.json").read_text()))
        results["generate_launches"] = launch_counts()
    torch.save(results, out / f"{task}_rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def step_gate(label: str, got: dict, want: dict, tol: float, want_launches: dict,
              loss_tol: float = DP_LOSS_REL_TOL) -> None:
    """A rank's step against the one-process step: loss terms within
    ``loss_tol``, grad_norm, every gradient and the parameters after the
    step (PARAM_GRAD_FLOOR) within ``tol`` of scale, the launches
    ``want_launches`` and no other kernel."""
    launches = {k: v for k, v in got["launches"].items() if v}
    if launches != want_launches:
        raise RuntimeError(f"{label}: launched {launches}, not {want_launches}")
    for name, value in want["metrics"].items():
        rel = abs(got["metrics"][name] - value) / max(abs(value), 1e-12)
        limit = tol if name == "grad_norm" else loss_tol
        if not rel <= limit:
            raise RuntimeError(f"{label}: {name} {got['metrics'][name]!r} against one process's "
                               f"{value!r} (rel {rel:.3e}, tolerance {limit:g})")
    worst, unresolved = {}, 0
    for what in ("grads", "params"):
        worst[what] = 0.0
        for name, w in want[what].items():
            diff = (got[what][name] - w).abs()
            if what == "params":
                g = want["grads"][name].abs()
                resolved = g > PARAM_GRAD_FLOOR * g.max()
                unresolved += int((~resolved).sum())
                diff = diff[resolved]
            err = (diff.max().item() if diff.numel() else 0.0) / w.abs().max().item()
            if not err <= tol:
                raise RuntimeError(f"{label}: {what} {name} off by {err:.3e} of scale "
                                   f"(tolerance {tol:g})")
            worst[what] = max(worst[what], err)
    print(f"{label}: loss {got['metrics']['loss']:.6f} (one process {want['metrics']['loss']:.6f});"
          f" worst gradient {worst['grads']:.3e}, parameter {worst['params']:.3e} of scale "
          f"(tolerance {tol:g}; {unresolved} entries with gradients below {PARAM_GRAD_FLOOR:g} of "
          f"their tensor's not read); launches {launches}")


def nccl_phase(tmp: Path, card: str) -> None:
    """The training CLI under ``torch.distributed.run --nproc_per_node 1``
    (NCCL, world size 1) against the CLI without the launcher, same seed:
    every step's metrics bit for bit."""
    wall = run_ranks(1, "nccl1", tmp)
    got = torch.load(tmp / "nccl1_rank0.pt", weights_only=False)
    if got["backend"] != "nccl" or got["world"] != 1:
        raise RuntimeError(f"the launcher's run took backend {got['backend']}, world "
                           f"{got['world']}, not nccl over 1 rank")
    want = recorded_training([*PARALLEL_CLI_ARGS, "--checkpoint_dir", str(tmp / "ck_plain")])
    print(f"{len(got['steps'])} steps under torchrun (nccl, {wall:.2f} s wall with the "
          f"launcher) and {len(want)} without; losses {[m['loss'] for m in want]}")
    if len(got["steps"]) != len(want) or len(want) != 10:
        raise RuntimeError("the two runs took different numbers of steps")
    for i, (a, b) in enumerate(zip(got["steps"], want)):
        differ = {k: (a[k], b[k]) for k in b if a[k] != b[k]}
        if differ:
            raise RuntimeError(f"step {i}: under torchrun {differ} (launcher, plain): not bit "
                               "for bit")
    print(f"every step's metrics bit for bit with and without the launcher on {card}")


def dp_phase(tmp: Path, card: str, records: dict) -> None:
    """2 gloo ranks sharing the card (data 2): a float32 and a bfloat16 step
    at the training cell (256 crystals globally, 128 a rank) against the
    one-process card step; then generate ``--data_parallel true`` on 2 ranks
    at 128 x 8, S = 50, against one process."""
    from arreau_tpu_torch.cli import generate
    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.inference.io import load_sample_results
    from arreau_tpu_torch.parallel.mesh import Mesh
    from arreau_tpu_torch.tasks.diffusion import DiffusionConfig, DiffusionModel

    z_table = synthetic_z_table()
    cfg = DiffusionConfig(num_atomic_states=len(z_table))
    model = DiffusionModel(cfg, device="cuda")
    model.model.init_parameters(prng.prng_key(SEED))
    write_checkpoint(tmp / "ckpt", cfg, model, z_table)
    del model
    gen = ["--checkpoint_dir", str(tmp / "ckpt"), "--batch_size", str(BATCH),
           "--num_atoms_per_sample", str(ATOMS), "--num_crystals", str(BATCH), "--sample_steps",
           str(STEPS), "--seed", str(SEED), "--device", "cuda", "--data_parallel", "true"]
    (tmp / "generate_args.json").write_text(json.dumps([*gen, "--out_dir", str(tmp / "gen_dp")]))
    torch.cuda.empty_cache()
    wall = run_ranks(2, "dp", tmp)
    ranks = [torch.load(tmp / f"dp_rank{r}.pt", weights_only=False) for r in range(2)]
    print(f"2 ranks, backend {ranks[0]['backend']}, {wall:.2f} s wall")
    if ranks[0]["backend"] != "gloo":
        raise RuntimeError("two ranks on one card must take gloo")
    for label, dtype in (("float32", None), ("bfloat16", "bfloat16")):
        want = parallel_step(Mesh(), dtype, False)
        print(f"one process, {label}: {want['step_ms']:.4f} ms a step at {TRAIN_BATCH}x16 on {card}")
        for r, res in enumerate(ranks):
            got = res[label]
            step_gate(f"DP rank {r}/2 {label} ({got['rows']} crystals)", got, want,
                      DP_PARAM_REL_TOL[label], DEFAULT_STEP)
            print(f"DP rank {r}/2 {label}: {got['step_ms']:.4f} ms a step (host clock, gloo "
                  f"through the host, 2 ranks sharing {card})")
        torch.cuda.empty_cache()
    suffix = {"float32": "", "bfloat16": "_bf16"}
    for name in DEFAULT_STEP:
        for label in ("float32", "bfloat16"):
            records[name + suffix[label]]["launches_dp"] = [r[label]["launches"][name]
                                                            for r in ranks]
    forwards = len(strided_levels_of(cfg.num_timesteps)) - 1
    for r, res in enumerate(ranks):
        counts = {k: v for k, v in res["generate_launches"].items() if v}
        want = {"spatial_conv": 5 * forwards, "basis_h1": forwards}
        if counts != want:
            raise RuntimeError(f"DP generate rank {r}: launched {counts}, not {want}")
    print(f"DP generate: each rank launched 5 spatial_conv and 1 basis_h1 in each of "
          f"{forwards} forwards")
    generate.main([*gen, "--out_dir", str(tmp / "gen_one")])
    got, want = (vars(load_sample_results(str(tmp / d / "crystals.h5")))
                 for d in ("gen_dp", "gen_one"))
    gaps = {}
    for name in want:
        if want[name].dtype.kind == "f":
            gaps[name] = float(np.abs(got[name] - want[name]).max())
        elif not np.array_equal(got[name], want[name]):
            raise RuntimeError(f"DP generate: {name} differs from one process")
    print(f"DP generate (2 ranks, {BATCH}x{ATOMS}, S={STEPS}) against one process: integer "
          f"fields equal, largest gaps {gaps} (tolerance {DP_SAMPLER_ATOL:g})")
    if not all(v <= DP_SAMPLER_ATOL for v in gaps.values()):
        raise RuntimeError("DP generate left the tolerance")


def strided_levels_of(num_timesteps: int):
    from arreau_tpu_torch.tasks.diffusion import strided_levels

    return strided_levels(num_timesteps, STEPS)


def tp_phase(tmp: Path, card: str, records: dict) -> None:
    """4 gloo ranks sharing the card (data 2 x model 2): a float32 step on
    the default branch and a bfloat16 ``fuse_convnext`` step (#9/#10 on
    gathered weights) against the one-process card step (bfloat16 loss
    terms to TP_BF16_LOSS_REL_TOL); prints the local shape of a split
    weight."""
    from arreau_tpu_torch.parallel.mesh import Mesh

    torch.cuda.empty_cache()
    wall = run_ranks(4, "tp", tmp)
    ranks = [torch.load(tmp / f"tp_rank{r}.pt", weights_only=False) for r in range(4)]
    print(f"4 ranks, backend {ranks[0]['backend']}, meshes {[r['mesh'] for r in ranks]}, "
          f"{wall:.2f} s wall")
    for label, dtype, fuse, want_launches in (("float32", None, False, DEFAULT_STEP),
                                              ("bfloat16", "bfloat16", True, CONVNEXT_STEP)):
        want = parallel_step(Mesh(), dtype, fuse)
        what = "fuse_convnext " if fuse else ""
        print(f"one process, {what}{label}: {want['step_ms']:.4f} ms a step on {card}")
        for r, res in enumerate(ranks):
            got = res[label]
            if got["split"][0] * 2 != got["whole"][0]:
                raise RuntimeError(f"TP rank {r}: linear_1 holds {got['split']} of {got['whole']}")
            step_gate(f"TP rank {r} (data {res['mesh'][2]}, model {res['mesh'][3]}) {what}{label}",
                      got, want, DP_PARAM_REL_TOL[label], want_launches,
                      TP_BF16_LOSS_REL_TOL if dtype else DP_LOSS_REL_TOL)
            print(f"TP rank {r} {what}{label}: layers.0.linear_1.weight holds {got['split']} of "
                  f"{got['whole']}; {got['step_ms']:.4f} ms a step (host clock, 4 ranks sharing "
                  f"{card})")
        torch.cuda.empty_cache()
    for name in DEFAULT_STEP:
        records[name]["launches_tp"] = [r["float32"]["launches"][name] for r in ranks]
    for name in CONVNEXT_STEP:
        key = name if name.startswith("convnext") else name + "_bf16"
        records[key]["launches_tp"] = [r["bfloat16"]["launches"][name] for r in ranks]


def alexandria_document(packed) -> dict:
    """``packed`` as an Alexandria document: pymatgen
    ``ComputedStructureEntry`` dicts with the fields ``data/prep.py`` reads."""
    from arreau_tpu_torch.data.atoms import z_to_symbol

    entries = []
    for i in range(len(packed)):
        s, e = packed.offsets[i], packed.offsets[i + 1]
        sites = [{"species": [{"element": z_to_symbol(int(z)), "occu": 1.0}], "abc": f.tolist()}
                 for z, f in zip(packed.atomic_numbers[s:e], packed.frac_coords[s:e])]
        entries.append({"structure": {"lattice": {"matrix": packed.lattices[i].tolist()},
                                      "sites": sites}})
    return {"entries": entries}


def same_packed(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f)) and getattr(a, f).dtype ==
               getattr(b, f).dtype for f in ("atomic_numbers", "frac_coords", "offsets", "lattices"))


def hdf5_phase(tmp: Path, card: str, records: dict) -> None:
    """Phase 40 (module docstring): the crystal data on disk, read and
    written by the port alone."""
    import bz2

    from arreau_tpu_torch.cli import generate, process_results
    from arreau_tpu_torch.data.atoms import AtomicNumberTable, synthetic_z_table
    from arreau_tpu_torch.data.crystal import CrystalDataset, read_h5, write_packed_h5
    from arreau_tpu_torch.data.prep import prep_all
    from arreau_tpu_torch.data.synthetic import synthetic_packed
    from arreau_tpu_torch.inference.io import load_sample_results
    from arreau_tpu_torch.tasks.diffusion import strided_levels

    # (a) the committed crystals.h5 files and the flagship report's crystals
    paths = sorted(OUT.rglob("crystals.h5"))
    if Q_ANG_S100 / "crystals.h5" not in paths:
        raise RuntimeError(f"{Q_ANG_S100 / 'crystals.h5'} is missing: this phase reads the "
                           "committed crystals.h5 files under out/")
    t0 = time.perf_counter()
    for path in paths:
        r = load_sample_results(str(path))
        starts = np.concatenate([[0], np.cumsum(r.num_atoms)[:-1]])
        if not (len(r.frac_x) == len(r.atomic_numbers) == r.num_atoms.sum()
                and r.lattice.shape == (r.num_crystals, 3, 3)
                and np.array_equal(r.idx_start, starts)
                and np.isfinite(r.frac_x).all() and np.isfinite(r.lattice).all()):
            raise RuntimeError(f"{path}: the arrays read do not make a set of crystals")
    seconds = time.perf_counter() - t0
    size = sum(p.stat().st_size for p in paths)
    print(f"read {len(paths)} crystals.h5 files ({size} bytes) in {seconds:.4f} s "
          f"({size / seconds / 1e6:.1f} MB/s, warm)")
    reference = generate.reference_dataset(QUALITY_REF)
    flagship_zs = json.loads((FLAGSHIP / "meta.json").read_text())["z_table_zs"]
    t0 = time.perf_counter()
    report = generate.quality_from_results(load_sample_results(str(Q_ANG_S100 / "crystals.h5")),
                                           AtomicNumberTable(flagship_zs), reference)
    print(f"quality report against {QUALITY_REF}: {time.perf_counter() - t0:.2f} s (host)")
    want = json.loads((Q_ANG_S100 / "quality.json").read_text())
    gap = max(abs(report[k] - v) for k, v in want.items()) if list(report) == list(want) else None
    print(f"out/r4/q_ang_s100: the report recomputed through the port's reader against "
          f"{QUALITY_REF}: largest gap to quality.json {gap} (tolerance 1e-12)")
    if gap is None or gap > 1e-12:
        raise RuntimeError("the recomputed report of out/r4/q_ang_s100 left its quality.json")

    # (b) data/prep.py on an Alexandria document; the reference as a packed shard
    crystals = synthetic_packed(2000, seed=SEED).packed
    src, shards = tmp / "alexandria", tmp / "shards"
    src.mkdir()
    t0 = time.perf_counter()
    with bz2.open(src / "alexandria_ps_000.json.bz2", "wt", encoding="utf-8") as fh:
        json.dump(alexandria_document(crystals), fh)
    written = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep_all(str(src), str(shards), num_shards=1)
    prepped = time.perf_counter() - t0
    take10 = read_h5(str(shards / "alexandria_ps_000_take10.h5"))
    end = int(crystals.offsets[10])
    if not (same_packed(read_h5(str(shards / "alexandria_ps_000.h5")), crystals)
            and len(take10) == 10 and np.array_equal(take10.lattices, crystals.lattices[:10])
            and np.array_equal(take10.frac_coords, crystals.frac_coords[:end])):
        raise RuntimeError("data/prep.py's shards are not the document's crystals bit for bit")
    print(f"data/prep.py: 2000 crystals ({len(crystals.atomic_numbers)} atoms) from a "
          f"{(src / 'alexandria_ps_000.json.bz2').stat().st_size} byte json.bz2 (written in "
          f"{written:.2f} s) into a shard and its take-10 shard in {prepped:.2f} s; bit for bit")
    ref_shard = tmp / "synthetic_20000_0.h5"
    write_packed_h5(str(ref_shard), reference.packed)
    t0 = time.perf_counter()
    back = read_h5(str(ref_shard))
    seconds = time.perf_counter() - t0
    if not same_packed(back, reference.packed):
        raise RuntimeError("the reference shard did not read back bit for bit")
    size = ref_shard.stat().st_size
    print(f"shard of {QUALITY_REF}: {len(back)} crystals, {size} bytes, loaded in {seconds:.4f} s "
          f"({size / seconds / 1e6:.1f} MB/s, warm), bit for bit")
    big = synthetic_packed(100_000, seed=SEED).packed
    write_packed_h5(str(tmp / "big.h5"), big)
    arrays = {f: getattr(big, f) for f in ("atomic_numbers", "frac_coords", "offsets", "lattices")}
    np.savez(tmp / "big.npz", **arrays)
    times = {"read_h5": [], "np.load": []}
    for _ in range(3):
        t0 = time.perf_counter()
        read_h5(str(tmp / "big.h5"))
        times["read_h5"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        with np.load(tmp / "big.npz") as data:
            {f: data[f] for f in arrays}
        times["np.load"].append(time.perf_counter() - t0)
    size = (tmp / "big.h5").stat().st_size
    print(f"100000-crystal shard ({len(big.atomic_numbers)} atoms, {size} bytes): "
          + ", ".join(f"{k} best of 3 {min(v):.4f} s ({size / min(v) / 1e6:.1f} MB/s)"
                      for k, v in times.items()) + " (warm file cache)")

    # (c) the training CLI on the shard and on the synthetic set of the same crystals
    base = ["--batch_size", str(TRAIN_BATCH), "--hidden_dim", str(TRAIN_HIDDEN), "--warmup", "0",
            "--max_steps", str(HDF5_STEPS), "--val_interval", "1", "--seed", str(SEED),
            "--device", "cuda"]
    runs = {}
    for name, flags in (("alexandria", ["--dataset", "alexandria", "--data_dir", str(shards)]),
                        ("synthetic", ["--dataset", "synthetic", "--synthetic_size", "2000"])):
        per_step, metrics, rate, _ = counted_training(
            [*base, *flags, "--checkpoint_dir", str(tmp / f"ck_{name}")])
        want_step = {k: DEFAULT_STEP.get(k, 0) for k in per_step[0]} if per_step else None
        if len(per_step) != HDF5_STEPS or any(c != want_step for c in per_step):
            raise RuntimeError(f"--dataset {name}: steps launched {per_step}, not {want_step} "
                               "each")
        runs[name] = (metrics, rate, launch_counts())
        print(f"--dataset {name}: {HDF5_STEPS} steps at {TRAIN_BATCH} x 16, hidden "
              f"{TRAIN_HIDDEN}: {rate:.3f} steps/s on {card}; losses "
              f"{[m['loss'] for m in metrics]}")
    for kernel in DEFAULT_STEP:
        records[kernel]["launches_hdf5"] = runs["alexandria"][2][kernel]
    shard_table = CrystalDataset([str(shards / "alexandria_ps_000.h5")]).z_table
    if shard_table.zs == synthetic_z_table().zs:
        differ = [i for i, (a, b) in enumerate(zip(runs["alexandria"][0], runs["synthetic"][0]))
                  if a != b]
        if differ:
            raise RuntimeError(f"steps {differ}: the shard run's metrics differ from the "
                               "synthetic run's on the same crystals")
        print(f"every step's metrics bit for bit on the shard and on the synthetic set (z-table "
              f"{shard_table.zs})")
    else:
        print(f"the metrics may differ: the shard's z-table {shard_table.zs} is not the "
              f"synthetic set's {synthetic_z_table().zs}, so the type classes are others")

    # (d) generate with the shard as the quality reference; process_results
    out = tmp / "gen"
    meta = json.loads((tmp / "ck_alexandria" / "meta.json").read_text())
    reset_launch_counts()
    result = generate.main([
        "--checkpoint_dir", str(tmp / "ck_alexandria"), "--tag", "best", "--quality_ref",
        str(ref_shard), "--num_atoms_dist", "ref", "--num_crystals", str(CRYSTALS),
        "--batch_size", str(BATCH), "--num_atoms_per_sample", str(ATOMS), "--sample_steps",
        str(STEPS), "--seed", str(SEED), "--device", "cuda", "--out_dir", str(out)])
    counts = launch_counts()
    forwards = math.ceil(CRYSTALS / BATCH) * (len(strided_levels(
        meta["config"]["num_timesteps"], STEPS)) - 1)
    L = meta["config"]["num_layers"]
    want = {k: {"spatial_conv": L * forwards, "basis_h1": forwards}.get(k, 0) for k in counts}
    if counts != want:
        raise RuntimeError(f"generate on the shard's checkpoint launched {counts}, not {want}")
    saved = load_sample_results(str(out / "crystals.h5"))
    if not all(np.array_equal(getattr(saved, f), getattr(result, f)) and getattr(saved, f).dtype
               == getattr(result, f).dtype for f in ("frac_x", "atomic_numbers", "lattice",
                                                      "idx_start", "num_atoms")):
        raise RuntimeError("crystals.h5 did not read back bit for bit")
    shard_report = json.loads((out / "quality.json").read_text())
    syn_report = generate.quality_from_results(saved, AtomicNumberTable(meta["z_table_zs"]),
                                               reference)
    print(f"generate --quality_ref <shard> --num_atoms_dist ref: {forwards} forwards, launches "
          f"{counts}; crystals.h5 read back bit for bit; atom counts "
          f"{np.bincount(saved.num_atoms).tolist()}")
    if shard_report != syn_report:
        raise RuntimeError(f"the report against the shard {shard_report} is not the report "
                           f"against {QUALITY_REF} {syn_report}")
    print(f"its report equals the report against {QUALITY_REF}, value for value")
    process_results.main(["--in_path", str(out / "crystals.h5"), "--device", "cuda"])
    relaxed = load_sample_results(str(out / "crystals_relaxed.h5"))
    e0, e1 = mean_soft_sphere_energy(saved), mean_soft_sphere_energy(relaxed)
    print(f"process_results on it: crystals_relaxed.h5, mean soft-sphere energy {e0:.6f} -> "
          f"{e1:.6f}")
    if not (e1 < e0 and relaxed.num_crystals == CRYSTALS):
        raise RuntimeError("process_results did not relax the crystals of crystals.h5")
    print(f"HDF5 data on {card}")


# ---------------- per-block rematerialisation (remat) ----------------

REMAT_STEPS = 5  # timed steps a path and setting
REMAT_GRAD_REL_TOL = {"float32": 1e-6, "bfloat16": 1e-3}


def holders_at_peak(events: list, top: int = 6) -> tuple[int, str, list]:
    """Replays the CUDA allocator's history (``torch.cuda.memory._snapshot()``'s
    ``device_traces`` of one device): the peak of the bytes allocated while it
    recorded, where the allocation that reached it was made, and the ``top``
    groups of blocks live at the peak as (bytes, blocks, where), ``where``
    the innermost frame in this repository (blocks with no Python frame are
    the autograd engine's backward)."""
    root = str(Path(__file__).resolve().parent) + "/"

    def where(event):
        frames = event.get("frames") or []
        for f in frames:
            if f["filename"].startswith(root):
                return f"{f['filename'][len(root):]}:{f['line']} ({f['name']})"
        return f"{frames[0]['filename']}:{frames[0]['line']}" if frames else "autograd backward"

    def replay(stop):
        live, now = {}, 0
        best, best_i = -1, -1
        for i, e in enumerate(events[:stop]):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                now += e["size"]
            elif e["action"] == "free_completed" and e["addr"] in live:
                now -= live.pop(e["addr"])["size"]
            if now > best:
                best, best_i = now, i
        return live, best, best_i

    _, peak, peak_i = replay(len(events))
    live, _, _ = replay(peak_i + 1)
    groups = {}
    for e in live.values():
        size, count = groups.get(where(e), (0, 0))
        groups[where(e)] = (size + e["size"], count + 1)
    ranked = sorted(((size, count, w) for w, (size, count) in groups.items()), reverse=True)
    return peak, where(events[peak_i]), ranked[:top]


def peak_memory_holders(step) -> str:
    """Runs ``step`` once with the allocator's history on and says what holds
    its peak (:func:`holders_at_peak`)."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(enabled="all", context="alloc", stacks="python",
                                             clear_history=True)
    try:
        step()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    peak, at, ranked = holders_at_peak(snap["device_traces"][torch.cuda.current_device()])
    held = "; ".join(f"{size / 2**30:.3f} GiB in {count} blocks from {w}"
                     for size, count, w in ranked)
    return (f"{peak / 2**30:.3f} GiB allocated in the step at its peak, reached by an "
            f"allocation from {at}; live there: {held}")


def remat_phase(dataset, chunk, bucket, train_cfg, card: str) -> None:
    """The training cell (256 x 16, full width) with ``remat`` off and on,
    the same seeded weights and noise: float32, bfloat16 and bfloat16 with
    ``fuse_convnext``. On each path the loss terms must repeat bit for bit
    and every gradient within REMAT_GRAD_REL_TOL of its scale; a step
    launches the default counts, with ``remat`` the block's forward kernel
    (#3, and #9 under ``fuse_convnext``) once more a layer for the
    recompute; the peak memory of one loss and backward and the step time
    are printed both ways."""
    from arreau_tpu_torch.data.crystal import pack_dense_batch
    from arreau_tpu_torch.tasks.diffusion import DiffusionModel, batch_to_device, draw_loss_noise
    from arreau_tpu_torch.train.loop import train_step
    from arreau_tpu_torch.train.optim import AdamW

    dev = torch.device("cuda")
    L = train_cfg.num_layers
    batch = batch_to_device(pack_dense_batch(dataset, chunk, bucket), dev)
    bf16_cfg = dataclasses.replace(train_cfg, compute_dtype="bfloat16")
    for label, cfg, fuse, dtype in (("float32", train_cfg, False, "float32"),
                                    ("bf16", bf16_cfg, False, "bfloat16"),
                                    ("fuse_convnext bf16", bf16_cfg, True, "bfloat16")):
        noise = draw_loss_noise(prng.prng_key(SEED),
                                *batch.atom_types.shape, cfg.num_atomic_states, cfg.num_timesteps,
                                cfg.diffuse_angles, dev)
        forward = {"convnext_mlp": L, "spatial_conv": L} if fuse else {"spatial_conv": L}
        base = {"spatial_conv": L, "basis_h1": 1, "spatial_conv_bwd": L, "basis_mlp_bwd": 1}
        if fuse:
            base.update(convnext_mlp=L, convnext_mlp_bwd=L)
        state, runs = None, {}
        for remat in (False, True):
            model = DiffusionModel(dataclasses.replace(cfg, remat=remat), device=dev)
            if fuse:
                model.model = fused_convnext_backbone(model)
            if state is None:
                model.init(prng.prng_key(SEED), batch)
                state = {k: v.clone() for k, v in model.model.state_dict().items()}
            model.model.load_state_dict(state)
            want = {name: n + (forward.get(name, 0) if remat else 0) for name, n in base.items()}
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            reset_launch_counts()
            loss, metrics = model.loss(batch, noise)
            loss.backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            counts = launch_counts()
            want = {name: want.get(name, 0) for name in counts}
            if counts != want:
                raise RuntimeError(f"a {label} step with remat={remat} launched {counts}, not {want}")
            grads = {n: p.grad.detach().clone() for n, p in model.model.named_parameters()}
            metrics = {k: v.item() for k, v in metrics.items()}
            optimizer = AdamW(model.model, lambda count: 1e-3, weight_decay=1e-10)
            reset_launch_counts()
            step_ms = cuda_ms(lambda: train_step(model, optimizer, None, batch, noise),
                              runs=REMAT_STEPS)
            steps = 3 + REMAT_STEPS
            if launch_counts() != {name: n * steps for name, n in want.items()}:
                raise RuntimeError(f"{steps} {label} steps with remat={remat} launched "
                                   f"{launch_counts()}")
            runs[remat] = (metrics, grads)
            model.model.zero_grad(set_to_none=True)
            holders = peak_memory_holders(lambda: model.loss(batch, noise)[0].backward())
            print(f"{label}, remat {'on' if remat else 'off'}: launches a step "
                  f"{ {k: v for k, v in want.items() if v} }; peak memory of one loss and "
                  f"backward {peak / 2**30:.3f} GiB ({(peak - before) / 2**30:.3f} GiB above the "
                  f"{before / 2**30:.3f} GiB held before it); training step {step_ms:.4f} ms "
                  f"(CUDA events, {REMAT_STEPS} steps, AdamW included) on {card}")
            print(f"{label}, remat {'on' if remat else 'off'}: {holders}")
            del model, optimizer, loss, grads
        (m_off, g_off), (m_on, g_on) = runs[False], runs[True]
        if m_on != m_off:
            raise RuntimeError(f"{label}: the loss terms moved with remat: {m_off} -> {m_on}")
        bitwise, worst = True, 0.0
        for name, want_g in g_off.items():
            got = g_on[name]
            bitwise = bitwise and torch.equal(got, want_g)
            scale = want_g.abs().max().item()
            worst = max(worst, (got - want_g).abs().max().item() / scale if scale else 0.0)
        print(f"{label}: loss terms bit for bit; {len(g_off)} gradients "
              f"{'bit for bit' if bitwise else 'not bit for bit'}, worst |on - off| / max |off| "
              f"{worst:.3e} (tolerance {REMAT_GRAD_REL_TOL[dtype]:g})")
        if not worst <= REMAT_GRAD_REL_TOL[dtype]:
            raise RuntimeError(f"{label}: a gradient moved with remat")
        del runs, noise
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from arreau_tpu_torch.cli import generate
    from arreau_tpu_torch.data.atoms import synthetic_z_table
    from arreau_tpu_torch.data.crystal import pack_dense_batch
    from arreau_tpu_torch.inference.io import concat_results, from_dense_batch
    from arreau_tpu_torch.kernels import build
    from arreau_tpu_torch.tasks.diffusion import (
        DiffusionConfig,
        DiffusionModel,
        batch_to_device,
        draw_loss_noise,
        draw_sampler_noise,
        strided_levels,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    with Phase("device"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    with Phase("build"):
        seconds = build.build_library()
        build.library()
        print(f"nvcc build: {seconds:.2f} s" if seconds else "kernel library up to date")
        sass_dump = start_sass_dump()

    z_table = synthetic_z_table()
    cfg = DiffusionConfig(num_atomic_states=len(z_table))
    model = DiffusionModel(cfg, device=dev)
    model.model.init_parameters(prng.prng_key(SEED))

    with Phase("serving kernels"):
        noise = draw_sampler_noise(prng.prng_key(SEED), 1, BATCH, ATOMS,
                                   cfg.num_atomic_states, "monoclinic", False, dev)
        with torch.inference_mode():
            inputs = first_step_inputs(model, noise)
            with capturing() as args:
                model.predict_scores(*inputs)
            serve_conv, serve_h1, _ = forward_kernel_records(args, f"serving {BATCH}x{ATOMS}")
            fwd_ms = cuda_ms(lambda: model.predict_scores(*inputs), runs=10)
            kernels_ms = cfg.num_layers * serve_conv["ms"] + serve_h1["ms"]
            print(f"forward at {BATCH}x{ATOMS}: {fwd_ms:.4f} ms (CUDA events, 10 runs), of which "
                  f"{cfg.num_layers} x spatial_conv + basis_h1 = {kernels_ms:.4f} ms")
            del args, inputs

    L = cfg.num_layers
    with Phase("sampler path"), tempfile.TemporaryDirectory() as tmp:
        meta = write_checkpoint(Path(tmp) / "ckpt", cfg, model, z_table)
        del model
        torch.cuda.empty_cache()
        sampler_counts = sampler_path(Path(tmp) / "ckpt", Path(tmp) / "out", meta, z_table, card,
                                      {"spatial_conv": L, "basis_h1": 1})

    with Phase("forward reference"):
        # one backbone forward on realistic crystals (lengths U(3, 8) angstrom,
        # angles U(75, 105) degrees): the CUDA kernel branch against the plain
        # branch on the CPU, on one neighbour list built on the CPU (the top-K
        # may pick either of two equidistant images, so two devices' graphs
        # can differ in an edge)
        B = 32
        g = torch.Generator().manual_seed(SEED + 1)
        lengths = 3.0 + 5.0 * torch.rand((B, 3), generator=g)
        angles = torch.deg2rad(75.0 + 30.0 * torch.rand((B, 3), generator=g))
        frac = torch.rand((B, ATOMS, 3), generator=g)
        types = torch.randint(0, cfg.num_atomic_states - 1, (B, ATOMS), generator=g)
        t = torch.randint(1, cfg.num_timesteps + 1, (B,), generator=g)
        # layer scale 1 (not the init's 1e-6) so the conv layers weigh in the outputs
        ref_cfg = dataclasses.replace(cfg, layer_scale=1.0)
        model = DiffusionModel(ref_cfg, device=dev)
        model.model.init_parameters(prng.prng_key(SEED + 1))
        plain = DiffusionModel(dataclasses.replace(ref_cfg, use_pallas=False), device="cpu")
        plain.model.load_state_dict({k: v.cpu() for k, v in model.model.state_dict().items()})
        with torch.inference_mode():
            want_in = plain._build_inputs(
                frac, torch.nn.functional.one_hot(types, cfg.num_atomic_states).float(), t,
                torch.full((B,), ATOMS), lengths, angles, torch.ones((B, ATOMS), dtype=torch.bool))
            got_in = want_in._replace(
                neighbors=type(want_in.neighbors)(*(a.to(dev) for a in want_in.neighbors)),
                **{f: getattr(want_in, f).to(dev)
                   for f in ("scalar", "vec", "atom_mask", "lattice", "ori_grid")})
            got, want = model.model(got_in), plain.model(want_in)
        print(f"{want_in.neighbors.mask.sum().item()} edges")
        for name, a, b in zip(("node scalar", "node vec", "global scalar"), got, want):
            err, scale = (a.cpu() - b).abs().max().item(), b.abs().max().item()
            print(f"{name}: kernel branch (cuda) vs plain branch (cpu), {B}x{ATOMS}: "
                  f"max_abs_err {err:.3e}, max |plain| {scale:.3e} (tolerance {KERNEL_REL_TOL:g} rel)")
            if not err <= KERNEL_REL_TOL * scale:
                raise RuntimeError(f"{name}: kernel branch disagrees with the plain branch")
        del model, plain

    # the training CLI's model at the canonical width (BASELINE.md: hidden 200,
    # basis 256, 5 layers, 16 orientations, K=8, radius 5, T=1000) with its
    # default diffuse_angles: four loss terms
    train_cfg = dataclasses.replace(cfg, hidden_dim=TRAIN_HIDDEN, diffuse_angles=True)

    with Phase("training kernels"):
        dataset, chunk, bucket = training_chunk()
        batch = batch_to_device(pack_dense_batch(dataset, chunk, bucket), dev)
        model = DiffusionModel(train_cfg, device=dev)
        model.init(prng.prng_key(SEED), batch)
        noise = draw_loss_noise(prng.prng_key(SEED), *batch.atom_types.shape,
                                train_cfg.num_atomic_states, train_cfg.num_timesteps, True, dev)
        with capturing() as args:
            model.loss(batch, noise)[0].backward()
        with torch.no_grad():
            conv, h1, n_valid = forward_kernel_records(args, f"training {TRAIN_BATCH}x{bucket}")
            conv_bwd, mlp_bwd = backward_kernel_records(args, n_valid)
        records = {"spatial_conv": conv, "basis_h1": h1, "spatial_conv_bwd": conv_bwd,
                   "basis_mlp_bwd": mlp_bwd}
        del args

    default_step = {"spatial_conv": L, "basis_h1": 1, "spatial_conv_bwd": L, "basis_mlp_bwd": 1}
    with Phase("training step"):
        # where one training step's time goes, at the same batch: CUDA-event
        # step time, then a torch.profiler trace of the device's kernels
        step_time(model, batch, noise, "default", default_step,
                  sum(records[k]["ms"] * n for k, n in default_step.items()))
        del model, batch, noise
        torch.cuda.empty_cache()

    with Phase("training reference"):
        training_reference(dataclasses.replace(train_cfg, layer_scale=1.0), z_table, SEED + 2,
                           KERNEL_REL_TOL)

    with Phase("training path"), tempfile.TemporaryDirectory() as tmp:
        train_counts = training_path(Path(tmp) / "ckpt", [], default_step, card)
        for name, record in records.items():
            record["launches"] = train_counts[name]
        for name in ("spatial_conv", "basis_h1"):
            records[name]["launches_sampler"] = sampler_counts[name]
        records["threefry"] = {"launches": train_counts["threefry"],
                               "launches_sampler": sampler_counts["threefry"]}

        with Phase("trained sampling"):
            reset_launch_counts()
            n = 128
            ckpt = Path(tmp) / "ckpt"
            result = generate.main([
                "--checkpoint_dir", str(ckpt), "--tag", "best", "--batch_size", str(n),
                "--num_atoms_per_sample", str(ATOMS), "--num_crystals", str(n),
                "--sample_steps", str(STEPS), "--seed", str(SEED), "--out_dir", str(Path(tmp) / "out"),
                "--device", "cuda",
            ])
            counts = launch_counts()
            print(f"launches {counts}")
            forwards = len(strided_levels(train_cfg.num_timesteps, STEPS)) - 1
            if counts["spatial_conv"] != L * forwards or counts["basis_h1"] != forwards:
                raise RuntimeError("sampling from the trained checkpoint missed a kernel launch")
            meta = json.loads((ckpt / "meta.json").read_text())
            crystal_checks(result, z_table, n, ATOMS, generate.length_bounds_from_meta(meta))

    # the fused fiber conv path: the same model and shapes with fuse_fiber
    fiber_cfg = dataclasses.replace(cfg, fuse_fiber=True)
    fiber_train_cfg = dataclasses.replace(train_cfg, fuse_fiber=True)

    with Phase("fiber kernels"):
        model = DiffusionModel(fiber_cfg, device=dev)
        model.model.init_parameters(prng.prng_key(SEED))
        noise = draw_sampler_noise(prng.prng_key(SEED), 1, BATCH, ATOMS,
                                   cfg.num_atomic_states, "monoclinic", False, dev)
        basis_attrs = {}  # the basis MLP's invariants, for the fused basis kernels below
        with torch.inference_mode():
            inputs = first_step_inputs(model, noise)
            with capturing() as args, basis_input(model, basis_attrs, "serve"):
                model.predict_scores(*inputs)
            [serve_fiber] = fiber_records(args, f"fiber serving {BATCH}x{ATOMS}")
            fwd_ms = cuda_ms(lambda: model.predict_scores(*inputs), runs=10)
            print(f"fuse_fiber forward at {BATCH}x{ATOMS}: {fwd_ms:.4f} ms (CUDA events, 10 runs), "
                  f"of which {L} x fiber_conv = {L * serve_fiber['ms']:.4f} ms")
            del args, inputs, model

        batch = batch_to_device(pack_dense_batch(dataset, chunk, bucket), dev)
        model = DiffusionModel(fiber_train_cfg, device=dev)
        model.init(prng.prng_key(SEED), batch)
        noise = draw_loss_noise(prng.prng_key(SEED), *batch.atom_types.shape,
                                train_cfg.num_atomic_states, train_cfg.num_timesteps, True, dev)
        with capturing() as args, basis_input(model, basis_attrs, "train"):
            model.loss(batch, noise)[0].backward()
        # plain tensors (the serving capture ran in inference mode)
        basis_attrs = {k: v.clone() for k, v in basis_attrs.items()}
        with torch.no_grad():
            fiber_fwd, fiber_bwd = fiber_records(args, f"fiber training {TRAIN_BATCH}x{bucket}")
        fiber_fwd["serve"] = {k: serve_fiber[k] for k in
                              ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
        records.update(fiber_conv=fiber_fwd, fiber_conv_bwd=fiber_bwd)
        del args
        model.model.zero_grad(set_to_none=True)

    with Phase("fiber sampler path"), tempfile.TemporaryDirectory() as tmp:
        sampler_model = DiffusionModel(fiber_cfg, device=dev)
        sampler_model.model.init_parameters(prng.prng_key(SEED))
        meta = write_checkpoint(Path(tmp) / "ckpt", fiber_cfg, sampler_model, z_table)
        del sampler_model
        counts = sampler_path(Path(tmp) / "ckpt", Path(tmp) / "out", meta, z_table, card,
                              {"fiber_conv": L})
        records["fiber_conv"]["launches_sampler"] = counts["fiber_conv"]

    with Phase("fiber training"):
        training_reference(dataclasses.replace(fiber_train_cfg, layer_scale=1.0), z_table,
                           SEED + 2, FIBER_LOSS_REL_TOL)
        _, counts = step_time(model, batch, noise, "fuse_fiber",
                              {"fiber_conv": L, "fiber_conv_bwd": L},
                              L * (fiber_fwd["ms"] + fiber_bwd["ms"]))
        for name in ("fiber_conv", "fiber_conv_bwd"):
            records[name]["launches"] = counts[name]
        del model, noise
        torch.cuda.empty_cache()

    # ---------------- the bfloat16 compute path ----------------
    bf16_cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    bf16_train_cfg = dataclasses.replace(train_cfg, compute_dtype="bfloat16")
    bf16 = dict(tol=BF16_KERNEL_REL_TOL, peak=BF16_FLOP_PER_S)
    served = ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")

    with Phase("bf16 kernels"):
        model = DiffusionModel(bf16_cfg, device=dev)
        model.model.init_parameters(prng.prng_key(SEED))
        noise = draw_sampler_noise(prng.prng_key(SEED), 1, BATCH, ATOMS,
                                   cfg.num_atomic_states, "monoclinic", False, dev)
        with torch.inference_mode():
            inputs = first_step_inputs(model, noise)
            with capturing() as args:
                model.predict_scores(*inputs)
            serve_conv, serve_h1, _ = forward_kernel_records(
                args, f"bf16 serving {BATCH}x{ATOMS}", "_bf16", **bf16)
            fwd_ms = cuda_ms(lambda: model.predict_scores(*inputs), runs=10)
            print(f"bf16 forward at {BATCH}x{ATOMS}: {fwd_ms:.4f} ms (CUDA events, 10 runs), of "
                  f"which {L} x spatial_conv_bf16 + basis_h1_bf16 = "
                  f"{L * serve_conv['ms'] + serve_h1['ms']:.4f} ms")
            del args, inputs, model

        batch = batch_to_device(pack_dense_batch(dataset, chunk, bucket), dev)
        model = DiffusionModel(bf16_train_cfg, device=dev)
        model.init(prng.prng_key(SEED), batch)
        noise = draw_loss_noise(prng.prng_key(SEED), *batch.atom_types.shape,
                                train_cfg.num_atomic_states, train_cfg.num_timesteps, True, dev)
        with capturing() as args:
            model.loss(batch, noise)[0].backward()
        with torch.no_grad():
            conv16, h116, n_valid = forward_kernel_records(
                args, f"bf16 training {TRAIN_BATCH}x{bucket}", "_bf16", **bf16)
            bwd16 = backward_kernel_records(args, n_valid, "_bf16", **bf16)
        conv16["serve"] = {k: serve_conv[k] for k in served}
        h116["serve"] = {k: serve_h1[k] for k in served}
        for record in (conv16, h116, *bwd16):
            records[record["name"]] = record
        del args
        model.model.zero_grad(set_to_none=True)

    with Phase("bf16 training reference"):
        ref_cfg = dataclasses.replace(bf16_train_cfg, layer_scale=1.0)
        training_reference(ref_cfg, z_table, SEED + 2, BF16_LOSS_REL_TOL, BF16_GRAD_REL_TOL)
        print("-- with fuse_convnext (#9/#10 on the card)")
        training_reference(ref_cfg, z_table, SEED + 2, BF16_LOSS_REL_TOL, BF16_GRAD_REL_TOL,
                           fuse_convnext=True)

    with Phase("bf16 training path"), tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "ckpt"
        counts = training_path(ckpt, ["--compute_dtype", "bfloat16"], default_step, card)
        for name in default_step:
            records[name + "_bf16"]["launches"] = counts[name]
        kernels_ms = sum(records[k + "_bf16"]["ms"] * n for k, n in default_step.items())
        step_time(model, batch, noise, "bf16", default_step, kernels_ms)
        del model, noise
        torch.cuda.empty_cache()

        with Phase("bf16 sampler path"):
            meta = json.loads((ckpt / "meta.json").read_text())
            if meta["config"]["compute_dtype"] != "bfloat16":
                raise RuntimeError("the bf16 training run's meta.json lost its compute_dtype")
            counts = sampler_path(ckpt, Path(tmp) / "out", meta, z_table, card,
                                  {"spatial_conv": L, "basis_h1": 1}, tag="best")
            for name in ("spatial_conv", "basis_h1"):
                records[name + "_bf16"]["launches_sampler"] = counts[name]

    # ---------------- the fused ConvNext MLP (fuse_convnext, bfloat16) ----------------
    with Phase("convnext kernels"):
        # layer scale 1 (not the init's 1e-6): with gamma ~ 1e-6, gamma * m is
        # below half a bf16 ulp of res, so out would equal res whatever the MLP
        # computed and no check below could see it
        model = DiffusionModel(dataclasses.replace(bf16_cfg, layer_scale=1.0), device=dev)
        model.model = fused_convnext_backbone(model)
        model.model.init_parameters(prng.prng_key(SEED))
        noise = draw_sampler_noise(prng.prng_key(SEED), 1, BATCH, ATOMS,
                                   cfg.num_atomic_states, "monoclinic", False, dev)
        with torch.inference_mode():
            inputs = first_step_inputs(model, noise)
            with capturing() as args:
                model.predict_scores(*inputs)
            [serve_cn] = convnext_records(args, f"convnext serving {BATCH}x{ATOMS}", **bf16)
            fwd_ms = cuda_ms(lambda: model.predict_scores(*inputs), runs=10)
            print(f"fuse_convnext bf16 forward at {BATCH}x{ATOMS}: {fwd_ms:.4f} ms (CUDA events, "
                  f"10 runs), of which {L} x convnext_mlp = {L * serve_cn['ms']:.4f} ms")
            del args, inputs, model

        model = DiffusionModel(dataclasses.replace(bf16_train_cfg, layer_scale=1.0), device=dev)
        model.model = fused_convnext_backbone(model)
        model.init(prng.prng_key(SEED), batch)
        noise = draw_loss_noise(prng.prng_key(SEED), *batch.atom_types.shape,
                                train_cfg.num_atomic_states, train_cfg.num_timesteps, True, dev)
        with capturing() as args:
            model.loss(batch, noise)[0].backward()
        with torch.no_grad():
            cn_fwd, cn_bwd = convnext_records(args, f"convnext training {TRAIN_BATCH}x{bucket}",
                                              **bf16)
            print("-- the float32 instantiation on the same values")
            f32_args = {k: tuple(t.float() if torch.is_tensor(t) else t for t in v)
                        for k, v in args.items() if k.startswith("convnext")}
            cn_fwd32, cn_bwd32 = convnext_records(
                f32_args, f"convnext float32 {TRAIN_BATCH}x{bucket}", KERNEL_REL_TOL,
                TF32X3_FLOP_PER_S)
        cn_fwd["serve"] = {k: serve_cn[k] for k in served}
        cn_fwd["float32"] = {k: cn_fwd32[k] for k in served}
        cn_bwd["float32"] = {k: cn_bwd32[k] for k in served}
        records.update(convnext_mlp=cn_fwd, convnext_mlp_bwd=cn_bwd)
        del args
        model.model.zero_grad(set_to_none=True)

    with Phase("fuse_convnext path"):
        want_cn_step = {"convnext_mlp": L, "convnext_mlp_bwd": L, "spatial_conv": L,
                        "spatial_conv_bwd": L, "basis_h1": 1, "basis_mlp_bwd": 1}
        kernels_ms = L * (cn_fwd["ms"] + cn_bwd["ms"]) + sum(
            records[k + "_bf16"]["ms"] * n for k, n in default_step.items())
        _, counts = step_time(model, batch, noise, "fuse_convnext bf16", want_cn_step, kernels_ms)
        for name in ("convnext_mlp", "convnext_mlp_bwd"):
            records[name]["launches"] = counts[name]
        del model, batch, noise
        torch.cuda.empty_cache()

        # the sampler through DiffusionModel.sample (generate reads its
        # backbone from meta.json, which has no fuse_convnext, as in the JAX
        # package): CRYSTALS crystals in batches of BATCH x ATOMS, STEPS steps
        sampler = DiffusionModel(bf16_cfg, device=dev)
        sampler.model = fused_convnext_backbone(sampler)
        sampler.model.init_parameters(prng.prng_key(SEED))
        bounds = generate.length_bounds_from_meta({"length_stats": {"min": 3.0, "max": 8.0}})
        key = prng.prng_key(SEED)
        reset_launch_counts()
        t0 = time.perf_counter()
        results = []
        for _ in range(CRYSTALS // BATCH):
            key, sub = prng.split(key)  # the generate CLI's key chain
            out = sampler.sample(BATCH, ATOMS, key=sub, sample_steps=STEPS,
                                 length_bounds=bounds)
            results.append(from_dense_batch(out, z_table))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        forwards = (CRYSTALS // BATCH) * (len(strided_levels(cfg.num_timesteps, STEPS)) - 1)
        want = {name: 0 for name in counts}
        want.update(convnext_mlp=L * forwards, spatial_conv=L * forwards, basis_h1=forwards)
        print(f"forwards {forwards}: launches {counts}")
        if counts != want:
            raise RuntimeError(f"the fuse_convnext sampler launched {counts}, not {want}")
        crystal_checks(concat_results(results), z_table, CRYSTALS, ATOMS, bounds)
        records["convnext_mlp"]["launches_sampler"] = counts["convnext_mlp"]
        print(f"fuse_convnext sampler: {CRYSTALS} crystals in {wall:.2f} s wall, first batch "
              f"included ({CRYSTALS / wall * 60:.0f} crystals/min on {card})")
        del sampler

    # ---------------- the fused fiber conv path in bfloat16 ----------------
    fiber_bf16_cfg = dataclasses.replace(bf16_cfg, fuse_fiber=True)
    fiber_bf16_train_cfg = dataclasses.replace(bf16_train_cfg, fuse_fiber=True)

    with Phase("fiber bf16 kernels"):
        model = DiffusionModel(fiber_bf16_cfg, device=dev)
        model.model.init_parameters(prng.prng_key(SEED))
        noise = draw_sampler_noise(prng.prng_key(SEED), 1, BATCH, ATOMS,
                                   cfg.num_atomic_states, "monoclinic", False, dev)
        with torch.inference_mode():
            inputs = first_step_inputs(model, noise)
            with capturing() as args:
                model.predict_scores(*inputs)
            [serve_fiber16] = fiber_records(args, f"fiber bf16 serving {BATCH}x{ATOMS}", "_bf16",
                                            **bf16)
            fwd_ms = cuda_ms(lambda: model.predict_scores(*inputs), runs=10)
            print(f"fuse_fiber bf16 forward at {BATCH}x{ATOMS}: {fwd_ms:.4f} ms (CUDA events, 10 "
                  f"runs), of which {L} x fiber_conv_bf16 = {L * serve_fiber16['ms']:.4f} ms")
            del args, inputs, model

        batch = batch_to_device(pack_dense_batch(dataset, chunk, bucket), dev)
        model = DiffusionModel(fiber_bf16_train_cfg, device=dev)
        model.init(prng.prng_key(SEED), batch)
        noise = draw_loss_noise(prng.prng_key(SEED), *batch.atom_types.shape,
                                train_cfg.num_atomic_states, train_cfg.num_timesteps, True, dev)
        with capturing() as args:
            model.loss(batch, noise)[0].backward()
        with torch.no_grad():
            fiber16_fwd, fiber16_bwd = fiber_records(
                args, f"fiber bf16 training {TRAIN_BATCH}x{bucket}", "_bf16", **bf16)
        fiber16_fwd["serve"] = {k: serve_fiber16[k] for k in served}
        records.update(fiber_conv_bf16=fiber16_fwd, fiber_conv_bwd_bf16=fiber16_bwd)
        del args
        model.model.zero_grad(set_to_none=True)

    with Phase("fuse_fiber bf16 path"):
        training_reference(dataclasses.replace(fiber_bf16_train_cfg, layer_scale=1.0), z_table,
                           SEED + 2, BF16_LOSS_REL_TOL, BF16_GRAD_REL_TOL)
        _, counts = step_time(model, batch, noise, "fuse_fiber bf16",
                              {"fiber_conv": L, "fiber_conv_bwd": L},
                              L * (fiber16_fwd["ms"] + fiber16_bwd["ms"]))
        for name in ("fiber_conv", "fiber_conv_bwd"):
            records[name + "_bf16"]["launches"] = counts[name]
        del model, batch, noise
        torch.cuda.empty_cache()

        with tempfile.TemporaryDirectory() as tmp:
            sampler_model = DiffusionModel(fiber_bf16_cfg, device=dev)
            sampler_model.model.init_parameters(prng.prng_key(SEED))
            meta = write_checkpoint(Path(tmp) / "ckpt", fiber_bf16_cfg, sampler_model, z_table)
            del sampler_model
            if not (meta["config"]["fuse_fiber"] and meta["config"]["compute_dtype"] == "bfloat16"):
                raise RuntimeError("the fuse_fiber bf16 checkpoint's meta.json lost a field")
            counts = sampler_path(Path(tmp) / "ckpt", Path(tmp) / "out", meta, z_table, card,
                                  {"fiber_conv": L})
            records["fiber_conv_bf16"]["launches_sampler"] = counts["fiber_conv"]

    # ---------------- #5/#6 through BasisMLP(fused=True) ----------------
    with Phase("fused basis kernels"):
        for dtype, tol, peak in ((torch.float32, KERNEL_REL_TOL, TF32X3_FLOP_PER_S),
                                 (torch.bfloat16, BF16_KERNEL_REL_TOL, BF16_FLOP_PER_S)):
            for record in fused_basis_records(basis_attrs, dtype, f"fused basis {dtype}", tol,
                                              peak):
                records[record["name"]] = record
        del basis_attrs

    # ---------------- the trained flagship checkpoint ----------------
    with Phase("trained flagship"), tempfile.TemporaryDirectory() as tmp:
        counts = flagship_path(Path(tmp), card)
        for name in ("spatial_conv", "basis_h1"):
            records[name + "_bf16"]["launches_flagship"] = counts[name]

    # ---------------- the backbone tasks ----------------
    with Phase("backbone tasks: nbody"), tempfile.TemporaryDirectory() as tmp:
        nbody_phase(Path(tmp), card, records)
    with Phase("backbone tasks: mnist"), tempfile.TemporaryDirectory() as tmp:
        mnist_phase(Path(tmp), card, records)

    # ---------------- gradients through positions ----------------
    with Phase("position gradients"):
        position_phase(dataset, chunk, bucket, train_cfg, card, records)
    with Phase("backbone tasks: qm9"), tempfile.TemporaryDirectory() as tmp:
        point_cloud_phase(Path(tmp), card, "qm9")
    with Phase("backbone tasks: md17"), tempfile.TemporaryDirectory() as tmp:
        point_cloud_phase(Path(tmp), card, "md17")

    # ---------------- the sampler's and the trainer's remaining surface ----------------
    with Phase("snapshot sampling"):
        snapshot_phase(card, records)
    with Phase("renders"), tempfile.TemporaryDirectory() as tmp:
        renders_phase(Path(tmp), card)
    with Phase("serving export"), tempfile.TemporaryDirectory() as tmp:
        export_phase(Path(tmp), card, records)
    with Phase("training CLI leftovers"), tempfile.TemporaryDirectory() as tmp:
        training_leftovers_phase(Path(tmp), card)

    # ---------------- reference import, calibration and the exploration tools ----------------
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("import", "equivariance", "diagnosis", "eda"):
            (tmp / sub).mkdir()
        with Phase("reference import"):
            import_phase(tmp / "import", card, records)
        with Phase("calibration"):
            calibration_phase(card, records)
        with Phase("equivariance check"):
            equivariance_phase(tmp / "equivariance", card, records)
        with Phase("sampler diagnosis"):
            diagnosis_phase(tmp / "diagnosis", card, records)
        with Phase("EDA tools"):
            eda_phase(tmp / "eda", tmp / "import" / "out_imported" / "crystals.h5", card)

    # ---------------- data and tensor parallelism on the one card ----------------
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with Phase("NCCL, world size 1"):
            nccl_phase(tmp, card)
        with Phase("DP on one card"):
            dp_phase(tmp, card, records)
        with Phase("TP on one card"):
            tp_phase(tmp, card, records)

    # ---------------- the crystal data on disk, without h5py ----------------
    with Phase("HDF5 data"), tempfile.TemporaryDirectory() as tmp:
        hdf5_phase(Path(tmp), card, records)

    # ---------------- per-block rematerialisation ----------------
    with Phase("remat"):
        remat_phase(dataset, chunk, bucket, train_cfg, card)

    # ---------------- JAX's random streams from --seed ----------------
    with Phase("jax streams"), tempfile.TemporaryDirectory() as tmp:
        jax_streams_phase(Path(tmp), card, records)

    # ---------------- #8's and #7's bfloat16 kernels on Hopper's own instructions ----------------
    with Phase("SASS check"):
        sass_check(sass_dump)

    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2], Path(sys.argv[3])))
    sys.exit(main())
