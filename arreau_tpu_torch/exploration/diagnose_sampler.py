"""Reverse-chain diagnosis: where do the lattice lengths leave the data
manifold? Counterpart of ``arreau_tpu/exploration/diagnose_sampler.py``.

Runs the dense reverse chain step by step (the sampler's arithmetic,
``DiffusionModel._sample_impl``, without its length clamp) and records
every ``--record_every`` steps:

  * mean and std of the chain's lattice lengths ``l_t``;
  * mean and std of the model's x0-prediction ``pred_lengths * num_atoms``
    (what the posterior pulls toward);
  * the forward marginal a perfect model would give at that step,
    ``q(l_t | l_0) = sqrt(abar_t) l_0 + sqrt(1 - abar_t) eps`` over the
    reference data: mean ``sqrt(abar_t) E[l_0]``, std
    ``sqrt(abar_t Var[l_0] + (1 - abar_t))``.

The records go to ``--out`` as JSON. The chain runs on ``--device`` (default
``cuda``): on the card each step is one forward through kernels #3 and #8.
Its random numbers are a :class:`SamplerNoise` drawn ahead from the JAX
tool's own key chain (:func:`draw_diagnosis_noise`: ``PRNGKey(--seed)``
split into the prior's keys and the loop's, one split of the loop key a
step), each field of the whole chain one launch of the threefry kernel on
the card; or handed to :func:`diagnose`.

    python -m arreau_tpu_torch.exploration.diagnose_sampler \\
        --checkpoint_dir ckpt --ref synthetic:20000:0 --out out/diag_sampler.json

``--ref`` is ``synthetic[:size[:seed]]`` or a packed HDF5 shard.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from arreau_tpu_torch.cli import generate
from arreau_tpu_torch.diffusion.d3pm import d3pm_reverse_step
from arreau_tpu_torch.diffusion.ve import ve_reverse_step
from arreau_tpu_torch.diffusion.vp import vp_reverse_given_x0
from arreau_tpu_torch.exploration import open_device
from arreau_tpu_torch.inference.quality import lattice_params_np
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.tasks.diffusion import SamplerNoise, _decode_angles_safe, draw_sampler_noise


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--tag", type=str, default="best")
    p.add_argument("--ref", type=str, default="synthetic:20000:0")
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--num_atoms_per_sample", type=int, default=8)
    p.add_argument("--record_every", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="out/diag_sampler.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    return p.parse_args(argv)


def reference_lengths(ref: str) -> tuple[float, float]:
    """Mean and variance of the reference data's lattice lengths (``ref``
    as ``generate --quality_ref`` takes it)."""
    lengths, _ = lattice_params_np(generate.reference_dataset(ref).packed.lattices)
    return float(lengths.mean()), float(lengths.var())


def diagnosis_step_keys(key, num_steps: int) -> np.ndarray:
    """uint32 ``[num_steps, 4, 2]``: each step's ``(k_lat, k_pos, k_type,
    k_ang)`` off the JAX tool's loop key, ``key, sub = split(key)`` then
    ``split(sub, 4)`` a step."""
    out = np.empty((num_steps, 4, 2), np.uint32)
    key = np.asarray(key, np.uint32)
    for s in range(num_steps):
        key, sub = prng.split(key)
        out[s] = prng.split(sub, 4)
    return out


def draw_diagnosis_noise(key, num_steps: int, B: int, A: int, C: int, diffuse_angles: bool,
                         device) -> SamplerNoise:
    """The :class:`SamplerNoise` the JAX tool draws from ``key`` (uint32
    ``[2]``, its ``PRNGKey(seed)``) for ``num_steps`` steps of B crystals of
    A atoms and C classes, on ``device``: its prior as the sampler's
    (``k_ang, k_len, k_frac, k_loop = split(key, 4)``; monoclinic Bravais
    angles without ``diffuse_angles``), each step's fields from
    :func:`diagnosis_step_keys` off ``k_loop``."""
    return draw_sampler_noise(key, num_steps, B, A, C, "monoclinic", diffuse_angles, device,
                              step_keys=diagnosis_step_keys)


def diagnose(model, noise: SamplerNoise, l0_mean: float, l0_var: float, record_every: int,
             num_steps: Optional[int] = None, verbose: bool = True):
    """(records, state) of the dense chain of ``model`` from ``noise``
    (``num_steps`` of its T-1 steps, all by default): the records described
    above, at every ``record_every``-th timestep and at T-1 and 1; the
    state is the chain's last ``lengths``, ``frac``, ``types``, ``ang_enc``
    and ``pred_x0``."""
    cfg = model.config
    dev = model.device
    B, A = noise.frac0.shape[:2]
    C, T = cfg.num_atomic_states, cfg.num_timesteps
    num_steps = T - 1 if num_steps is None else num_steps
    frac, lengths, ang_enc = noise.frac0, noise.lengths0, noise.ang_enc0
    types = torch.full((B, A), C - 1, dtype=torch.long, device=dev)
    num_atoms = torch.full((B,), A, dtype=torch.long, device=dev)
    atom_mask = torch.ones((B, A), dtype=torch.bool, device=dev)
    abar = model.vp.alpha_bars.cpu().numpy()
    records = []
    with torch.inference_mode():
        for k in range(num_steps):
            timestep = T - 1 - k
            t = torch.full((B,), timestep, dtype=torch.long, device=dev)
            ang = _decode_angles_safe(ang_enc) if cfg.diffuse_angles else noise.angles
            pred_eps, logits, pred_global = model.predict_scores(
                frac, F.one_hot(types, C).to(torch.float32), t, num_atoms, lengths, ang, atom_mask)
            pred_x0 = pred_global[:, :3] * num_atoms.to(torch.float32)[:, None]
            lengths = vp_reverse_given_x0(model.vp, noise.lattice[k], lengths, pred_x0, t)
            if cfg.diffuse_angles:
                pred_enc = torch.clamp(pred_global[:, 3:9], -1.0, 1.0)
                ang_enc = vp_reverse_given_x0(model.vp, noise.angle[k], ang_enc, pred_enc, t)
            frac = ve_reverse_step(model.ve, noise.pos[k], frac, pred_eps, t)
            types = d3pm_reverse_step(model.d3pm, noise.types[k], types, logits,
                                      t[:, None].expand(B, A))
            if timestep % record_every == 0 or timestep in (1, T - 1):
                ln, px = lengths.cpu().numpy(), pred_x0.cpu().numpy()
                ab = abar[max(timestep - 1, 0)]
                r = {
                    "t": int(timestep - 1),
                    "chain_mean": float(ln.mean()),
                    "chain_std": float(ln.std()),
                    "pred_x0_mean": float(px.mean()),
                    "pred_x0_std": float(px.std()),
                    "marginal_mean": float(np.sqrt(ab) * l0_mean),
                    "marginal_std": float(np.sqrt(ab * l0_var + (1 - ab))),
                }
                records.append(r)
                if verbose:
                    print(f"t={r['t']:4d} chain {r['chain_mean']:7.3f}±{r['chain_std']:6.3f} "
                          f"pred_x0 {r['pred_x0_mean']:7.3f} "
                          f"| marginal {r['marginal_mean']:7.3f}±{r['marginal_std']:6.3f}",
                          flush=True)
    state = {"lengths": lengths, "frac": frac, "types": types, "ang_enc": ang_enc,
             "pred_x0": pred_x0}
    return records, state


def main(argv=None, noise: Optional[SamplerNoise] = None) -> list:
    args = parse_args(argv)
    l0_mean, l0_var = reference_lengths(args.ref)
    device = open_device(args.device)
    model, _, _ = generate.load_model(args.checkpoint_dir, args.tag, False, device)
    cfg = model.config
    if noise is None:
        noise = draw_diagnosis_noise(prng.prng_key(args.seed), cfg.num_timesteps - 1,
                                     args.num_samples, args.num_atoms_per_sample,
                                     cfg.num_atomic_states, cfg.diffuse_angles, device)
    records, _ = diagnose(model, noise, l0_mean, l0_var, args.record_every)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"l0_mean": l0_mean, "l0_var": l0_var, "records": records}, f, indent=2)
    print(f"wrote {args.out}")
    return records


if __name__ == "__main__":
    main()
