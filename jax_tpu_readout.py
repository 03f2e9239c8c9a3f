#!/usr/bin/env python3
"""The JAX package's reverse chain on the CPU with its readout product
computed as a CPU computes it and as a TPU does.

The bfloat16 network's one float32 product is the readout,
``jnp.dot(xcat, wcat)`` in ``arreau_tpu/models/ponita.py``. JAX runs it at
DEFAULT precision: a CPU computes that in float32, a TPU from bfloat16
operands with float32 sums. A checkpoint trained on a TPU learned its
readout weights under the TPU's rounding. This script samples the same
chain (same key, the flagship command's settings: no length clamp, gumbel
type draws, eta 0) both ways and prints the mean lattice length of each;
``--all_dots`` rounds the operands of every float32 dot at DEFAULT
precision instead, as a TPU does, to show what the readout leaves out.
Nothing in the JAX package changes: the switch replaces the module's
``jnp`` (or ``lax.dot_general``) for the run.

Run from the repository root, where the JAX package imports:

    JAX_PLATFORMS=cpu python3 jax_tpu_readout.py --checkpoint_dir out/r4/ckpt_ang_on \\
        --tag best --num_crystals 100 --seed 0

The port's counterpart is ``readout_bf16_operands``
(``arreau_tpu_torch/models/ponita.py``).
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


class _TPUReadout:
    """``jax.numpy`` with ``dot`` from bfloat16 operands, float32 sums."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def dot(a, b):
        return jnp.dot(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)


def tpu_readout(on: bool) -> None:
    """The readout's product as a TPU computes it (``on``) or as the CPU
    does; applies to what is traced after the call."""
    import arreau_tpu.models.ponita as ponita

    ponita.jnp = _TPUReadout() if on else jnp


def tpu_dots(on: bool) -> None:
    """Every float32 ``dot_general`` at DEFAULT precision from bfloat16
    operands (``on``), or the CPU's float32 products."""
    import jax._src.lax.lax as lax_impl

    orig = getattr(tpu_dots, "orig", lax_impl.dot_general)
    tpu_dots.orig = orig

    def default(p):
        if p is None:
            return True
        if isinstance(p, tuple):
            return all(default(q) for q in p)
        return p == jax.lax.Precision.DEFAULT

    def dot_general(lhs, rhs, dimension_numbers, precision=None, preferred_element_type=None,
                    **kw):
        if default(precision) and jnp.float32 in (jnp.result_type(lhs), jnp.result_type(rhs)):
            lhs = jnp.asarray(lhs).astype(jnp.bfloat16)
            rhs = jnp.asarray(rhs).astype(jnp.bfloat16)
            preferred_element_type = preferred_element_type or jnp.float32
        return orig(lhs, rhs, dimension_numbers, precision=precision,
                    preferred_element_type=preferred_element_type, **kw)

    lax_impl.dot_general = jax.lax.dot_general = dot_general if on else orig


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--tag", type=str, default="best")
    p.add_argument("--num_crystals", type=int, default=100)
    p.add_argument("--num_atoms", type=int, default=8)
    p.add_argument("--sample_steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--all_dots", action="store_true",
                   help="round every DEFAULT-precision float32 dot, not the readout's alone")
    args = p.parse_args(argv)

    from arreau_tpu.cli.generate import load_model

    model, params, _ = load_model(args.checkpoint_dir, args.tag, False)
    switch = tpu_dots if args.all_dots else tpu_readout
    kw = dict(length_bounds=None, type_temperature=1.0, sample_steps=args.sample_steps,
              ddim_eta=0.0)
    for name, on in (("cpu", False), ("tpu", True)):
        switch(on)
        jax.clear_caches()  # jnp's own jitted functions keep the product they traced
        t0 = time.perf_counter()
        crystals = jax.jit(lambda prm, key: model._sample_impl(
            prm, key, args.num_crystals, args.num_atoms, **kw))(params, jax.random.PRNGKey(args.seed))
        lengths = np.linalg.norm(np.asarray(crystals.lattice), axis=-1)
        print(f"{'all dots' if args.all_dots else 'readout'} as on a {name.upper()}: mean lattice "
              f"length {lengths.mean():.6f} A over {args.num_crystals} crystals, seed {args.seed} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
