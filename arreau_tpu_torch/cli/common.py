"""argparse value parsers shared by the task CLIs; a copy of
``arreau_tpu/cli/common.py``: ``True``/``False``/``None``/floats accepted,
anything else an argparse error (where ``type=eval`` would take any
expression). And the task CLIs' data-parallel set-up and the per-step
keys of the JAX QM9, MD17 and MNIST CLIs' chain."""

from __future__ import annotations

import argparse

from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.parallel.mesh import make_mesh, maybe_initialize_distributed


def data_parallel_setup(device, batch_size: int):
    """``(mesh, say)`` of a task CLI: under torchrun the ranks form a
    ``("data",)`` mesh (a no-op in one process), each takes rows ``r::n`` of
    every global batch of ``batch_size`` (which the ranks must divide), and
    ``say`` prints on rank 0 alone."""
    maybe_initialize_distributed(device)
    mesh = make_mesh()
    if batch_size % mesh.data_size:
        raise ValueError(f"--batch_size {batch_size} not divisible by {mesh.data_size} data ranks")
    return mesh, (print if mesh.is_main else silent)


def step_keys(key) -> tuple:
    """``(key, k_rot)`` of one training step of the JAX QM9, MD17 and MNIST
    CLIs: the chain splits ``key, k_step = split(key)``, and the step draws
    its rotation from ``split(k_step)[1]``. A validation or test batch
    takes one ``key, k_eval = split(key)`` of the chain."""
    key, k_step = prng.split(key)
    return key, prng.split(k_step)[1]


def silent(*args, **kwargs) -> None:
    """``print`` on the ranks that do not print."""


def parse_bool(value: str) -> bool:
    """True/False (case-insensitive; also 1/0, yes/no)."""
    s = str(value).strip().lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {value!r}")


def parse_opt_bool(value: str):
    """None | True | False (tri-state knobs like --scan_epoch)."""
    s = str(value).strip().lower()
    if s in ("none", ""):
        return None
    return parse_bool(value)


def parse_opt_float(value: str):
    """None | float (knobs like --radius where None means fully connected)."""
    s = str(value).strip().lower()
    if s in ("none", ""):
        return None
    try:
        return float(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected a float or None, got {value!r}")
