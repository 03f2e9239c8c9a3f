"""Exponential moving average of the parameters; counterpart of the EMA in
``arreau_tpu/train/state.py`` (``ema = d * ema + (1 - d) * w`` after every
optimizer step). The average is updated in place under ``no_grad``;
:meth:`EMA.swapped_in` evaluates a module with the averaged weights. Built
after ``parallel.mesh.shard_state``, the shadows are this rank's shards of
the split parameters (the JAX EMA follows the parameters' shardings)."""

from __future__ import annotations

import contextlib

import torch
from torch import nn


class EMA:
    def __init__(self, module: nn.Module, decay: float):
        self.decay = decay
        self.params = {n: p.detach().clone() for n, p in module.named_parameters()}

    @torch.no_grad()
    def update(self, module: nn.Module) -> None:
        for name, p in module.named_parameters():
            self.params[name].mul_(self.decay).add_((1.0 - self.decay) * p)

    @contextlib.contextmanager
    def swapped_in(self, module: nn.Module):
        """Run the body with ``module``'s parameters set to the averages."""
        saved = {n: p.detach().clone() for n, p in module.named_parameters()}
        with torch.no_grad():
            for name, p in module.named_parameters():
                p.copy_(self.params[name])
        try:
            yield
        finally:
            with torch.no_grad():
                for name, p in module.named_parameters():
                    p.copy_(saved[name])

    def state_dict(self) -> dict:
        return {"decay": self.decay, "params": self.params}

    def load_state_dict(self, state: dict) -> None:
        self.decay = state["decay"]
        for name, value in state["params"].items():
            self.params[name].copy_(value)
