"""The optimizer of the JAX package, written out: global-norm gradient
clipping, then Adam with decoupled weight decay on the Dense and conv
kernels, with a cosine warmup learning rate; counterpart of
``arreau_tpu/train/optim.py`` (``optax.chain(clip_by_global_norm,
adamw(mask=...))``), step for step:

- clip: ``g <- (g / norm) * max_norm`` unless ``norm < max_norm``, with
  ``norm`` the global L2 norm of every gradient (optax's rule;
  ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` and is
  another function);
- Adam: ``mu <- (1 - b1) g + b1 mu``, ``nu <- (1 - b2) g^2 + b2 nu``, the
  update ``mu_hat / (sqrt(nu_hat) + eps)`` with bias corrections at the
  incremented count;
- decay: ``+ weight_decay * p`` for the JAX package's ``kernel`` leaves of
  rank >= 2 (every 2-D parameter of the port), nothing else;
- ``p <- p - lr(count) * update``, the schedule read at the count before
  the increment, as optax's ``scale_by_learning_rate`` does.

The clip happens on the device with no host synchronisation. Under tensor
parallelism (``mesh`` with a model group) the norm is that of the whole
parameters, as optax's over JAX's global arrays: the squares of the split
gradients are summed over the model group, the replicated ones counted
once.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from arreau_tpu_torch.parallel.mesh import model_sum, state_shardings


def cosine_warmup_schedule(base_lr: float, warmup_epochs: float, max_epochs: float,
                           steps_per_epoch: int) -> Callable[[int], float]:
    """``lr(step) = base * 0.5 (1 + cos(pi epoch / max_epochs))``, scaled
    linearly during warmup, with fractional epochs ``step / steps_per_epoch``."""

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        factor = 0.5 * (1 + math.cos(math.pi * epoch / max_epochs))
        warm = (epoch + 1e-6) / (warmup_epochs + 1e-6) if epoch <= warmup_epochs else 1.0
        return base_lr * factor * warm

    return schedule


def decays(name: str, param: torch.Tensor) -> bool:
    """Whether ``param`` is a JAX ``kernel`` of rank >= 2 (nn.Linear weights
    and the conv kernels; not biases, LayerNorm scales or layer scales)."""
    from arreau_tpu_torch.interop.from_jax import _jax_name

    return _jax_name(name)[0].endswith("/kernel") and param.dim() >= 2


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class AdamW:
    """Clip + AdamW over a module's parameters (their ``.grad``)."""

    def __init__(self, module: nn.Module, schedule: Callable[[int], float],
                 weight_decay: float = 1e-10, grad_clip: Optional[float] = 0.5,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, mesh=None):
        self.params = dict(module.named_parameters())
        self.mesh = mesh
        self.split = state_shardings(module) if mesh is not None and mesh.model_size > 1 else {}
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.decay = {n: decays(n, p) for n, p in self.params.items()}
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' gradients; returns the global
        gradient norm before clipping (a device scalar)."""
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.params.items()}
        if self.split:
            sq = model_sum(sum(torch.sum(g * g) for n, g in grads.items() if n in self.split),
                           self.mesh)
            norm = torch.sqrt(sum(torch.sum(g * g) for n, g in grads.items()
                                  if n not in self.split) + sq)
        else:
            norm = global_norm(grads.values())
        if self.grad_clip is not None:
            keep = norm < self.grad_clip
            grads = {n: torch.where(keep, g, (g / norm) * self.grad_clip) for n, g in grads.items()}
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1 - self.b1**self.count
        c2 = 1 - self.b2**self.count
        for n, p in self.params.items():
            g = grads[n]
            mu = self.mu[n].mul_(self.b1).add_((1 - self.b1) * g)
            nu = self.nu[n].mul_(self.b2).add_((1 - self.b2) * (g * g))
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.decay[n]:
                update = update + self.weight_decay * p
            p.add_(update * -lr)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for name in self.params:
            self.mu[name].copy_(state["mu"][name])
            self.nu[name].copy_(state["nu"][name])
