"""Metric accumulation, epoch timing and the metrics log; counterpart of
``arreau_tpu/train/metrics.py``. Under data parallelism every rank's step
metrics are already the global batch's (``train/loop.py``; the diffusion
loss's ``num_atoms``/``num_crystals`` are global counts), so
:func:`weighted_update` gives every rank the exact epoch means, as XLA's
fully reduced scalars do; the CLIs give rank 0 alone a log path (the JAX
logger's process 0)."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np


class MeanMetrics:
    """Running weighted mean of scalar metric dicts; ``weight`` is a scalar
    or a per-key dict (missing keys weigh 1)."""

    def __init__(self):
        self._sums: Dict[str, float] = defaultdict(float)
        self._weights: Dict[str, float] = defaultdict(float)

    def update(self, metrics: dict, weight=1) -> None:
        for k, v in metrics.items():
            w = float(weight.get(k, 1)) if isinstance(weight, dict) else float(weight)
            self._sums[k] += float(v) * w
            self._weights[k] += w

    def compute(self) -> dict:
        return {k: v / self._weights[k] for k, v in self._sums.items() if self._weights[k] > 0}

    def reset(self) -> None:
        self._sums.clear()
        self._weights.clear()


_PER_ATOM_KEYS = ("loss_coord", "loss_type")
_PER_CRYSTAL_KEYS = ("loss_lattice", "loss_angle", "loss")


def weighted_update(acc: MeanMetrics, metrics: dict) -> None:
    """Exact epoch means: per-atom metrics weighted by the batch's real atom
    count, per-crystal metrics by its real crystal count (both carried in
    the metrics)."""
    m = dict(metrics)
    n_atoms = float(m.pop("num_atoms", 1.0))
    n_crystals = float(m.pop("num_crystals", 1.0))
    weights = {k: n_atoms for k in _PER_ATOM_KEYS}
    weights.update({k: n_crystals for k in _PER_CRYSTAL_KEYS})
    acc.update(m, weights)


def exact_loss(m: dict, angle_weight: float = 1.0) -> dict:
    """The composite loss recomposed from the exactly weighted components
    (its own batch mean mixes per-atom and per-crystal denominators)."""
    if all(k in m for k in ("loss_coord", "loss_type", "loss_lattice")):
        m = dict(m)
        m["loss"] = (m["loss_coord"] + m["loss_type"] + m["loss_lattice"]
                     + angle_weight * m.get("loss_angle", 0.0))
    return m


class EpochTimer:
    """Wall time per epoch; epoch 0 (kernel build, first launches) is not
    counted."""

    def __init__(self):
        self.times: list[float] = []
        self._start = None
        self._epoch = 0

    def epoch_start(self) -> None:
        self._start = time.perf_counter()

    def epoch_end(self) -> float:
        dt = time.perf_counter() - self._start
        if self._epoch > 0:
            self.times.append(dt)
        self._epoch += 1
        return dt

    def summary(self) -> str:
        if not self.times:
            return "no timed epochs"
        return (f"epoch time mean {np.mean(self.times):.2f}s "
                f"± {np.std(self.times):.2f}s over {len(self.times)} epochs")


class JsonlLogger:
    """Append-only metrics log, one JSON object per line; ``path=None``
    logs nothing."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, record: dict) -> None:
        if not self.path:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps({k: _jsonable(v) for k, v in record.items()}) + "\n")


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v
