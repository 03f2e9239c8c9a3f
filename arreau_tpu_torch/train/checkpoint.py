"""Checkpoints of the port: parameters in the JAX layout beside the
training state; counterpart of ``arreau_tpu/train/checkpoint.py`` (which
writes orbax checkpoints the card's machine cannot read). A checkpoint
holds a task's ``.model`` module (``DiffusionModel``, ``NBodyModel``,
``EGNNNBody``, ``MnistModel``).

``<directory>/meta.json`` describes the run (:func:`diffusion_meta`, or the
task CLIs' ``{"config": <their arguments>}``). Each
tag (``last``, ``best``, ``best-<step>``) is a directory of its own, which
``arreau_tpu_torch.cli.generate --checkpoint_dir <directory> --tag <tag>``
reads (its EMA weights by default, as the JAX CLI):

- ``meta.json``, a copy of the run's;
- ``params.npz``, the parameters as a flat JAX-layout tree
  (``interop/from_jax.py``), and ``ema_params.npz`` when an EMA is kept;
- ``state.pt``, a ``torch.save`` of the optimizer state, the EMA and the
  step, for ``--resume``.

A save writes a temporary directory and then renames it over the tag. The
``keep`` lowest validation losses are kept as ``best-<step>`` (their scores
in ``scores.json``, which also carries the best score across resumes), and
``best`` is the lowest.

With a ``mesh`` (``parallel/mesh.py``) every rank calls every method, in
the same order: rank 0 alone writes ``meta.json``, the tags, ``scores.json``
and the evictions, decides a ranked save and broadcasts the decision (the
JAX package's ``_is_primary`` and ``_broadcast_decision``); the others wait
for it. Under tensor parallelism the shards of the parameters, of AdamW's
moments and of the EMA are gathered before a save, so a checkpoint has the
one-card layout whatever the topology that wrote it, and a restore cuts
them again.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import asdict
from typing import Optional

import torch

from arreau_tpu_torch.interop.from_jax import (
    load_params_npz,
    params_from_jax,
    params_to_jax,
    save_params_npz,
)
from arreau_tpu_torch.parallel.mesh import (
    barrier,
    broadcast_from_main,
    sharded_state,
    state_shardings,
    whole_parameters,
    whole_state,
)
from arreau_tpu_torch.train.optim import AdamW
from arreau_tpu_torch.train.state import EMA


def diffusion_meta(config, z_table, length_stats: Optional[dict] = None,
                   fourier_w: Optional[torch.Tensor] = None) -> dict:
    """Self-describing metadata: the config, the z-table, the training
    lattice-length statistics (generation's ``clip_denoised`` envelope) and
    the fixed Fourier frequencies of the time embedding."""
    meta = {"config": asdict(config), "z_table_zs": [int(z) for z in z_table.zs]}
    if length_stats is not None:
        meta["length_stats"] = {k: float(v) for k, v in length_stats.items()}
    if fourier_w is not None:
        meta["fourier_w"] = [float(v) for v in fourier_w.detach().cpu().reshape(-1)]
    return meta


class CheckpointManager:
    def __init__(self, directory: str, meta: Optional[dict] = None, mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        self.main = mesh is None or mesh.is_main
        if self.main:
            os.makedirs(self.directory, exist_ok=True)
            if meta is not None:
                self._write_json("meta.json", meta)
        barrier(mesh)

    def path(self, tag: str) -> str:
        return os.path.join(self.directory, tag)

    def has(self, tag: str = "last") -> bool:
        return os.path.exists(os.path.join(self.path(tag), "state.pt"))

    def load_meta(self) -> dict:
        with open(os.path.join(self.directory, "meta.json")) as f:
            return json.load(f)

    def save(self, tag: str, model, optimizer: AdamW,
             ema: Optional[EMA] = None) -> None:
        plan = state_shardings(model.model)
        params = whole_state(model.model.state_dict(), plan, self.mesh)
        ema_params = whole_state(ema.params, plan, self.mesh) if ema is not None else None
        opt = optimizer.state_dict()
        opt = {**opt, "mu": whole_state(opt["mu"], plan, self.mesh),
               "nu": whole_state(opt["nu"], plan, self.mesh)}
        if self.main:
            target = self.path(tag)
            tmp = target + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            shutil.copyfile(os.path.join(self.directory, "meta.json"),
                            os.path.join(tmp, "meta.json"))
            save_params_npz(os.path.join(tmp, "params.npz"), params_to_jax(params))
            if ema is not None:
                save_params_npz(os.path.join(tmp, "ema_params.npz"),
                                params_to_jax({**params, **ema_params}))
            torch.save({"step": optimizer.count, "optimizer": opt,
                        "ema": {**ema.state_dict(), "params": ema_params}
                        if ema is not None else None},
                       os.path.join(tmp, "state.pt"))
            shutil.rmtree(target, ignore_errors=True)
            os.replace(tmp, target)
        barrier(self.mesh)

    def restore(self, tag: str, model, optimizer: AdamW,
                ema: Optional[EMA] = None) -> int:
        """Load a tag's parameters, optimizer state and EMA (cut to this
        rank's shards under tensor parallelism); returns its step."""
        with whole_parameters(model.model, self.mesh):
            params_from_jax(model, load_params_npz(os.path.join(self.path(tag), "params.npz")))
        device = next(model.model.parameters()).device
        state = torch.load(os.path.join(self.path(tag), "state.pt"), map_location=device,
                           weights_only=True)
        plan = state_shardings(model.model)
        opt = state["optimizer"]
        optimizer.load_state_dict({**opt, "mu": sharded_state(opt["mu"], plan, self.mesh),
                                   "nu": sharded_state(opt["nu"], plan, self.mesh)})
        if ema is not None and state["ema"] is not None:
            ema.load_state_dict({**state["ema"],
                                 "params": sharded_state(state["ema"]["params"], plan, self.mesh)})
        return int(state["step"])

    # ---- ranked retention

    def load_scores(self) -> dict:
        path = os.path.join(self.directory, "scores.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {"ranked": []}  # [score, tag] pairs, ascending

    def best_score(self) -> float:
        ranked = self.load_scores()["ranked"]
        return float(ranked[0][0]) if ranked else float("inf")

    def save_ranked(self, score: float, step: int, model, optimizer: AdamW,
                    ema: Optional[EMA] = None, keep: int = 3) -> bool:
        """Keep the ``keep`` lowest scores as ``best-<step>`` and the lowest
        as ``best``; returns whether this one entered. Rank 0 decides."""
        ranked = None
        if self.main:
            ranked = [(float(s), t) for s, t in self.load_scores()["ranked"]]
            if len(ranked) >= keep and score >= ranked[-1][0]:
                ranked = None
            else:
                ranked = sorted(ranked + [(float(score), f"best-{step}")], key=lambda st: st[0])
        ranked = broadcast_from_main(ranked, self.mesh)
        if ranked is None:
            return False
        tag = f"best-{step}"
        self.save(tag, model, optimizer, ema)
        if ranked[0][1] == tag:
            self.save("best", model, optimizer, ema)
        if self.main:
            for _, old in ranked[keep:]:
                shutil.rmtree(self.path(old), ignore_errors=True)
            self._write_json("scores.json", {"ranked": [[s, t] for s, t in ranked[:keep]]})
        barrier(self.mesh)
        return True

    def _write_json(self, name: str, obj: dict) -> None:
        with open(os.path.join(self.directory, name), "w") as f:
            json.dump(obj, f, indent=2)
