"""Import reference (PyTorch Lightning) PONITA_DIFFUSION checkpoints into
the port; counterpart of ``arreau_tpu/interop/torch_import.py``.

The reference trains ``PonitaFiberBundle`` under a Lightning wrapper; its
trainable parameters map one to one onto the port's. A reference ``.ckpt``
is read with ``torch.load``, its ``state_dict`` renamed into the JAX
package's layout (the table below, the JAX importer's), loaded through
``interop/from_jax.py:params_from_jax`` (which refuses an unmatched name)
and written as a port checkpoint directory (``train/checkpoint.py``) that
``arreau_tpu_torch.cli.generate`` reads. ``kernel(W)`` marks a transpose:
``nn.Linear`` stores ``[out, in]``, the JAX layout ``[in, out]``.

  t_emb.gaussian_fourier_proj_w                 -> meta["fourier_w"]
  z_table_zs (buffer)                           -> meta["z_table_zs"]
  model.basis_fn.{1,3}.weight/bias              -> basis_fn.dense_{in,out}.kernel(W)/bias
  model.fiber_basis_fn.{1,3}.weight/bias        -> fiber_basis_fn.dense_{in,out}.kernel(W)/bias
  model.x_embedder.weight                       -> x_embedder.kernel(W)
  model.interaction_layers.{i}.conv.kernel.weight        -> layer_{i}.conv.kernel(W)
  model.interaction_layers.{i}.conv.fiber_kernel.weight  -> layer_{i}.conv.fiber_kernel.kernel(W)
  model.interaction_layers.{i}.conv.bias                 -> layer_{i}.conv.bias
  model.interaction_layers.{i}.norm.weight/bias          -> layer_{i}.norm.scale/bias
  model.interaction_layers.{i}.linear_{1,2}.weight/bias  -> layer_{i}.linear_{1,2}.kernel(W)/bias
  model.interaction_layers.{i}.layer_scale               -> layer_{i}.layer_scale
  model.read_out_layers.{i}.weight/bias                  -> readout_{i}.kernel(W)/bias
  model.edge_readout_layers.{i}.*               -> edge_readout_{i}.* (dropped when
                                                   zero-width, as in the diffusion config)
  *.callibrated, diffusion_loss.*               -> dropped (re-derived from the config)

The port's ``layers.{i}.conv.kernel`` is a bare ``[D, C]`` parameter in the
JAX layout, so the reference's ``[C, D]`` weight is transposed once, here.

Approximations, the JAX importer's, unchanged: the reference's GELU is the
exact (erf) one and both packages use the tanh form; the reference draws a
new S^2 orientation grid in every process (it is not in its checkpoints),
and both packages use their one fixed grid. The port therefore computes the
JAX import's function (``tests/test_torch_reference_import.py``) and
inherits its distance to the reference (``tests/test_import_e2e_bound.py``).

``torch.load`` here unpickles the whole file (``weights_only=False``), which
can run code the file names: import only checkpoints you trust.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from arreau_tpu_torch.data.atoms import AtomicNumberTable
from arreau_tpu_torch.interop.from_jax import _flatten, params_from_jax, params_to_jax
from arreau_tpu_torch.tasks.diffusion import DiffusionConfig, DiffusionModel
from arreau_tpu_torch.train.checkpoint import CheckpointManager, diffusion_meta
from arreau_tpu_torch.train.optim import AdamW
from arreau_tpu_torch.train.state import EMA

# ---------------------------------------------------------------------------
# Tolerant torch.load: reference checkpoints pickle classes of the reference
# package (AtomicNumberTable, its argparse namespace) that do not import here.
# Each missing class becomes a stub that keeps its state.


class _Stub:
    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Stub,), {"__module__": module})


class _TolerantPickle:
    """The ``pickle_module`` ``torch.load`` takes: ``Unpickler`` and ``load``."""

    Unpickler = _Unpickler

    @staticmethod
    def load(f, **kwargs):
        return _Unpickler(f).load()

    @staticmethod
    def loads(b, **kwargs):
        return _Unpickler(io.BytesIO(b)).load()


def _tolerant_torch_load(path: str):
    # map_location cpu: a checkpoint saved on a GPU is converted without CUDA
    return torch.load(path, map_location="cpu", pickle_module=_TolerantPickle, weights_only=False)


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """A reference ``.ckpt`` -> (state_dict as numpy, hyper-parameter dict).

    A bare ``state_dict`` file (no Lightning wrapper) gives an empty
    hyper-parameter dict."""
    obj = _tolerant_torch_load(path)
    if isinstance(obj, dict) and "state_dict" in obj:
        sd, hparams = obj["state_dict"], obj.get("hyper_parameters", {}) or {}
    else:
        sd, hparams = obj, {}
    sd_np = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
             for k, v in sd.items()}
    args = hparams.get("args") if isinstance(hparams, dict) else None
    args_dict = dict(vars(args)) if args is not None and hasattr(args, "__dict__") else {}
    return sd_np, args_dict


# ---------------------------------------------------------------------------
# state_dict -> JAX-layout tree


def _t(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def convert_state_dict(
    sd: Dict[str, np.ndarray], num_layers: int
) -> Tuple[dict, np.ndarray, Optional[np.ndarray]]:
    """A PONITA_DIFFUSION state_dict -> ``({'params': ...}, fourier_w,
    z_table_zs)``, the tree in the JAX layout. Raises ``KeyError`` naming
    the first reference key that is missing."""
    p: Dict[str, Any] = {}

    def dense(torch_prefix: str, bias: bool = True) -> dict:
        out = {"kernel": _t(sd[f"{torch_prefix}.weight"])}
        if bias:
            out["bias"] = sd[f"{torch_prefix}.bias"]
        return out

    for ours, theirs in (("basis_fn", "model.basis_fn"), ("fiber_basis_fn", "model.fiber_basis_fn")):
        p[ours] = {"dense_in": dense(f"{theirs}.1"), "dense_out": dense(f"{theirs}.3")}
    p["x_embedder"] = {"kernel": _t(sd["model.x_embedder.weight"])}

    for i in range(num_layers):
        t = f"model.interaction_layers.{i}"
        layer: Dict[str, Any] = {
            "conv": {
                "kernel": _t(sd[f"{t}.conv.kernel.weight"]),
                "fiber_kernel": {"kernel": _t(sd[f"{t}.conv.fiber_kernel.weight"])},
                "bias": sd[f"{t}.conv.bias"],
            },
            "norm": {"scale": sd[f"{t}.norm.weight"], "bias": sd[f"{t}.norm.bias"]},
            "linear_1": dense(f"{t}.linear_1"),
            "linear_2": dense(f"{t}.linear_2"),
        }
        if f"{t}.layer_scale" in sd:
            layer["layer_scale"] = sd[f"{t}.layer_scale"]
        p[f"layer_{i}"] = layer
        ro = f"model.read_out_layers.{i}"
        if f"{ro}.weight" in sd:  # absent where multiple_readouts is off
            p[f"readout_{i}"] = dense(ro)
        er = f"model.edge_readout_layers.{i}"
        if f"{er}.weight" in sd and sd[f"{er}.weight"].shape[0] > 0:
            p[f"edge_readout_{i}"] = dense(er)

    fourier_w = sd["t_emb.gaussian_fourier_proj_w"]
    z_zs = sd.get("z_table_zs")
    return {"params": p}, fourier_w, z_zs


# ---------------------------------------------------------------------------
# end to end: reference .ckpt -> the port's checkpoint directory


def config_from_reference_args(args: dict, num_atomic_states: int) -> DiffusionConfig:
    """The reference CLI's namespace onto :class:`DiffusionConfig`; unknown
    keys are ignored, fields it does not name keep their defaults."""
    take = {
        "num_timesteps": "num_timesteps",
        "radius": "radius",
        "max_neighbors": "max_neighbors",
        "hidden_dim": "hidden_dim",
        "basis_dim": "basis_dim",
        "degree": "degree",
        "layers": "num_layers",
        "num_ori": "num_ori",
        "widening_factor": "widening_factor",
        "layer_scale": "layer_scale",
        "multiple_readouts": "multiple_readouts",
    }
    kw = {ours: args[theirs] for theirs, ours in take.items() if args.get(theirs) is not None}
    return DiffusionConfig(num_atomic_states=num_atomic_states, **kw)


def convert_reference_checkpoint(ckpt_path: str, out_dir: str, tag: str = "best") -> dict:
    """A reference ``.ckpt`` -> the port's checkpoint directory ``out_dir``
    (``meta.json``, ``<tag>/params.npz``, ``ema_params.npz`` equal to it,
    ``state.pt``), converted on the CPU. Returns the written meta."""
    sd, args = load_reference_checkpoint(ckpt_path)
    if "z_table_zs" not in sd:
        raise ValueError(f"{ckpt_path} has no z_table_zs buffer — not a PONITA_DIFFUSION checkpoint")
    z_zs = [int(z) for z in sd["z_table_zs"]]
    cfg = config_from_reference_args(args, num_atomic_states=len(z_zs))
    params, fourier_w, _ = convert_state_dict(sd, cfg.num_layers)

    model = DiffusionModel(cfg, device="cpu", fourier_w=np.asarray(fourier_w, np.float32))
    want = {k: tuple(v.shape) for k, v in _flatten(params_to_jax(model.model)).items()}
    got = {k: tuple(v.shape) for k, v in _flatten(params).items()}
    if want != got:
        raise ValueError(
            "converted parameter tree does not match the model built from the "
            f"checkpoint's hyper-parameters:\nwant {want}\ngot  {got}"
        )
    params_from_jax(model, params)

    meta = diffusion_meta(cfg, AtomicNumberTable(z_zs))
    meta["fourier_w"] = [float(w) for w in fourier_w]
    meta["imported_from"] = ckpt_path
    # a fresh training state, as the JAX importer writes: the EMA equals the weights
    CheckpointManager(out_dir, meta=meta).save(tag, model, AdamW(model.model, lambda _: 1e-3),
                                               EMA(model.model, 0.999))
    return meta
