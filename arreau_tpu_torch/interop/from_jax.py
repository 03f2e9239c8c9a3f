"""Carry the JAX package's parameters into the port, and store them.

A parameter tree of the JAX package is nested dicts of arrays (the flax
variables ``{"params": {...}}``, or the bare ``params`` dict). The port's
module names follow it, so one rule maps every name, of the Ponita
backbone of every task and of the EGNN baseline:

  params/basis_fn/dense_in/kernel   [F, H] -> basis_fn.dense_in.weight (transposed)
  params/layer_{i}/conv/kernel      [D, C] -> layers.{i}.conv.kernel   (as is: a bare param)
  params/layer_{i}/norm/scale              -> layers.{i}.norm.weight
  params/layer_{i}/layer_scale             -> layers.{i}.layer_scale
  params/readout_{i}/kernel         [C, O] -> readouts.{i}.weight      (transposed)
  params/edge_readout_{i}/kernel    [C + 4, O] -> edge_readouts.{i}.weight (transposed)
  params/conv_{i}/kernel/kernel     [D, C] -> convs.{i}.kernel.weight  (transposed; the
                                              point-cloud model's per-layer conv)
  .../bias                                 -> .../bias

(Dense kernels are ``[in, out]`` in flax and ``[out, in]`` in ``nn.Linear``;
``arreau_tpu/interop/torch_import.py`` documents the same table read the
other way.) The fixed Fourier frequencies travel beside the tree.

:func:`init_from_key` draws the parameters Flax's ``model.init(key, ...)``
gives the JAX model of the same configuration (``ops/prng.py``: each
parameter's key from its scope path and its place in the scope) and loads
them through the same table.

``save_params_npz`` / ``load_params_npz`` store a tree as one flat compressed npz with
``'/'``-joined keys, in the JAX layout, so either package can read it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from arreau_tpu_torch.models.blocks import BasisMLP
from arreau_tpu_torch.ops import prng

# a parameter's place among its flax scope's ``self.param`` calls: a Dense's
# (or a conv's) kernel and a LayerNorm's scale come before its bias
_CREATION_RANK = {"kernel": 0, "scale": 0, "layer_scale": 0, "bias": 1}


def _jax_name(torch_name: str) -> tuple[str, bool]:
    """(JAX key, transpose?) of one of the port's parameter names."""
    parts = torch_name.split(".")
    if parts[0] == "layers":
        parts[:2] = [f"layer_{parts[1]}"]
    elif parts[0] in ("readouts", "edge_readouts"):
        parts[:2] = [f"{parts[0][:-1]}_{parts[1]}"]
    elif parts[0] == "convs":
        parts[:2] = [f"conv_{parts[1]}"]
    transpose = False
    if parts[-1] == "weight":
        if parts[-2] == "norm":
            parts[-1] = "scale"
        else:
            parts[-1], transpose = "kernel", True
    return "/".join(["params", *parts]), transpose


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(_flatten(value, name))
        else:
            flat[name] = np.asarray(value)
    return flat


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _load(module, tree) -> None:
    """Load a JAX parameter tree into ``module``; every parameter on either
    side must be matched."""
    flat = _flatten(tree if "params" in tree else {"params": tree})
    state = {}
    for name, param in module.state_dict().items():
        key, transpose = _jax_name(name)
        if key not in flat:
            raise KeyError(f"JAX tree has no {key} for the port's {name}")
        value = torch.tensor(np.asarray(flat.pop(key), dtype=np.float32))
        state[name] = value.t() if transpose else value
    if flat:
        raise KeyError(f"JAX tree entries the port has no place for: {sorted(flat)}")
    module.load_state_dict(state, strict=True)


def init_from_key(module, key, kernel_scale=lambda path: 1.0,
                  layer_scale: Optional[float] = None) -> None:
    """Initialise ``module`` as Flax's ``model.init(key, ...)`` initialises
    the JAX model: every ``kernel`` by ``variance_scaling(kernel_scale(path),
    "fan_in", "truncated_normal")`` (``path`` its ``'/'``-joined JAX name),
    biases zero, LayerNorm scales one, ``layer_scale`` constant. ``key`` is
    a JAX key (uint32 ``[2]``, ``prng.prng_key(seed)``). Drawn on the host
    in float32 and loaded by :func:`_load`."""
    key = np.asarray(key, dtype=np.uint32)
    shapes = {}
    for name, param in module.state_dict().items():
        path, transpose = _jax_name(name)
        shapes[path] = tuple(param.shape[::-1]) if transpose else tuple(param.shape)
    scopes: dict = {}
    for path in shapes:
        scope, leaf = path.rsplit("/", 1)
        scopes.setdefault(scope, []).append(_CREATION_RANK[leaf])
    flat = {}
    for path, shape in shapes.items():
        scope, leaf = path.rsplit("/", 1)
        counter = 1 + sum(r < _CREATION_RANK[leaf] for r in scopes[scope])
        if leaf == "kernel":
            k = prng.flax_param_key(key, tuple(scope.split("/")[1:]), counter)
            fan_in = int(np.prod(shape[:-1]))
            flat[path] = prng.variance_scaling(k, shape, kernel_scale(path), fan_in)
        elif leaf == "scale":
            flat[path] = np.ones(shape, np.float32)
        elif leaf == "layer_scale":
            flat[path] = np.full(shape, layer_scale, np.float32)
        else:
            flat[path] = np.zeros(shape, np.float32)
    _load(module, _unflatten(flat))


def params_from_jax(model, tree, fourier_w: Optional[np.ndarray] = None) -> None:
    """Load a JAX parameter tree into ``model`` (a task: ``DiffusionModel``,
    ``NBodyModel``, ``MnistModel``, ``EGNNNBody``, ``QM9Model``,
    ``MD17Model``; or a bare module such as
    ``PonitaFiberBundle``); every parameter must be matched. With a
    ``DiffusionModel`` and ``fourier_w`` given, the frequencies are carried
    too."""
    _load(model if isinstance(model, torch.nn.Module) else model.model, tree)
    if fourier_w is not None:
        model.fourier_w = torch.as_tensor(
            np.asarray(fourier_w, dtype=np.float32), device=model.fourier_w.device
        )


def basis_mlp_params_from_jax(module: BasisMLP, tree) -> None:
    """Load a JAX ``BasisMLP`` parameter tree (``{"dense_in": {"kernel"[,
    "bias"]}, "dense_out": {...}}``, or the flax variables around it) into
    the port's ``BasisMLP``; ``fused=True`` or not, the tree is the same."""
    _load(module, tree)


def egnn_params_from_jax(model, tree) -> None:
    """Load a JAX ``EGNN`` parameter tree (``embed``, ``layer_{i}/edge_1``,
    ``edge_2``, ``coord``, ``vel_gate``, ``node_1``, ``node_2``) into the
    port's ``EGNN`` or ``EGNNNBody``; the names map by the same rule."""
    params_from_jax(model, tree)


def point_cloud_params_from_jax(model, tree) -> None:
    """Load a JAX ``PonitaPointCloud`` parameter tree (``x_embedder``,
    ``conv_{i}/basis_fn``, ``conv_{i}/kernel``, ``conv_{i}/bias``,
    ``layer_{i}/{norm,linear_1,linear_2}``, ``readout_{i}``: the names
    ``model.init`` gives, each conv in the parent's scope) into the port's
    ``PonitaPointCloud``, ``QM9Model`` or ``MD17Model``; the names map by
    the same rule."""
    params_from_jax(model, tree)


def params_to_jax(module) -> dict:
    """The port's parameters as a JAX-layout tree ``{"params": {...}}``;
    ``module`` is a module or its ``state_dict()``."""
    flat = {}
    state = module if isinstance(module, dict) else module.state_dict()
    for name, param in state.items():
        key, transpose = _jax_name(name)
        value = param.detach().float().cpu()
        flat[key] = (value.t() if transpose else value).contiguous().numpy()
    return _unflatten(flat)


def save_params_npz(path: str, tree) -> None:
    np.savez_compressed(path, **_flatten(tree))


def load_params_npz(path: str) -> dict:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})
