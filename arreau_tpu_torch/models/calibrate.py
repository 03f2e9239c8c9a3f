"""One-shot activation-variance calibration of the conv kernels;
counterpart of ``arreau_tpu/models/calibrate.py``.

The reference rescales its conv kernels on the first training batch so
that each interaction layer's output has unit std. The port's initialisation
already scales the conv kernel by ``1/sqrt(expected_degree)``
(``PonitaFiberBundle.init_parameters``); this is the explicit equivalent,
applied once after init: one probe forward with a hook on every interaction
layer ``layers.{i}``, then each ``layers.{i}.conv.kernel`` rescaled in place
by ``target_std / std`` of that layer's output. The std is taken over the
whole output, padded atoms and every orientation included, as ``jnp.std``
in the JAX package; the output is the first element of
``ConvNextBlock.forward``'s pair on every branch (plain, kernel,
``fuse_fiber``, ``fuse_convnext``). On a CUDA backbone the probe runs the
forward kernels (#3 once a layer and #8 once on the default branch).
"""

from __future__ import annotations

import torch

from arreau_tpu_torch.models.ponita import FiberBundleInputs, PonitaFiberBundle


def calibrate_conv_kernels(backbone: PonitaFiberBundle, inputs: FiberBundleInputs,
                           target_std: float = 1.0) -> dict[str, float]:
    """Rescale ``backbone``'s conv kernels in place; returns the std each
    layer's output had in the probe, keyed ``layers.{i}``. A layer whose
    output std is 0 keeps its kernel."""
    measured: dict[str, torch.Tensor] = {}

    def probe(name):
        def hook(module, args, output):
            measured[name] = torch.std(output[0].float(), correction=0)
        return hook

    handles = [layer.register_forward_hook(probe(f"layers.{i}"))
               for i, layer in enumerate(backbone.layers)]
    try:
        with torch.no_grad():
            backbone(inputs)
    finally:
        for handle in handles:
            handle.remove()
    stds = {name: float(std) for name, std in measured.items()}
    with torch.no_grad():
        for name, std in stds.items():
            if std > 0:
                backbone.get_submodule(name).conv.kernel.mul_(target_std / std)
    return stds
