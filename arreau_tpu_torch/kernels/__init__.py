"""The port's hand-written CUDA kernels and their wrappers.

Importing this package registers the five forward kernels as PyTorch
operators under the namespace ``arreau_tpu_torch`` (``spatial_conv``,
``basis_h1``, ``fiber_conv``, ``convnext_mlp``, ``fused_basis_mlp``), so
that a program ``torch.export`` saved can be loaded and run; the kernel
library is built at the first launch on the card (``build.py``), never at
import.
"""

from arreau_tpu_torch.kernels import (  # noqa: F401
    basis_h1,
    basis_mlp,
    convnext_mlp,
    fiber_conv,
    fused_basis_mlp,
    spatial_conv,
)
