"""One training step of the ``fuse_fiber`` bfloat16 path against the JAX
package on the CPU: each loss term, then every parameter gradient, of the
port's kernel branch with ``fuse_fiber=True, compute_dtype="bfloat16"``
(the plain basis MLP in bfloat16, and the fused_fiber_conv Function with
kernels #1/#2 running their bfloat16 plain versions) against ``jax.grad``
of the JAX loss on its Pallas branch with the same settings
(``fused_fiber_conv`` and its custom VJP in interpret mode). The tolerances
are ``tests/test_torch_bf16.py``'s for the bfloat16 Pallas branch, with its
reasons."""

from arreau_tpu_torch.kernels import fiber_conv
from tests.test_torch_bf16 import GRAD_REL_TOL, LOSS_REL_TOL, _assert_loss_and_gradients
from tests.test_torch_train import _jax_setup


def test_fuse_fiber_bf16_loss_terms_and_every_gradient_match_jax_pallas_branch(monkeypatch):
    jmodel, host, params = _jax_setup(True, compute_dtype="bfloat16", fuse_fiber=True)
    calls = {"fiber_conv_plain": 0, "fiber_conv_bwd_plain": 0}

    def counted(name):
        fn = getattr(fiber_conv, name)

        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)

        return call

    for name in calls:
        monkeypatch.setattr(fiber_conv, name, counted(name))
    _assert_loss_and_gradients(jmodel, host, params, dict(rtol=LOSS_REL_TOL, atol=1e-6),
                               GRAD_REL_TOL, fuse_convnext=False)
    # every layer's conv went through #1 and #2 (their plain versions on the CPU)
    layers = jmodel.config.num_layers
    assert calls == {"fiber_conv_plain": layers, "fiber_conv_bwd_plain": layers}
