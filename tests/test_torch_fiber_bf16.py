"""The fused fiber conv (kernels #1/#2, ``kernels/fiber_conv.py``) in
bfloat16 against the JAX package on the CPU: the bfloat16 plain versions
against the Pallas ``fused_fiber_conv`` and its backward ``_bwd`` in
interpret mode, the dx rounding point of #2 shown bit for bit, the
``fuse_fiber`` bfloat16 backbone against the JAX Pallas branch, and the
generate CLI on a checkpoint whose ``meta.json`` carries ``fuse_fiber`` and
``compute_dtype="bfloat16"``. (One training step's loss terms and
gradients: ``tests/test_torch_fiber_bf16_train.py``.)

Inputs are made with numpy and fed to both packages; the tolerances are
those of ``tests/test_torch_bf16.py``, with its reasons."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.ops.pallas_conv import _bwd as j_fiber_bwd
from arreau_tpu.ops.pallas_conv import fused_fiber_conv as j_fused_fiber_conv
from arreau_tpu.ops.pallas_conv import make_gather_matrix
from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import DiffusionModel as JModel
from arreau_tpu_torch.cli import generate, train_diffusion
from arreau_tpu_torch.interop.from_jax import params_from_jax
from arreau_tpu_torch.kernels.fiber_conv import fiber_conv_bwd, fiber_conv_plain, fused_fiber_conv
from arreau_tpu_torch.kernels.spatial_conv import spatial_conv_bwd_plain
from arreau_tpu_torch.models.ponita import tile_senders
from arreau_tpu_torch.tasks.diffusion import DiffusionModel
from tests.test_torch_bf16 import KERNEL_REL_TOL, SCORE_REL_TOL, _rel
from tests.test_torch_fiber_conv import _kernel_layout
from tests.test_torch_model import _batch, _scores_inputs, perturbed_params, port_config, tiny_config
from tests.test_torch_train import TINY_ARGS

BF16 = jnp.bfloat16
ROOT = Path(__file__).resolve().parents[1]


def _fiber_inputs(rng, B=6, A=5, K=4, O=3, P=3, D=16, C=24, dyadic=False):
    """Standard layouts: basis [B, A, K, O, D], w [D, C], x [B, A, O, C],
    fk [O, P, C], the cotangent g [B, A, P, C], src/mask [B, A, K]. With
    ``dyadic`` every value is a small multiple of a power of two, so that
    every product and sum of the conv is exact in float32 whatever the
    order, and only the bfloat16 roundings shape the results."""
    shapes = dict(basis=(B, A, K, O, D), w=(D, C), x=(B, A, O, C), fk=(O, P, C), g=(B, A, P, C))
    if dyadic:
        # denominators: the per-edge kernel and the fiber cotangent come out
        # exact in float32 but not in bfloat16
        den = dict(basis=8, w=16, x=8, fk=64, g=16)
        vals = {k: rng.integers(-8, 9, size=s) / den[k] for k, s in shapes.items()}
    else:
        scale = dict(basis=1.0, w=0.2, x=1.0, fk=0.3, g=1.0)
        vals = {k: rng.normal(size=s) * scale[k] for k, s in shapes.items()}
    vals = {k: np.asarray(jnp.asarray(v, BF16 if k != "g" else jnp.float32).astype(jnp.float32))
            for k, v in vals.items()}
    return vals, rng.integers(0, A, size=(B, A, K)), rng.random((B, A, K)) > 0.3


def _both(vals, src, mask, tile):
    """(JAX bfloat16 arrays, the port's bfloat16 tensors, tile-local src):
    basis and x in the kernel layout, g as [B', P, TA, C]."""
    B, A = vals["basis"].shape[:2]
    basis, x = _kernel_layout(vals["basis"], vals["x"], tile)
    g = _kernel_layout(vals["basis"], vals["g"], tile)[1]
    arrays = dict(basis=basis, w=vals["w"], x=x, fk=vals["fk"])
    j = {k: jnp.asarray(v, BF16) for k, v in arrays.items()}
    j["g"] = jnp.asarray(g)
    j["sel"] = make_gather_matrix(jnp.asarray(src), jnp.asarray(mask), dtype=BF16,
                                  crystals_per_tile=tile)
    t = {k: torch.tensor(v, dtype=torch.float32).to(torch.bfloat16) for k, v in arrays.items()}
    t["g"] = torch.tensor(g, dtype=torch.float32)
    return j, t, tile_senders(torch.tensor(src), torch.tensor(mask), tile)


@pytest.mark.parametrize("tile", [1, 2])
def test_bf16_fiber_conv_plain_versions_match_pallas(tile):
    """#1 and #2 in bfloat16: y (float32) against fused_fiber_conv, and
    dbasis, dw, dx (bfloat16) and dfiber_kernel (bfloat16) of the port's
    Function against the Pallas backward _bwd, each within 1e-2 of its
    scale."""
    vals, src, mask = _fiber_inputs(np.random.default_rng(10 + tile))
    j, t, src_t = _both(vals, src, mask, tile)
    want = j_fused_fiber_conv(j["basis"], j["w"], j["x"], j["sel"], j["fk"])
    want_grads = j_fiber_bwd(j["basis"], j["w"], j["x"], j["sel"], j["fk"], j["g"])
    leaves = [t[k].clone().requires_grad_() for k in ("basis", "w", "x", "fk")]
    got = fused_fiber_conv(leaves[0], leaves[1], leaves[2], src_t, leaves[3])
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel(got.detach().numpy(), want) <= KERNEL_REL_TOL
    got.backward(t["g"])
    for name, leaf, ref in zip(("dbasis", "dw", "dx", "dfk"), leaves, want_grads):
        assert leaf.grad.dtype == torch.bfloat16 and ref.dtype == BF16, name
        assert _rel(leaf.grad.float().numpy(), ref.astype(jnp.float32)) <= KERNEL_REL_TOL, name


# runs the JAX package's #2 (pallas_conv.py:_bwd) on saved inputs, with XLA's
# excess precision off; writes its dx
_JAX_DX = """
import sys
import jax.numpy as jnp
import numpy as np
from arreau_tpu.ops.pallas_conv import _bwd

a = dict(np.load(sys.argv[1]))
bf = {k: jnp.asarray(a[k], jnp.bfloat16) for k in ("basis", "w", "x", "sel", "fk")}
dx = _bwd(bf["basis"], bf["w"], bf["x"], bf["sel"], bf["fk"], jnp.asarray(a["g"]))[2]
np.save(sys.argv[2], np.asarray(dx.astype(jnp.float32)))
"""


def test_bf16_fiber_conv_bwd_dx_rounds_as_the_jax_kernel(tmp_path):
    """#2's dx rounding point (pallas_conv.py:143, :158): the per-edge kernel
    and the fiber cotangent are rounded to bfloat16 apart and multiplied in
    bfloat16, where #4's own backward rounds their float32 product once
    (:376). On dyadic inputs every other product and sum is exact in
    float32, so the port's bfloat16 dx equals the JAX kernel's bit for bit,
    and the once-rounded dx does not. XLA's CPU compiler may keep a bfloat16
    intermediate in float32 (its flag xla_allow_excess_precision, on by
    default), which skips the bfloat16 product's rounding that the Pallas
    source writes: the JAX side runs in a fresh process with that off."""
    vals, src, mask = _fiber_inputs(np.random.default_rng(3), dyadic=True)
    j, t, src_t = _both(vals, src, mask, 2)
    np.savez(tmp_path / "in.npz", **{k: np.asarray(v.astype(jnp.float32)) for k, v in j.items()})
    flags = f"{os.environ.get('XLA_FLAGS', '')} --xla_allow_excess_precision=false".strip()
    env = {**os.environ, "XLA_FLAGS": flags, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", _JAX_DX, str(tmp_path / "in.npz"),
                    str(tmp_path / "dx.npy")], cwd=ROOT, env=env, check=True, timeout=300)
    want_dx = np.load(tmp_path / "dx.npy")
    _, x_sp = fiber_conv_plain(t["basis"], t["w"], t["x"], src_t, t["fk"], save_x_sp=True)
    got_dx = fiber_conv_bwd(t["basis"], t["w"], t["x"], src_t, t["fk"], t["g"], x_sp)[2]
    np.testing.assert_array_equal(got_dx.float().numpy(), want_dx)
    g_o = torch.einsum("bptc,opc->botc", t["g"], t["fk"].float())
    once = spatial_conv_bwd_plain(t["basis"], t["w"], t["x"], src_t, torch.ones(src_t.shape), g_o)
    assert not np.array_equal(once[2].float().numpy(), want_dx)


@pytest.mark.parametrize("degree", [2, 3])
def test_fuse_fiber_bf16_backbone_scores_match_jax_pallas_branch(degree):
    """predict_scores with fuse_fiber=True, compute_dtype="bfloat16": the
    port's kernel branch (the shared bfloat16 basis, #1's plain version per
    layer) against the JAX Pallas branch (fused_fiber_conv in interpret
    mode), same weights (biases and layer scales drawn at random); 30
    crystals of up to 5 atoms make two super-crystals of 15."""
    jcfg = tiny_config(degree=degree, compute_dtype="bfloat16", use_pallas=True, fuse_fiber=True)
    jmodel = JModel(jcfg)
    host = _batch(30, 5, seed=3)
    params = perturbed_params(jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                                   JBatch(*map(jnp.asarray, host))))
    inputs = _scores_inputs(host, jcfg.num_timesteps, seed=4)
    want = jax.jit(jmodel.predict_scores)(params, *map(jnp.asarray, inputs))
    model = DiffusionModel(port_config(jcfg), device="cpu", fourier_w=np.asarray(jmodel.fourier_w))
    assert model.model.config.fuse_fiber and model.model.dtype == torch.bfloat16
    params_from_jax(model, params)
    with torch.no_grad():
        got = model.predict_scores(*map(torch.tensor, inputs))
    for name, a, b in zip(("eps", "logits", "global"), got, want):
        assert a.dtype == torch.float32, name
        assert _rel(a.numpy(), np.asarray(b, np.float32)) <= SCORE_REL_TOL, name


def test_generate_cli_serves_fuse_fiber_bf16_checkpoint(tmp_path):
    """A checkpoint whose meta.json carries fuse_fiber and
    compute_dtype="bfloat16" (and use_pallas, so that the CPU takes the
    kernel branch): the generate CLI builds that backbone and samples finite
    crystals through #1's bfloat16 plain version."""
    ckpt = tmp_path / "ckpt"
    train_diffusion.main([*TINY_ARGS, "--compute_dtype", "bfloat16", "--max_steps", "2",
                          "--checkpoint_dir", str(ckpt)])
    meta = json.loads((ckpt / "meta.json").read_text())
    meta["config"].update(fuse_fiber=True, use_pallas=True)
    (ckpt / "meta.json").write_text(json.dumps(meta))
    model, _, _ = generate.load_model(str(ckpt), "best", True, "cpu")
    cfg = model.model.config
    assert cfg.fuse_fiber and cfg.use_kernels and model.model.dtype == torch.bfloat16
    result = generate.main(["--device", "cpu", "--checkpoint_dir", str(ckpt), "--tag", "best",
                            "--num_crystals", "3", "--batch_size", "3", "--num_atoms_per_sample",
                            "4", "--sample_steps", "3", "--out_dir", str(tmp_path / "gen")])
    assert result.num_crystals == 3 and np.isfinite(result.frac_x).all()
    assert np.isfinite(result.lattice).all()
