"""Trained checkpoints of the JAX package in the PyTorch port, on the CPU:
``convert_jax_checkpoint.py`` on the tracked orbax checkpoints, the port's
reverse chain on a converted float32 checkpoint against the JAX chain, one
bfloat16 score prediction of the flagship checkpoint through both packages
(its bfloat16 chain on a few crystals is
``tests/test_torch_trained_checkpoint_chain.py``), and the committed
``ported_ckpt/ang_on`` against a fresh conversion.

The flagship was trained on a TPU, where the JAX package's one float32
product of its bfloat16 network, the readout's ``jnp.dot(xcat, wcat)`` at
DEFAULT precision, takes bfloat16 operands; on the CPU JAX computes it in
float32. The JAX side runs it both ways (``jax_tpu_readout.py``), and the port
serves the flagship as it was trained (``readout_bf16_operands``).

The converter and the JAX side of the bfloat16 checks run in fresh
processes, as a user runs them: tests/conftest.py enables float64 in JAX,
under which ``DiffusionModel`` draws other Fourier frequencies than the
float32 ones the checkpoints were trained with."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from arreau_tpu.cli.generate import load_model as j_load_model
from arreau_tpu.ops.grids import cached_grid_s2 as j_cached_grid_s2
from arreau_tpu_torch.cli import generate
from arreau_tpu_torch.interop.from_jax import load_params_npz, params_from_jax
from arreau_tpu_torch.ops.fourier import default_fourier_weights
from arreau_tpu_torch.tasks.diffusion import (
    DiffusionConfig,
    DiffusionModel,
    strided_levels,
)
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.ops.lattice import frac_to_cart, lattice_from_params
from arreau_tpu_torch.ops.pbc import SELF_EDGE_EPS_SQR, SUPERCELLS, pbc_neighbor_list
from tests.test_torch_bf16 import SCORE_REL_TOL, _rel
from tests.test_torch_sampler import assert_same_crystals, jax_noise

ROOT = Path(__file__).resolve().parents[1]
RAND = ROOT / "out" / "r3" / "ckpt_rand"  # float32, 4 training steps
ANG_ON = ROOT / "out" / "r4" / "ckpt_ang_on"  # the flagship: bfloat16, diffuse_angles
PORTED = ROOT / "ported_ckpt" / "ang_on"


def convert(checkpoint_dir, tag, out_dir, *flags):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, str(ROOT / "convert_jax_checkpoint.py"), "--checkpoint_dir",
                    str(checkpoint_dir), "--tag", tag, "--out_dir", str(out_dir), *flags],
                   cwd=ROOT, env=env, check=True, timeout=300, capture_output=True)


def test_converted_float32_checkpoint_chain_matches_jax(tmp_path):
    """``ckpt_rand`` converted and loaded by the port's generate loader: two
    strided steps (eta 0, argmax types, clip_denoised from its
    length_stats) on 2 crystals of 4 atoms at the canonical width, every
    random number injected from the JAX keys, against ``_sample_impl`` on
    the parameters the JAX CLI's loader restores. Positions and lattice
    within 1e-4, types where the JAX top-2 logit margin exceeds 1e-4."""
    convert(RAND, "last", tmp_path / "rand")
    model, z_table, meta = generate.load_model(str(tmp_path / "rand"), "last", True, "cpu")
    assert meta["config"]["compute_dtype"] is None
    np.testing.assert_array_equal(meta["fourier_w"], default_fourier_weights(1234, 32).numpy())

    jmodel, params, j_z_table, j_meta = j_load_model(str(RAND), "last", True, return_meta=True)
    assert j_meta["config"] == meta["config"] and list(j_z_table.zs) == list(z_table.zs)
    # the JAX model's grid, carried by meta.json and loaded bit for bit
    np.testing.assert_array_equal(model.ori_grid.numpy(), np.asarray(jmodel.ori_grid))
    # the JAX loader's own rule for a meta that carries its frequencies: under
    # float64 (tests/conftest.py) JAX would draw others than training used
    jmodel.fourier_w = jax.numpy.asarray(meta["fourier_w"], jax.numpy.float32)
    seen = []
    predict = jmodel.predict_scores

    def recording(*args):  # keeps the type logits of every step, in order
        out = predict(*args)
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), out[1], ordered=True)
        return out

    jmodel.predict_scores = recording
    B, A, S = 2, 4, 2
    key = jax.random.PRNGKey(5)
    kw = dict(length_bounds=generate.length_bounds_from_meta(meta), type_temperature=0.0,
              sample_steps=S, ddim_eta=0.0)
    want = jmodel._sample_impl(params, key, B, A, **kw)
    num_steps = len(strided_levels(meta["config"]["num_timesteps"], S)) - 1
    noise = jax_noise(key, num_steps, len(z_table), B=B, A=A)
    with torch.no_grad():
        got = model._sample_impl(B, A, noise=noise, **kw)
    assert_same_crystals(want, got, seen[-1])


# the JAX side's switch between the readout product as the CPU computes it
# (float32) and as a TPU does at DEFAULT precision (bfloat16 operands, float32
# sums), from the repository's witness script
_TPU_READOUT = """
from jax_tpu_readout import tpu_readout
"""

_JAX_SCORES = _TPU_READOUT + """
import dataclasses
import sys
import jax
import jax.numpy as jnp
import numpy as np
import arreau_tpu.tasks.diffusion as diffusion
from arreau_tpu.cli.generate import load_model
from arreau_tpu.ops.pbc import SUPERCELLS, NeighborList
from arreau_tpu.tasks.diffusion import DiffusionModel

port = np.load(sys.argv[4])
own_graph = diffusion.pbc_neighbor_list
graphs = []


def edge_keys(src, image, mask):
    return jnp.sort(jnp.where(mask, src * len(SUPERCELLS) + image, -1), axis=-1)


def own_but_ties(cart, lattice, atom_mask, radius, max_neighbors):
    # JAX's own graph; a receiver whose edge set is not the port's takes the
    # port's slots (the test holds each such receiver to a tie), with its
    # lengths and directions from cart
    own = own_graph(cart, lattice, atom_mask, radius, max_neighbors)
    src, image, mask = (jnp.asarray(port[k]) for k in ("src", "image", "mask"))
    differ = jnp.any(edge_keys(src, image, mask) != edge_keys(own.src, own.image, own.mask),
                     axis=-1, keepdims=True)
    jax.debug.callback(lambda *g: graphs.append([np.asarray(x) for x in g]),
                       own.src, own.image, own.mask, differ[..., 0])
    B, A, K = src.shape
    offsets = jnp.einsum("ci,bij->bcj", jnp.asarray(SUPERCELLS, cart.dtype), lattice)
    sender = jnp.take_along_axis(cart, src.reshape(B, A * K, 1), axis=1)
    offset = jnp.take_along_axis(offsets, image.reshape(B, A * K, 1), axis=1)
    direction = (sender + offset).reshape(B, A, K, 3) - cart[:, :, None, :]
    direction = jnp.where(mask[..., None], direction, 0.0)
    dist = jnp.sqrt(jnp.sum(direction**2, axis=-1))
    return NeighborList(src=jnp.where(differ, src, own.src),
                        image=jnp.where(differ, image, own.image),
                        dist=jnp.where(differ, dist, own.dist),
                        direction=jnp.where(differ[..., None], direction, own.direction),
                        mask=jnp.where(differ, mask, own.mask))


diffusion.pbc_neighbor_list = own_but_ties
bf16, params, _ = load_model(sys.argv[1], "best", False)
f32 = DiffusionModel(dataclasses.replace(bf16.config, compute_dtype=None))
a = np.load(sys.argv[2])
args = [a[k] for k in ("frac", "onehot", "t", "num_atoms", "lengths", "angles", "mask")]
out = {}
for name, model in (("bfloat16", bf16), ("float32", f32)):
    for tpu in (False, True):
        tpu_readout(tpu)
        scores = jax.jit(lambda *a: model.predict_scores(*a))(params, *args)
        for i, o in enumerate(scores):
            out[f"{name}{'_tpu' if tpu else ''}{i}"] = np.asarray(o, np.float32)
jax.effects_barrier()
for run, graph in enumerate(graphs):
    for key, value in zip(("src", "image", "mask", "differ"), graph):
        out[f"graph{run}_{key}"] = value
np.savez(sys.argv[3], **out)
"""
SCORE_ARGS = ("frac", "onehot", "t", "num_atoms", "lengths", "angles", "mask")


def port_flagship(compute_dtype, use_kernels, readout_bf16_operands=True):
    """The committed flagship checkpoint in the port, at ``compute_dtype``
    (its own: bfloat16) on the given branch, its readout as the TPU it was
    trained on computed it (its own) or in float32."""
    meta = json.loads((PORTED / "meta.json").read_text())
    assert meta["config"]["compute_dtype"] == "bfloat16" and meta["config"]["diffuse_angles"]
    assert meta["readout_bf16_operands"] is True
    config = DiffusionConfig(**{**meta["config"], "compute_dtype": compute_dtype,
                                "use_pallas": use_kernels})
    model = DiffusionModel(config, device="cpu", fourier_w=meta["fourier_w"],
                           readout_bf16_operands=readout_bf16_operands)
    params_from_jax(model, load_params_npz(str(PORTED / "best" / "params.npz")))
    return model


@pytest.fixture(scope="module")
def flagship_scores(tmp_path_factory):
    """(inputs, the JAX package's scores in bfloat16 and float32, each with
    the readout as the CPU and as a TPU computes it) of the flagship
    checkpoint restored by the JAX CLI's loader. The inputs are
    those the sampler gives the model: the first, sixth and last forwards
    of a ten-step strided chain of 4 crystals of 8 atoms (t = 999, 500,
    100), run by the port in float32 from ``PRNGKey(3)``, and the port's
    graph of them. JAX runs in a fresh process with XLA's excess precision
    off (XLA's CPU compiler otherwise keeps bfloat16 intermediates in
    float32), on its own graph, except in a receiver whose edge set is not
    the port's: there it takes the port's slots (its lengths and directions
    its own, from the positions), and
    ``test_flagship_graphs_differ_only_at_ties`` holds each such receiver to
    a tie. Last, JAX's own graphs of its four runs."""
    tmp = tmp_path_factory.mktemp("flagship")
    model = port_flagship(None, False, False)
    seen = []
    predict = model.predict_scores
    model.predict_scores = lambda *a: seen.append([x.clone() for x in a]) or predict(*a)
    model.sample(4, 8, key=prng.prng_key(3), sample_steps=10)
    inputs = {k: torch.cat([seen[i][j] for i in (0, 5, 9)]).numpy()
              for j, k in enumerate(SCORE_ARGS)}
    np.savez(tmp / "in.npz", **inputs)
    cfg = model.config
    lattice = lattice_from_params(torch.as_tensor(inputs["lengths"]),
                                  torch.as_tensor(inputs["angles"]))
    graph = pbc_neighbor_list(frac_to_cart(torch.as_tensor(inputs["frac"]), lattice), lattice,
                              torch.as_tensor(inputs["mask"]), cfg.radius, cfg.max_neighbors)
    graph = {k: getattr(graph, k).numpy().astype(np.int32 if k != "mask" else bool)
             for k in ("src", "image", "mask")}
    np.savez(tmp / "graph.npz", **graph)
    flags = f"{os.environ.get('XLA_FLAGS', '')} --xla_allow_excess_precision=false".strip()
    env = {**os.environ, "XLA_FLAGS": flags, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", _JAX_SCORES, str(ANG_ON), str(tmp / "in.npz"),
                    str(tmp / "out.npz"), str(tmp / "graph.npz")], cwd=ROOT, env=env, check=True,
                   timeout=300)
    with np.load(tmp / "out.npz") as out:
        jax_graphs = [{k: out[f"graph{run}_{k}"] for k in ("src", "image", "mask", "differ")}
                      for run in range(4)]
        return inputs, {dt: [out[f"{dt}{i}"] for i in range(3)]
                        for dt in ("bfloat16", "bfloat16_tpu", "float32", "float32_tpu")}, \
            (graph, jax_graphs)


# float32 rounding of a candidate's squared distance in either package's
# selection, |x|^2 + |p|^2 - 2 x.p on centred coordinates: a few units of
# float32 roundoff (2^-24) of |x|^2 + |p|^2
TIE_ROUNDING = 16 * 2.0**-24


def untied_receivers(inputs, port, own, radius, max_neighbors):
    """(receivers whose edge sets differ between the graphs ``port`` and
    ``own``, those of them no tie explains). A tie: each edge in one set
    and not the other has an exact (float64, from the float32 inputs)
    squared distance within TIE_ROUNDING of the receiver's K-th smallest
    candidate's, or of the radius or self-edge cut."""
    lattice = lattice_from_params(torch.as_tensor(inputs["lengths"]).double(),
                                  torch.as_tensor(inputs["angles"]).double()).numpy()
    cart = np.einsum("bai,bij->baj", inputs["frac"].astype(np.float64), lattice)
    B, A, _ = cart.shape
    images = np.einsum("ci,bij->bcj", SUPERCELLS, lattice)
    cands = (cart[:, :, None] + images[:, None]).reshape(B, A * len(SUPERCELLS), 3)
    centre = cart.mean(axis=1)

    def edges(graph, b, i):
        return {int(s) * len(SUPERCELLS) + int(c)
                for s, c, m in zip(graph["src"][b, i], graph["image"][b, i], graph["mask"][b, i])
                if m}

    differ, untied = [], []
    for b in range(B):
        real = np.repeat(inputs["mask"][b], len(SUPERCELLS))
        for i in range(A):
            moved = edges(port, b, i) ^ edges(own, b, i)
            if not moved:
                continue
            differ.append((b, i))
            d2 = np.sum((cands[b] - cart[b, i]) ** 2, axis=-1)
            live = np.sort(d2[real & (d2 <= radius**2) & (d2 > SELF_EDGE_EPS_SQR)])
            cuts = [radius**2, SELF_EDGE_EPS_SQR]
            if len(live) >= max_neighbors:
                cuts.append(live[max_neighbors - 1])
            scale = np.sum((cart[b, i] - centre[b]) ** 2) + np.sum((cands[b] - centre[b]) ** 2, -1)
            if any(min(abs(d2[e] - c) for c in cuts) > TIE_ROUNDING * scale[e] for e in moved):
                untied.append((b, i))
    return differ, untied


def port_scores(inputs, compute_dtype, use_kernels, readout_bf16_operands=True):
    model = port_flagship(compute_dtype, use_kernels, readout_bf16_operands)
    with torch.no_grad():
        out = model.predict_scores(*[torch.as_tensor(inputs[k]) for k in SCORE_ARGS])
    return [o.float().numpy() for o in out]


def _rms_rel(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want**2)))


def test_flagship_graphs_differ_only_at_ties(flagship_scores):
    """The JAX package's own graph of the flagship inputs, in each of its
    four runs, against the port's: a receiver's edge set differs only where
    a tie at its K-th neighbour or a cut explains it (measured: 4 of 96
    receivers, each a pair of mirror images of one atom at exactly one
    distance, on the K-th slot), and JAX took the port's slots in exactly
    those receivers."""
    inputs, _, (port, own_graphs) = flagship_scores
    meta = json.loads((PORTED / "meta.json").read_text())["config"]
    for run, own in enumerate(own_graphs):
        differ, untied = untied_receivers(inputs, port, own, meta["radius"],
                                          meta["max_neighbors"])
        assert not untied, (run, f"{len(differ)} of {own['mask'].shape[0] * own['mask'].shape[1]}"
                                 f" receivers differ, untied: {untied}")
        assert sorted(zip(*np.nonzero(own["differ"]))) == differ, run


@pytest.mark.parametrize("use_kernels", [False, True])
def test_flagship_float32_scores_match_jax(flagship_scores, use_kernels):
    """The flagship's trained weights as the float32 function: the port's
    plain branch and its kernel branch (the kernels' plain versions on the
    CPU) against the JAX package's, every output within 1e-4 of its largest
    magnitude. Any misplaced or mistransposed weight of the trained tree
    shows here."""
    inputs, want, _ = flagship_scores
    for name, a, b in zip(("eps", "logits", "global"),
                          port_scores(inputs, None, use_kernels, False), want["float32"]):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 1e-4, name


@pytest.mark.parametrize("use_kernels", [False, True])
def test_flagship_tpu_readout_matches_jax(flagship_scores, use_kernels):
    """``readout_bf16_operands`` is the JAX readout as a TPU computes it. In
    the float32 function, where nothing else rounds, the port's outputs
    with it match the JAX package's with its readout product taken from
    bfloat16 operands: the type logits and the lattice head within 1e-4 of
    their largest magnitude (measured: 2.2e-06 and 6.6e-05), the coordinate
    head within 1e-2 (3.0e-03: a float32 difference of the two packages'
    activations can round them to neighbouring bfloat16 values, and eps is
    a small sum). That readout moves the lattice head by more than 1e-2
    from JAX's float32 readout (2.5%) and eps by 9.8%, so the check tells
    the two apart."""
    inputs, want, _ = flagship_scores
    got = port_scores(inputs, None, use_kernels, True)
    for name, a, b, tol in zip(("eps", "logits", "global"), got, want["float32_tpu"],
                               (1e-2, 1e-4, 1e-4)):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= tol, name
    assert _rel(got[2], want["float32"][2]) > 1e-2


# the coordinate head's bfloat16 rounding noise on these inputs: two
# evaluations at the JAX package's cast points that differ only in the order
# of their sums (the port's plain and kernel branches) differ by 6.5% of its
# RMS; the port against JAX 7.0% (plain) and 6.4% (kernel branch); JAX's own
# bfloat16 against its float32 function, both with the TPU's readout, 13.8%
EPS_BF16_RMS_TOL = 0.12


@pytest.mark.parametrize("use_kernels", [False, True])
def test_flagship_bf16_scores_match_jax(flagship_scores, use_kernels):
    """The flagship as it was trained, bfloat16 with the TPU's readout
    (``readout_bf16_operands``), on both of the port's branches, against the
    JAX package's bfloat16 outputs with its readout as a TPU computes it. The type logits
    and the lattice head within 2e-2 of their largest magnitude, the
    bfloat16 score tolerance of ``tests/test_torch_bf16.py``. The coordinate
    head (eps) of the trained model is a small sum over orientations
    (largest magnitude ~6e-3) that bfloat16 rounding moves by more than
    that in either package; it is held to JAX's bfloat16 eps within
    EPS_BF16_RMS_TOL of its RMS, 1.8x the rounding noise measured between
    the port's own two branches."""
    inputs, want, _ = flagship_scores
    got = port_scores(inputs, "bfloat16", use_kernels)
    for name, a, b in zip(("logits", "global"), got[1:], want["bfloat16_tpu"][1:]):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= SCORE_REL_TOL, name
    assert got[0].shape == want["bfloat16_tpu"][0].shape
    assert _rms_rel(got[0], want["bfloat16_tpu"][0]) <= EPS_BF16_RMS_TOL


def test_committed_flagship_checkpoint_is_a_fresh_conversion(tmp_path):
    """Converting ``ckpt_ang_on/best`` again gives the committed
    ``ported_ckpt/ang_on``: every array equal bit for bit (float32, as
    stored) and the same ``meta.json``, whose frequencies are the float32
    draw the port makes for seed 1234 and which serves the readout as
    the TPU the checkpoint was trained on computed it; its S^2 grid is the
    JAX package's, bit for bit."""
    convert(ANG_ON, "best", tmp_path / "ang_on", "--readout_bf16_operands", "true")
    fresh = json.loads((tmp_path / "ang_on" / "meta.json").read_text())
    committed = json.loads((PORTED / "meta.json").read_text())
    assert fresh == committed
    assert committed["readout_bf16_operands"] is True
    assert committed["config"] == json.loads((ANG_ON / "meta.json").read_text())["config"]
    np.testing.assert_array_equal(committed["fourier_w"], default_fourier_weights(1234, 32).numpy())
    np.testing.assert_array_equal(committed["ori_grid"],
                                  j_cached_grid_s2(committed["config"]["num_ori"]))
    assert sorted(os.listdir(tmp_path / "ang_on" / "best")) == ["params.npz"]
    with np.load(tmp_path / "ang_on" / "best" / "params.npz") as a, \
            np.load(PORTED / "best" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sum(v.size for v in jax.tree.leaves(load_params_npz(str(PORTED / "best" / "params.npz")))) \
        == 2313007
