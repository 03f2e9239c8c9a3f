"""The generate CLI against the JAX package's from the same ``--seed`` on
the CPU: the same ``crystals.h5``. The JAX CLI runs in a fresh process that
sees one CPU device, without ``enable_x64``, as the port's runs (the
training CLI's three steps: ``tests/test_torch_jax_train_streams.py``)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np

from arreau_tpu_torch.cli import generate
from arreau_tpu_torch.inference.io import load_sample_results
from arreau_tpu_torch.interop.from_jax import save_params_npz
from tests.test_torch_jax_streams import ROOT, _jax_model
from tests.test_torch_model import Z_TABLE


def _run_jax_cli(module, argv, timeout=600):
    """``python -m module argv`` of the JAX package in a fresh process on
    one CPU device, without ``enable_x64``."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_generate_seed_gives_the_jax_crystals(tmp_path):
    """``generate --seed 5`` in both packages on one checkpoint (two batches,
    the strided chain with ancestral noise): the same ``crystals.h5`` within
    the injected-noise chain tests' tolerances."""
    jmodel, params = _jax_model(0)
    from arreau_tpu.train.checkpoint import CheckpointManager, diffusion_meta
    from arreau_tpu.train.optim import make_optimizer
    from arreau_tpu.train.state import create_train_state

    meta = diffusion_meta(jmodel.config, Z_TABLE, {"min": 3.0, "max": 8.0, "mean": 5.5,
                                                   "std": 1.4})
    with jax.enable_x64(False):
        CheckpointManager(str(tmp_path / "jax"), meta=meta).save(
            create_train_state(params, make_optimizer(1e-3)), "best")
    (tmp_path / "port" / "best").mkdir(parents=True)
    (tmp_path / "port" / "meta.json").write_text(json.dumps(
        {**meta, "fourier_w": np.asarray(jmodel.fourier_w).tolist()}))
    save_params_npz(str(tmp_path / "port" / "best" / "params.npz"), params)
    flags = ["--tag", "best", "--use_ema", "false", "--num_crystals", "6", "--batch_size", "3",
             "--num_atoms_per_sample", "4", "--sample_steps", "4", "--ddim_eta", "1.0",
             "--seed", "5"]
    _run_jax_cli("arreau_tpu.cli.generate", ["--checkpoint_dir", str(tmp_path / "jax"), *flags,
                                             "--out_dir", str(tmp_path / "j")])
    generate.main(["--checkpoint_dir", str(tmp_path / "port"), "--device", "cpu", *flags,
                   "--out_dir", str(tmp_path / "p")])
    got = load_sample_results(str(tmp_path / "p" / "crystals.h5"))
    want = load_sample_results(str(tmp_path / "j" / "crystals.h5"))
    np.testing.assert_array_equal(got.num_atoms, want.num_atoms)
    np.testing.assert_array_equal(got.atomic_numbers, want.atomic_numbers)
    d = np.abs(got.frac_x - want.frac_x)
    assert np.minimum(d, 1 - d).max() < 1e-4
    np.testing.assert_allclose(got.lattice, want.lattice, rtol=1e-4, atol=1e-4)


def jsonl(path) -> list:
    """The records of a ``metrics.jsonl``."""
    with open(path) as f:
        return [json.loads(line) for line in f]


def printed(text: str, label: str) -> list:
    """Every number ``text`` prints right after ``label`` (``"test MSE"``,
    ``"train MAE"``, ...), in order."""
    import re

    return [float(x) for x in re.findall(re.escape(label) + r" ([-+]?\d+\.\d+(?:e[-+]?\d+)?)",
                                         text)]


def run_both(jax_module: str, port_main, flags: list, root) -> tuple:
    """``jax_module`` (in a fresh process, :func:`_run_jax_cli`) and the
    port's ``port_main`` (on the CPU) with ``flags`` and checkpoint
    directories under ``root``: ((port records, port output), (JAX records,
    JAX output)), the records those of each ``metrics.jsonl``."""
    import contextlib
    import io

    want_out = _run_jax_cli(jax_module, [*flags, "--checkpoint_dir", str(root / "j")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_main(["--device", "cpu", *flags, "--checkpoint_dir", str(root / "p")])
    return ((jsonl(root / "p" / "metrics.jsonl"), buf.getvalue()),
            (jsonl(root / "j" / "metrics.jsonl"), want_out))
