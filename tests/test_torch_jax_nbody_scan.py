"""``train_nbody`` on the JAX CLI's default chain (the scan chain: one
process, one device, no ``--max_steps``) against the JAX CLI from the same
``--seed`` on the CPU: a tiny Ponita, both CLIs reading one ``--data_dir``
(simulated once, so the key chain is tested apart from the integrator).
The JAX CLI runs its epoch as one ``lax.scan`` in a fresh process (one CPU
device, no ``enable_x64``; its Pallas kernels in interpret mode): the
epoch's shuffle is ``jax.random.permutation``, each step splits three keys,
each evaluation one. 35 training systems in batches of 10: the epoch's
shuffle drops the last 5 of the permutation (the remainder)."""

import numpy as np
import pytest

from arreau_tpu_torch.cli import train_nbody
from arreau_tpu_torch.data.nbody import generate_nbody_npz
from tests.test_torch_jax_cli_streams import _run_jax_cli, jsonl, printed
from tests.test_torch_train import LOSS_TOL

FLAGS = ["--epochs", "3", "--val_interval", "1", "--batch_size", "10",
         "--max_training_samples", "35", "--hidden_dim", "16", "--basis_dim", "8",
         "--layers", "2", "--num_ori", "4", "--seed", "3", "--lr", "1e-4"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port, JAX): each CLI's metrics.jsonl records and standard output."""
    root = tmp_path_factory.mktemp("nbody_scan")
    data = root / "data"
    generate_nbody_npz(str(data), num_train=35, num_valid=20, num_test=20)
    want_out = _run_jax_cli("arreau_tpu.cli.train_nbody",
                            [*FLAGS, "--data_dir", str(data), "--checkpoint_dir", str(root / "j")])
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_nbody.main(["--device", "cpu", *FLAGS, "--data_dir", str(data),
                          "--checkpoint_dir", str(root / "p")])
    return ((jsonl(root / "p" / "metrics.jsonl"), buf.getvalue()),
            (jsonl(root / "j" / "metrics.jsonl"), want_out))


@pytest.mark.parametrize("metric", ["train/mse", "valid/mse", "test/mse"])
def test_scan_chain_gives_the_jax_metrics(runs, metric):
    """Every epoch's train and valid MSE and the test MSE within the loss
    parity tolerance (``tests/test_torch_train.py``)."""
    (got, _), (want, _) = runs
    assert len(got) == len(want) == 4  # three epochs, then the test
    g = [r[metric] for r in got if metric in r]
    w = [r[metric] for r in want if metric in r]
    assert len(g) == len(w) == (1 if metric == "test/mse" else 3)
    np.testing.assert_allclose(g, w, **LOSS_TOL, err_msg=metric)


def test_scan_chain_steps_and_prints_as_jax(runs):
    (got, out), (want, want_out) = runs
    assert [r["step"] for r in got] == [r["step"] for r in want] == [3, 6, 9, 9]
    assert "NOTE" not in out and "steps/epoch 3" in out and "steps/epoch 3" in want_out
    np.testing.assert_allclose(printed(out, "test MSE"),
                               printed(want_out, "test MSE"), rtol=0, atol=1e-6)
