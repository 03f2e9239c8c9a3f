"""``train_nbody`` on the JAX CLI's per-batch chain (``--max_steps``)
against the JAX CLI from the same ``--seed`` on the CPU, with the EGNN
baseline and one shared ``--data_dir``: numpy's shuffle an epoch, three
keys split a step, one a validation or test batch. The run stops inside
its third epoch, after two validations whose splits the later steps'
rotations follow. The JAX CLI runs in a fresh process (one CPU device, no
``enable_x64``)."""

import contextlib
import io

import numpy as np
import pytest

from arreau_tpu_torch.cli import train_nbody
from arreau_tpu_torch.data.nbody import generate_nbody_npz
from tests.test_torch_jax_cli_streams import _run_jax_cli, jsonl, printed
from tests.test_torch_train import LOSS_TOL

FLAGS = ["--model", "egnn", "--epochs", "3", "--val_interval", "1", "--batch_size", "10",
         "--max_training_samples", "30", "--hidden_dim", "16", "--layers", "2", "--seed", "4",
         "--max_steps", "7", "--lr", "1e-3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port, JAX): each CLI's metrics.jsonl records and standard output."""
    root = tmp_path_factory.mktemp("nbody_steps")
    data = root / "data"
    generate_nbody_npz(str(data), num_train=30, num_valid=20, num_test=20)
    want_out = _run_jax_cli("arreau_tpu.cli.train_nbody",
                            [*FLAGS, "--data_dir", str(data), "--checkpoint_dir", str(root / "j")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_nbody.main(["--device", "cpu", *FLAGS, "--data_dir", str(data),
                          "--checkpoint_dir", str(root / "p")])
    return ((jsonl(root / "p" / "metrics.jsonl"), buf.getvalue()),
            (jsonl(root / "j" / "metrics.jsonl"), want_out), data)


@pytest.mark.parametrize("metric", ["train/mse", "valid/mse", "test/mse"])
def test_per_batch_chain_gives_the_jax_metrics(runs, metric):
    """Every epoch's train and valid MSE and the test MSE within the loss
    parity tolerance (``tests/test_torch_train.py``)."""
    (got, _), (want, _), _ = runs
    assert [r["step"] for r in got] == [r["step"] for r in want] == [3, 6, 7, 7]
    g = [r[metric] for r in got if metric in r]
    w = [r[metric] for r in want if metric in r]
    assert len(g) == len(w) == (1 if metric == "test/mse" else 3)
    np.testing.assert_allclose(g, w, **LOSS_TOL, err_msg=metric)


def _without_times(records):
    return [{k: v for k, v in r.items() if k != "epoch_s"} for r in records]


@pytest.mark.parametrize("flag", [[], ["--scan_epoch", "True"]])
def test_max_steps_takes_the_per_batch_chain(runs, flag, tmp_path):
    """``--max_steps`` overrides ``--scan_epoch True``, which the CLI says:
    the same records either way, and the JAX CLI's printed test MSE."""
    (got, out), (_, want_out), data = runs
    if flag:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_nbody.main(["--device", "cpu", *FLAGS, *flag, "--data_dir", str(data),
                              "--checkpoint_dir", str(tmp_path)])
        out = buf.getvalue()
        assert "NOTE: --scan_epoch=True is ignored" in out
        assert _without_times(jsonl(tmp_path / "metrics.jsonl")) == _without_times(got)
    np.testing.assert_allclose(printed(out, "test MSE"),
                               printed(want_out, "test MSE"), rtol=0, atol=1e-6)
