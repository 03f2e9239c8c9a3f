"""``train_qm9`` against the JAX CLI from the same ``--seed`` on the CPU,
on the same synthetic molecules: the chain splits ``key, k_step`` a step
(the rotation from ``split(k_step)[1]``) and one ``k_eval`` a validation
or test batch (two batches each here, between the epochs' steps). The JAX
CLI runs in a fresh process (one CPU device, no ``enable_x64``)."""

import numpy as np
import pytest

from arreau_tpu_torch.cli import train_qm9
from tests.test_torch_jax_cli_streams import printed, run_both
from tests.test_torch_train import LOSS_TOL

# 50 molecules: 40 / 5 / 5, 20 steps an epoch, two batches a validation
FLAGS = ["--epochs", "2", "--val_interval", "1", "--batch_size", "2", "--synthetic_size", "50",
         "--hidden_dim", "16", "--basis_dim", "8", "--degree", "2", "--layers", "2",
         "--num_ori", "4", "--seed", "3", "--lr", "1e-4"]
# a metric printed with 6 decimals: within the loss tolerance or its last digit
PRINTED_ATOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both("arreau_tpu.cli.train_qm9", train_qm9.main, FLAGS,
                    tmp_path_factory.mktemp("qm9"))


@pytest.mark.parametrize("metric", ["valid/mae", "test/mae"])
def test_qm9_seed_gives_the_jax_metrics(runs, metric):
    """Each validation's and the test's MAE within the loss parity
    tolerance (``tests/test_torch_train.py``)."""
    (got, _), (want, _) = runs
    assert [r["step"] for r in got] == [r["step"] for r in want] == [20, 40, 40]
    g, w = ([r[metric] for r in recs if metric in r] for recs in (got, want))
    assert len(g) == len(w) == (1 if metric == "test/mae" else 2)
    np.testing.assert_allclose(g, w, **LOSS_TOL, err_msg=metric)


def test_qm9_train_maes_match_jax(runs):
    """Each epoch's printed train MAE (the mean over its steps)."""
    (_, out), (_, want_out) = runs
    got, want = printed(out, "train MAE"), printed(want_out, "train MAE")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL["rtol"], atol=PRINTED_ATOL)
