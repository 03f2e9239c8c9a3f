"""``train_mnist`` against the JAX CLI from the same ``--seed`` on the CPU,
on the same synthetic superpixels: the chain splits ``key, k_step`` a step
(the SO(2) rotation from ``split(k_step)[1]``) and one ``k_eval`` a
validation or test batch (two batches each here). The JAX CLI runs in a
fresh process (one CPU device, no ``enable_x64``; its Pallas kernels in
interpret mode)."""

import numpy as np
import pytest

from arreau_tpu_torch.cli import train_mnist
from tests.test_torch_jax_cli_streams import printed, run_both
from tests.test_torch_train import LOSS_TOL

# 50 digits: 40 / 5 / 5, 20 steps an epoch, two batches a validation
FLAGS = ["--epochs", "2", "--val_interval", "1", "--batch_size", "2", "--synthetic_size", "50",
         "--hidden_dim", "16", "--basis_dim", "8", "--layers", "2", "--num_ori", "6",
         "--seed", "3", "--lr", "1e-4"]
# the train metrics are printed with 4 decimals: within the loss tolerance or
# their last digit
PRINTED_ATOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both("arreau_tpu.cli.train_mnist", train_mnist.main, FLAGS,
                    tmp_path_factory.mktemp("mnist"))


@pytest.mark.parametrize("metric", ["valid/acc", "test/acc"])
def test_mnist_seed_gives_the_jax_accuracies(runs, metric):
    (got, _), (want, _) = runs
    assert [r["step"] for r in got] == [r["step"] for r in want] == [20, 40, 40]
    g, w = ([r[metric] for r in recs if metric in r] for recs in (got, want))
    assert len(g) == len(w) == (1 if metric == "test/acc" else 2)
    np.testing.assert_allclose(g, w, **LOSS_TOL, err_msg=metric)


@pytest.mark.parametrize("label", ["train acc", "nll"])
def test_mnist_train_metrics_match_jax(runs, label):
    """Each epoch's printed train accuracy and cross-entropy."""
    (_, out), (_, want_out) = runs
    got, want = printed(out, label), printed(want_out, label)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL["rtol"], atol=PRINTED_ATOL)
