"""``train_md17`` against the JAX CLI from the same ``--seed`` on the CPU,
on the same synthetic molecules: the chain splits ``key, k_step`` a step
(the rotation from ``split(k_step)[1]``) and one ``k_eval`` a validation
or test batch; each test batch's repeats take the keys of
``split(k_eval, repeats)``, one rotation batch a key. The JAX CLI runs in
a fresh process (one CPU device, no ``enable_x64``)."""

import numpy as np
import pytest

from arreau_tpu_torch.cli import train_md17
from tests.test_torch_jax_cli_streams import printed, run_both
from tests.test_torch_train import LOSS_TOL

# 28 molecules: 16 train (8 steps an epoch), 4 valid (two batches), 8 test
# (four batches) of 3 rotation repeats
FLAGS = ["--epochs", "2", "--val_interval", "1", "--batch_size", "2", "--synthetic_size", "28",
         "--train_size", "16", "--val_size", "4", "--repeats", "3", "--hidden_dim", "16",
         "--basis_dim", "8", "--degree", "2", "--layers", "2", "--num_ori", "4", "--seed", "3",
         "--lr", "1e-4"]
# a metric printed with 4 decimals: within the loss tolerance or its last digit
PRINTED_ATOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both("arreau_tpu.cli.train_md17", train_md17.main, FLAGS,
                    tmp_path_factory.mktemp("md17"))


@pytest.mark.parametrize("metric", ["valid/mae_energy", "valid/mae_force"])
def test_md17_seed_gives_the_jax_validations(runs, metric):
    """Each validation's energy and force MAE within the loss parity
    tolerance (``tests/test_torch_train.py``)."""
    (got, _), (want, _) = runs
    g, w = ([r[metric] for r in recs if "epoch" in r] for recs in (got, want))
    assert len(g) == len(w) == 2
    np.testing.assert_allclose(g, w, **LOSS_TOL, err_msg=metric)


@pytest.mark.parametrize("label", ["train E-MAE", "F-MAE", "energy", "force"])
def test_md17_printed_train_and_test_repeats_match_jax(runs, label):
    """The printed train MAEs of each epoch (``F-MAE`` also the
    validations') and the test's energy and force MAE after each of the 3
    repeats (what the JAX CLI prints and returns)."""
    (_, out), (_, want_out) = runs
    got, want = printed(out, label), printed(want_out, label)
    assert len(got) == len(want) == {"train E-MAE": 2, "F-MAE": 4, "energy": 3, "force": 3}[label]
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL["rtol"], atol=PRINTED_ATOL)
