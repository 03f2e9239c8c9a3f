"""Three steps of the training CLI under ``--train_augm`` against the JAX
package's from the same ``--seed`` on the same synthetic data, on the CPU.
The JAX CLI runs in a fresh process that sees one CPU device, without
``enable_x64``, as the port's runs."""

import json

import numpy as np

from arreau_tpu_torch.cli import train_diffusion
from tests.test_torch_jax_cli_streams import _run_jax_cli
from tests.test_torch_train import LOSS_TOL, TINY_ARGS


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_seed_gives_the_jax_losses(tmp_path):
    """``train_diffusion --seed 7 --train_augm true`` in both packages on the
    same synthetic data, three steps, then a validation and the test pass:
    every train (the three steps' mean), validation and test loss term
    within the loss parity tolerance (``tests/test_torch_train.py``). The
    learning rate is 1e-5: AdamW's first step moves every parameter by lr
    times the sign of its gradient, and a gradient near zero can take either
    sign in two float32 computations."""
    flags = [a for a in TINY_ARGS if a not in ("--device", "cpu")]
    flags += ["--synthetic_size", "12", "--max_steps", "3", "--seed", "7", "--train_augm", "true",
              "--diffuse_angles", "true", "--layer_scale", "0.5", "--lr", "1e-5"]
    _run_jax_cli("arreau_tpu.cli.train_diffusion",
                 [*flags, "--checkpoint_dir", str(tmp_path / "j")])
    train_diffusion.main(["--device", "cpu", *flags, "--checkpoint_dir", str(tmp_path / "p")])
    got, want = _jsonl(tmp_path / "p" / "metrics.jsonl"), _jsonl(tmp_path / "j" / "metrics.jsonl")
    assert len(got) == len(want) == 3  # train, valid, test
    for g, w in zip(got, want):
        terms = [k for k in w if k.split("/")[-1].startswith("loss")]
        assert terms and set(terms) <= set(g)
        for k in terms:
            np.testing.assert_allclose(g[k], w[k], **LOSS_TOL, err_msg=k)
