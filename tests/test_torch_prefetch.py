"""``utils.prefetch`` against the JAX package's ``arreau_tpu.utils.prefetch``
on the same iterables (order, depth, the worker's exception), the training
CLI's batches staged in a thread (the same per-step losses as collating in
the step's own thread, bit for bit on the CPU), and its ``--log`` and
``--profiler torch`` flags."""

import json
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from arreau_tpu.utils import prefetch as j_prefetch
from arreau_tpu_torch.cli import train_diffusion
from arreau_tpu_torch.data.crystal import BucketedLoader
from arreau_tpu_torch.data.synthetic import synthetic_packed
from arreau_tpu_torch.tasks.diffusion import batch_to_device
from arreau_tpu_torch.utils import prefetch, prefetch_to_device
from tests.test_torch_train import TINY_ARGS


@pytest.mark.parametrize("fn", [prefetch, j_prefetch], ids=["port", "jax"])
@pytest.mark.parametrize("items", [[], [3], list(range(17)), ["a", None, 2.5, (1, 2)]])
def test_items_come_out_in_order(fn, items):
    assert list(fn(iter(items), depth=2)) == items


def _ahead(fn, depth, n=12):
    """The most items the worker had drawn beyond those the consumer had
    taken, for a slow consumer."""
    drawn, ahead = [0], []

    def source():
        for i in range(n):
            drawn[0] += 1
            yield i

    for taken, _ in enumerate(fn(source(), depth=depth), start=1):
        time.sleep(0.01)
        ahead.append(drawn[0] - taken)
    return max(ahead)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_worker_runs_at_most_depth_ahead_as_jax(depth):
    """The queue holds ``depth`` items and the worker one more in hand: the
    same bound, reached, in both packages."""
    assert _ahead(prefetch, depth) == _ahead(j_prefetch, depth) == depth + 1


@pytest.mark.parametrize("fn", [prefetch, j_prefetch], ids=["port", "jax"])
def test_worker_exception_reaches_the_consumer_after_the_items_before_it(fn):
    def source():
        yield 1
        yield 2
        raise KeyError("collate failed")

    got = []
    with pytest.raises(KeyError, match="collate failed"):
        for item in fn(source(), depth=2):
            got.append(item)
    assert got == [1, 2]


def test_worker_is_a_daemon_thread():
    seen = []

    def source():
        seen.append(threading.current_thread())
        yield 0

    assert list(prefetch(source())) == [0]
    assert seen[0] is not threading.main_thread() and seen[0].daemon


def test_prefetch_to_device_gives_the_loaders_batches_on_the_cpu():
    """Off CUDA the worker calls ``batch_to_device(host, device, False)``: the same
    tensors as collating and copying in the consumer's thread."""
    ds = synthetic_packed(40, seed=0)

    def loader():
        return BucketedLoader(ds, np.arange(40), node_budget=64, seed=3)

    want = [batch_to_device(host, "cpu") for host in loader()]
    got = list(prefetch_to_device(loader(), batch_to_device, torch.device("cpu")))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        for name in a._fields:
            assert getattr(a, name).dtype == getattr(b, name).dtype
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def _run_cli(tmp_path, monkeypatch, name, extra=()):
    """Per-step loss terms of a training CLI run (4 steps), and its test loss."""
    losses = []
    step = train_diffusion.train_step

    def recording(*args, **kw):
        metrics = step(*args, **kw)
        losses.append({k: v.clone() for k, v in metrics.items()})
        return metrics

    monkeypatch.setattr(train_diffusion, "train_step", recording)
    test_loss = train_diffusion.main([*TINY_ARGS, "--max_steps", "4", "--train_augm", "true",
                                      "--checkpoint_dir", str(tmp_path / name), *extra])
    monkeypatch.setattr(train_diffusion, "train_step", step)
    return losses, test_loss


def test_training_with_prefetch_equals_collating_in_the_step_thread(tmp_path, monkeypatch):
    """The CLI (batches staged two ahead in a thread, noise and rotations
    drawn on the main thread) against the same CLI with the batches
    collated and copied in the step's own thread: every step's loss terms
    and the test loss equal bit for bit."""
    staged, staged_test = _run_cli(tmp_path, monkeypatch, "staged")

    def in_thread(host_batches, to_device, device, depth=2):
        assert threading.current_thread() is threading.main_thread()
        return (to_device(host, device, False) for host in host_batches)

    monkeypatch.setattr(train_diffusion, "prefetch_to_device", in_thread)
    plain, plain_test = _run_cli(tmp_path, monkeypatch, "plain")
    assert len(staged) == len(plain) == 4
    for a, b in zip(staged, plain):
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), key
    assert staged_test == plain_test


def test_log_without_wandb_prints_the_notice_and_trains(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)
    loss = train_diffusion.main([*TINY_ARGS, "--max_steps", "2", "--log", "true",
                                 "--checkpoint_dir", str(tmp_path)])
    assert np.isfinite(loss)
    assert "wandb not available; logging to stdout only" in capsys.readouterr().out


def test_log_with_wandb_logs_what_the_jax_cli_logs(tmp_path, monkeypatch):
    """Where wandb imports: one run (project, experiment name, the flags),
    the train record of every epoch, the valid record of every evaluation
    and the test record, then ``finish``."""
    calls = []

    class Run:
        def log(self, record):
            calls.append(("log", record))

        def finish(self):
            calls.append(("finish", None))

    def init(**kw):
        calls.append(("init", kw))
        return Run()

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    train_diffusion.main([*TINY_ARGS, "--epochs", "2", "--log", "true", "--experiment_name", "x",
                          "--checkpoint_dir", str(tmp_path)])
    kind, kw = calls[0]
    assert kind == "init" and kw["project"] == "arreau-tpu" and kw["name"] == "x"
    assert kw["config"]["log"] is True and calls[-1] == ("finish", None)
    records = [r for k, r in calls if k == "log"]
    assert [sorted(r)[:2] for r in records if "epoch" in r] == [["epoch", "lr"]] * 2
    assert sum(any(k.startswith("valid/") for k in r) for r in records) == 2
    assert any(k.startswith("train/") for k in records[0])
    assert all(k.startswith("test/") for k in records[-1]) and "test/loss" in records[-1]


def test_profiler_torch_writes_a_trace_of_epoch_one(tmp_path, monkeypatch, capsys):
    """``--profiler torch``: a Chrome trace of epoch 1 (the first timed
    epoch, as the JAX CLI's ``jax``) under ``profile_results/`` of the
    working directory, naming the training step's operators; none for one
    epoch; the JAX CLI's value ``jax`` is not this package's profiler."""
    monkeypatch.chdir(tmp_path)
    train_diffusion.main([*TINY_ARGS, "--epochs", "1", "--profiler", "torch",
                          "--checkpoint_dir", str(tmp_path / "one")])
    assert not (tmp_path / "profile_results").exists()
    train_diffusion.main([*TINY_ARGS, "--epochs", "2", "--profiler", "torch",
                          "--checkpoint_dir", str(tmp_path / "two")])
    traces = list((tmp_path / "profile_results").iterdir())
    assert len(traces) == 1 and f"profiler: wrote {traces[0].relative_to(tmp_path)}" in (
        capsys.readouterr().out)
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names
    with pytest.raises(SystemExit):
        train_diffusion.parse_args(["--profiler", "jax"])
