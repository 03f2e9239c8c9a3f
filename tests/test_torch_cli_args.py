"""Every command line of the port with a JAX twin parses as the twin's:
the same arguments (``--device`` of the port apart) with the same defaults,
types, choices and arities, and each boolean flag gives the same value, or
the same error, on the same text. The exploration tools are held in
``tests/test_torch_exploration.py``."""

import argparse
import importlib
import runpy

import pytest

CLIS = ["cli.generate", "cli.train_diffusion", "cli.train_nbody", "cli.train_mnist",
        "cli.train_qm9", "cli.train_md17", "cli.process_results", "cli.export_sampler",
        "cli.import_checkpoint", "data.prep"]
BOOL_TEXTS = ["true", "True", "1", "yes", "y", "n", " True", "maybe"]
# the port's profiler is torch.profiler where the JAX package's is jax.profiler
CHOICES = {("cli.train_diffusion", "profiler"): ([None, "jax"], [None, "torch"])}


class _Parsed(Exception):
    pass


def _parser(run) -> argparse.ArgumentParser:
    """The parser ``run()`` builds, caught at its ``parse_args``."""
    parsers = []

    def grab(self, args=None, namespace=None):
        parsers.append(self)
        raise _Parsed

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        run()
    except _Parsed:
        pass
    finally:
        argparse.ArgumentParser.parse_args = original
    return parsers[0]


def _parsers(cli: str):
    port = importlib.import_module(f"arreau_tpu_torch.{cli}")
    if cli == "data.prep":
        # the JAX package parses prep's flags under its __main__ guard
        jax_run = lambda: runpy.run_module("arreau_tpu.data.prep", run_name="__main__")  # noqa: E731
    else:
        jax_run = importlib.import_module(f"arreau_tpu.{cli}").main
    return _parser(lambda: port.main([])), _parser(jax_run)


def _actions(parser) -> dict:
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def _outcome(parse, text):
    try:
        return parse(text)
    except argparse.ArgumentTypeError as e:
        return type(e)


@pytest.mark.parametrize("cli", CLIS)
def test_arguments_and_boolean_flags_match_jax(cli):
    port, jax_parser = (_actions(p) for p in _parsers(cli))
    device = port.pop("device", None)
    if cli not in ("cli.import_checkpoint", "data.prep"):
        assert device is not None and device.default == "cuda"
    assert sorted(port) == sorted(jax_parser)
    for dest, want in jax_parser.items():
        got = port[dest]
        assert got.option_strings == want.option_strings, dest
        assert got.default == want.default, dest
        assert getattr(got.type, "__name__", got.type) == getattr(want.type, "__name__", want.type), dest
        assert (got.nargs, got.required) == (want.nargs, want.required), dest
        want_choices, got_choices = CHOICES.get((cli, dest), (want.choices, want.choices))
        assert (want.choices, got.choices) == (want_choices, got_choices), dest
        if getattr(want.type, "__name__", "") in ("parse_bool", "parse_opt_bool"):
            for text in BOOL_TEXTS:
                assert _outcome(got.type, text) == _outcome(want.type, text), (dest, text)
