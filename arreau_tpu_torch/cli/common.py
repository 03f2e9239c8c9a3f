"""argparse value parsers shared by the task CLIs; a copy of
``arreau_tpu/cli/common.py``: ``True``/``False``/``None``/floats accepted,
anything else an argparse error (where ``type=eval`` would take any
expression)."""

from __future__ import annotations

import argparse


def parse_bool(value: str) -> bool:
    """True/False (case-insensitive; also 1/0, yes/no)."""
    s = str(value).strip().lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {value!r}")


def parse_opt_bool(value: str):
    """None | True | False (tri-state knobs like --scan_epoch)."""
    s = str(value).strip().lower()
    if s in ("none", ""):
        return None
    return parse_bool(value)


def parse_opt_float(value: str):
    """None | float (knobs like --radius where None means fully connected)."""
    s = str(value).strip().lower()
    if s in ("none", ""):
        return None
    try:
        return float(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected a float or None, got {value!r}")
