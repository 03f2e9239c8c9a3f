"""The port's sample-quality report repeats the JAX package's flagship
report: the 500 tracked crystals of ``out/r4/q_ang_s100/crystals.h5`` (read
with the JAX package's loader) against ``synthetic:20000:0`` give the 18
values of ``out/r4/q_ang_s100/quality.json`` within 1e-12 each. About 25 s
on a CPU, most of it the reference statistics of 20000 crystals."""

import json
from pathlib import Path

import pytest

from arreau_tpu.inference.io import load_sample_results as j_load_sample_results
from arreau_tpu_torch.cli.generate import quality_from_results, reference_dataset
from arreau_tpu_torch.data.atoms import AtomicNumberTable

ROOT = Path(__file__).resolve().parents[1]
REPORT = ROOT / "out" / "r4" / "q_ang_s100"


def test_flagship_report_repeats_the_jax_report():
    result = j_load_sample_results(str(REPORT / "crystals.h5"))
    meta = json.loads((ROOT / "ported_ckpt" / "ang_on" / "meta.json").read_text())
    got = quality_from_results(result, AtomicNumberTable(meta["z_table_zs"]),
                               reference_dataset("synthetic:20000:0"))
    want = json.loads((REPORT / "quality.json").read_text())
    assert len(want) == 18 and list(got) == list(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=0, abs=1e-12), key
