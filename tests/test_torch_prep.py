"""The port's dataset prep (``arreau_tpu_torch/data/prep.py``) against the
JAX package's on Alexandria-schema ``json.bz2`` files made here: the same
parsed arrays, the same shard files (read back by ``h5py``, the JAX
package's ``read_h5`` and the port's), and the take-10 shard."""

import bz2
import json

import h5py
import numpy as np
import pytest

from arreau_tpu.data import prep as j_prep
from arreau_tpu.data.atoms import z_to_symbol as j_z_to_symbol
from arreau_tpu.data.crystal import read_h5 as j_read_h5
from arreau_tpu_torch.data import prep
from arreau_tpu_torch.data.atoms import MASK_ATOMIC_NUMBER, z_to_symbol
from arreau_tpu_torch.data.crystal import read_h5

FIELDS = ("atomic_numbers", "frac_coords", "offsets", "lattices")


def alexandria_document(n: int, seed: int) -> dict:
    """``n`` pymatgen ``ComputedStructureEntry`` dicts, the fields prep
    reads (and a few it does not), one crystal of one atom."""
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        count = 1 if i == 2 else int(rng.integers(2, 9))
        sites = [{"species": [{"element": z_to_symbol(int(z)), "occu": 1}],
                  "abc": rng.uniform(size=3).tolist(), "label": "x"}
                 for z in rng.integers(1, 95, count)]
        entries.append({"@class": "ComputedStructureEntry", "energy": float(rng.normal()),
                        "structure": {"lattice": {"matrix": rng.normal(size=(3, 3)).tolist()},
                                      "sites": sites}})
    return {"entries": entries}


def write_bz2(path, document):
    with bz2.open(path, "wt", encoding="utf-8") as fh:
        json.dump(document, fh)


def assert_same_packed(got, want):
    for field in FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


def test_z_to_symbol_matches_jax():
    for z in [*range(1, 119), MASK_ATOMIC_NUMBER]:
        assert z_to_symbol(z) == j_z_to_symbol(z)


@pytest.mark.parametrize("take", [None, 0, 3])
def test_parse_entries_matches_jax(take):
    document = alexandria_document(7, seed=take or 0)
    assert_same_packed(prep.parse_entries(document, take), j_prep.parse_entries(document, take))


def test_prep_shard_writes_what_jax_writes(tmp_path):
    write_bz2(tmp_path / "in.json.bz2", alexandria_document(12, seed=1))
    prep.prep_shard(str(tmp_path / "in.json.bz2"), str(tmp_path / "port.h5"))
    j_prep.prep_shard(str(tmp_path / "in.json.bz2"), str(tmp_path / "jax.h5"))
    assert_same_packed(read_h5(str(tmp_path / "port.h5")), j_read_h5(str(tmp_path / "jax.h5")))
    assert_same_packed(j_read_h5(str(tmp_path / "port.h5")), j_read_h5(str(tmp_path / "jax.h5")))
    with h5py.File(tmp_path / "port.h5", "r") as f:
        assert f.attrs["layout"] == "packed-v1"


def test_prep_all_makes_the_jax_files(tmp_path, capsys):
    """Two input shards (and a gap in the numbering): the same files in both
    packages, the take-10 shard the first ten crystals of shard 000."""
    src = tmp_path / "in"
    src.mkdir()
    write_bz2(src / "alexandria_ps_000.json.bz2", alexandria_document(14, seed=2))
    write_bz2(src / "alexandria_ps_002.json.bz2", alexandria_document(5, seed=3))
    prep.main(["--in_dir", str(src), "--out_dir", str(tmp_path / "port"), "--num_shards", "3"])
    j_prep.prep_all(str(src), str(tmp_path / "jax"), num_shards=3)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["alexandria_ps_000.h5", "alexandria_ps_000_take10.h5", "alexandria_ps_002.h5"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        assert_same_packed(read_h5(str(tmp_path / "port" / name)),
                           j_read_h5(str(tmp_path / "jax" / name)))
    take10 = read_h5(str(tmp_path / "port" / "alexandria_ps_000_take10.h5"))
    full = read_h5(str(tmp_path / "port" / "alexandria_ps_000.h5"))
    assert len(take10) == 10
    assert_same_packed(take10, prep.parse_entries(alexandria_document(14, seed=2), 10))
    np.testing.assert_array_equal(take10.lattices, full.lattices[:10])
    assert "alexandria_ps_000_take10.h5: 10 crystals" in capsys.readouterr().out
