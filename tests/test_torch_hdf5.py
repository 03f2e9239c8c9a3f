"""The port's HDF5 subset (``arreau_tpu_torch/data/hdf5.py``) against
``h5py`` and the JAX package's readers and writers, on the CPU.

Reader: every git-tracked ``out/**/crystals.h5``, packed shards written by
the JAX package (zero crystals, a one-atom crystal), a 1000-crystal
reference-layout file (a group B-tree two levels deep) and the JAX
sampler's files read bit for bit as ``h5py`` reads them. Writer: its files
read bit for bit in ``h5py`` and in the JAX package's ``read_h5`` /
``load_sample_results``, and survive a round trip. Files outside the
subset raise ``ValueError`` naming the feature."""

import subprocess
from pathlib import Path

import h5py
import numpy as np
import pytest

from arreau_tpu.data.crystal import PackedCrystals as JPacked
from arreau_tpu.data.crystal import read_h5 as j_read_h5
from arreau_tpu.data.crystal import write_packed_h5 as j_write_packed_h5
from arreau_tpu.inference.io import SampleResult as JResult
from arreau_tpu.inference.io import load_sample_results as j_load
from arreau_tpu.inference.io import save_sample_results as j_save
from arreau_tpu_torch.data.crystal import PackedCrystals, read_h5, write_packed_h5
from arreau_tpu_torch.data.hdf5 import LEAF_K, read_datasets, write_datasets
from arreau_tpu_torch.inference.io import FIELDS, SampleResult, load_sample_results
from arreau_tpu_torch.inference.io import save_sample_results

ROOT = Path(__file__).resolve().parents[1]
TRACKED = subprocess.run(["git", "ls-files", "out/**crystals.h5"], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
PACKED_FIELDS = ("atomic_numbers", "frac_coords", "offsets", "lattices")


def h5py_contents(path):
    """Every dataset and attribute of ``path`` as h5py reads them, keyed as
    ``read_datasets`` keys them."""
    datasets, attrs = {}, {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                datasets[name] = obj[()]
            if len(obj.attrs):
                attrs[name] = dict(obj.attrs)
        f.visititems(visit)
        if len(f.attrs):
            attrs[""] = dict(f.attrs)
    return datasets, attrs


def assert_reads_as_h5py(path):
    got, got_attrs = read_datasets(str(path))
    want, want_attrs = h5py_contents(path)
    assert got.keys() == want.keys()
    for name, value in want.items():
        value = np.asarray(value)
        assert got[name].dtype == value.dtype and got[name].shape == value.shape, name
        assert got[name].tobytes() == value.tobytes(), name
    assert got_attrs.keys() == want_attrs.keys()
    for name, attrs in want_attrs.items():
        assert got_attrs[name].keys() == attrs.keys()
        for key, value in attrs.items():
            assert type(got_attrs[name][key]) is type(value)
            np.testing.assert_array_equal(got_attrs[name][key], value)
    return got, got_attrs


def packed(seed, counts):
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    return PackedCrystals(atomic_numbers=rng.integers(1, 90, total),
                          frac_coords=rng.uniform(size=(total, 3)),
                          offsets=np.concatenate([[0], np.cumsum(counts)]),
                          lattices=rng.normal(size=(len(counts), 3, 3)))


def test_every_tracked_crystals_file_reads_as_h5py():
    assert len(TRACKED) >= 23
    for path in TRACKED:
        data, _ = assert_reads_as_h5py(ROOT / path)
        # the grouped layout or (the earliest rounds) flat root datasets
        assert sorted(name.rpartition("/")[2] for name in data) == sorted(FIELDS)
        result = load_sample_results(str(ROOT / path))
        want = j_load(str(ROOT / path))
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(result, name), getattr(want, name))


@pytest.mark.parametrize("counts", [[], [1], [3, 1, 5, 2]], ids=["zero", "one_atom", "four"])
def test_packed_shards_of_the_jax_writer(tmp_path, counts):
    p = packed(1, counts)
    j_write_packed_h5(str(tmp_path / "s.h5"), JPacked(*(getattr(p, f) for f in PACKED_FIELDS)))
    _, attrs = assert_reads_as_h5py(tmp_path / "s.h5")
    assert attrs == {"": {"layout": "packed-v1"}}
    got = read_h5(str(tmp_path / "s.h5"))
    for field in PACKED_FIELDS:
        assert getattr(got, field).tobytes() == getattr(p, field).tobytes(), field


def test_reference_layout_of_1000_crystals(tmp_path):
    """The reference's dataset-per-crystal layout, written with h5py: 1000
    members a group make its B-tree two levels deep."""
    rng = np.random.default_rng(2)
    counts = rng.integers(1, 6, 1000)
    path = tmp_path / "ref.h5"
    with h5py.File(path, "w") as f:
        for i, n in enumerate(counts):
            f.create_dataset(f"atomic_number/{i}", data=rng.integers(1, 90, n))
            f.create_dataset(f"frac_coord/{i}", data=rng.uniform(size=(n, 3)))
        f.create_dataset("lattice_matrix", data=rng.normal(size=(1000, 3, 3)))
    with open(path, "rb") as fh:  # the root B-tree of atomic_number has level 1
        data = fh.read()
    assert any(data[i + 5] > 0 for i in range(len(data)) if data.startswith(b"TREE", i))
    assert_reads_as_h5py(path)
    got, want = read_h5(str(path)), j_read_h5(str(path))
    for field in PACKED_FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got.num_atoms, counts)


def test_jax_sample_results_read_bit_for_bit(tmp_path):
    rng = np.random.default_rng(3)
    fields = dict(frac_x=rng.uniform(size=(9, 3)), atomic_numbers=rng.integers(1, 9, 9),
                  lattice=rng.normal(size=(3, 3, 3)), idx_start=np.array([0, 2, 7]),
                  num_atoms=np.array([2, 5, 2]))
    j_save(str(tmp_path / "crystals.h5"), JResult(**fields))
    assert_reads_as_h5py(tmp_path / "crystals.h5")
    got = load_sample_results(str(tmp_path / "crystals.h5"))
    for name, value in fields.items():
        assert getattr(got, name).tobytes() == value.tobytes(), name


def test_npz_of_earlier_versions_still_reads(tmp_path):
    """Earlier versions of the port wrote ``crystals.npz``: read by its suffix."""
    fields = dict(frac_x=np.zeros((2, 3)), atomic_numbers=np.array([1, 8]),
                  lattice=np.eye(3)[None], idx_start=np.array([0]), num_atoms=np.array([2]))
    np.savez(tmp_path / "crystals.npz", **fields)
    got = load_sample_results(str(tmp_path / "crystals.npz"))
    for name, value in fields.items():
        np.testing.assert_array_equal(getattr(got, name), value)


def test_flat_root_sample_results(tmp_path):
    """Flat root datasets (no ``crystals`` group) read in both packages."""
    rng = np.random.default_rng(4)
    fields = dict(frac_x=rng.uniform(size=(3, 3)), atomic_numbers=np.array([1, 6, 8]),
                  lattice=rng.normal(size=(1, 3, 3)), idx_start=np.array([0]),
                  num_atoms=np.array([3]))
    write_datasets(str(tmp_path / "flat.h5"), fields)
    got, want = load_sample_results(str(tmp_path / "flat.h5")), j_load(str(tmp_path / "flat.h5"))
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("counts", [[], [1], [3, 1, 5, 2]], ids=["zero", "one_atom", "four"])
def test_port_writer_reads_in_h5py_and_jax(tmp_path, counts):
    p = packed(5, counts)
    write_packed_h5(str(tmp_path / "s.h5"), p)
    with h5py.File(tmp_path / "s.h5", "r") as f:
        assert f.attrs["layout"] == "packed-v1"
        assert sorted(f) == ["atomic_numbers", "frac_coords", "lattice_matrix", "offsets"]
    want = j_read_h5(str(tmp_path / "s.h5"))
    for field in PACKED_FIELDS:
        assert getattr(want, field).dtype == getattr(p, field).dtype
        assert getattr(want, field).tobytes() == getattr(p, field).tobytes(), field
    got = read_h5(str(tmp_path / "s.h5"))
    for field in PACKED_FIELDS:
        assert getattr(got, field).tobytes() == getattr(p, field).tobytes(), field


def test_port_sample_results_read_in_jax(tmp_path):
    rng = np.random.default_rng(6)
    result = SampleResult(frac_x=rng.uniform(size=(6, 3)), atomic_numbers=rng.integers(1, 9, 6),
                          lattice=rng.normal(size=(2, 3, 3)), idx_start=np.array([0, 4]),
                          num_atoms=np.array([4, 2]))
    save_sample_results(str(tmp_path / "crystals.h5"), result)
    with h5py.File(tmp_path / "crystals.h5", "r") as f:
        assert sorted(f) == ["crystals"] and sorted(f["crystals"]) == sorted(FIELDS)
    want = j_load(str(tmp_path / "crystals.h5"))
    for name in FIELDS:
        assert getattr(want, name).dtype == getattr(result, name).dtype
        assert getattr(want, name).tobytes() == getattr(result, name).tobytes(), name


def test_numeric_and_string_attributes_of_h5py(tmp_path):
    """Scalar and array attributes of every supported type and strings, on
    the root, a group and a dataset, and a compact dataset, as h5py wrote
    them."""
    with h5py.File(tmp_path / "a.h5", "w") as f:
        f.attrs.update(n=np.int64(3), u=np.uint16(7), x=np.arange(3.0), s="hé")
        f.create_group("g").attrs["f"] = np.float32(1.5)
        f.create_dataset("d", data=np.arange(4)).attrs["layout"] = "packed-v1"
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        dset = h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I64LE, h5py.h5s.create_simple((4,)),
                               dcpl)
        dset.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(4, dtype=np.int64))
    got, attrs = assert_reads_as_h5py(tmp_path / "a.h5")
    assert sorted(got) == ["compact", "d"] and attrs["g"] == {"f": np.float32(1.5)}


def test_writer_round_trip(tmp_path):
    """int64 and float64 datasets, scalars, empty arrays, nested groups, a
    group of 2 * LEAF_K members (one full symbol node) and the root's string
    attributes: h5py and the port's reader read back what was written."""
    rng = np.random.default_rng(7)
    tree = {"i8": rng.integers(-100, 100, (2, 3)), "f8": rng.normal(size=(2, 2, 2)),
            "scalar": np.float64(2.5), "a/b/empty": np.zeros((0, 3)), "a/c": np.arange(4)}
    tree |= {f"full/{i}": np.arange(i % 4) for i in range(2 * LEAF_K)}
    attrs = {"layout": "packed-v1", "note": "hé", "empty": ""}
    write_datasets(str(tmp_path / "w.h5"), tree, attrs)
    got, got_attrs = assert_reads_as_h5py(tmp_path / "w.h5")
    assert got.keys() == tree.keys()
    for name, value in tree.items():
        assert got[name].dtype == np.asarray(value).dtype and got[name].tobytes() == value.tobytes()
    assert got_attrs == {"": attrs}


@pytest.mark.parametrize("tree, attrs, message", [
    ({f"g/{i}": np.arange(2) for i in range(2 * LEAF_K + 1)}, None, "members"),
    ({"a": np.arange(3, dtype=np.int32)}, None, "int64 and float64 only"),
    ({"a": np.ones(3, np.float32)}, None, "int64 and float64 only"),
    ({"a": np.arange(3)}, {"n": 3}, "only string attributes"),
], ids=["nine_members", "int32", "float32", "numeric_attribute"])
def test_writer_refuses_what_no_caller_writes(tmp_path, tree, attrs, message):
    with pytest.raises(ValueError, match=message):
        write_datasets(str(tmp_path / "w.h5"), tree, attrs)


def _chunked_gzip(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("a", data=np.arange(300.0), chunks=True, compression="gzip")


def _latest(path):
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("a", data=np.arange(3))


def _big_endian(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("a", data=np.arange(3.0).astype(">f8"))


@pytest.mark.parametrize("make, feature", [
    (_chunked_gzip, "filters"),
    (_latest, "superblock version 3"),
    (_big_endian, "big-endian"),
], ids=["chunked_gzip", "libver_latest", "big_endian"])
def test_files_outside_the_subset_raise(tmp_path, make, feature):
    make(tmp_path / "x.h5")
    with pytest.raises(ValueError, match=feature):
        read_datasets(str(tmp_path / "x.h5"))


def test_a_large_shard_reads_in_one_pass(tmp_path):
    """A packed shard of 100000 crystals (about 1.1 million atoms): the
    four datasets read whole, bit for bit."""
    p = packed(8, np.random.default_rng(8).integers(1, 20, 100_000))
    write_packed_h5(str(tmp_path / "big.h5"), p)
    got = read_h5(str(tmp_path / "big.h5"))
    for field in PACKED_FIELDS:
        assert getattr(got, field).tobytes() == getattr(p, field).tobytes(), field
