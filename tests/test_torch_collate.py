"""The port's C++ dense-batch collator (``arreau_tpu_torch/native``) against
its plain numpy version (``data.crystal.collate_dense``) and the JAX
package's collator (``arreau_tpu.native.collate_dense``: its C++ loop in
float32, its numpy one in float64), bit for bit."""

import numpy as np
import pytest

from arreau_tpu.native import collate_dense as j_collate
from arreau_tpu_torch import native
from arreau_tpu_torch.data import crystal
from arreau_tpu_torch.data.synthetic import synthetic_packed

DS = synthetic_packed(60, seed=4)


def _columns(ds=DS):
    p = ds.packed
    return ds.type_indices, p.frac_coords, p.offsets, p.lattices


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("idx", [[0, 5, -1, 17, 33, -1], [-1, -1], [59]], ids=["mixed", "padding",
                                                                           "one"])
def test_collator_equals_numpy_and_jax(dtype, idx):
    """Crystals and -1 sentinels (empty examples, identity lattices) into a
    bucket of 32 atoms: every array equal, dtypes included."""
    cols = _columns()
    idx = np.asarray(idx, np.int64)
    got = native.collate_dense(*cols, idx, 32, dtype)
    plain = crystal.collate_dense(*cols, idx, 32, dtype)
    jax_side = j_collate(*cols, idx, 32, dtype)
    for g, p, j in zip(got, plain, jax_side):
        assert g.dtype == p.dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, np.asarray(j))
    pad = idx < 0
    assert (got[3][pad] == 0).all() and not got[4][pad].any()
    np.testing.assert_array_equal(got[2][pad], np.broadcast_to(np.eye(3, dtype=dtype),
                                                               (int(pad.sum()), 3, 3)))


def test_crystal_larger_than_its_bucket_raises():
    """A crystal of more atoms than the bucket raises, in both collators."""
    cols = _columns()
    n = int(np.diff(DS.packed.offsets)[7])
    for collate in (native.collate_dense, crystal.collate_dense):
        with pytest.raises(ValueError, match=f"crystal 7 has {n} atoms, more than the bucket's 1"):
            collate(*cols, np.array([-1, 7]), 1)
    with pytest.raises(ValueError, match="float32 or float64"):
        native.collate_dense(*cols, np.array([0]), 32, np.float16)


def test_pack_dense_batch_goes_through_the_native_collator(monkeypatch):
    """The loader's collation is the C++ one."""
    calls = []
    real = native.collate_dense

    def counting(*args):
        calls.append(np.asarray(args[4]).tolist())
        return real(*args)

    monkeypatch.setattr(native, "collate_dense", counting)
    batch = crystal.pack_dense_batch(DS, [3, -1], 32)
    assert calls == [[3, -1]] and batch.frac_x.shape == (2, 32, 3)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a source g++ refuses raises at the build."""
    bad = tmp_path / "collate.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "libcollate.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library()
