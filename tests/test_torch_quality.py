"""The port's sample-quality metrics and bond prediction
(``inference/quality.py``, ``inference/bonds.py``) against the JAX
package's on seeded small inputs, and the generate CLI's quality report and
reference-histogram atom counts (``--quality_ref``, ``--num_atoms_dist``)
against the JAX CLI's, on the CPU. Both modules are host-side numpy with
the same arithmetic in the same order: the values agree to 1e-12."""

import json
import sys

import numpy as np
import pytest

from arreau_tpu.cli.generate import _ref_num_atoms as j_ref_num_atoms
from arreau_tpu.cli.generate import quality_from_results as j_quality_from_results
from arreau_tpu.data.crystal import write_packed_h5 as j_write_packed_h5
from arreau_tpu.data.synthetic import synthetic_packed as j_synthetic_packed
from arreau_tpu.inference import bonds as j_bonds
from arreau_tpu.inference import quality as jq
from arreau_tpu.inference.io import SampleResult as JResult
from arreau_tpu.inference.io import load_sample_results as j_load_sample_results
from arreau_tpu_torch.cli import generate
from arreau_tpu_torch.data.synthetic import random_lattices
from arreau_tpu_torch.inference import bonds, quality
from arreau_tpu_torch.inference.io import load_sample_results
from tests.test_torch_model import Z_TABLE
from tests.test_torch_sampler import jax_model_and_params, write_checkpoint

TOL = dict(rtol=1e-12, atol=1e-12)


def crystals(seed=0, n=12, max_atoms=7):
    """A flattened collection: n crystals of 1..max_atoms atoms (one of one
    atom), random lattices, z-table type indices, plus one crystal squeezed
    to a flat cell (its Voronoi tessellation fails)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(2, max_atoms + 1, size=n)
    counts[3] = 1
    lattices = random_lattices(rng, n)
    lattices[5, 2] = lattices[5, 0] + lattices[5, 1]  # a singular cell
    idx_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    frac = rng.uniform(-0.2, 1.2, size=(int(counts.sum()), 3))
    types = rng.integers(0, len(Z_TABLE) - 1, size=len(frac))
    return dict(frac=frac, types=types, lattices=lattices, idx_start=idx_start, num_atoms=counts)


def _same(got, want):
    """Equal structures, floats within 1e-12."""
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (float, np.floating, np.ndarray)):
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert got == want


def _twins():
    c = crystals()
    s, n = int(c["idx_start"][0]), int(c["num_atoms"][0])
    one = (c["frac"][s : s + n], c["lattices"][0])
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=300), rng.normal(1, 2, size=200)
    return {
        "wasserstein1": lambda m: m.wasserstein1(a, b),
        "lattice_params_np": lambda m: m.lattice_params_np(c["lattices"]),
        "min_pairwise_distance": lambda m: m.min_pairwise_distance(*one),
        "min_distance_violation_rate": lambda m: m.min_distance_violation_rate(
            c["frac"], c["lattices"], c["idx_start"], c["num_atoms"], threshold=1.2),
        "pairwise_min_image_dists": lambda m: m._pairwise_min_image_dists(*one),
        "structure_fingerprint": lambda m: m.structure_fingerprint(
            one[0], c["types"][s : s + n], one[1]),
        "fingerprint_set": lambda m: m.fingerprint_set(
            c["frac"], c["types"], c["lattices"], c["idx_start"], c["num_atoms"], max_crystals=7),
        "type_geometry_mutual_info": lambda m: m.type_geometry_mutual_info(
            c["types"], c["frac"][:, 2], len(Z_TABLE)),
        "coordination_histogram": lambda m: m.coordination_histogram(
            c["frac"], c["lattices"], c["idx_start"], c["num_atoms"], max_coord=8),
    }


@pytest.mark.parametrize("name", list(_twins()))
def test_quality_function_matches_jax(name):
    """Each metric of ``inference/quality.py`` on the same seeded crystals
    (wrapped coordinates, a one-atom crystal, a singular cell) as its JAX
    twin: every value within 1e-12, fingerprints equal."""
    fn = _twins()[name]
    _same(fn(quality), fn(jq))


def _reports(seed):
    gen, ref = crystals(seed), crystals(seed + 100, n=20, max_atoms=9)
    out = []
    packed = j_synthetic_packed(30, seed=seed, max_atoms=8)  # the reference training set
    for m in (quality, jq):
        stats = m.dataset_reference_stats(packed.packed, packed.type_indices, len(Z_TABLE),
                                          violation_sample=11)
        ref_lengths, ref_angles = m.lattice_params_np(ref["lattices"])
        report = m.quality_report(
            gen["frac"], gen["types"], gen["lattices"], gen["idx_start"], gen["num_atoms"],
            ref_lengths, ref_angles, len(Z_TABLE), ref_type_mi=stats["type_mi"],
            ref_coord_hist=stats["coord_hist"], ref_mean_num_atoms=stats["mean_num_atoms"],
            ref_fingerprints=stats["fingerprints"])
        out.append((stats, report))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_quality_report_and_reference_stats_match_jax(seed):
    """``dataset_reference_stats`` on a small synthetic set and
    ``quality_report`` with every optional reference: the same keys, every
    value within 1e-12."""
    (stats, report), (j_stats, j_report) = _reports(seed)
    _same(stats, j_stats)
    _same(report, j_report)
    assert len(report) == 17


@pytest.mark.parametrize("distance_screen", [False, True])
def test_voronoi_bonds_match_jax(distance_screen):
    """``predict_bonds_voronoi`` on every crystal of the seeded collection
    of at least two atoms, with and without the covalent-radius screen: the
    same bond lists (the singular cell raises in both)."""
    c = crystals(3)
    zs = np.asarray(Z_TABLE.zs)[c["types"]]
    for i in range(len(c["num_atoms"])):
        s, n = int(c["idx_start"][i]), int(c["num_atoms"][i])
        args = (c["frac"][s : s + n], c["lattices"][i], zs[s : s + n] if distance_screen else None)
        try:
            want = j_bonds.predict_bonds_voronoi(*args)
        except Exception as e:  # noqa: BLE001 - the singular cell
            with pytest.raises(type(e)):
                bonds.predict_bonds_voronoi(*args)
            continue
        assert bonds.predict_bonds_voronoi(*args) == want
    assert bonds._COVALENT_RADII == __import__(
        "arreau_tpu.inference.visualize", fromlist=["_COVALENT_RADII"])._COVALENT_RADII


def test_solid_angle_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(5):
        centre, verts = rng.normal(size=3), rng.normal(size=(6, 3))
        assert bonds._solid_angle(centre, verts) == pytest.approx(
            j_bonds._solid_angle(centre, verts), rel=1e-12, abs=1e-12)


def test_coordination_without_scipy_raises(monkeypatch):
    """A missing scipy raises; it is never read as zero coordination."""
    monkeypatch.setitem(sys.modules, "scipy.spatial", None)
    c = crystals()
    with pytest.raises(ImportError):
        quality.coordination_histogram(c["frac"], c["lattices"], c["idx_start"], c["num_atoms"])


# ---------------- the generate CLI ----------------


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    jmodel, params = jax_model_and_params()
    path = tmp_path_factory.mktemp("quality") / "ckpt"
    write_checkpoint(path, jmodel, params, fourier_w=np.asarray(jmodel.fourier_w).tolist())
    return path


def run_generate(ckpt, out, *flags):
    return generate.main(["--checkpoint_dir", str(ckpt), "--device", "cpu", "--num_crystals", "5",
                          "--batch_size", "3", "--num_atoms_per_sample", "5", "--sample_steps", "2",
                          "--seed", "4", "--out_dir", str(out), *flags])


def test_generate_quality_report_matches_jax(tiny_checkpoint, tmp_path, capsys):
    """``--quality_ref synthetic:40:0`` writes ``quality.json``, the 18
    keys of the JAX CLI's report on the same crystals, every value within
    1e-12, and prints them as the JAX CLI does."""
    run_generate(tiny_checkpoint, tmp_path, "--quality_ref", "synthetic:40:0")
    printed = capsys.readouterr().out
    got = json.loads((tmp_path / "quality.json").read_text())
    r = load_sample_results(str(tmp_path / "crystals.h5"))
    want = j_quality_from_results(JResult(r.frac_x, r.atomic_numbers, r.lattice, r.idx_start,
                                          r.num_atoms), Z_TABLE, "synthetic:40:0")
    assert len(got) == 18 and got.keys() == want.keys()
    _same({k: float(v) for k, v in got.items()}, {k: float(v) for k, v in want.items()})
    assert "sample quality vs training data:" in printed
    assert f"  w1_lengths: {want['w1_lengths']:.4f}" in printed


def test_generate_ref_atom_counts_match_jax(tiny_checkpoint, tmp_path):
    """``--num_atoms_dist ref``: each batch's counts drawn from the reference
    histogram capped at the pad size, by the JAX CLI's generator (seed + 1,
    one draw of batch_size a batch), and the crystals hold those counts."""
    result = run_generate(tiny_checkpoint, tmp_path, "--quality_ref", "synthetic:40:0",
                          "--num_atoms_dist", "ref")
    ref = np.minimum(j_ref_num_atoms("synthetic:40:0"), 5)
    rng = np.random.default_rng(4 + 1)
    want = np.concatenate([rng.choice(ref, size=3) for _ in range(2)])[:5]
    np.testing.assert_array_equal(result.num_atoms, want)
    assert len(set(want.tolist())) > 1
    saved = load_sample_results(str(tmp_path / "crystals.h5"))
    np.testing.assert_array_equal(saved.num_atoms, want)
    assert len(saved.frac_x) == want.sum()


def test_generate_hdf5_quality_ref_matches_jax(tiny_checkpoint, tmp_path):
    """``--quality_ref <shard>.h5 --num_atoms_dist ref`` on a packed shard
    the JAX package wrote: the atom counts drawn from the shard's histogram
    and the report (the shard's own z-table) are the JAX CLI's, and the
    ``crystals.h5`` written reads the same in the JAX package."""
    shard = tmp_path / "train.h5"
    j_write_packed_h5(str(shard), j_synthetic_packed(40, seed=3).packed)
    result = run_generate(tiny_checkpoint, tmp_path / "out", "--quality_ref", str(shard),
                          "--num_atoms_dist", "ref")
    ref = np.minimum(j_ref_num_atoms(str(shard)), 5)
    rng = np.random.default_rng(4 + 1)
    np.testing.assert_array_equal(result.num_atoms,
                                  np.concatenate([rng.choice(ref, size=3) for _ in range(2)])[:5])
    r = j_load_sample_results(str(tmp_path / "out" / "crystals.h5"))
    for name in ("frac_x", "atomic_numbers", "lattice", "idx_start", "num_atoms"):
        assert getattr(r, name).tobytes() == getattr(result, name).tobytes(), name
    got = json.loads((tmp_path / "out" / "quality.json").read_text())
    want = j_quality_from_results(r, Z_TABLE, str(shard))
    assert len(got) == 18 and got.keys() == want.keys()
    _same({k: float(v) for k, v in got.items()}, {k: float(v) for k, v in want.items()})


def test_generate_ref_counts_without_reference_exit():
    with pytest.raises(SystemExit, match="requires --quality_ref"):
        generate.main(["--device", "cpu", "--num_atoms_dist", "ref"])


def test_reports_against_one_reference_match_jax():
    """Two results reported against one ``reference_dataset`` (its
    statistics computed once and kept by ``reference_stats``) each give the
    JAX CLI's report: the kept statistics are not changed by a report."""
    from arreau_tpu_torch.data.atoms import synthetic_z_table

    ds, z_table = generate.reference_dataset("synthetic:40:0"), synthetic_z_table()
    hits = generate.reference_stats.cache_info().hits
    for seed in (1, 2):
        p = j_synthetic_packed(6, seed=seed).packed
        r = JResult(p.frac_coords, p.atomic_numbers, p.lattices, p.offsets[:-1],
                    np.diff(p.offsets))
        got = generate.quality_from_results(r, z_table, ds)
        want = j_quality_from_results(r, z_table, "synthetic:40:0")
        assert got.keys() == want.keys()
        _same({k: float(v) for k, v in got.items()}, {k: float(v) for k, v in want.items()})
    assert generate.reference_stats.cache_info().hits == hits + 1
