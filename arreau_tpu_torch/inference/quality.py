"""Generated-crystal quality metrics; counterpart of
``arreau_tpu/inference/quality.py`` (a copy: the same arithmetic in the
same order, so a report repeats the JAX package's).

  * **Wasserstein-1 distance** between generated and training distributions of
    lattice lengths and cell angles (1D, via quantile integration);
  * **min-interatomic-distance violation rate**: fraction of generated
    crystals whose closest atom pair (under PBC, 27 images) is below a
    physical threshold (default 0.5 angstrom: overlapping atoms);
  * **type-geometry mutual information**: how much the generated atom types
    know about the fractional z coordinate (the synthetic dataset's types are
    a function of it, ``data/synthetic.py``);
  * **in-range fraction** of generated lattice lengths within the training
    min/max envelope;
  * the Voronoi coordination histogram (``inference/bonds.py``, scipy) and
    coarse-fingerprint uniqueness and novelty.

All host-side numpy, on flattened ``SampleResult`` arrays.
"""

from __future__ import annotations

import itertools

import numpy as np

PBC_OFFSETS = np.array(list(itertools.product((-1, 0, 1), repeat=3)), dtype=np.float64)


def wasserstein1(a: np.ndarray, b: np.ndarray, num_quantiles: int = 512) -> float:
    """1D W1 distance via quantile-function integration."""
    q = np.linspace(0.0, 1.0, num_quantiles)
    qa = np.quantile(np.asarray(a, np.float64).ravel(), q)
    qb = np.quantile(np.asarray(b, np.float64).ravel(), q)
    return float(np.mean(np.abs(qa - qb)))


def lattice_params_np(lattices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Row-basis lattices [N, 3, 3] -> (lengths [N, 3], angles_deg [N, 3]).

    Same math as ops/lattice.matrix_to_params (pymatgen convention), numpy
    host-side."""
    lat = np.asarray(lattices, np.float64)
    lengths = np.linalg.norm(lat, axis=-1)
    angles = np.zeros_like(lengths)
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        cos = np.sum(lat[:, j] * lat[:, k], axis=-1) / np.maximum(
            lengths[:, j] * lengths[:, k], 1e-12
        )
        angles[:, i] = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    return lengths, angles


def min_pairwise_distance(frac: np.ndarray, lattice: np.ndarray) -> float:
    """Min interatomic distance of one crystal under PBC (27 images).

    frac: [n, 3] fractional coords; lattice: [3, 3] row basis. Returns +inf
    for crystals with < 2 atoms."""
    n = len(frac)
    if n < 2:
        return float("inf")
    cart = (np.asarray(frac, np.float64) % 1.0) @ np.asarray(lattice, np.float64)
    best = np.inf
    for off in PBC_OFFSETS:
        shift = off @ lattice
        d = cart[:, None, :] - (cart[None, :, :] + shift)
        sqr = (d**2).sum(-1)
        if (off == 0).all():
            np.fill_diagonal(sqr, np.inf)
        best = min(best, float(sqr.min()))
    return float(np.sqrt(best))


def min_distance_violation_rate(
    frac_x: np.ndarray,
    lattices: np.ndarray,
    idx_start: np.ndarray,
    num_atoms: np.ndarray,
    threshold: float = 0.5,
) -> float:
    """Fraction of crystals whose min interatomic PBC distance < threshold."""
    violations = 0
    n_crystals = len(num_atoms)
    for i in range(n_crystals):
        s, n = int(idx_start[i]), int(num_atoms[i])
        if min_pairwise_distance(frac_x[s : s + n], lattices[i]) < threshold:
            violations += 1
    return violations / max(n_crystals, 1)


def _pairwise_min_image_dists(frac: np.ndarray, lattice: np.ndarray) -> np.ndarray:
    """All unique-pair min-image distances of one crystal (sorted, [n*(n-1)/2])."""
    n = len(frac)
    if n < 2:
        return np.zeros((0,), np.float64)
    cart = (np.asarray(frac, np.float64) % 1.0) @ np.asarray(lattice, np.float64)
    best = np.full((n, n), np.inf)
    for off in PBC_OFFSETS:
        shift = off @ lattice
        d = cart[:, None, :] - (cart[None, :, :] + shift)
        sqr = (d**2).sum(-1)
        if (off == 0).all():
            np.fill_diagonal(sqr, np.inf)
        best = np.minimum(best, sqr)
    iu = np.triu_indices(n, 1)
    return np.sort(np.sqrt(best[iu]))


def structure_fingerprint(
    frac: np.ndarray,
    types: np.ndarray,
    lattice: np.ndarray,
    length_quant: float = 0.25,
    angle_quant: float = 5.0,
    dist_quant: float = 0.25,
) -> tuple:
    """Coarse invariant fingerprint of one crystal for duplicate detection.

    Composition (sorted type counts) + quantized sorted lattice params +
    quantized sorted pairwise min-image distance multiset: invariant to
    rotation, translation, and atom permutation. NOT a full structure match
    (no Niggli reduction / supercell equivalence — pymatgen's
    StructureMatcher territory); a coarse proxy for uniqueness/novelty
    counting, biased toward over-merging at these quantizations."""
    lengths, angles = lattice_params_np(np.asarray(lattice)[None])
    counts = np.bincount(np.asarray(types).ravel())
    comp = tuple(sorted((int(t), int(c)) for t, c in enumerate(counts) if c > 0))
    ql = tuple(sorted(np.round(lengths[0] / length_quant).astype(int).tolist()))
    qa = tuple(sorted(np.round(angles[0] / angle_quant).astype(int).tolist()))
    qd = tuple(
        np.round(_pairwise_min_image_dists(frac, lattice) / dist_quant)
        .astype(int)
        .tolist()
    )
    return (comp, ql, qa, qd)


def fingerprint_set(
    frac_x: np.ndarray,
    types: np.ndarray,
    lattices: np.ndarray,
    idx_start: np.ndarray,
    num_atoms: np.ndarray,
    max_crystals: int | None = None,
) -> list:
    """Fingerprints for a flattened crystal collection (optionally subsampled
    evenly — the distance multiset is O(n^2 * 27) per crystal)."""
    n = len(num_atoms)
    idx = range(n)
    if max_crystals is not None and n > max_crystals:
        idx = np.linspace(0, n - 1, max_crystals).astype(int)
    out = []
    for i in idx:
        s, k = int(idx_start[i]), int(num_atoms[i])
        out.append(structure_fingerprint(frac_x[s : s + k], types[s : s + k], lattices[i]))
    return out


def type_geometry_mutual_info(
    types: np.ndarray, frac_z: np.ndarray, num_types: int, num_bins: int = 8
) -> float:
    """Binned mutual information I(type; frac_z) in nats."""
    types = np.asarray(types).ravel()
    z = np.asarray(frac_z).ravel() % 1.0
    bins = np.minimum((z * num_bins).astype(int), num_bins - 1)
    joint = np.zeros((num_types, num_bins), np.float64)
    np.add.at(joint, (np.clip(types, 0, num_types - 1), bins), 1.0)
    joint /= max(joint.sum(), 1.0)
    pt = joint.sum(1, keepdims=True)
    pb = joint.sum(0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = joint * (np.log(joint) - np.log(pt) - np.log(pb))
    return float(np.nansum(terms))


def coordination_histogram(
    frac: np.ndarray,
    lattices: np.ndarray,
    idx_start: np.ndarray,
    num_atoms: np.ndarray,
    max_coord: int = 16,
    max_crystals: int = 200,
) -> np.ndarray:
    """Normalized per-atom coordination-number histogram (Voronoi bonds).

    A structure-level metric the length/angle marginals cannot see: real
    crystals concentrate at chemically plausible coordinations (4/6/8/12),
    degenerate geometry smears the distribution. Crystals beyond
    ``max_crystals`` are subsampled evenly (the Voronoi tessellation is
    host-side and O(27·N) per crystal).

    Degrees are unique-pair bond counts (see ``predict_bonds_voronoi``), so
    small cells read below their true coordination; comparable between two
    sets as long as their atom-count distributions are similar."""
    from arreau_tpu_torch.inference.bonds import predict_bonds_voronoi

    counts = np.zeros(max_coord + 1)
    n = len(num_atoms)
    for i in np.linspace(0, n - 1, min(max_crystals, n)).astype(int):
        s, e = int(idx_start[i]), int(idx_start[i]) + int(num_atoms[i])
        if e - s < 2:
            continue
        try:
            bonds = predict_bonds_voronoi(frac[s:e], lattices[i])
        except ImportError:
            raise  # scipy missing — an environment problem, not a 0-coordination cell
        except Exception:  # degenerate cell -> count as 0-coordinated atoms
            counts[0] += e - s
            continue
        deg = np.zeros(e - s, dtype=int)
        for a, b in bonds:
            deg[a] += 1
            deg[b] += 1
        np.add.at(counts, np.clip(deg, 0, max_coord), 1)
    total = counts.sum()
    return counts / total if total else counts


def quality_report(
    gen_frac: np.ndarray,
    gen_types: np.ndarray,
    gen_lattices: np.ndarray,
    gen_idx_start: np.ndarray,
    gen_num_atoms: np.ndarray,
    ref_lengths: np.ndarray,
    ref_angles: np.ndarray,
    num_types: int,
    ref_type_mi: float | None = None,
    min_dist_threshold: float = 0.5,
    ref_coord_hist: np.ndarray | None = None,
    ref_mean_num_atoms: float | None = None,
    ref_fingerprints: list | None = None,
) -> dict:
    """Full quality report of generated crystals vs training statistics.

    The coordination histogram uses unique-pair Voronoi degrees, which read
    below the true coordination in small cells — the TV distance is only a
    like-for-like signal when the generated and reference atom-count regimes
    match. When ``ref_mean_num_atoms`` is given, ``coordination_comparable``
    flags (1.0/0.0) whether the mean atom counts are within 2x of each
    other; treat ``coordination_tv_dist`` as cell-size-driven, not
    geometry-driven, when it is 0."""
    lengths, angles = lattice_params_np(gen_lattices)
    lo, hi = float(np.min(ref_lengths)), float(np.max(ref_lengths))
    margin = 0.25 * (hi - lo)
    in_range = float(
        np.mean((lengths >= lo - margin) & (lengths <= hi + margin))
    )
    report = {
        "w1_lengths": wasserstein1(lengths, ref_lengths),
        "w1_angles_deg": wasserstein1(angles, ref_angles),
        "gen_length_mean": float(lengths.mean()),
        "gen_length_std": float(lengths.std()),
        "ref_length_mean": float(np.mean(ref_lengths)),
        "length_in_range_frac": in_range,
        "min_dist_violation_rate": min_distance_violation_rate(
            gen_frac, gen_lattices, gen_idx_start, gen_num_atoms, min_dist_threshold
        ),
        "type_geometry_mi": type_geometry_mutual_info(
            gen_types, gen_frac[:, 2], num_types
        ),
    }
    if ref_type_mi is not None:
        report["ref_type_geometry_mi"] = float(ref_type_mi)
    if ref_coord_hist is not None:
        gen_hist = coordination_histogram(
            gen_frac, gen_lattices, gen_idx_start, gen_num_atoms,
            max_coord=len(ref_coord_hist) - 1,
        )
        ks = np.arange(len(ref_coord_hist))
        report["coordination_tv_dist"] = float(
            0.5 * np.abs(gen_hist - ref_coord_hist).sum()
        )
        report["gen_mean_coordination"] = float((gen_hist * ks).sum())
        report["ref_mean_coordination"] = float((ref_coord_hist * ks).sum())
        if ref_mean_num_atoms is not None:
            gen_mean = float(np.mean(gen_num_atoms))
            ratio = gen_mean / max(float(ref_mean_num_atoms), 1e-9)
            report["gen_mean_num_atoms"] = gen_mean
            report["ref_mean_num_atoms"] = float(ref_mean_num_atoms)
            report["coordination_comparable"] = float(0.5 <= ratio <= 2.0)
    # uniqueness (always measurable) + novelty vs the training set (coarse
    # fingerprint proxy — see structure_fingerprint)
    gen_fps = fingerprint_set(gen_frac, gen_types, gen_lattices, gen_idx_start, gen_num_atoms)
    report["uniqueness_frac"] = float(len(set(gen_fps)) / max(len(gen_fps), 1))
    if ref_fingerprints is not None:
        ref_set = set(ref_fingerprints)
        report["novelty_frac"] = float(
            sum(fp not in ref_set for fp in gen_fps) / max(len(gen_fps), 1)
        )
    return report


def dataset_reference_stats(
    packed, type_indices: np.ndarray, num_types: int, violation_sample: int = 500
) -> dict:
    """Reference statistics from a PackedCrystals training set (violation rate
    measured on a subsample — it is O(n^2 * 27) per crystal)."""
    lengths, angles = lattice_params_np(packed.lattices)
    n = len(packed.lattices)
    idx = np.linspace(0, n - 1, min(violation_sample, n)).astype(int)
    viol = min_distance_violation_rate(
        packed.frac_coords,
        packed.lattices[idx],
        packed.offsets[idx],
        np.diff(packed.offsets)[idx],
    )
    return {
        "lengths": lengths,
        "angles": angles,
        "type_mi": type_geometry_mutual_info(
            type_indices, packed.frac_coords[:, 2], num_types
        ),
        "min_dist_violation_rate": viol,
        "coord_hist": coordination_histogram(
            packed.frac_coords, packed.lattices, packed.offsets,
            np.diff(packed.offsets),
        ),
        "mean_num_atoms": float(np.diff(packed.offsets).mean()),
        "fingerprints": fingerprint_set(
            packed.frac_coords, type_indices, packed.lattices, packed.offsets,
            np.diff(packed.offsets), max_crystals=5000,
        ),
    }
