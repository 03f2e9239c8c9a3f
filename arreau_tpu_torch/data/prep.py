"""Dataset prep: Alexandria ``*.json.bz2`` -> packed HDF5 shards; the
counterpart of ``arreau_tpu/data/prep.py`` (``bz2``, ``json``, numpy and
``multiprocessing`` only).

Each entry is a pymatgen ``ComputedStructureEntry`` dict, read without
pymatgen: ``structure.lattice.matrix``, ``structure.sites[*].species[0]
.element`` and ``structure.sites[*].abc``. Each input shard becomes one
packed shard (``data/crystal.py:write_packed_h5``), one process a shard,
and the first also a take-N development subset
(``alexandria_ps_000_take10.h5``).

    python -m arreau_tpu_torch.data.prep --in_dir datasets/alexandria \\
        --out_dir datasets/alexandria_hdf5
"""

from __future__ import annotations

import argparse
import bz2
import json
import multiprocessing
import os
from typing import Optional

import numpy as np

from arreau_tpu_torch.data.atoms import symbol_to_z
from arreau_tpu_torch.data.crystal import PackedCrystals, write_packed_h5


def parse_entries(data: dict, take: Optional[int] = None) -> PackedCrystals:
    """The crystals of an Alexandria document (the first ``take``)."""
    entries = data["entries"]
    if take is not None:
        entries = entries[:take]
    zs_list, frac_list, lattices = [], [], []
    for entry in entries:
        structure = entry["structure"]
        lattices.append(np.asarray(structure["lattice"]["matrix"], np.float64))
        sites = structure["sites"]
        zs_list.append(np.array([symbol_to_z(site["species"][0]["element"]) for site in sites],
                                np.int64))
        frac_list.append(np.array([site["abc"] for site in sites], np.float64).reshape(-1, 3))
    counts = np.array([len(z) for z in zs_list], np.int64)
    return PackedCrystals(
        atomic_numbers=np.concatenate(zs_list) if zs_list else np.zeros(0, np.int64),
        frac_coords=np.concatenate(frac_list) if frac_list else np.zeros((0, 3)),
        offsets=np.concatenate([[0], np.cumsum(counts)]),
        lattices=np.stack(lattices) if lattices else np.zeros((0, 3, 3)),
    )


def prep_shard(in_path: str, out_path: str, take: Optional[int] = None) -> None:
    with bz2.open(in_path, "rt", encoding="utf-8") as fh:
        data = json.load(fh)
    packed = parse_entries(data, take)
    write_packed_h5(out_path, packed)
    print(f"wrote {out_path}: {len(packed)} crystals, {len(packed.atomic_numbers)} atoms")


def prep_all(in_dir: str, out_dir: str, num_shards: int = 5, dev_take: int = 10) -> None:
    """``alexandria_ps_00{i}.json.bz2`` -> ``alexandria_ps_00{i}.h5`` for
    i < ``num_shards`` (those present), one spawned process each, after the
    take-``dev_take`` subset of the first."""
    os.makedirs(out_dir, exist_ok=True)
    first = os.path.join(in_dir, "alexandria_ps_000.json.bz2")
    if os.path.exists(first):
        prep_shard(first, os.path.join(out_dir, f"alexandria_ps_000_take{dev_take}.h5"),
                   take=dev_take)
    context = multiprocessing.get_context("spawn")
    procs = []
    for i in range(num_shards):
        name = f"alexandria_ps_00{i}"
        in_path = os.path.join(in_dir, f"{name}.json.bz2")
        if not os.path.exists(in_path):
            continue
        proc = context.Process(target=prep_shard, args=(in_path, os.path.join(out_dir, f"{name}.h5")))
        proc.start()
        procs.append((name, proc))
    failed = []
    for name, proc in procs:
        proc.join()
        if proc.exitcode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"prep failed for {', '.join(failed)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--in_dir", default="datasets/alexandria")
    ap.add_argument("--out_dir", default="datasets/alexandria_hdf5")
    ap.add_argument("--num_shards", type=int, default=5)
    args = ap.parse_args(argv)
    prep_all(args.in_dir, args.out_dir, args.num_shards)


if __name__ == "__main__":
    main()
