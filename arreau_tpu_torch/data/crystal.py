"""Crystal datasets in memory, size-bucketed dense batching, and splits;
counterpart of ``arreau_tpu/data/crystal.py`` (numpy only).

Crystals are stored columnar (:class:`PackedCrystals`), assigned to the
smallest size bucket that fits, and emitted as dense ``[B, A_bucket]``
:class:`CrystalBatch`es of numpy arrays with masks. Each bucket's batch
size comes from a node budget, and for one seed the loader yields the same
batches in the same order as the JAX package's. Under data parallelism
each rank is a host of the JAX loader's multi-host contract: the chunks are
decided globally from the shared seed and rank ``host_index`` of
``num_hosts`` takes rows ``host_index::num_hosts`` of each, so every rank
runs the same sequence of shapes. Shards are HDF5 files, read and written
by ``data/hdf5.py`` (no ``h5py``): the packed columnar layout
(``atomic_numbers``, ``frac_coords``, ``offsets``, ``lattice_matrix``) and,
for reading, the reference's dataset-per-crystal layout. Batches are
collated by the C++ collator (``arreau_tpu_torch/native``); the numpy
:func:`collate_dense` is its plain version.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from arreau_tpu_torch import native
from arreau_tpu_torch.data.atoms import AtomicNumberTable, table_from_zs
from arreau_tpu_torch.data.hdf5 import read_datasets, write_datasets
from arreau_tpu_torch.tasks.diffusion import CrystalBatch

DEFAULT_BUCKETS = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


@dataclass
class PackedCrystals:
    """Columnar in-memory crystal store (float64 on the host, cast at batch)."""

    atomic_numbers: np.ndarray  # [total_atoms] int
    frac_coords: np.ndarray  # [total_atoms, 3]
    offsets: np.ndarray  # [N + 1] int64 prefix sums
    lattices: np.ndarray  # [N, 3, 3]

    def __len__(self) -> int:
        return len(self.lattices)

    @property
    def num_atoms(self) -> np.ndarray:
        return np.diff(self.offsets)

    def concat(self, other: "PackedCrystals") -> "PackedCrystals":
        return PackedCrystals(
            atomic_numbers=np.concatenate([self.atomic_numbers, other.atomic_numbers]),
            frac_coords=np.concatenate([self.frac_coords, other.frac_coords]),
            offsets=np.concatenate([self.offsets, self.offsets[-1] + other.offsets[1:]]),
            lattices=np.concatenate([self.lattices, other.lattices]),
        )


def write_packed_h5(path: str, packed: PackedCrystals) -> None:
    """Write a packed shard: four datasets and ``attrs["layout"] =
    "packed-v1"``, as the JAX package's ``write_packed_h5``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_datasets(path, {"atomic_numbers": packed.atomic_numbers,
                          "frac_coords": packed.frac_coords, "offsets": packed.offsets,
                          "lattice_matrix": packed.lattices},
                   {"layout": "packed-v1"})


def read_h5(path: str) -> PackedCrystals:
    """Read either the packed layout or the reference's per-crystal layout
    (``atomic_number/<i>``, ``frac_coord/<i>`` in integer key order, and a
    dense ``lattice_matrix``)."""
    data, _ = read_datasets(path)
    if "offsets" in data:
        return PackedCrystals(data["atomic_numbers"], data["frac_coords"], data["offsets"],
                              data["lattice_matrix"])
    members = {"atomic_number": {}, "frac_coord": {}}
    for name, array in data.items():
        group, _, key = name.partition("/")
        if group in members:
            members[group][key] = array
    zs = [members["atomic_number"][k] for k in sorted(members["atomic_number"], key=int)]
    fracs = [members["frac_coord"][k] for k in sorted(members["frac_coord"], key=int)]
    counts = np.array([len(z) for z in zs], dtype=np.int64)
    return PackedCrystals(
        atomic_numbers=np.concatenate(zs) if zs else np.zeros(0, np.int64),
        frac_coords=np.concatenate(fracs) if fracs else np.zeros((0, 3)),
        offsets=np.concatenate([[0], np.cumsum(counts)]),
        lattices=data["lattice_matrix"],
    )


def alexandria_shards(data_dir: str) -> list[str]:
    """The full Alexandria shards under ``data_dir``, sorted: every
    ``alexandria_ps_0*.h5`` but the take-N subsets."""
    paths = sorted(glob.glob(os.path.join(data_dir, "alexandria_ps_0*.h5")))
    return [p for p in paths if "take" not in p]


class CrystalDataset:
    """One or more shards (or ``packed``), the z-table, and the atoms'
    z-table indices."""

    def __init__(self, paths: Sequence[str] = (), packed: Optional[PackedCrystals] = None,
                 z_table: Optional[AtomicNumberTable] = None):
        if packed is None:
            packs = [read_h5(p) for p in paths]
            packed = packs[0]
            for p in packs[1:]:
                packed = packed.concat(p)
        self.packed = packed
        self.z_table = z_table or table_from_zs(np.unique(packed.atomic_numbers).tolist())
        self.type_indices = self.z_table.zs_to_indices(packed.atomic_numbers)

    @classmethod
    def from_packed(cls, packed: PackedCrystals,
                    z_table: Optional[AtomicNumberTable] = None) -> "CrystalDataset":
        """Without ``z_table`` the table is the crystals' own Zs and MASK."""
        return cls(packed=packed, z_table=z_table)

    def __len__(self) -> int:
        return len(self.packed)


def random_split(n: int, fractions: Sequence[float], seed: int) -> list[np.ndarray]:
    """Shuffled index split (the reference's 0.7/0.15/0.15)."""
    perm = np.random.default_rng(seed).permutation(n)
    out, start = [], 0
    for frac in fractions[:-1]:
        size = int(round(frac * n))
        out.append(perm[start : start + size])
        start += size
    out.append(perm[start:])
    return out


def _bucket_for(n_atoms: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n_atoms <= b:
            return b
    raise ValueError(f"crystal with {n_atoms} atoms exceeds largest bucket {buckets[-1]}")


def collate_dense(type_indices, frac_coords, offsets, lattices, idx, max_atoms: int,
                  dtype=np.float32) -> CrystalBatch:
    """One dense padded batch of the crystals ``idx``; an index of -1 is a
    padding slot: an empty example with the identity lattice (which keeps
    the lattice codecs finite). The plain version of the C++ collator."""
    B = len(idx)
    frac = np.zeros((B, max_atoms, 3), dtype)
    types = np.zeros((B, max_atoms), np.int32)
    lattice = np.zeros((B, 3, 3), dtype)
    num_atoms = np.zeros((B,), np.int32)
    mask = np.zeros((B, max_atoms), bool)
    for b, ci in enumerate(idx):
        if ci < 0:
            lattice[b] = np.eye(3, dtype=dtype)
            continue
        start, end = offsets[ci], offsets[ci + 1]
        n = end - start
        if n > max_atoms:
            raise ValueError(f"crystal {ci} has {n} atoms, more than the bucket's {max_atoms}")
        frac[b, :n] = frac_coords[start:end]
        types[b, :n] = type_indices[start:end]
        lattice[b] = lattices[ci]
        num_atoms[b] = n
        mask[b, :n] = True
    return CrystalBatch(frac, types, lattice, num_atoms, mask)


def pack_dense_batch(dataset: CrystalDataset, idx: np.ndarray, max_atoms: int,
                     dtype=np.float32) -> CrystalBatch:
    """The crystals ``idx`` (-1: a padding example) as one dense batch,
    collated by the C++ collator."""
    packed = dataset.packed
    return CrystalBatch(*native.collate_dense(dataset.type_indices, packed.frac_coords,
                                              packed.offsets, packed.lattices, idx, max_atoms,
                                              dtype))


class BucketedLoader:
    """Shuffled size-bucketed batch iterator: each bucket's batch size is
    ``node_budget // bucket``, rounded down to a multiple of
    ``batch_multiple``; a bucket's last short chunk is padded with empty
    examples (or dropped); chunks come in a shuffled order each epoch.

    Multi-host (one host per data rank): the chunks and their order are
    decided over the whole index set from the shared seed, the batch
    sizes are global and a multiple of ``num_hosts``, and host
    ``host_index`` yields rows ``host_index::num_hosts`` of each chunk:
    disjoint crystals, the same shapes on every host."""

    def __init__(
        self,
        dataset: CrystalDataset,
        indices: np.ndarray,
        node_budget: int = 4096,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        seed: int = 0,
        dtype=np.float32,
        batch_multiple: int = 1,
        drop_remainder: bool = False,
        host_index: int = 0,
        num_hosts: int = 1,
    ):
        if not 0 <= host_index < num_hosts:
            raise ValueError(f"host_index {host_index} not in [0, {num_hosts})")
        self.dataset = dataset
        self.node_budget = node_budget
        self.buckets = tuple(buckets)
        self.dtype = dtype
        self.batch_multiple = max(batch_multiple, num_hosts)
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)
        num_atoms = dataset.packed.num_atoms
        assign = {b: [] for b in self.buckets}
        for i in np.asarray(indices):
            assign[_bucket_for(int(num_atoms[i]), self.buckets)].append(i)
        self.by_bucket = {b: np.asarray(v, np.int64) for b, v in assign.items() if v}

    def batch_size_for(self, bucket: int) -> int:
        """The global batch size of ``bucket`` (all hosts together)."""
        bs = max(self.node_budget // bucket, 1)
        m = self.batch_multiple
        if m > 1:
            bs = max((bs // m) * m, m)
        return bs

    def chunks(self) -> list[tuple[int, np.ndarray]]:
        """One epoch's global (bucket, crystal indices) in order; draws from
        the loader's generator, as iterating does."""
        chunks = []
        for bucket in self.buckets:
            if bucket not in self.by_bucket:
                continue
            perm = self._rng.permutation(self.by_bucket[bucket])
            bs = self.batch_size_for(bucket)
            for start in range(0, len(perm), bs):
                chunk = perm[start : start + bs]
                if len(chunk) < bs:
                    if self.drop_remainder:
                        continue
                    chunk = np.concatenate([chunk, np.full(bs - len(chunk), -1, np.int64)])
                chunks.append((bucket, chunk))
        order = self._rng.permutation(len(chunks))
        return [chunks[i] for i in order]

    def __iter__(self) -> Iterator[CrystalBatch]:
        for bucket, chunk in self.chunks():
            local = chunk[self.host_index :: self.num_hosts]
            yield pack_dense_batch(self.dataset, local, bucket, self.dtype)

    def num_batches(self) -> int:
        total = 0
        for bucket, idx in self.by_bucket.items():
            bs = self.batch_size_for(bucket)
            total += len(idx) // bs if self.drop_remainder else -(-len(idx) // bs)
        return total
