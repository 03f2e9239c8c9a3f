"""A reader and a writer for the subset of HDF5 that the crystal files use,
in numpy and ``struct`` alone: what ``h5py`` is to the JAX package.

The subset is what ``h5py`` writes with its default ``libver='earliest'``:

* superblock version 0 with 8-byte offsets and lengths;
* version-1 object headers, continuation blocks included;
* groups kept in symbol tables: a version-1 B-tree of group nodes (any
  depth), a local heap of names and ``SNOD`` symbol nodes;
* simple (any rank) and scalar dataspaces;
* little-endian integers of 1, 2, 4 or 8 bytes, signed or not, and IEEE
  floats of 4 or 8 bytes;
* contiguous storage (an undefined address is an empty array) and compact
  storage, in layout messages of version 3;
* attributes of those types, and variable-length strings held in a global
  heap collection (``GCOL``).

Anything else raises ``ValueError`` naming the feature and the object's
path: chunked storage, filters, superblock versions 1-3, version-2 object
headers, link messages and dense link or attribute storage (what
``libver='latest'`` writes), shared messages, big-endian, compound and
other datatypes. Nothing outside the subset is read as if it were in it.

``read_datasets(path)`` returns every dataset as ``{"group/name": array}``
and the attributes as ``{object path ("" is the root): {name: value}}``.
``write_datasets(path, datasets, attrs)`` writes the part of the subset
that the crystal files need, the way ``h5py`` does: int64 and float64
datasets, groups (implied by the paths) of up to ``2 * LEAF_K`` members,
and string attributes of the root group; ``h5py`` reads it back.
Each dataset is read with one ``readinto`` and written with one ``write``.
"""

from __future__ import annotations

import math
import struct
from typing import Any, Mapping

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFF_FFFF_FFFF_FFFF
LEAF_K = 4  # a symbol node holds up to 2 * LEAF_K entries
INTERNAL_K = 16  # a group B-tree node holds up to 2 * INTERNAL_K children
ENTRY_SIZE = 40  # a symbol table entry with 8-byte offsets
SNOD_SIZE = 8 + 2 * LEAF_K * ENTRY_SIZE
TREE_SIZE = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
GCOL_MIN_SIZE = 4096
HEAP_NO_FREE_BLOCK = 1  # the HDF5 library's "no free block" offset in a local heap

# object header message types
NIL, DATASPACE, DATATYPE, FILL_OLD, FILL, LAYOUT = 0x00, 0x01, 0x03, 0x04, 0x05, 0x08
ATTRIBUTE, COMMENT, MTIME_OLD, CONTINUATION, SYMBOL_TABLE, MTIME, REFCOUNT = (
    0x0C, 0x0D, 0x0E, 0x10, 0x11, 0x12, 0x16)
_IGNORED = {NIL, FILL_OLD, FILL, COMMENT, MTIME_OLD, MTIME, REFCOUNT}
_REFUSED = {
    0x02: "link info messages (new-style groups)",
    0x06: "link messages (new-style groups)",
    0x07: "external storage",
    0x0A: "group info messages (new-style groups)",
    0x0B: "filters",
    0x13: "shared message tables",
    0x15: "attribute info messages (dense attribute storage)",
}
_CLASSES = ("fixed-point", "floating-point", "time", "string", "bit field", "opaque",
            "compound", "reference", "enumerated", "variable-length", "array")
# bit offset, precision, exponent location and size, mantissa location and
# size, exponent bias, sign location of the IEEE floats
_IEEE = {4: (0, 32, 23, 8, 0, 23, 127, 31), 8: (0, 64, 52, 11, 0, 52, 1023, 63)}


class _VlenString:
    """The datatype of a variable-length string (``utf8`` or ASCII)."""


VLEN_STRING = _VlenString()


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------- reading


def _datatype(data: bytes, where: str):
    """(numpy dtype or ``VLEN_STRING``, bytes taken) of a datatype message."""
    cls, bits0 = data[0] & 0x0F, data[1]
    size = struct.unpack_from("<I", data, 4)[0]
    if cls == 0:
        if bits0 & 0x01:
            raise ValueError(f"{where}: big-endian integers are outside the supported HDF5 subset")
        offset, precision = struct.unpack_from("<HH", data, 8)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            raise ValueError(f"{where}: an integer of {size} bytes with {precision} bits at "
                             f"offset {offset} is outside the supported HDF5 subset")
        return np.dtype(f"<{'i' if bits0 & 0x08 else 'u'}{size}"), 12
    if cls == 1:
        if bits0 & 0x41:
            raise ValueError(f"{where}: big-endian floats are outside the supported HDF5 subset")
        fields = struct.unpack_from("<HHBBBBI", data, 8) + (data[2],)
        if size not in _IEEE or fields != _IEEE[size] or (bits0 & 0x3E) != 0x20:
            raise ValueError(f"{where}: a non-IEEE float of {size} bytes is outside the "
                             "supported HDF5 subset")
        return np.dtype(f"<f{size}"), 20
    if cls == 9:
        if bits0 & 0x0F != 1:
            raise ValueError(f"{where}: variable-length sequences are outside the supported "
                             "HDF5 subset")
        base, taken = _datatype(data[8:], where)
        if base != np.dtype("u1") and base != np.dtype("i1"):
            raise ValueError(f"{where}: a variable-length string of {base} is outside the "
                             "supported HDF5 subset")
        return VLEN_STRING, 8 + taken
    name = _CLASSES[cls] if cls < len(_CLASSES) else f"class {cls}"
    raise ValueError(f"{where}: the {name} datatype is outside the supported HDF5 subset")


def _dataspace(data: bytes, where: str) -> tuple[int, ...]:
    version, rank = data[0], data[1]
    if version == 1:
        start = 8
    elif version == 2:
        if data[3] == 2:
            raise ValueError(f"{where}: null dataspaces are outside the supported HDF5 subset")
        start = 4
    else:
        raise ValueError(f"{where}: dataspace message version {version} is outside the "
                         "supported HDF5 subset")
    return struct.unpack_from(f"<{rank}Q", data, start)


class _Reader:
    def __init__(self, fh, path: str):
        self.fh = fh
        self.path = path
        self.collections: dict[int, dict[int, bytes]] = {}

    def read(self, addr: int, n: int) -> bytes:
        self.fh.seek(addr)
        data = self.fh.read(n)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated at byte {addr} (wanted {n} bytes)")
        return data

    def messages(self, addr: int, where: str) -> list[tuple[int, bytes]]:
        """(type, body) of every message of the object header at ``addr``,
        its continuation blocks included."""
        prefix = self.read(addr, 16)
        if prefix[:4] == b"OHDR":
            raise ValueError(f"{where}: version-2 object headers are outside the supported "
                             "HDF5 subset (a file written with libver='latest'?)")
        version, _, _, _, size = struct.unpack_from("<BBHII", prefix)
        if version != 1:
            raise ValueError(f"{where}: object header version {version} is outside the "
                             "supported HDF5 subset")
        out, blocks = [], [(addr + 16, size)]
        while blocks:
            start, length = blocks.pop(0)
            block, p = self.read(start, length), 0
            while p + 8 <= length:
                mtype, msize, flags = struct.unpack_from("<HHB", block, p)
                body = block[p + 8 : p + 8 + msize]
                p += 8 + msize
                if mtype == CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body))
                elif mtype in _IGNORED:
                    continue
                elif mtype in _REFUSED:
                    raise ValueError(f"{where}: {_REFUSED[mtype]} are outside the supported "
                                     "HDF5 subset")
                elif mtype not in (DATASPACE, DATATYPE, LAYOUT, ATTRIBUTE, SYMBOL_TABLE):
                    raise ValueError(f"{where}: object header message type {mtype:#x} is "
                                     "outside the supported HDF5 subset")
                elif flags & 0x02:
                    raise ValueError(f"{where}: shared object header messages are outside "
                                     "the supported HDF5 subset")
                else:
                    out.append((mtype, body))
        return out

    def walk(self, addr: int, path: str, datasets: dict, attrs: dict) -> None:
        where = f"{self.path}:/{path}"
        msgs = self.messages(addr, where)
        kinds = {mtype for mtype, _ in msgs}
        own = dict(self.attribute(body, where) for mtype, body in msgs if mtype == ATTRIBUTE)
        if own:
            attrs[path] = own
        if SYMBOL_TABLE in kinds:
            body = next(body for mtype, body in msgs if mtype == SYMBOL_TABLE)
            btree, heap = struct.unpack_from("<QQ", body)
            for name, child in self.members(btree, heap, where):
                self.walk(child, f"{path}/{name}" if path else name, datasets, attrs)
        elif DATASPACE in kinds:
            datasets[path] = self.dataset(msgs, where)
        else:
            raise ValueError(f"{where}: an object that is neither a symbol-table group nor a "
                             "dataset is outside the supported HDF5 subset")

    def members(self, btree: int, heap: int, where: str) -> list[tuple[str, int]]:
        """(name, object header address) of every member of a group, in the
        B-tree's order."""
        head = self.read(heap, 32)
        if head[:4] != b"HEAP":
            raise ValueError(f"{where}: no local heap at byte {heap}")
        size, _, data_addr = struct.unpack_from("<QQQ", head, 8)
        names = self.read(data_addr, size)
        out: list[tuple[str, int]] = []
        self._node(btree, names, out, where)
        return out

    def _node(self, addr: int, names: bytes, out: list, where: str) -> None:
        head = self.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise ValueError(f"{where}: no group B-tree node at byte {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        body = self.read(addr + 24, 16 * used + 8)
        for i in range(used):
            child = struct.unpack_from("<Q", body, 16 * i + 8)[0]
            if level:
                self._node(child, names, out, where)
            else:
                self._symbols(child, names, out, where)

    def _symbols(self, addr: int, names: bytes, out: list, where: str) -> None:
        head = self.read(addr, 8)
        if head[:4] != b"SNOD":
            raise ValueError(f"{where}: no symbol node at byte {addr}")
        count = struct.unpack_from("<H", head, 6)[0]
        body = self.read(addr + 8, ENTRY_SIZE * count)
        for i in range(count):
            name_at, header = struct.unpack_from("<QQ", body, ENTRY_SIZE * i)
            out.append((names[name_at : names.index(b"\0", name_at)].decode(), header))

    def dataset(self, msgs: list[tuple[int, bytes]], where: str) -> np.ndarray:
        body = {mtype: body for mtype, body in msgs}
        if DATATYPE not in body or LAYOUT not in body:
            raise ValueError(f"{where}: a dataset without a datatype or layout message")
        shape = _dataspace(body[DATASPACE], where)
        dtype, _ = _datatype(body[DATATYPE], where)
        if dtype is VLEN_STRING:
            raise ValueError(f"{where}: string datasets are outside the supported HDF5 subset")
        layout = body[LAYOUT]
        version, cls = layout[0], layout[1]
        if version != 3:
            raise ValueError(f"{where}: layout message version {version} is outside the "
                             "supported HDF5 subset")
        nbytes = math.prod(shape) * dtype.itemsize
        if cls == 0:  # compact: the data is in the message
            size = struct.unpack_from("<H", layout, 2)[0]
            if size != nbytes:
                raise ValueError(f"{where}: {size} compact bytes for {nbytes} of data")
            return np.frombuffer(layout, dtype, math.prod(shape), 4).reshape(shape).copy()
        if cls == 2:
            raise ValueError(f"{where}: chunked layouts are outside the supported HDF5 subset")
        if cls != 1:
            raise ValueError(f"{where}: layout class {cls} is outside the supported HDF5 subset")
        addr, size = struct.unpack_from("<QQ", layout, 2)
        out = np.empty(shape, dtype)
        if addr == UNDEFINED:
            if nbytes:
                raise ValueError(f"{where}: a dataset whose storage was never written (fill "
                                 "values) is outside the supported HDF5 subset")
            return out
        if size != nbytes:
            raise ValueError(f"{where}: {size} stored bytes for {nbytes} of data")
        self.fh.seek(addr)
        if self.fh.readinto(memoryview(out).cast("B")) != nbytes:
            raise ValueError(f"{self.path}: truncated in the data of {where}")
        return out

    def attribute(self, data: bytes, where: str) -> tuple[str, Any]:
        version = data[0]
        name_size, type_size, space_size = struct.unpack_from("<HHH", data, 2)
        if version == 1:
            pad, p = _pad8, 8
        elif version in (2, 3):
            if data[1] & 0x03:
                raise ValueError(f"{where}: shared attribute datatypes are outside the "
                                 "supported HDF5 subset")
            pad, p = (lambda n: n), 8 + (version == 3)
        else:
            raise ValueError(f"{where}: attribute message version {version} is outside the "
                             "supported HDF5 subset")
        name = data[p : p + name_size].split(b"\0", 1)[0].decode()
        p += pad(name_size)
        where = f"{where} attribute {name!r}"
        dtype, _ = _datatype(data[p : p + type_size], where)
        p += pad(type_size)
        shape = _dataspace(data[p : p + space_size], where)
        p += pad(space_size)
        count = math.prod(shape)
        if dtype is VLEN_STRING:
            values = [self.string(data, p + 16 * i, where) for i in range(count)]
            return name, values[0] if shape == () else np.array(values, object).reshape(shape)
        value = np.frombuffer(data, dtype, count, p).reshape(shape).copy()
        return name, value[()] if shape == () else value

    def string(self, data: bytes, p: int, where: str) -> str:
        length, collection, index = struct.unpack_from("<IQI", data, p)
        if length == 0:
            return ""
        if collection not in self.collections:
            head = self.read(collection, 16)
            if head[:4] != b"GCOL":
                raise ValueError(f"{where}: no global heap collection at byte {collection}")
            size = struct.unpack_from("<Q", head, 8)[0]
            block, objects, q = self.read(collection, size), {}, 16
            while q + 16 <= size:
                obj, _, obj_size = struct.unpack_from("<HH4xQ", block, q)
                if obj == 0:  # the free space closes the collection
                    break
                objects[obj] = block[q + 16 : q + 16 + obj_size]
                q += 16 + _pad8(obj_size)
            self.collections[collection] = objects
        return self.collections[collection][index][:length].decode()


def read_datasets(path: str) -> tuple[dict[str, np.ndarray], dict[str, dict[str, Any]]]:
    """Every dataset of the file at ``path`` as ``{"group/name": array}``
    (little-endian numpy arrays, a scalar dataset as a 0-d array), and the
    attributes of the groups and datasets that have any, keyed by their
    path (``""`` is the root group). Raises ``ValueError`` for a file
    outside the supported subset."""
    with open(path, "rb") as fh:
        reader = _Reader(fh, path)
        head = reader.read(0, 96)
        if head[:8] != SIGNATURE:
            raise ValueError(f"{path}: no HDF5 superblock at byte 0 (a user block, or not an "
                             "HDF5 file)")
        if head[8] != 0:
            raise ValueError(f"{path}: superblock version {head[8]} is outside the supported "
                             "HDF5 subset (a file written with libver='latest'?)")
        if head[13] != 8 or head[14] != 8:
            raise ValueError(f"{path}: {head[13]}-byte offsets and {head[14]}-byte lengths are "
                             "outside the supported HDF5 subset")
        if struct.unpack_from("<Q", head, 24)[0] != 0:
            raise ValueError(f"{path}: a base address other than 0 is outside the supported "
                             "HDF5 subset")
        root = struct.unpack_from("<Q", head, 64)[0]
        datasets: dict[str, np.ndarray] = {}
        attrs: dict[str, dict[str, Any]] = {}
        reader.walk(root, "", datasets, attrs)
    return datasets, attrs


# ---------------------------------------------------------------- writing


def _type_message(value) -> bytes:
    """The datatype message of int64, float64 or a variable-length UTF-8
    string (a sequence of unsigned bytes)."""
    if value is VLEN_STRING:
        return (struct.pack("<4BI", 0x19, 0x01, 0x01, 0, 16)
                + struct.pack("<4BIHH", 0x10, 0, 0, 0, 1, 0, 8))
    if value == np.dtype("<i8"):
        return struct.pack("<4BIHH", 0x10, 0x08, 0, 0, 8, 0, 64)
    if value == np.dtype("<f8"):
        offset, precision, exp_at, exp_size, man_at, man_size, bias, sign = _IEEE[8]
        return struct.pack("<4BIHHBBBBI", 0x11, 0x20, sign, 0, 8, offset, precision, exp_at,
                           exp_size, man_at, man_size, bias)
    raise ValueError(f"a {value} dataset: the writer writes int64 and float64 only")


def _space_message(shape: tuple[int, ...]) -> bytes:
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBBx4x", 1, len(shape), 1 if shape else 0) + dims + dims


def _object_header(messages: list[tuple[int, int, bytes]]) -> bytearray:
    """A version-1 object header: (type, flags, body) messages, each body
    padded to 8 bytes."""
    body = b"".join(struct.pack("<HHB3x", mtype, _pad8(len(data)), flags)
                    + data + bytes(_pad8(len(data)) - len(data))
                    for mtype, flags, data in messages)
    return bytearray(struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body)


class _Writer:
    def __init__(self):
        self.meta = bytearray(96)  # the superblock comes last, into these bytes
        # (byte, dataset path) of a data address not yet known; None: the global heap's
        self.patches: list[tuple[int, str | None]] = []
        self.strings: list[bytes] = []  # the global heap collection's objects
        self.data: list[tuple[str, np.ndarray]] = []

    def emit(self, block: bytes) -> int:
        addr = len(self.meta)
        self.meta += block
        return addr

    def attribute(self, name: str, value: str) -> bytes:
        """An attribute message (version 1) holding the variable-length
        UTF-8 string ``value``: its global heap reference (length,
        collection address, object index) ends the body."""
        if not isinstance(value, str):
            raise ValueError(f"attribute {name!r}: only string attributes are written")
        self.strings.append(value.encode())
        parts = (name.encode() + b"\0", _type_message(VLEN_STRING), _space_message(()))
        head = struct.pack("<BxHHH", 1, *(len(part) for part in parts))
        return (head + b"".join(part + bytes(_pad8(len(part)) - len(part)) for part in parts)
                + struct.pack("<IQI", len(self.strings[-1]), 0, len(self.strings)))

    def dataset(self, path: str, array: np.ndarray) -> int:
        dtype = array.dtype.newbyteorder("<")
        messages = [(DATASPACE, 0, _space_message(array.shape)), (DATATYPE, 1, _type_message(dtype)),
                    (FILL, 1, struct.pack("<4B4x", 2, 2, 2, 1)),
                    (LAYOUT, 0, struct.pack("<BBQQ", 3, 1, UNDEFINED, 0))]
        addr = self.emit(_object_header(messages))
        if array.size:
            layout_at = addr + 16 + sum(8 + _pad8(len(data)) for _, _, data in messages[:3])
            self.patches.append((layout_at + 8 + 2, path))
            struct.pack_into("<Q", self.meta, layout_at + 8 + 10, array.nbytes)
            self.data.append((path, np.ascontiguousarray(array, dtype)))
        return addr

    def group(self, path: str, tree: dict, attrs: Mapping[str, str]):
        """Emit a group with the string attributes ``attrs`` and, after it,
        its members: one symbol node under one leaf of the group B-tree.
        Returns the addresses of its object header, B-tree and local heap."""
        names = sorted(tree, key=str.encode)
        if len(names) > 2 * LEAF_K:
            raise ValueError(f"/{path}: {len(names)} members; the writer keeps a group in one "
                             f"symbol node, of at most {2 * LEAF_K}")
        bodies = [self.attribute(name, value) for name, value in attrs.items()]
        header = len(self.meta)
        p = header + 16 + 8 + 16  # after the symbol table message
        for body in bodies:  # each string's global heap address, patched when it is placed
            self.patches.append((p + 8 + len(body) - 12, None))
            p += 8 + _pad8(len(body))
        self.emit(_object_header([(SYMBOL_TABLE, 0, bytes(16))]
                                 + [(ATTRIBUTE, 0, body) for body in bodies]))
        heap_data = bytearray(8)  # offset 0: the empty name
        offsets = []
        for name in names:
            offsets.append(len(heap_data))
            encoded = name.encode() + b"\0"
            heap_data += encoded + bytes(_pad8(len(encoded)) - len(encoded))
        heap = self.emit(struct.pack("<4s4xQQQ", b"HEAP", len(heap_data), HEAP_NO_FREE_BLOCK,
                                     len(self.meta) + 32))
        self.emit(bytes(heap_data))
        node = bytearray(TREE_SIZE)
        struct.pack_into("<4sBBHQQ", node, 0, b"TREE", 0, 0, 1 if names else 0, UNDEFINED,
                         UNDEFINED)
        if names:
            snod = self.emit(struct.pack("<4sBxH", b"SNOD", 1, len(names))
                             + bytes(SNOD_SIZE - 8))
            struct.pack_into("<QQQ", node, 24, 0, snod, offsets[-1])
        btree = self.emit(bytes(node))
        struct.pack_into("<QQ", self.meta, header + 16 + 8, btree, heap)
        for j, (name, offset) in enumerate(zip(names, offsets)):
            child = f"{path}/{name}" if path else name
            entry = snod + 8 + ENTRY_SIZE * j
            if isinstance(tree[name], dict):
                oh, child_btree, child_heap = self.group(child, tree[name], {})
                struct.pack_into("<QQIIQQ", self.meta, entry, offset, oh, 1, 0, child_btree,
                                 child_heap)
            else:
                struct.pack_into("<QQ", self.meta, entry, offset, self.dataset(child, tree[name]))
        return header, btree, heap


def _tree(datasets: Mapping[str, np.ndarray]) -> dict:
    root: dict = {}
    for path, array in datasets.items():
        *groups, name = path.strip("/").split("/")
        node = root
        for group in groups:
            node = node.setdefault(group, {})
            if not isinstance(node, dict):
                raise ValueError(f"{path}: {group} is a dataset, not a group")
        if name in node:
            raise ValueError(f"{path}: written twice, or a group of that name exists")
        node[name] = np.asarray(array)
    return root


def write_datasets(path: str, datasets: Mapping[str, np.ndarray],
                   attrs: Mapping[str, str] | None = None) -> None:
    """Write ``{"group/name": array}`` (int64 or float64) to a new file at
    ``path``, the groups implied by the paths, with the root group's string
    attributes ``attrs``. A group holds at most ``2 * LEAF_K`` members.
    The layout is ``h5py``'s with ``libver='earliest'``: metadata first,
    then each dataset's data, contiguous."""
    writer = _Writer()
    root, btree, heap = writer.group("", _tree(datasets), attrs or {})
    gcol = None
    if writer.strings:
        body = b"".join(struct.pack("<HH4xQ", i + 1, 0, len(s)) + s + bytes(_pad8(len(s)) - len(s))
                        for i, s in enumerate(writer.strings))
        size = max(GCOL_MIN_SIZE, 16 + len(body) + 16)
        gcol = writer.emit(struct.pack("<4sB3xQ", b"GCOL", 1, size) + body
                           + struct.pack("<HH4xQ", 0, 0, size - 16 - len(body))
                           + bytes(size - 32 - len(body)))
    data_at, offset = {}, len(writer.meta)
    for key, array in writer.data:
        data_at[key] = offset
        offset += _pad8(array.nbytes)
    for at, key in writer.patches:
        struct.pack_into("<Q", writer.meta, at, gcol if key is None else data_at[key])
    struct.pack_into("<8s8BHHI4Q", writer.meta, 0, SIGNATURE, 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K,
                     INTERNAL_K, 0, 0, UNDEFINED, offset, UNDEFINED)
    struct.pack_into("<QQIIQQ", writer.meta, 56, 0, root, 1, 0, btree, heap)
    with open(path, "wb") as fh:
        fh.write(writer.meta)
        for _, array in writer.data:
            fh.write(memoryview(array).cast("B"))
            fh.write(bytes(_pad8(array.nbytes) - array.nbytes))
