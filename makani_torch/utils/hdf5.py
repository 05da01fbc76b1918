"""A numpy reader and writer for the HDF5 files the framework reads and
writes: superblock version 0, version-1 object headers, groups held in
symbol tables, and contiguous, uncompressed datasets of little-endian
numbers or fixed-length strings.

That is the layout of the training and validation files (``fields`` (T, C,
H, W) fp32 and ``timestamp`` int64, as h5py writes them by default) and of
the inference outputs. The reader memory-maps a dataset at its offset in the
file, the path the JAX package takes for such files (``np.memmap`` at
``ds.id.get_offset()``); chunked or compressed data, object headers of
version 2 and groups without a symbol table raise ``NotImplementedError``.
The writer lays out the whole file when it is opened: each dataset's shape
and dtype are given up front, and its data is written through a memory map
(``File.create``) or in one piece (``write``). h5py reads what it writes.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["File", "Dataset", "write"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
# message types (HDF5 file format specification, section IV.A.2)
_DATASPACE, _DATATYPE, _FILTERS, _LAYOUT, _CONTINUATION, _SYMBOL_TABLE = 0x0001, 0x0003, 0x000B, 0x0008, 0x0010, 0x0011
# datatype classes
_FIXED, _FLOAT, _STRING = 0, 1, 3
# the writer's B-tree and symbol-table node widths (the superblock's K values)
_LEAF_K, _NODE_K = 4, 16


def _align8(n: int) -> int:
    return (n + 7) & ~7


class Dataset:
    """A contiguous dataset: its shape, dtype, and byte offset in the file."""

    def __init__(self, path: str, name: str, shape, dtype: np.dtype, offset: int | None):
        self.path, self.name = path, name
        self.shape, self.dtype, self.offset = tuple(shape), np.dtype(dtype), offset
        self._map = None

    def memmap(self, mode: str = "r") -> np.ndarray:
        """The data as a memory map of the file (an empty array for a dataset
        that has no storage yet)."""
        if self.offset is None or int(np.prod(self.shape)) == 0:
            return np.zeros(self.shape, self.dtype)
        if mode != "r":
            return np.memmap(self.path, dtype=self.dtype, mode=mode, offset=self.offset, shape=self.shape)
        if self._map is None:
            self._map = np.memmap(self.path, dtype=self.dtype, mode="r", offset=self.offset, shape=self.shape)
        return self._map

    def __getitem__(self, key):
        return np.asarray(self.memmap()[key])


# ---------------------------------------------------------------------------
# reader


class _Reader:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = f.read(4096)
        self._f = None

    def read(self, addr: int, n: int) -> bytes:
        if addr + n <= len(self.buf):
            return self.buf[addr : addr + n]
        if self._f is None:
            self._f = open(self.path, "rb")
        self._f.seek(addr)
        out = self._f.read(n)
        if len(out) != n:
            raise ValueError(f"{self.path}: truncated at byte {addr + len(out)} (wanted {n} bytes at {addr})")
        return out

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


def _superblock(r: _Reader):
    head = r.read(0, 24)
    if head[:8] != _SIGNATURE:
        raise ValueError(f"{r.path}: not an HDF5 file (no signature at byte 0)")
    version = head[8]
    if version not in (0, 1):
        raise NotImplementedError(f"{r.path}: superblock version {version} (only 0 and 1 are read)")
    if head[13] != 8 or head[14] != 8:
        raise NotImplementedError(f"{r.path}: offsets of {head[13]} and lengths of {head[14]} bytes (only 8)")
    pos = 24 + (4 if version == 1 else 0)
    base = struct.unpack_from("<Q", r.read(pos, 8))[0]
    if base != 0:
        raise NotImplementedError(f"{r.path}: base address {base} (only 0)")
    entry = r.read(pos + 32, 40)
    return struct.unpack_from("<Q", entry, 8)[0]


def _messages(r: _Reader, addr: int):
    """(type, data) of each message of the version-1 object header at addr,
    following continuation blocks."""
    prefix = r.read(addr, 16)
    if prefix[0] != 1:
        if prefix[:4] == b"OHDR":
            raise NotImplementedError(f"{r.path}: version-2 object header at {addr} (only version 1; write the file with h5py's default libver)")
        raise ValueError(f"{r.path}: no object header at {addr}")
    n_msgs, = struct.unpack_from("<H", prefix, 2)
    size, = struct.unpack_from("<I", prefix, 8)
    blocks = [(addr + 16, size)]
    out = []
    while blocks and len(out) < n_msgs:
        start, length = blocks.pop(0)
        block = r.read(start, length)
        pos = 0
        while pos + 8 <= length and len(out) < n_msgs:
            mtype, msize = struct.unpack_from("<HH", block, pos)
            data = block[pos + 8 : pos + 8 + msize]
            pos += 8 + msize
            if mtype == _CONTINUATION:
                blocks.append(struct.unpack_from("<QQ", data))
            out.append((mtype, data))
    return out


def _dataspace(data: bytes):
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        pos = 8
    elif version == 2:
        pos = 4
        if data[3] == 2:  # the null dataspace
            return ()
    else:
        raise NotImplementedError(f"dataspace message version {version}")
    return tuple(struct.unpack_from(f"<{rank}Q", data, pos)) if rank else ()


def _datatype(data: bytes) -> np.dtype:
    cls, bits0 = data[0] & 0x0F, data[1]
    size, = struct.unpack_from("<I", data, 4)
    if cls in (_FIXED, _FLOAT) and bits0 & 1:
        raise NotImplementedError("big-endian data")
    if cls == _FIXED:
        return np.dtype(f"<{'i' if bits0 & 0x08 else 'u'}{size}")
    if cls == _FLOAT:
        if size not in (2, 4, 8):
            raise NotImplementedError(f"{size}-byte floats")
        return np.dtype(f"<f{size}")
    if cls == _STRING:
        return np.dtype(f"S{size}")
    raise NotImplementedError(f"datatype class {cls}")


def _layout(path: str, name: str, data: bytes):
    version, cls = data[0], data[1]
    if version != 3:
        raise NotImplementedError(f"{path}:{name}: layout message version {version} (only 3)")
    if cls != 1:
        kind = {0: "compact", 2: "chunked"}.get(cls, f"class {cls}")
        raise NotImplementedError(f"{path}:{name}: {kind} storage (only contiguous datasets are read)")
    addr, _ = struct.unpack_from("<QQ", data, 2)
    return None if addr == _UNDEF else addr


def _group_entries(r: _Reader, btree: int, heap: int) -> dict:
    """{name: object header address} of a symbol-table group."""
    h = r.read(heap, 32)
    if h[:4] != b"HEAP":
        raise ValueError(f"{r.path}: no local heap at {heap}")
    seg_size, _, seg_addr = struct.unpack_from("<QQQ", h, 8)
    names = r.read(seg_addr, seg_size)

    def name_at(off):
        return names[off : names.index(b"\0", off)].decode()

    out = {}
    stack = [btree]
    while stack:
        node = stack.pop()
        head = r.read(node, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise ValueError(f"{r.path}: no group B-tree node at {node}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        body = r.read(node + 24, used * 16 + 8)
        children = [struct.unpack_from("<Q", body, 8 + 16 * i)[0] for i in range(used)]
        if level > 0:
            stack.extend(children)
            continue
        for snod in children:
            sh = r.read(snod, 8)
            if sh[:4] != b"SNOD":
                raise ValueError(f"{r.path}: no symbol-table node at {snod}")
            n, = struct.unpack_from("<H", sh, 6)
            ents = r.read(snod + 8, 40 * n)
            for i in range(n):
                name_off, obj = struct.unpack_from("<QQ", ents, 40 * i)
                out[name_at(name_off)] = obj
    return out


class File:
    """The datasets of an HDF5 file by path ("fields", "group/fields"):
    ``File(path)["fields"]`` is a ``Dataset``; ``in`` and ``keys()`` list
    the names. Nothing stays open but the memory maps the caller holds."""

    def __init__(self, path: str):
        self.path = path
        r = _Reader(path)
        try:
            self._datasets = {}
            self._walk(r, _superblock(r), "")
        finally:
            r.close()

    def _walk(self, r: _Reader, addr: int, prefix: str):
        msgs = dict(_messages(r, addr))
        if _SYMBOL_TABLE in msgs:
            btree, heap = struct.unpack_from("<QQ", msgs[_SYMBOL_TABLE])
            for name, obj in _group_entries(r, btree, heap).items():
                self._walk(r, obj, f"{prefix}{name}/")
            return
        name = prefix.rstrip("/")
        if _DATASPACE not in msgs or _LAYOUT not in msgs:
            if not prefix:
                raise NotImplementedError(f"{self.path}: the root group has no symbol table (write the file with h5py's default libver)")
            return  # a named datatype or a group of the new layout: not a dataset
        if _FILTERS in msgs:
            raise NotImplementedError(f"{self.path}:{name}: filtered (compressed) data")
        shape = _dataspace(msgs[_DATASPACE])
        self._datasets[name] = Dataset(self.path, name, shape, _datatype(msgs[_DATATYPE]), _layout(self.path, name, msgs[_LAYOUT]))

    def __getitem__(self, name: str) -> Dataset:
        return self._datasets[name.strip("/")]

    def __contains__(self, name: str) -> bool:
        return name.strip("/") in self._datasets

    def keys(self):
        return list(self._datasets)

    @staticmethod
    def create(path: str, specs: dict) -> dict:
        """Write the file's layout for ``specs`` {name: (shape, dtype)} in
        the root group (data zero) and return {name: writable memory map}."""
        offsets = _write_layout(path, {k: (tuple(s), np.dtype(d)) for k, (s, d) in specs.items()})
        return {k: Dataset(path, k, specs[k][0], specs[k][1], off).memmap("r+") for k, off in offsets.items()}


# ---------------------------------------------------------------------------
# writer


def _datatype_message(dtype: np.dtype) -> bytes:
    if dtype.kind == "f":
        bits = 8 * dtype.itemsize
        exp_size, mant_size, bias = {16: (5, 10, 15), 32: (8, 23, 127), 64: (11, 52, 1023)}[bits]
        head = struct.pack("<B3BI", 0x10 | _FLOAT, 0x20, bits - 1, 0, dtype.itemsize)
        return head + struct.pack("<HHBBBBI", 0, bits, mant_size, exp_size, 0, mant_size, bias)
    if dtype.kind in "iu":
        head = struct.pack("<B3BI", 0x10 | _FIXED, 0x08 if dtype.kind == "i" else 0, 0, 0, dtype.itemsize)
        return head + struct.pack("<HH", 0, 8 * dtype.itemsize)
    if dtype.kind == "S":
        return struct.pack("<B3BI", 0x10 | _STRING, 0x01, 0, 0, dtype.itemsize)  # null-padded ASCII
    raise NotImplementedError(f"dtype {dtype}")


def _header(messages) -> bytes:
    body = b"".join(struct.pack("<HHB3x", t, _align8(len(d)), 0) + d.ljust(_align8(len(d)), b"\0") for t, d in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _write_layout(path: str, specs: dict) -> dict:
    """Write the superblock, the root group and each dataset's header, and
    size the file for the data; returns {name: data offset}."""
    for name, (shape, dtype) in specs.items():
        if not name or "/" in name:
            raise ValueError(f"dataset name {name!r}: only names in the root group")
        if dtype.byteorder == ">":
            raise NotImplementedError("big-endian data")
    names = sorted(specs)
    # local heap: the empty name at offset 0, then each name, 8-byte aligned
    heap_data, name_off = b"\0" * 8, {}
    for n in names:
        name_off[n] = len(heap_data)
        heap_data += n.encode().ljust(_align8(len(n) + 1), b"\0")

    n_snod = max(1, -(-len(names) // (2 * _LEAF_K)))
    if n_snod > 2 * _NODE_K:
        raise NotImplementedError(f"{len(names)} datasets (at most {2 * _NODE_K * 2 * _LEAF_K})")
    superblock_size = 96
    btree_size = 24 + (2 * _NODE_K) * 16 + 8
    snod_size = 8 + 2 * _LEAF_K * 40
    root_header = _header([(_SYMBOL_TABLE, struct.pack("<QQ", 0, 0))])
    pos = superblock_size
    root_addr = pos
    pos += len(root_header)
    heap_addr = pos
    pos += 32
    heap_seg = pos
    pos += len(heap_data)
    btree_addr = pos
    pos += btree_size
    snod_addrs = []
    for _ in range(n_snod):
        snod_addrs.append(pos)
        pos += snod_size

    headers, data_off = {}, {}
    hdr_addrs = {}
    for n in names:
        shape, dtype = specs[n]
        space = struct.pack("<BBBB4x", 1, len(shape), 0, 0) + struct.pack(f"<{len(shape)}Q", *shape)
        # layout: filled in once the data's offset is known; a fixed size
        headers[n] = (space, _datatype_message(dtype))
        hdr_addrs[n] = pos
        pos += len(_header([(_DATASPACE, space), (_DATATYPE, headers[n][1]), (_LAYOUT, b"\0" * 18)]))
    pos = (pos + 4095) & ~4095  # data on page boundaries
    for n in names:
        shape, dtype = specs[n]
        data_off[n] = pos
        pos = _align8(pos + int(np.prod(shape)) * dtype.itemsize)
    eof = pos

    with open(path, "wb") as f:
        sb = _SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
        sb += struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
        sb += struct.pack("<QQII", 0, root_addr, 1, 0) + struct.pack("<QQ", btree_addr, heap_addr)
        f.write(sb)
        f.write(_header([(_SYMBOL_TABLE, struct.pack("<QQ", btree_addr, heap_addr))]))
        # the free list's head: 1, the library's "no free block"
        f.write(b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack("<QQQ", len(heap_data), 1, heap_seg))
        f.write(heap_data)
        groups = [names[i : i + 2 * _LEAF_K] for i in range(0, len(names), 2 * _LEAF_K)] or [[]]
        # B-tree keys: the heap offset of the last name of each node (key 0 the empty name)
        keys = [0] + [name_off[g[-1]] if g else 0 for g in groups]
        bt = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(groups) if names else 0, _UNDEF, _UNDEF)
        for i, a in enumerate(snod_addrs):
            bt += struct.pack("<QQ", keys[i], a)
        bt += struct.pack("<Q", keys[len(snod_addrs)])
        f.write(bt.ljust(btree_size, b"\0"))
        for a, g in zip(snod_addrs, groups):
            sn = b"SNOD" + struct.pack("<BBH", 1, 0, len(g))
            for n in g:
                sn += struct.pack("<QQII16x", name_off[n], hdr_addrs[n], 0, 0)
            f.write(sn.ljust(snod_size, b"\0"))
        for n in names:
            shape, dtype = specs[n]
            layout = struct.pack("<BBQQ", 3, 1, data_off[n], int(np.prod(shape)) * dtype.itemsize)
            f.write(_header([(_DATASPACE, headers[n][0]), (_DATATYPE, headers[n][1]), (_LAYOUT, layout)]))
        f.truncate(eof)
    return data_off


def write(path: str, arrays: dict):
    """Write {name: array} as contiguous datasets in the root group of a new
    file at ``path`` (h5py's ``create_dataset(name, data=array)`` for each)."""
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    offsets = _write_layout(path, {k: (v.shape, v.dtype.newbyteorder("<") if v.dtype.byteorder == ">" else v.dtype) for k, v in arrays.items()})
    with open(path, "r+b") as f:
        for k, v in arrays.items():
            f.seek(offsets[k])
            f.write(memoryview(v.astype(v.dtype.newbyteorder("<"), copy=False)).cast("B"))
