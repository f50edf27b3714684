"""The subset of HDF5 that the binarized item stores use, in numpy and the
standard library (the port's own codec: no ``h5py``).

A store is one file whose root group holds a group per item, and each item
group a dataset per attribute. ``Writer`` writes such a file in the format
libhdf5 writes under h5py's defaults, so ``h5py``, the JAX package and
upstream DiffSinger read it; ``Reader`` reads the files they write.

What is read (HDF5 file format specification, version 0 structures):

* superblock version 0 with 8-byte offsets and lengths;
* version-1 object headers, with continuation blocks;
* old-style groups: a symbol-table message, a version-1 B-tree of type 0
  (any number of levels) whose leaves are symbol-table nodes, and a local
  heap for the link names;
* datasets: dataspace (scalar or simple), datatype (fixed-point and IEEE
  floating-point of either byte order, and h5py's ``FALSE``/``TRUE`` enum
  over int8 read back as ``np.bool_``), contiguous or compact layout; other
  messages (fill value, times, attributes) are skipped.

Anything else (chunked or filtered storage, variable-length or string
types, new-style groups, another superblock version) raises
``HDF5FormatError`` naming the object.

The reader parses the root group's index when the file is opened and reads
each group's datasets with ``os.preadv`` straight into new arrays: it never
loads the whole file.
"""

from __future__ import annotations

import os
import struct
import weakref
from typing import Dict, List, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address
FREE_NULL = 1  # a local heap's free list end (libhdf5's H5HL_FREE_NULL)

# message types
MSG_DATASPACE, MSG_DATATYPE, MSG_FILL = 0x01, 0x03, 0x05
MSG_LAYOUT, MSG_FILTERS, MSG_CONTINUATION, MSG_STAB = 0x08, 0x0B, 0x10, 0x11
MSG_LINK, MSG_LINK_INFO = 0x06, 0x02

# libhdf5's defaults: a symbol-table node holds 2 x 4 links, a B-tree node
# 2 x 16 children
LEAF_K, INTERNAL_K = 4, 16
ENTRY_SIZE = 40  # a symbol-table entry
SUPERBLOCK_SIZE = 96
HEADER_PREFIX = 16  # a version-1 object header's prefix, padded to 8 bytes
READ_AHEAD = 512  # bytes read for an object header before its size is known

_ENTRY = np.dtype([("name", "<u8"), ("header", "<u8"), ("cache", "<u4"), ("reserved", "<u4"),
                   ("btree", "<u8"), ("heap", "<u8")])
# IEEE layouts: size -> (exponent location, exponent size, mantissa size, bias)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}
_BOOL_MEMBERS = (b"FALSE", b"TRUE")


class HDF5FormatError(ValueError):
    """A file, or a part of it, outside the subset this module reads."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _padded_name(name: bytes) -> bytes:
    """A name with its terminator, padded with zeros to a multiple of 8 bytes."""
    return name + b"\0" * (_pad8(len(name) + 1) - len(name))


# ---------------------------------------------------------------------- reader
class Reader:
    """Reads the groups of datasets under an HDF5 file's root group."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self.fd = os.open(self.path, os.O_RDONLY)
        # closes the descriptor once: on close() or when the reader is collected
        self._close = weakref.finalize(self, os.close, self.fd)
        try:
            self._read_superblock()
            self.index = self._links(self.root_header, self.root_stab, "/")
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        self._close()
        self.fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self) -> int:
        return len(self.index)

    def keys(self) -> List[str]:
        """The root group's link names, in libhdf5's (byte) order."""
        return list(self.index)

    def read_group(self, name: str) -> Dict[str, np.ndarray]:
        """The datasets of the root group's member ``name``, by name (0-d
        arrays for scalars), in libhdf5's order."""
        header, stab = self.index[name]
        links = self._links(header, stab, name)
        return {key: self._read_dataset(addr, f"{name}/{key}") for key, (addr, _) in links.items()}

    # -- file structures
    def _pread(self, size: int, addr: int, what: str) -> bytes:
        data = os.pread(self.fd, size, self.base + addr)
        if len(data) < size:
            raise HDF5FormatError(f"{self.path}: {what} at {addr} runs past the end of the file")
        return data

    def _read_superblock(self) -> None:
        self.base = 0
        sb = os.pread(self.fd, SUPERBLOCK_SIZE, 0)
        if sb[:8] != SIGNATURE:
            raise HDF5FormatError(f"{self.path}: not an HDF5 file (no signature at offset 0)")
        if len(sb) < SUPERBLOCK_SIZE:
            raise HDF5FormatError(f"{self.path}: the superblock is truncated")
        if sb[8] != 0:
            raise HDF5FormatError(f"{self.path}: superblock version {sb[8]} is not supported "
                                  "(only version 0, libhdf5's default)")
        if sb[13] != 8 or sb[14] != 8:
            raise HDF5FormatError(f"{self.path}: offsets of {sb[13]} and lengths of {sb[14]} "
                                  "bytes are not supported (only 8)")
        self.leaf_k, self.internal_k = struct.unpack_from("<HH", sb, 16)
        self.base = struct.unpack_from("<Q", sb, 24)[0]
        root = np.frombuffer(sb, _ENTRY, 1, 56)[0]
        self.root_header = int(root["header"])
        self.root_stab = (int(root["btree"]), int(root["heap"])) if root["cache"] == 1 else None

    def _messages(self, addr: int, what: str) -> List[Tuple[int, int, bytes, int]]:
        """(type, flags, block, offset of the data in the block) of each
        message of the version-1 object header at ``addr``."""
        head = os.pread(self.fd, READ_AHEAD, self.base + addr)
        if len(head) < HEADER_PREFIX:
            raise HDF5FormatError(f"{self.path}: object header of {what!r} at {addr} is truncated")
        version, n_msgs, size = head[0], *struct.unpack_from("<H4xI", head, 2)
        if version != 1:
            raise HDF5FormatError(f"{self.path}: object header version {version} of {what!r} is "
                                  "not supported (only version 1, libhdf5's default)")
        if len(head) < HEADER_PREFIX + size:
            head = self._pread(HEADER_PREFIX + size, addr, f"object header of {what!r}")
        blocks = [(head, HEADER_PREFIX, HEADER_PREFIX + size)]
        out = []
        while blocks and len(out) < n_msgs:
            block, pos, end = blocks.pop(0)
            while pos + 8 <= end and len(out) < n_msgs:
                mtype, msize, flags = struct.unpack_from("<HHB", block, pos)
                pos += 8
                if mtype == MSG_CONTINUATION:
                    c_addr, c_size = struct.unpack_from("<QQ", block, pos)
                    blocks.append((self._pread(c_size, c_addr, f"header continuation of {what!r}"),
                                   0, c_size))
                out.append((mtype, flags, block, pos))
                pos += msize
        return out

    def _links(self, header: int, stab, what: str) -> Dict[str, Tuple[int, tuple]]:
        """name -> (object header address, cached (B-tree, heap) or None) of
        the old-style group whose header is at ``header``."""
        if stab is None:
            msgs = self._messages(header, what)
            found = [(block, pos) for mtype, _, block, pos in msgs if mtype == MSG_STAB]
            if not found:
                if any(m[0] in (MSG_LINK, MSG_LINK_INFO) for m in msgs):
                    raise HDF5FormatError(f"{self.path}: group {what!r} uses new-style links "
                                          "(libver 'latest'), which are not supported")
                raise HDF5FormatError(f"{self.path}: {what!r} is not a group")
            stab = struct.unpack_from("<QQ", *found[0])
        btree, heap_addr = stab
        prefix = self._pread(32, heap_addr, f"local heap of {what!r}")
        if prefix[:4] != b"HEAP":
            raise HDF5FormatError(f"{self.path}: no local heap for {what!r} at {heap_addr}")
        heap_size, _, data_addr = struct.unpack_from("<QQQ", prefix, 8)
        heap = self._pread(heap_size, data_addr, f"local heap data of {what!r}")
        links = {}
        self._walk(btree, heap, links, what)
        return links

    def _walk(self, addr: int, heap: bytes, links: dict, what: str) -> None:
        node_size = 24 + 2 * self.internal_k * 16 + 8
        node = os.pread(self.fd, node_size, self.base + addr)
        if node[:4] != b"TREE" or node[4] != 0:
            raise HDF5FormatError(f"{self.path}: no group B-tree node for {what!r} at {addr}")
        level, used = node[5], struct.unpack_from("<H", node, 6)[0]
        children = struct.unpack_from(f"<{2 * used + 1}Q", node, 24)[1::2]
        for child in children:
            if level > 0:
                self._walk(child, heap, links, what)
                continue
            snod = self._pread(8 + 2 * self.leaf_k * ENTRY_SIZE, child,
                               f"symbol table node of {what!r}")
            if snod[:4] != b"SNOD":
                raise HDF5FormatError(f"{self.path}: no symbol table node for {what!r} at {child}")
            n = struct.unpack_from("<H", snod, 6)[0]
            for e in np.frombuffer(snod, _ENTRY, n, 8).tolist():
                off = e[0]
                name = heap[off:heap.index(b"\0", off)].decode()
                links[name] = (e[1], (e[4], e[5]) if e[2] == 1 else None)

    # -- datasets
    def _read_dataset(self, addr: int, what: str) -> np.ndarray:
        shape = dtype = layout = None
        for mtype, flags, block, pos in self._messages(addr, what):
            if mtype in (MSG_DATASPACE, MSG_DATATYPE, MSG_LAYOUT) and flags & 0x02:
                raise HDF5FormatError(f"{self.path}: dataset {what!r} has a shared (committed) "
                                      "message, which is not supported")
            if mtype == MSG_DATASPACE:
                shape = self._dataspace(block, pos, what)
            elif mtype == MSG_DATATYPE:
                dtype = self._datatype(block, pos, what)[0]
            elif mtype == MSG_LAYOUT:
                layout = (block, pos)
            elif mtype == MSG_FILTERS:
                raise HDF5FormatError(f"{self.path}: dataset {what!r} is filtered (compressed), "
                                      "which is not supported")
            elif mtype == MSG_STAB:
                raise HDF5FormatError(f"{self.path}: {what!r} is a group, not a dataset")
        if shape is None or dtype is None or layout is None:
            raise HDF5FormatError(f"{self.path}: {what!r} is not a dataset")
        is_bool = dtype is np.bool_
        stored = np.dtype(np.int8) if is_bool else dtype
        out = np.empty(shape, stored)
        nbytes = out.nbytes
        block, pos = layout
        version, cls = block[pos], block[pos + 1]
        if version != 3:
            raise HDF5FormatError(f"{self.path}: layout message version {version} of dataset "
                                  f"{what!r} is not supported (only version 3)")
        if cls == 0:  # compact: the data is in the message
            size = struct.unpack_from("<H", block, pos + 2)[0]
            if size != nbytes:
                raise HDF5FormatError(f"{self.path}: dataset {what!r} holds {size} bytes, its "
                                      f"shape and type need {nbytes}")
            out.reshape(-1).view(np.uint8)[:] = np.frombuffer(block, np.uint8, size, pos + 4)
        elif cls == 1:  # contiguous
            data_addr, size = struct.unpack_from("<QQ", block, pos + 2)
            if data_addr == UNDEF:  # never written: libhdf5 reads the fill value, 0
                out.fill(0)
            elif size != nbytes:
                raise HDF5FormatError(f"{self.path}: dataset {what!r} holds {size} bytes, its "
                                      f"shape and type need {nbytes}")
            elif nbytes:
                got = os.preadv(self.fd, [out.reshape(-1).view(np.uint8)], self.base + data_addr)
                if got != nbytes:
                    raise HDF5FormatError(f"{self.path}: the data of {what!r} runs past the end "
                                          "of the file")
        else:
            kind = {2: "chunked", 3: "virtual"}.get(cls, f"class {cls}")
            raise HDF5FormatError(f"{self.path}: dataset {what!r} has {kind} storage, which is "
                                  "not supported (only contiguous and compact)")
        return out.view(np.bool_) if is_bool else out

    def _dataspace(self, block: bytes, pos: int, what: str) -> tuple:
        version, rank, flags = block[pos], block[pos + 1], block[pos + 2]
        if version == 1:
            dims = pos + 8
        elif version == 2:
            if block[pos + 3] == 2:
                raise HDF5FormatError(f"{self.path}: dataset {what!r} has a null dataspace")
            dims = pos + 4
        else:
            raise HDF5FormatError(f"{self.path}: dataspace version {version} of {what!r} is "
                                  "not supported")
        return struct.unpack_from(f"<{rank}Q", block, dims)

    def _datatype(self, block: bytes, pos: int, what: str):
        """(dtype, or np.bool_ for h5py's boolean enum; offset after the
        datatype's properties)."""
        cls = block[pos] & 0x0F
        bits = block[pos + 1] | block[pos + 2] << 8 | block[pos + 3] << 16
        size = struct.unpack_from("<I", block, pos + 4)[0]
        props = pos + 8
        order = ">" if bits & 1 else "<"
        if cls == 0:  # fixed-point
            offset, precision = struct.unpack_from("<HH", block, props)
            if offset or precision != 8 * size or size not in (1, 2, 4, 8):
                raise HDF5FormatError(f"{self.path}: the {precision}-bit integer at bit {offset} "
                                      f"of {size} bytes of {what!r} is not supported")
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}"), props + 4
        if cls == 1:  # floating-point
            offset, precision, e_loc, e_size, m_loc, m_size, bias = struct.unpack_from(
                "<HHBBBBI", block, props)
            if (bits & 0x40 or offset or precision != 8 * size
                    or (e_loc, e_size, m_size, bias) != _IEEE.get(size) or m_loc):
                raise HDF5FormatError(f"{self.path}: the floating-point type of {what!r} is not "
                                      "an IEEE binary16, 32 or 64")
            return np.dtype(f"{order}f{size}"), props + 12
        if cls == 8:  # enumeration: h5py's boolean
            n = bits & 0xFFFF
            base, pos_names = self._datatype(block, props, what)
            names = []
            for _ in range(n):
                end = block.index(b"\0", pos_names)
                names.append(block[pos_names:end])
                # versions 1 and 2 pad each name to 8 bytes with its terminator
                pos_names = (pos_names + _pad8(end - pos_names + 1) if block[pos] >> 4 < 3
                             else end + 1)
            values = np.frombuffer(block, base, n, pos_names).tolist()
            if tuple(names) != _BOOL_MEMBERS or values != [0, 1] or base.itemsize != 1:
                raise HDF5FormatError(f"{self.path}: the enumeration of {what!r} is not h5py's "
                                      "boolean (FALSE = 0, TRUE = 1 over int8)")
            return np.bool_, pos_names + n
        kind = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 9: "variable-length", 10: "array"}.get(cls, f"class {cls}")
        raise HDF5FormatError(f"{self.path}: dataset {what!r} has a {kind} type, which is not "
                              "supported")


# ---------------------------------------------------------------------- writer
def _datatype_message(dtype: np.dtype, key: str) -> bytes:
    if dtype == np.bool_:  # h5py's boolean: an enum over int8
        base = _datatype_message(np.dtype(np.int8), key)
        names = b"".join(_padded_name(n) for n in _BOOL_MEMBERS)
        return struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + base + names + b"\0\1"
    order = 1 if dtype.byteorder == ">" else 0
    if dtype.kind in "iu":
        signed = 0x08 if dtype.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, order | signed, 0, 0, dtype.itemsize, 0,
                           8 * dtype.itemsize)
    if dtype.kind == "f" and dtype.itemsize in _IEEE:
        e_loc, e_size, m_size, bias = _IEEE[dtype.itemsize]
        return struct.pack("<BBBBIHHBBBBI", 0x11, order | 0x20, 8 * dtype.itemsize - 1, 0,
                           dtype.itemsize, 0, 8 * dtype.itemsize, e_loc, e_size, 0, m_size, bias)
    raise TypeError(f"cannot store {key!r} of dtype {dtype}: the store holds integers, IEEE "
                    "floats and booleans")


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data += b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class Writer:
    """Writes groups of datasets under a new file's root group, as libhdf5
    does under h5py's defaults (contiguous datasets, old-style groups). Each
    group is written whole when it is added; ``close`` writes the root
    group's index and the superblock."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self.file = open(self.path, "wb")
        # the superblock is written last: until then the file is no HDF5 file
        self.file.write(b"\0" * SUPERBLOCK_SIZE)
        self.pos = SUPERBLOCK_SIZE
        self.members: Dict[bytes, Tuple[int, int, int]] = {}  # name -> (header, B-tree, heap)

    def _put(self, data: bytes) -> int:
        """Appends ``data`` at the next 8-byte boundary; returns its address."""
        pad = _pad8(self.pos) - self.pos
        if pad:
            self.file.write(b"\0" * pad)
        addr = self.pos + pad
        self.file.write(data)
        self.pos = addr + len(data)
        return addr

    def add_group(self, name: str, arrays: Dict[str, object]) -> None:
        """A group ``name`` under the root holding one dataset per entry of
        ``arrays`` (numpy arrays or scalars, converted as ``np.asarray``
        converts them)."""
        key = name.encode()
        if key in self.members or not key or b"/" in key or b"\0" in key:
            raise ValueError(f"cannot add group {name!r}: the name is taken or not a link name")
        entries = {}
        for attr, value in arrays.items():
            arr = np.asarray(value)
            data_msg = _datatype_message(arr.dtype, attr)
            data = arr.tobytes()
            addr = self._put(data) if data else UNDEF
            dims = struct.pack(f"<{arr.ndim}Q", *arr.shape)
            header = _object_header([
                # version 1, with the maximum dimensions (equal) for a simple dataspace
                _message(MSG_DATASPACE, struct.pack("<BBB5x", 1, arr.ndim, 1 if arr.ndim else 0)
                         + dims + dims),
                _message(MSG_DATATYPE, data_msg, flags=1),
                # fill value message version 2: late allocation, fill if set, defined (default)
                _message(MSG_FILL, struct.pack("<BBBBI", 2, 2, 2, 1, 0), flags=1),
                _message(MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, addr, len(data))),
            ])
            entries[attr.encode()] = (self._put(header), 0, 0)
        btree, heap = self._group_index(entries)
        header = _object_header([_message(MSG_STAB, struct.pack("<QQ", btree, heap))])
        self.members[key] = (self._put(header), btree, heap)

    def _group_index(self, entries: Dict[bytes, Tuple[int, int, int]]) -> Tuple[int, int]:
        """Writes a group's local heap, symbol-table nodes and B-tree over
        ``entries`` (name -> (object header, cached B-tree, cached heap; 0
        for a dataset)); returns the B-tree's and the heap's addresses."""
        names = sorted(entries)  # libhdf5 orders links by strcmp
        heap_data, offsets = bytearray(8), {}  # offset 0: the empty name of the first key
        for n in names:
            offsets[n] = len(heap_data)
            heap_data += _padded_name(n)
        heap = self._put(b"HEAP\0\0\0\0" + struct.pack("<QQQ", len(heap_data), FREE_NULL,
                                                       _pad8(self.pos) + 32) + heap_data)
        # level 0: symbol-table nodes of up to 2 LEAF_K links; each node's key
        # is its last name (the first key of a level is the empty name)
        per_node = 2 * LEAF_K
        level = []  # (address, last name's offset)
        for i in range(0, len(names), per_node):
            chunk = names[i:i + per_node]
            body = bytearray(b"SNOD\1\0" + struct.pack("<H", len(chunk)))
            for n in chunk:
                header, btree, heap_addr = entries[n]
                body += struct.pack("<QQII", offsets[n], header, 1 if btree else 0, 0)
                body += struct.pack("<QQ", btree, heap_addr)
            body += b"\0" * (8 + per_node * ENTRY_SIZE - len(body))
            level.append((self._put(bytes(body)), offsets[chunk[-1]]))
        # B-tree nodes of up to 2 INTERNAL_K children, level by level up to one root
        depth, node_size = 0, 24 + 2 * INTERNAL_K * 16 + 8
        while True:
            groups = [level[i:i + 2 * INTERNAL_K]
                      for i in range(0, len(level), 2 * INTERNAL_K)] or [[]]  # an empty group
            # the level's nodes go one after another
            addrs = [_pad8(self.pos) + j * node_size for j in range(len(groups))]
            upper, left_key = [], 0
            for j, children in enumerate(groups):
                left = addrs[j - 1] if j else UNDEF
                right = addrs[j + 1] if j + 1 < len(groups) else UNDEF
                body = bytearray(b"TREE" + struct.pack("<BBHQQ", 0, depth, len(children),
                                                       left, right))
                body += struct.pack("<Q", left_key)
                for child, key in children:
                    body += struct.pack("<QQ", child, key)
                body += b"\0" * (node_size - len(body))
                if self._put(bytes(body)) != addrs[j]:
                    raise AssertionError("B-tree nodes out of place")
                left_key = children[-1][1] if children else 0
                upper.append((addrs[j], left_key))
            if len(upper) == 1:
                return upper[0][0], heap
            level, depth = upper, depth + 1

    def close(self) -> None:
        """Writes the root group and the superblock, and closes the file."""
        if self.file is None:
            return
        try:
            btree, heap = self._group_index(self.members)
            root = self._put(_object_header([_message(MSG_STAB, struct.pack("<QQ", btree, heap))]))
            self.file.seek(0)
            self.file.write(
                SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
                + struct.pack("<QQQQ", 0, UNDEF, self.pos, UNDEF)
                + struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree, heap))
        finally:
            self.file.close()
            self.file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
