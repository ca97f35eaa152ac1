"""OCDBT key-value stores, read-only, without tensorstore.

OCDBT ("optionally-cooperative distributed B+tree") is the on-disk
key-value format of tensorstore's "ocdbt" kvstore driver, in which
Orbax writes a checkpoint's arrays (train/jax_checkpoint.py). A database
is a directory:

  manifest.ocdbt   the config and the newest versions of the tree;
  d/<id>           data files: B+tree nodes and values stored out of line.

Orbax writes one sub-database per process under `ocdbt.process_<i>/` and
a root database whose tree holds every key; the root's values point
into the sub-databases' data files. `open_store(path)` reads the root,
or, where a directory has no root manifest, the union of its
sub-databases.

Every manifest and node is an envelope: a magic number (uint32 big
endian: 0x0cdb3a2a for a manifest, 0x0cdb20de for a node), the file's
length (uint64 little endian), the format version (varint, 0), the
compression (varint: 0 none, 1 zstd), the body, and the CRC-32C of all
that (uint32 little endian). In the body integers are LEB128 varints
and arrays are stored column by column:

  config: uuid (16 bytes), manifest kind (0 single; numbered manifests
    are refused), max inline value bytes, max decoded node bytes, version
    tree arity log2 (1 byte), compression (0, or 1 then an int32 level);
  data file table: count n, path prefix lengths shared with the previous
    path [n - 1], suffix lengths [n], base path lengths [n], then the
    suffixes; a file is base path + relative path under the root;
  manifest versions: the table, count, generation [n], root height [n,
    1 byte], root file index [n], offset [n], length [n] (2**64 - 1 for
    an empty tree), key count [n], tree bytes [n], indirect bytes [n],
    commit time [n, uint64]; then the version tree nodes (older
    versions, which are not read);
  B+tree node: height (1 byte), the table, entry count, key prefix
    lengths shared with the previous key [n - 1], key suffix lengths
    [n], in an interior node the subtree's common prefix lengths [n],
    then the key suffixes. A leaf then has value lengths [n], value
    kinds [n] (0 inline, 1 out of line), file index [k] and offset [k]
    of the k out-of-line values, and the inline values concatenated; an
    interior node has each child's file index, offset, length, key
    count, tree bytes and indirect bytes [n]. Keys are stored relative
    to the prefix their ancestors share; a child's keys drop the
    common prefix of its subtree.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from livecell_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1
MANIFEST = "manifest.ocdbt"


class OcdbtError(ValueError):
    """An OCDBT database that does not read (corrupt, truncated, or in a
    layout the reader refuses)."""


@dataclass(frozen=True)
class ValueRef:
    """A value stored out of line: `length` bytes at `offset` of the data
    file `file` (a path under the database's root)."""

    file: str
    offset: int
    length: int


Value = Union[bytes, ValueRef]


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.at, self.what = data, 0, what

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            if self.at >= len(self.data) or shift > 63:
                raise OcdbtError(f"OCDBT {self.what}: truncated varint")
            b = self.data[self.at]
            self.at += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            raise OcdbtError(f"OCDBT {self.what}: truncated")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def end(self) -> None:
        if self.at != len(self.data):
            raise OcdbtError(f"OCDBT {self.what}: {len(self.data) - self.at} "
                             f"bytes after its end")


def envelope(data: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file, its checksum verified."""
    if len(data) < 18:
        raise OcdbtError(f"OCDBT {what}: truncated ({len(data)} bytes)")
    (got_magic,) = struct.unpack_from(">I", data)
    if got_magic != magic:
        raise OcdbtError(f"OCDBT {what}: magic {got_magic:#010x}, expected "
                         f"{magic:#010x}")
    (length,) = struct.unpack_from("<Q", data, 4)
    if length != len(data):
        raise OcdbtError(f"OCDBT {what}: records {length} bytes, has "
                         f"{len(data)}")
    (crc,) = struct.unpack_from("<I", data, len(data) - 4)
    if zstd.crc32c(data[:-4]) != crc:
        raise OcdbtError(f"OCDBT {what}: CRC-32C mismatch")
    head = _Cursor(data[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OcdbtError(f"OCDBT {what}: format version {version}")
    body = head.data[head.at:]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise OcdbtError(f"OCDBT {what}: compression format {compression}")


def _file_table(cur: _Cursor) -> List[str]:
    n = cur.varint()
    if n == 0:
        return []
    prefix = [0] + cur.varints(n - 1)
    suffix = cur.varints(n)
    base = cur.varints(n)
    paths: List[str] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"OCDBT {cur.what}: data file path prefix past "
                             f"the previous path")
        full = prev[:prefix[i]] + cur.take(suffix[i])
        if base[i] > len(full):
            raise OcdbtError(f"OCDBT {cur.what}: base path past its path")
        paths.append(full.decode())
        prev = full
    return paths


def _keys(cur: _Cursor, n: int, interior: bool
          ) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else []
    keys: List[bytes] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"OCDBT {cur.what}: key prefix past the "
                             f"previous key")
        prev = prev[:prefix[i]] + cur.take(suffix[i])
        keys.append(prev)
    return keys, common


def _file(files: List[str], i: int, what: str) -> str:
    if i >= len(files):
        raise OcdbtError(f"OCDBT {what}: data file index {i} of "
                         f"{len(files)}")
    return files[i]


@dataclass
class Manifest:
    """The newest version: its tree's root node (None for an empty
    tree), the root's height and the key count."""

    root: Optional[ValueRef]
    root_height: int
    num_keys: int


def parse_manifest(data: bytes, what: str = "manifest") -> Manifest:
    cur = _Cursor(envelope(data, MANIFEST_MAGIC, what), what)
    cur.take(16)                      # uuid
    kind = cur.varint()
    if kind != 0:
        raise OcdbtError(f"OCDBT {what}: numbered manifests (kind {kind}) "
                         f"are not supported")
    cur.varint()                      # max inline value bytes
    cur.varint()                      # max decoded node bytes
    cur.byte()                        # version tree arity log2
    compression = cur.varint()
    if compression == 1:
        cur.take(4)                   # zstd level, int32
    elif compression != 0:
        raise OcdbtError(f"OCDBT {what}: compression method {compression}")
    files = _file_table(cur)
    n = cur.varint()
    if n == 0:
        raise OcdbtError(f"OCDBT {what}: no versions")
    gens = cur.varints(n)
    heights = list(cur.take(n))
    fids, offs, lens = cur.varints(n), cur.varints(n), cur.varints(n)
    nkeys = cur.varints(n)
    cur.varints(n)                    # tree bytes
    cur.varints(n)                    # indirect value bytes
    cur.u64s(n)                       # commit times
    # Older versions (the version tree's nodes) follow; the newest
    # version, the last of the inline ones, is the one read.
    nodes = cur.varint()
    for _ in range(5):
        cur.varints(nodes)
    cur.u64s(nodes)
    cur.take(nodes)
    cur.end()
    last = max(range(n), key=lambda i: gens[i])
    root = None
    if not (offs[last] == MISSING and lens[last] == MISSING):
        root = ValueRef(_file(files, fids[last], what), offs[last],
                        lens[last])
    return Manifest(root, heights[last], nkeys[last])


def parse_node(data: bytes, what: str = "B+tree node"):
    """(height, [(key, value or child)]) of a node: a leaf's values are
    inline bytes or ValueRef; an interior node's children are
    (ValueRef of the child node, common prefix length of its subtree)."""
    cur = _Cursor(envelope(data, NODE_MAGIC, what), what)
    height = cur.byte()
    files = _file_table(cur)
    n = cur.varint()
    keys, common = _keys(cur, n, height > 0)
    if height > 0:
        fids, offs, lens = cur.varints(n), cur.varints(n), cur.varints(n)
        for _ in range(3):            # key count, tree and indirect bytes
            cur.varints(n)
        cur.end()
        return height, [
            (k, (ValueRef(_file(files, f, what), o, ln), c))
            for k, f, o, ln, c in zip(keys, fids, offs, lens, common)]
    lens = cur.varints(n)
    kinds = cur.varints(n)
    if any(k > 1 for k in kinds):
        raise OcdbtError(f"OCDBT {what}: value kind {max(kinds)}")
    k = sum(kinds)
    fids, offs = cur.varints(k), cur.varints(k)
    out: List[Tuple[bytes, Value]] = []
    j = 0
    for key, ln, kind in zip(keys, lens, kinds):
        if kind:
            out.append((key, ValueRef(_file(files, fids[j], what), offs[j],
                                      ln)))
            j += 1
        else:
            out.append((key, cur.take(ln)))
    cur.end()
    return 0, out


class Database:
    """The newest version of one OCDBT database (a directory holding
    manifest.ocdbt): its keys and their values. `bytes_read` counts the
    bytes read from the data files (nodes and values)."""

    def __init__(self, root):
        self.root = Path(root)
        self.bytes_read = 0
        path = self.root / MANIFEST
        if not path.exists():
            raise OcdbtError(f"{self.root} holds no {MANIFEST}")
        self.manifest = parse_manifest(path.read_bytes(), str(path))
        self.entries: Dict[bytes, Value] = {}
        if self.manifest.root is not None:
            self._walk(self.manifest.root, b"", self.manifest.root_height)
        if len(self.entries) != self.manifest.num_keys:
            raise OcdbtError(f"OCDBT {self.root}: {len(self.entries)} keys, "
                             f"the manifest records "
                             f"{self.manifest.num_keys}")

    def read_ref(self, ref: ValueRef) -> bytes:
        path = self.root / ref.file
        try:
            with open(path, "rb") as f:
                data = os.pread(f.fileno(), ref.length, ref.offset)
        except OSError as e:
            raise OcdbtError(f"OCDBT data file {path}: {e}") from None
        if len(data) != ref.length:
            raise OcdbtError(f"OCDBT data file {path}: {ref.length} bytes at "
                             f"{ref.offset} past its end")
        self.bytes_read += len(data)
        return data

    def _walk(self, ref: ValueRef, prefix: bytes, height: int) -> None:
        what = f"node {ref.file}@{ref.offset} of {self.root}"
        got, items = parse_node(self.read_ref(ref), what)
        if got != height:
            raise OcdbtError(f"OCDBT {what}: height {got}, expected "
                             f"{height}")
        for key, value in items:
            if height == 0:
                self.entries[prefix + key] = value
            else:
                child, common = value
                self._walk(child, prefix + key[:common], height - 1)

    def keys(self) -> List[bytes]:
        return sorted(self.entries)

    def get(self, key: bytes) -> bytes:
        value = self.entries[key]
        return self.read_ref(value) if isinstance(value, ValueRef) else value


class MergedStore:
    """The union of several databases' keys (Orbax's per-process
    sub-databases where no root database merges them); a key in two of
    them raises."""

    def __init__(self, dbs: List[Database]):
        self.dbs = dbs
        self.owner: Dict[bytes, Database] = {}
        for db in dbs:
            for key in db.entries:
                if key in self.owner:
                    raise OcdbtError(f"OCDBT key {key!r} in {db.root} and "
                                     f"{self.owner[key].root}")
                self.owner[key] = db

    @property
    def bytes_read(self) -> int:
        return sum(db.bytes_read for db in self.dbs)

    def keys(self) -> List[bytes]:
        return sorted(self.owner)

    def get(self, key: bytes) -> bytes:
        return self.owner[key].get(key)


def open_store(path):
    """The database at `path`: its root database where it has a
    manifest, else the union of its `ocdbt.process_<i>` sub-databases."""
    path = Path(path)
    if (path / MANIFEST).exists():
        return Database(path)
    subs = sorted(p for p in path.glob("ocdbt.process_*")
                  if (p / MANIFEST).exists())
    if not subs:
        raise OcdbtError(f"{path} holds no OCDBT database")
    return MergedStore([Database(p) for p in subs])
