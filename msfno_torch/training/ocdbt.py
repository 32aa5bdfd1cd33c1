"""The OCDBT key-value store of an Orbax checkpoint, read and written
without tensorstore (its on-disk format: a manifest, a version tree and a
b-tree of prefix-compressed keys, over data files).

Every manifest and node is a container: a big-endian magic, the u64
little-endian length of the whole file, varints for the format version (0)
and the compression (0 none, 1 zstd), the body, and the crc32c of all
bytes before it as a u32 little-endian footer, which is checked on read.

The manifest body: the config (uuid, manifest kind, max inline value
bytes, max decoded node bytes, version tree arity, compression and its
zstd level), a data-file table, the newest versions inline and
references to version-tree nodes.  A version names its b-tree root: a data
file, an offset and a length.  A b-tree node holds its height, its own
data-file table and its entries in columns: leaves keys and values (inline,
or a data file, offset and length), interior nodes keys, the common prefix
their subtree drops from its keys, and child references.  Data-file paths
carry a base path that the nodes they hold resolve their own paths against;
that is how the root manifest of a multi-process save reads the trees under
`ocdbt.process_<i>/` as one store.

`OcdbtReader` reads a store; `write_store` writes one process's store: a
manifest with an inline version tree, one leaf node and one data file,
compressed as zstd frames of Raw/RLE blocks (`utils.zstd.frame`).
"""

from __future__ import annotations

import os
import time
import uuid

from msfno_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_NODE_MAGIC = 0x0CDB1234
MAX_INLINE_VALUE_BYTES = 1024  # Orbax's setting
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


class _Cursor:
    """A position in a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated at byte {self.pos} (wanted {n})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} bytes after its end")


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def read_container(data: bytes, magic: int, what: str) -> bytes:
    """The decoded body of a manifest or node file (header, crc32c footer
    and compression checked)."""
    if len(data) < 4 + 8 + 2 + 4:
        raise ValueError(f"{what}: {len(data)} bytes, too short")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise ValueError(f"{what}: magic {got:08x}, expected {magic:08x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise ValueError(f"{what}: header says {length} bytes, the file has {len(data)}")
    want_crc = int.from_bytes(data[-4:], "little")
    if zstd.crc32c(memoryview(data)[:-4]) != want_crc:
        raise ValueError(f"{what}: crc32c mismatch")
    r = _Cursor(data[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}, only 0 is known")
    body = data[r.pos:-4]
    if compression == 0:
        return bytes(body)
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"{what}: compression {compression} is not known")


def container(magic: int, body: bytes) -> bytes:
    """A manifest or node file of `body`: zstd-compressed (Raw/RLE
    blocks), with its crc32c footer."""
    payload = zstd.frame(body)
    head = _varint(0) + _varint(1)
    total = 4 + 8 + len(head) + len(payload) + 4
    data = magic.to_bytes(4, "big") + total.to_bytes(8, "little") + head + payload
    return data + zstd.crc32c(data).to_bytes(4, "little")


def _data_file_table(r: _Cursor, base: str) -> list[tuple[str, str]]:
    """[(path from the store's root, the base its nodes resolve against)]:
    paths are prefix-compressed against the previous one, each split into
    a base path and a relative path."""
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix, base_len = r.varints(n), r.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: data file path prefix past the previous path")
        full = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(full):
            raise ValueError(f"{r.what}: data file base path longer than its path")
        out.append((base + full.decode(), base + full[:base_len[i]].decode()))
        prev = full
    return out


def _file(files, i: int, what: str) -> tuple[str, str]:
    if i >= len(files):
        raise ValueError(f"{what}: data file {i} of a table of {len(files)}")
    return files[i]


def _read_config(r: _Cursor) -> dict:
    cfg = dict(uuid=r.take(16).hex(), manifest_kind=r.varint(),
               max_inline_value_bytes=r.varint(), max_decoded_node_bytes=r.varint(),
               version_tree_arity_log2=r.u8(), compression=r.varint())
    if cfg["compression"] == 1:
        cfg["zstd_level"] = int.from_bytes(r.take(4), "little", signed=True)
    elif cfg["compression"] != 0:
        raise ValueError(f"{r.what}: compression method {cfg['compression']} is not known")
    return cfg


def _version_entries(r: _Cursor, files) -> list[dict]:
    """Versions, as the manifest holds them inline and version-tree leaves
    hold them."""
    n = r.varint()
    gen, height = r.varints(n), [r.u8() for _ in range(n)]
    fid, off, length = r.varints(n), r.varints(n), r.varints(n)
    keys, tree_bytes, indirect = r.varints(n), r.varints(n), r.varints(n)
    times = [r.u64() for _ in range(n)]
    return [dict(generation=gen[i], root_height=height[i],
                 root=(*_file(files, fid[i], r.what), off[i], length[i]),
                 num_keys=keys[i], num_tree_bytes=tree_bytes[i],
                 num_indirect_value_bytes=indirect[i], commit_time_ns=times[i])
            for i in range(n)]


def _version_refs(r: _Cursor, files, heights: bool, height: int = 0) -> list[dict]:
    """References to version-tree nodes: the manifest's carry each one's
    height, an interior node's are one below its own."""
    n = r.varint()
    gen, fid, off, length = r.varints(n), r.varints(n), r.varints(n), r.varints(n)
    count, times = r.varints(n), [r.u64() for _ in range(n)]
    hs = [r.u8() for _ in range(n)] if heights else [height - 1] * n
    return [dict(generation=gen[i], node=(*_file(files, fid[i], r.what), off[i], length[i]),
                 num_generations=count[i], commit_time_ns=times[i], height=hs[i])
            for i in range(n)]


class OcdbtReader:
    """The newest version of the store under `root` (a directory with
    `manifest.ocdbt`): `keys()`, `read(key)`."""

    def __init__(self, root: str):
        self.root = root
        body = read_container(self._raw(("manifest.ocdbt", "", 0, -1)), MANIFEST_MAGIC,
                              f"{root}/manifest.ocdbt")
        r = _Cursor(body, f"{root}/manifest.ocdbt")
        self.config = _read_config(r)
        if self.config["manifest_kind"] != 0:
            raise NotImplementedError(f"{root}: a numbered OCDBT manifest (kind "
                                      f"{self.config['manifest_kind']}) is not read here")
        files = _data_file_table(r, "")
        self._inline_versions = _version_entries(r, files)
        self._version_nodes = _version_refs(r, files, heights=True)
        r.done()
        self._handles: dict = {}
        self.entries = self._collect(self.latest())

    def _raw(self, ref) -> bytes:
        path, _, offset, length = ref
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read() if length < 0 else f.read(length)
        if length >= 0 and len(data) != length:
            raise ValueError(f"{self.root}/{path}: {len(data)} bytes at {offset}, wanted {length}")
        return data

    def _version_node(self, ref: dict) -> tuple[list[dict], list[dict]]:
        what = f"{self.root}/{ref['node'][0]}@{ref['node'][2]}"
        r = _Cursor(read_container(self._raw(ref["node"]), VERSION_NODE_MAGIC, what), what)
        r.u8()  # the arity it was written with
        height = r.u8()
        if height != ref["height"]:
            raise ValueError(f"{what}: version node of height {height}, expected {ref['height']}")
        files = _data_file_table(r, ref["node"][1])
        if height == 0:
            out = (_version_entries(r, files), [])
        else:
            out = ([], _version_refs(r, files, heights=False, height=height))
        r.done()
        return out

    def versions(self) -> list[dict]:
        """Every version the store holds, oldest first: those in
        version-tree nodes, then the manifest's inline ones."""
        out, stack = [], list(self._version_nodes)
        while stack:
            leaves, refs = self._version_node(stack.pop(0))
            out.extend(leaves)
            stack[:0] = refs
        return sorted(out + self._inline_versions, key=lambda v: v["generation"])

    def latest(self) -> dict:
        if self._inline_versions:
            return max(self._inline_versions, key=lambda v: v["generation"])
        if not self._version_nodes:
            raise ValueError(f"{self.root}: the manifest holds no version")
        return self.versions()[-1]

    def _collect(self, version: dict) -> dict:
        """key -> inline bytes or (path, offset, length), over the b-tree."""
        entries: dict = {}
        if version["num_keys"] == 0:
            return entries
        stack = [(version["root"], version["root_height"], b"")]
        while stack:
            ref, height, prefix = stack.pop()
            what = f"{self.root}/{ref[0]}@{ref[2]}"
            r = _Cursor(read_container(self._raw(ref), BTREE_MAGIC, what), what)
            if r.u8() != height:
                raise ValueError(f"{what}: b-tree node height differs from its reference")
            files = _data_file_table(r, ref[1])
            n = r.varint()
            kp = [0] + r.varints(n - 1) if n else []
            ks = r.varints(n)
            common = r.varints(n) if height > 0 else None
            keys, prev = [], b""
            for i in range(n):
                if kp[i] > len(prev):
                    raise ValueError(f"{what}: key prefix past the previous key")
                prev = prev[:kp[i]] + r.take(ks[i])
                keys.append(prev)
            if height > 0:
                fid, off, length = r.varints(n), r.varints(n), r.varints(n)
                r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
                for i in reversed(range(n)):
                    child = (*_file(files, fid[i], what), off[i], length[i])
                    stack.append((child, height - 1, prefix + keys[i][:common[i]]))
            else:
                lengths = r.varints(n)
                kinds = r.varints(n)
                indirect = [i for i in range(n) if kinds[i] == 1]
                if any(k not in (0, 1) for k in kinds):
                    raise ValueError(f"{what}: value kind other than inline / indirect")
                fid, off = r.varints(len(indirect)), r.varints(len(indirect))
                for j, i in enumerate(indirect):
                    path, _ = _file(files, fid[j], what)
                    entries[(prefix + keys[i]).decode()] = (path, off[j], lengths[i])
                for i in range(n):
                    if kinds[i] == 0:
                        entries[(prefix + keys[i]).decode()] = r.take(lengths[i])
            r.done()
        if len(entries) != version["num_keys"]:
            raise ValueError(f"{self.root}: the b-tree holds {len(entries)} keys, its version "
                             f"{version['num_keys']}")
        return entries

    def keys(self) -> list[str]:
        return sorted(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def read(self, key: str) -> bytes:
        v = self.entries[key]
        if isinstance(v, bytes):
            return v
        path, offset, length = v
        f = self._handles.get(path)
        if f is None:
            f = self._handles[path] = open(os.path.join(self.root, path), "rb")
        f.seek(offset)
        data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{self.root}/{path}: value of {key} truncated")
        return data

    def close(self) -> None:
        for f in self._handles.values():
            f.close()
        self._handles.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _size(value) -> int:
    return sum(len(memoryview(p).cast("B")) for p in value)


def _write_parts(fd: int, parts: list) -> None:
    """Write byte strings one after another to `fd` with as few system
    calls as writev allows (IOV_MAX at a time): a background writer then
    takes the GIL back a few times for a whole store, not once a block."""
    views = [memoryview(p).cast("B") for p in parts]
    i, most = 0, os.sysconf("SC_IOV_MAX")
    while i < len(views):
        n = os.writev(fd, views[i:i + most])
        while i < len(views) and n >= len(views[i]):
            n -= len(views[i])
            i += 1
        if n:  # a short write ends inside views[i]
            views[i] = views[i][n:]


def write_store(root: str, items: dict) -> None:
    """Write a store of `items` (key -> a list of byte strings that make
    its value, written one after another) under `root`: one data file
    `d/<uuid>` holding the values above MAX_INLINE_VALUE_BYTES and then the
    leaf node, and `manifest.ocdbt` with one inline version."""
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    name = f"d/{uuid.uuid4().hex}"
    keys = sorted(items, key=lambda k: k.encode())
    lengths, indirect_off, inline, data = [], {}, [], []
    offset = 0
    with open(os.path.join(root, name), "wb", buffering=0) as f:
        for k in keys:
            size = _size(items[k])
            lengths.append(size)
            if size > MAX_INLINE_VALUE_BYTES:
                indirect_off[k] = offset
                data.extend(items[k])
                offset += size
            else:
                inline.append(b"".join(bytes(memoryview(p).cast("B")) for p in items[k]))
        kb = [k.encode() for k in keys]
        prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(kb, kb[1:])]
        table = _varint(0) if not indirect_off else (
            _varint(1) + _varint(len(name)) + _varint(0) + name.encode())
        body = b"".join([
            bytes([0]), table, _varint(len(kb)),
            *map(_varint, prefix), *(_varint(len(k) - p) for k, p in zip(kb, [0] + prefix)),
            *(k[p:] for k, p in zip(kb, [0] + prefix)),
            *map(_varint, lengths), *(_varint(int(k in indirect_off)) for k in keys),
            *(_varint(0) for k in keys if k in indirect_off),
            *(_varint(indirect_off[k]) for k in keys if k in indirect_off),
            *inline])
        node = container(BTREE_MAGIC, body)
        _write_parts(f.fileno(), data + [node])
    manifest = b"".join([
        uuid.uuid4().bytes, _varint(0), _varint(MAX_INLINE_VALUE_BYTES),
        _varint(MAX_DECODED_NODE_BYTES), bytes([VERSION_TREE_ARITY_LOG2]), _varint(1),
        (0).to_bytes(4, "little"),  # the zstd level of the config (unused by readers)
        _varint(1), _varint(len(name)), _varint(0), name.encode(),  # the data-file table
        _varint(1), _varint(1), bytes([0]), _varint(0), _varint(offset), _varint(len(node)),
        _varint(len(keys)), _varint(len(node)), _varint(offset),
        time.time_ns().to_bytes(8, "little"),
        _varint(0)])  # no version-tree nodes
    tmp = os.path.join(root, "manifest.ocdbt.tmp")
    with open(tmp, "wb") as f:
        f.write(container(MANIFEST_MAGIC, manifest))
    os.replace(tmp, os.path.join(root, "manifest.ocdbt"))
