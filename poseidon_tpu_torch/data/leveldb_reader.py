"""Dependency-free LevelDB reader/writer (the reference's default backend):
the port's copy of ``poseidon_tpu/data/leveldb_reader.py``.

Caffe's DataParameter defaults to ``backend: LEVELDB`` (caffe.proto:444); the
image has no leveldb binding, so this module implements the on-disk format
directly (the format is public domain, OpenLDAP-style clean-room from the
spec):

- **SSTables** (``*.ldb``/``*.sst``): footer → index block → data blocks;
  per-block snappy (data/snappy.py) or raw; prefix-compressed keys with
  restart points; internal keys carry an 8-byte (sequence<<8|type) trailer.
- **Write-ahead log** (``*.log``): 32 KB physical blocks of
  crc/len/type-framed fragments; logical records are WriteBatches. A
  freshly-written, never-compacted Caffe database keeps its newest entries
  only here, so replay is required for correctness.
- **MANIFEST/CURRENT**: VersionEdit log naming the live files.

Reading merges SSTables + log by user key, newest sequence wins, deletions
drop. ``LevelDBWriter`` emits a single-SSTable database (+ manifest/current)
that standard LevelDB implementations accept — used by the dataset tools for
backend parity.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

from .snappy import compress as snappy_compress
from .snappy import uncompress as snappy_uncompress

TABLE_MAGIC = 0xDB4775248B80FB57

TYPE_DELETION = 0
TYPE_VALUE = 1

LOG_FULL, LOG_FIRST, LOG_MIDDLE, LOG_LAST = 1, 2, 3, 4
LOG_BLOCK = 32768
LOG_HEADER = 7


class LevelDBError(IOError):
    pass


# --------------------------------------------------------------------------- #
# varints & crc32c
# --------------------------------------------------------------------------- #

from .varint import VarintError, read_varint as _shared_read_varint
from .varint import write_varint as _write_varint


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    try:
        return _shared_read_varint(buf, pos)
    except VarintError as e:
        raise LevelDBError(str(e)) from e


_CRC_TABLE: List[int] = []


def _crc32c_init():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_crc32c_init()


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def crc32c_masked(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# SSTable reading
# --------------------------------------------------------------------------- #

def _parse_block(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key, value) from a decoded block (prefix-compressed entries)."""
    if len(data) < 4:
        return
    n_restarts = struct.unpack_from("<I", data, len(data) - 4)[0]
    limit = len(data) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    while pos < limit:
        shared, pos = _read_varint(data, pos)
        non_shared, pos = _read_varint(data, pos)
        value_len, pos = _read_varint(data, pos)
        key = key[:shared] + data[pos:pos + non_shared]
        pos += non_shared
        value = data[pos:pos + value_len]
        pos += value_len
        yield key, value


def _read_block(buf: bytes, offset: int, size: int) -> bytes:
    data = buf[offset:offset + size]
    if len(data) != size or offset + size + 1 > len(buf):
        raise LevelDBError("truncated block")
    block_type = buf[offset + size]
    if block_type == 0:
        return data
    if block_type == 1:
        return snappy_uncompress(data)
    raise LevelDBError(f"unknown block compression {block_type}")


class SSTable:
    """One .ldb/.sst file, mmap'd; blocks decode on demand."""

    def __init__(self, path: str):
        import mmap
        self.path = path
        self._f = open(path, "rb")
        self.buf = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        if len(self.buf) < 48:
            raise LevelDBError(f"{path}: too small for an sstable")
        footer = self.buf[-48:]
        magic = struct.unpack_from("<Q", footer, 40)[0]
        if magic != TABLE_MAGIC:
            raise LevelDBError(f"{path}: bad table magic")
        pos = 0
        _, pos = _read_varint(footer, pos)       # metaindex offset
        _, pos = _read_varint(footer, pos)       # metaindex size
        index_off, pos = _read_varint(footer, pos)
        index_size, pos = _read_varint(footer, pos)
        index = _read_block(self.buf, index_off, index_size)
        self.block_handles: List[Tuple[int, int]] = []
        for _, handle in _parse_block(index):
            hpos = 0
            boff, hpos = _read_varint(handle, hpos)
            bsize, hpos = _read_varint(handle, hpos)
            self.block_handles.append((boff, bsize))

    def block_entries(self, handle: Tuple[int, int]
                      ) -> List[Tuple[bytes, int, int, bytes]]:
        """Decoded (user_key, seq, type, value) list for one data block."""
        block = _read_block(self.buf, handle[0], handle[1])
        out = []
        for ikey, value in _parse_block(block):
            if len(ikey) < 8:
                raise LevelDBError(f"{self.path}: internal key too short")
            trailer = struct.unpack("<Q", ikey[-8:])[0]
            out.append((ikey[:-8], trailer >> 8, trailer & 0xFF, value))
        return out


def read_sstable(path: str) -> Iterator[Tuple[bytes, int, int, bytes]]:
    """Yield (user_key, sequence, type, value) from one .ldb/.sst file."""
    table = SSTable(path)
    for handle in table.block_handles:
        yield from table.block_entries(handle)


# --------------------------------------------------------------------------- #
# Log reading (write-ahead log replay)
# --------------------------------------------------------------------------- #

def _log_records(buf: bytes) -> Iterator[bytes]:
    pos = 0
    pending = bytearray()
    while pos + LOG_HEADER <= len(buf):
        block_left = LOG_BLOCK - (pos % LOG_BLOCK)
        if block_left < LOG_HEADER:
            pos += block_left  # trailer padding
            continue
        length, rtype = struct.unpack_from("<HB", buf, pos + 4)
        payload = buf[pos + LOG_HEADER:pos + LOG_HEADER + length]
        if rtype == 0 and length == 0:
            break  # zeroed preallocated tail
        pos += LOG_HEADER + length
        if rtype == LOG_FULL:
            yield bytes(payload)
        elif rtype == LOG_FIRST:
            pending = bytearray(payload)
        elif rtype == LOG_MIDDLE:
            pending += payload
        elif rtype == LOG_LAST:
            pending += payload
            yield bytes(pending)
            pending = bytearray()
        else:
            return  # corrupt tail: stop like leveldb's recovery does


def read_log(path: str) -> Iterator[Tuple[bytes, int, int, bytes]]:
    """Yield (user_key, sequence, type, value) from a write-ahead log."""
    with open(path, "rb") as f:
        buf = f.read()
    for record in _log_records(buf):
        if len(record) < 12:
            continue
        seq = struct.unpack_from("<Q", record, 0)[0]
        count = struct.unpack_from("<I", record, 8)[0]
        pos = 12
        for i in range(count):
            if pos >= len(record):
                break
            op = record[pos]
            pos += 1
            klen, pos = _read_varint(record, pos)
            key = record[pos:pos + klen]
            pos += klen
            if op == TYPE_VALUE:
                vlen, pos = _read_varint(record, pos)
                value = record[pos:pos + vlen]
                pos += vlen
                yield key, seq + i, TYPE_VALUE, value
            else:
                yield key, seq + i, TYPE_DELETION, b""


# --------------------------------------------------------------------------- #
# MANIFEST / CURRENT
# --------------------------------------------------------------------------- #

def _read_manifest(path: str) -> Tuple[List[int], int]:
    """-> (live sstable file numbers, current log number)."""
    with open(path, "rb") as f:
        buf = f.read()
    live: Dict[int, bool] = {}
    log_number = 0
    for record in _log_records(buf):
        pos = 0
        while pos < len(record):
            tag, pos = _read_varint(record, pos)
            if tag == 1:          # comparator name
                ln, pos = _read_varint(record, pos)
                pos += ln
            elif tag == 2:        # log number
                log_number, pos = _read_varint(record, pos)
            elif tag == 9:        # prev log number
                _, pos = _read_varint(record, pos)
            elif tag == 3:        # next file number
                _, pos = _read_varint(record, pos)
            elif tag == 4:        # last sequence
                _, pos = _read_varint(record, pos)
            elif tag == 5:        # compact pointer: level + internal key
                _, pos = _read_varint(record, pos)
                ln, pos = _read_varint(record, pos)
                pos += ln
            elif tag == 6:        # deleted file: level + number
                _, pos = _read_varint(record, pos)
                num, pos = _read_varint(record, pos)
                live.pop(num, None)
            elif tag == 7:        # new file: level num size smallest largest
                _, pos = _read_varint(record, pos)
                num, pos = _read_varint(record, pos)
                _, pos = _read_varint(record, pos)
                ln, pos = _read_varint(record, pos)
                pos += ln
                ln, pos = _read_varint(record, pos)
                pos += ln
                live[num] = True
            else:
                raise LevelDBError(f"{path}: unknown VersionEdit tag {tag}")
    return sorted(live), log_number


# --------------------------------------------------------------------------- #
# Reader facade
# --------------------------------------------------------------------------- #

class LevelDBReader:
    """Read-only merged view of a LevelDB directory, sorted by key.

    Startup scans every block once to build the key index but keeps only
    locators — (table, block, entry) for SSTable values, inline bytes for
    WAL-resident values — so memory stays proportional to the key count, not
    the dataset. ``value_at`` decodes blocks on demand through a small LRU."""

    BLOCK_CACHE = 16

    def __init__(self, path: str):
        if not os.path.isdir(path):
            raise LevelDBError(f"{path}: not a LevelDB directory")
        names = os.listdir(path)
        if "CURRENT" not in names and not any(
                n.endswith((".ldb", ".sst", ".log")) for n in names):
            raise LevelDBError(f"{path}: no LevelDB files "
                               f"(CURRENT/.ldb/.sst/.log) in directory")

        # key -> (seq, type, locator); locator = (table_idx, block_idx,
        # entry_idx) for sstables, ("mem", value) for WAL entries.
        entries: Dict[bytes, Tuple[int, int, tuple]] = {}

        def absorb(key, seq, typ, locator):
            cur = entries.get(key)
            if cur is None or seq >= cur[0]:
                entries[key] = (seq, typ, locator)

        current = os.path.join(path, "CURRENT")
        sst_numbers: Optional[List[int]] = None
        log_floor = 0
        if os.path.exists(current):
            with open(current) as f:
                manifest = f.read().strip()
            mpath = os.path.join(path, manifest)
            if os.path.exists(mpath):
                sst_numbers, log_floor = _read_manifest(mpath)

        def file_number(name: str) -> int:
            return int(name.split(".")[0].split("-")[0])

        self._tables: List[SSTable] = []
        for name in sorted(names):
            if name.endswith((".ldb", ".sst")):
                if sst_numbers is not None and \
                        file_number(name) not in sst_numbers:
                    continue  # obsolete (compacted-away) table
                table = SSTable(os.path.join(path, name))
                t_idx = len(self._tables)
                self._tables.append(table)
                for b_idx, handle in enumerate(table.block_handles):
                    for e_idx, (key, seq, typ, _value) in enumerate(
                            table.block_entries(handle)):
                        absorb(key, seq, typ, (t_idx, b_idx, e_idx))
        for name in sorted(names):
            if name.endswith(".log"):
                if sst_numbers is not None and file_number(name) < log_floor:
                    continue  # superseded by flushed tables
                for key, seq, typ, value in read_log(
                        os.path.join(path, name)):
                    absorb(key, seq, typ, ("mem", value))

        self._keys = sorted(k for k, (_, typ, _l) in entries.items()
                            if typ == TYPE_VALUE)
        self._entries = entries
        from collections import OrderedDict
        self._cache: "OrderedDict[tuple, list]" = OrderedDict()

    def _value(self, key: bytes) -> bytes:
        locator = self._entries[key][2]
        if locator[0] == "mem":
            return locator[1]
        t_idx, b_idx, e_idx = locator
        cache_key = (t_idx, b_idx)
        block = self._cache.get(cache_key)
        if block is None:
            table = self._tables[t_idx]
            block = table.block_entries(table.block_handles[b_idx])
            self._cache[cache_key] = block
            if len(self._cache) > self.BLOCK_CACHE:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(cache_key)
        return block[e_idx][3]

    def __len__(self) -> int:
        return len(self._keys)

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        for k in self._keys:
            yield k, self._value(k)

    def key_at(self, i: int) -> bytes:
        return self._keys[i]

    def value_at(self, i: int) -> bytes:
        return self._value(self._keys[i])


# --------------------------------------------------------------------------- #
# Writer: one sorted SSTable + manifest + current
# --------------------------------------------------------------------------- #

class LevelDBWriter:
    BLOCK_SIZE = 4096
    RESTART_INTERVAL = 16

    def __init__(self, path: str, compress: bool = True):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.compress = compress
        self.items: List[Tuple[bytes, bytes]] = []

    def put(self, key: bytes, value: bytes) -> None:
        self.items.append((key, value))

    # -- block building ------------------------------------------------- #
    def _build_block(self, entries: List[Tuple[bytes, bytes]]) -> bytes:
        out = bytearray()
        restarts = []
        prev_key = b""
        for i, (key, value) in enumerate(entries):
            if i % self.RESTART_INTERVAL == 0:
                restarts.append(len(out))
                shared = 0
            else:
                shared = 0
                limit = min(len(prev_key), len(key))
                while shared < limit and key[shared] == prev_key[shared]:
                    shared += 1
            _write_varint(out, shared)
            _write_varint(out, len(key) - shared)
            _write_varint(out, len(value))
            out += key[shared:]
            out += value
            prev_key = key
        for r in restarts:
            out += struct.pack("<I", r)
        out += struct.pack("<I", len(restarts))
        return bytes(out)

    def _emit_block(self, f, raw: bytes) -> bytes:
        """Write block (+type+crc); return the BlockHandle."""
        offset = f.tell()
        if self.compress:
            data, btype = snappy_compress(raw), 1
        else:
            data, btype = raw, 0
        f.write(data)
        f.write(bytes([btype]))
        f.write(struct.pack("<I", crc32c_masked(data + bytes([btype]))))
        handle = bytearray()
        _write_varint(handle, offset)
        _write_varint(handle, len(data))
        return bytes(handle)

    def close(self) -> None:
        # last put wins for duplicate keys; stock LevelDB orders duplicate
        # user keys by DESCENDING sequence, which a single-sequence-per-key
        # table sidesteps entirely.
        items = sorted(dict(self.items).items())
        table_no, manifest_no, log_no = 2, 1, 3
        table_path = os.path.join(self.path, f"{table_no:06d}.ldb")
        index_entries: List[Tuple[bytes, bytes]] = []
        seq = 1
        with open(table_path, "wb") as f:
            block: List[Tuple[bytes, bytes]] = []
            block_bytes = 0
            for key, value in items:
                ikey = key + struct.pack("<Q", (seq << 8) | TYPE_VALUE)
                seq += 1
                block.append((ikey, value))
                block_bytes += len(ikey) + len(value) + 8
                if block_bytes >= self.BLOCK_SIZE:
                    handle = self._emit_block(f, self._build_block(block))
                    index_entries.append((block[-1][0], handle))
                    block, block_bytes = [], 0
            if block:
                handle = self._emit_block(f, self._build_block(block))
                index_entries.append((block[-1][0], handle))
            metaindex_handle = self._emit_block(f, self._build_block([]))
            index_handle = self._emit_block(f, self._build_block(index_entries))
            footer = bytearray()
            footer += metaindex_handle
            footer += index_handle
            footer += b"\0" * (40 - len(footer))
            footer += struct.pack("<Q", TABLE_MAGIC)
            f.write(footer)
            table_size = f.tell()

        # Manifest: one VersionEdit declaring the table + an empty live log.
        edit = bytearray()
        _write_varint(edit, 1)
        comparator = b"leveldb.BytewiseComparator"
        _write_varint(edit, len(comparator))
        edit += comparator
        _write_varint(edit, 2)
        _write_varint(edit, log_no)
        _write_varint(edit, 3)
        _write_varint(edit, log_no + 1)
        _write_varint(edit, 4)
        _write_varint(edit, seq)
        if items:
            smallest = items[0][0] + struct.pack("<Q", (1 << 8) | TYPE_VALUE)
            largest = items[-1][0] + struct.pack(
                "<Q", ((seq - 1) << 8) | TYPE_VALUE)
            _write_varint(edit, 7)
            _write_varint(edit, 0)          # level
            _write_varint(edit, table_no)
            _write_varint(edit, table_size)
            _write_varint(edit, len(smallest))
            edit += smallest
            _write_varint(edit, len(largest))
            edit += largest

        with open(os.path.join(self.path, f"MANIFEST-{manifest_no:06d}"),
                  "wb") as f:
            payload = bytes(edit)
            header = struct.pack(
                "<IHB",
                crc32c_masked(bytes([LOG_FULL]) + payload),
                len(payload), LOG_FULL)
            f.write(header + payload)
        with open(os.path.join(self.path, f"{log_no:06d}.log"), "wb"):
            pass
        with open(os.path.join(self.path, "CURRENT"), "w") as f:
            f.write(f"MANIFEST-{manifest_no:06d}\n")
