"""Read-only LMDB reader (mmap + B+tree walk) and a minimal LMDB writer,
dependency-free: the port's own copy of ``poseidon_tpu/data/lmdb_reader.py``.

The reference ingests training data from LMDB databases of serialized
``Datum`` records (``src/caffe/layers/data_layer.cpp``). No ``lmdb`` C
binding is assumed, so this module implements the file format directly:
meta-page selection by transaction id, B+tree traversal of the main DB,
overflow-page reassembly. ``LMDBWriter`` writes a single-transaction
database in the same layout (the tests and chip_smoke.py build synthetic
datasets with it); databases written by either package read in both.

Format reference: LMDB is public domain (OpenLDAP); the on-disk layout is
page-size-aligned pages with a 16-byte header, meta pages 0 and 1, and
branch/leaf nodes carrying 48-bit page numbers / 32-bit data sizes.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01


class LMDBError(IOError):
    pass


class LMDBReader:
    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._parse_meta()
        self._index: Optional[List[Tuple[int, int]]] = None  # (page, node idx)

    # ------------------------------------------------------------------ #
    def _parse_meta(self):
        # Try both supported page sizes to locate meta page 1.
        best = None
        for psize in (4096, 8192, 16384, 32768):
            try:
                m0 = self._read_meta(0, psize)
                m1 = self._read_meta(1, psize)
            except (LMDBError, struct.error):
                continue
            meta = m0 if m0["txnid"] >= m1["txnid"] else m1
            best = (psize, meta)
            break
        if best is None:
            raise LMDBError("not an LMDB file (no valid meta page)")
        self.page_size, meta = best
        self.root = meta["main_root"]
        self.entries = meta["main_entries"]

    def _read_meta(self, pageno: int, psize: int) -> dict:
        off = pageno * psize
        buf = self._mm[off:off + psize]
        if len(buf) < 112:
            raise LMDBError("truncated meta page")
        # MDB_page header: pgno(8) pad(2) flags(2) lower(2) upper(2)
        flags = struct.unpack_from("<H", buf, 10)[0]
        if not flags & P_META:
            raise LMDBError("not a meta page")
        # MDB_meta at offset 16: magic(4) version(4) address(8) mapsize(8)
        magic, version = struct.unpack_from("<II", buf, 16)
        if magic != MDB_MAGIC:
            raise LMDBError("bad magic")
        # mm_dbs[2]: each MDB_db is 48 bytes:
        # pad(4) flags(2) depth(2) branch(8) leaf(8) overflow(8) entries(8) root(8)
        db_off = 16 + 4 + 4 + 8 + 8  # after magic/version/address/mapsize
        free_db = struct.unpack_from("<IHHQQQQq", buf, db_off)
        main_db = struct.unpack_from("<IHHQQQQq", buf, db_off + 48)
        last_pg, txnid = struct.unpack_from("<QQ", buf, db_off + 96)
        return {
            "txnid": txnid,
            "main_entries": main_db[6],
            "main_root": main_db[7],
        }

    # ------------------------------------------------------------------ #
    def _page(self, pgno: int) -> bytes:
        off = pgno * self.page_size
        return self._mm[off:off + self.page_size]

    def _page_header(self, buf: bytes) -> Tuple[int, int, int]:
        flags, lower, upper = struct.unpack_from("<HHH", buf, 10)
        return flags, lower, upper

    def _node_offsets(self, buf: bytes) -> List[int]:
        _, lower, _ = self._page_header(buf)
        n = (lower - 16) // 2
        return list(struct.unpack_from(f"<{n}H", buf, 16)) if n else []

    def _leaf_node(self, pgno: int, idx: int) -> Tuple[bytes, bytes]:
        """Return (key, value) for node idx of leaf page pgno."""
        buf = self._page(pgno)
        offsets = self._node_offsets(buf)
        off = offsets[idx]
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", buf, off)
        datasize = lo | (hi << 16)
        key = buf[off + 8:off + 8 + ksize]
        if flags & F_BIGDATA:
            (ovpg,) = struct.unpack_from("<Q", buf, off + 8 + ksize)
            return key, self._read_overflow(ovpg, datasize)
        data_start = off + 8 + ksize
        return key, buf[data_start:data_start + datasize]

    def _read_overflow(self, pgno: int, size: int) -> bytes:
        start = pgno * self.page_size + 16
        return self._mm[start:start + size]

    # ------------------------------------------------------------------ #
    def _walk_leaves(self, pgno: int) -> Iterator[int]:
        """Yield leaf page numbers left-to-right."""
        buf = self._page(pgno)
        flags, _, _ = self._page_header(buf)
        if flags & P_LEAF:
            yield pgno
            return
        if not flags & P_BRANCH:
            raise LMDBError(f"unexpected page flags {flags:#x} at {pgno}")
        for off in self._node_offsets(buf):
            lo, hi, nflags, ksize = struct.unpack_from("<HHHH", buf, off)
            child = lo | (hi << 16) | (nflags << 32)  # 48-bit pgno
            yield from self._walk_leaves(child)

    def _build_index(self):
        if self._index is not None:
            return
        index: List[Tuple[int, int]] = []
        if self.root >= 0:
            for leaf in self._walk_leaves(self.root):
                buf = self._page(leaf)
                for i in range(len(self._node_offsets(buf))):
                    index.append((leaf, i))
        self._index = index

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return self.entries

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        self._build_index()
        for pgno, i in self._index:
            yield self._leaf_node(pgno, i)

    def value_at(self, i: int) -> bytes:
        self._build_index()
        pgno, idx = self._index[i]
        return self._leaf_node(pgno, idx)[1]

    def key_at(self, i: int) -> bytes:
        self._build_index()
        pgno, idx = self._index[i]
        return self._leaf_node(pgno, idx)[0]

    def close(self):
        self._mm.close()
        self._f.close()


# --------------------------------------------------------------------------- #
# Minimal LMDB *writer* for tool parity (convert_imageset / partition_data
# equivalents must emit databases Caffe itself could read). Writes a fresh
# single-txn database: meta pages + sequential leaf pages, no free list.
# --------------------------------------------------------------------------- #

class LMDBWriter:
    PAGE = 4096

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.path = os.path.join(path, "data.mdb")
        self.items: List[Tuple[bytes, bytes]] = []

    def put(self, key: bytes, value: bytes):
        self.items.append((key, value))

    def close(self):
        items = sorted(self.items)
        pages: List[bytes] = []  # data pages, numbered from 2
        leaf_pages: List[Tuple[bytes, int]] = []  # (first key, pgno)

        def new_pgno() -> int:
            return 2 + len(pages)

        # Build leaves: pack as many nodes as fit per page.
        i = 0
        while i < len(items):
            nodes = []
            used = 16
            first_key = items[i][0]
            page_entries: List[Tuple[bytes, bytes, Optional[int]]] = []
            while i < len(items):
                key, value = items[i]
                big = 8 + len(key) + len(value) > self.PAGE - 16 - 2 or \
                    len(value) > self.PAGE // 2
                node_size = 8 + len(key) + (8 if big else len(value))
                node_size += node_size & 1
                if used + 2 + node_size > self.PAGE and page_entries:
                    break
                ovpg = None
                if big:
                    ovpg = new_pgno()
                    npages = (16 + len(value) + self.PAGE - 1) // self.PAGE
                    blob = struct.pack("<QHHHH", ovpg, 0, P_OVERFLOW, 0, 0)
                    blob += value
                    blob += b"\0" * (npages * self.PAGE - len(blob))
                    for p in range(npages):
                        pages.append(blob[p * self.PAGE:(p + 1) * self.PAGE])
                page_entries.append((key, value, ovpg))
                used += 2 + node_size
                i += 1
            pgno = new_pgno()
            pages.append(self._build_leaf(pgno, page_entries))
            leaf_pages.append((first_key, pgno))

        # Branch pages (single level is enough for tool-scale DBs; build
        # recursively otherwise).
        def build_branch(children: List[Tuple[bytes, int]]) -> int:
            if len(children) == 1:
                return children[0][1]
            level: List[Tuple[bytes, int]] = []
            j = 0
            while j < len(children):
                group = []
                used = 16
                first_key = children[j][0]
                while j < len(children):
                    key, child = children[j]
                    ksize = 0 if not group else len(key)
                    node_size = 8 + ksize
                    node_size += node_size & 1
                    if used + 2 + node_size > self.PAGE and group:
                        break
                    group.append((key, child))
                    used += 2 + node_size
                    j += 1
                pgno = new_pgno()
                pages.append(self._build_branch(pgno, group))
                level.append((first_key, pgno))
            return build_branch(level)

        root = build_branch(leaf_pages) if leaf_pages else -1

        meta = self._build_meta(root, len(items), last_pg=1 + len(pages))
        with open(self.path, "wb") as f:
            f.write(meta)
            for p in pages:
                f.write(p)

    def _build_leaf(self, pgno: int, entries) -> bytes:
        header_nodes: List[bytes] = []
        bodies: List[bytes] = []
        # lay out nodes from the top of the page downward
        offsets = []
        upper = self.PAGE
        for key, value, ovpg in entries:
            if ovpg is not None:
                node = struct.pack("<HHHH", len(value) & 0xFFFF,
                                   (len(value) >> 16) & 0xFFFF,
                                   F_BIGDATA, len(key))
                node += key + struct.pack("<Q", ovpg)
            else:
                node = struct.pack("<HHHH", len(value) & 0xFFFF,
                                   (len(value) >> 16) & 0xFFFF, 0, len(key))
                node += key + value
            if len(node) & 1:
                node += b"\0"
            upper -= len(node)
            offsets.append(upper)
            bodies.append(node)
        lower = 16 + 2 * len(entries)
        page = bytearray(self.PAGE)
        struct.pack_into("<QHHHH", page, 0, pgno, 0, P_LEAF, lower, upper)
        struct.pack_into(f"<{len(offsets)}H", page, 16, *offsets)
        for off, node in zip(offsets, bodies):
            page[off:off + len(node)] = node
        return bytes(page)

    def _build_branch(self, pgno: int, children) -> bytes:
        offsets = []
        bodies: List[bytes] = []
        upper = self.PAGE
        for idx, (key, child) in enumerate(children):
            k = b"" if idx == 0 else key
            node = struct.pack("<HHHH", child & 0xFFFF, (child >> 16) & 0xFFFF,
                               (child >> 32) & 0xFFFF, len(k))
            node += k
            if len(node) & 1:
                node += b"\0"
            upper -= len(node)
            offsets.append(upper)
            bodies.append(node)
        lower = 16 + 2 * len(children)
        page = bytearray(self.PAGE)
        struct.pack_into("<QHHHH", page, 0, pgno, 0, P_BRANCH, lower, upper)
        struct.pack_into(f"<{len(offsets)}H", page, 16, *offsets)
        for off, node in zip(offsets, bodies):
            page[off:off + len(node)] = node
        return bytes(page)

    def _build_meta(self, root: int, entries: int, last_pg: int) -> bytes:
        out = bytearray()
        for pageno, txnid in ((0, 0), (1, 1)):
            page = bytearray(self.PAGE)
            struct.pack_into("<QHHHH", page, 0, pageno, 0, P_META, 0, 0)
            struct.pack_into("<II", page, 16, MDB_MAGIC, 1)
            # address(8)=0, mapsize(8)
            struct.pack_into("<QQ", page, 24, 0, 1 << 30)
            db_off = 40
            # free DB: empty
            struct.pack_into("<IHHQQQQq", page, db_off, 0, 0, 0, 0, 0, 0, 0, -1)
            # main DB
            depth = 1 if root >= 0 else 0
            struct.pack_into("<IHHQQQQq", page, db_off + 48, 0, 0, depth,
                             0, 0, 0, entries, root)
            struct.pack_into("<QQ", page, db_off + 96, last_pg, txnid)
            out += page
        return bytes(out)
