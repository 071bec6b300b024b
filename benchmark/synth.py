"""Synthetic ILSVRC-shaped inputs from a seed: uint8 records of class
templates plus noise (the recipe of ``examples/make_synthetic_db.py``),
drawn on the device in a few large calls, written as an LMDB of Caffe
``Datum`` records beside a mean ``BlobProto`` file.

The LMDB writer and the protobuf encoding are frozen copies of the
program's ``data/lmdb_reader.LMDBWriter`` and ``proto/wire.py``
(``encode_datum``, ``encode_blob``), so that a change to the program
cannot change what the benchmark feeds it.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

PAGE = 4096
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
MDB_MAGIC = 0xBEEFC0DE


# ---------------------------------------------------------------- records
def make_records(seed: int, n: int, classes: int, shape: Tuple[int, ...],
                 device) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` uint8 images of ``shape`` and their labels in ``[0,
    classes)``: each image is its class's template (uniform in [60, 196))
    plus N(0, 30) noise, clipped to [0, 255]. The same seed gives the same
    records on the same kind of device."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    used, inverse = torch.unique(labels, return_inverse=True)
    templates = torch.randint(60, 196, (len(used),) + tuple(shape),
                              generator=gen, device=device,
                              dtype=torch.int16).float()
    noise = torch.randn((n,) + tuple(shape), generator=gen, device=device)
    images = (templates[inverse] + 30.0 * noise).clamp_(0, 255).to(
        torch.uint8)
    del templates, noise
    return images.cpu().numpy(), labels.cpu().numpy().astype(np.int64)


def image_mean(images: np.ndarray) -> np.ndarray:
    """The per-pixel mean of the records, (C, H, W) float32 (what
    ``compute_image_mean`` writes)."""
    return images.mean(axis=0, dtype=np.float64).astype(np.float32)


# ---------------------------------------------------------------- protobuf
def _varint(out: bytearray, value: int) -> None:
    value &= (1 << 64) - 1
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _varint_field(out: bytearray, fnum: int, value: int) -> None:
    _varint(out, fnum << 3)
    _varint(out, value)


def _bytes_field(out: bytearray, fnum: int, value: bytes) -> None:
    _varint(out, (fnum << 3) | 2)
    _varint(out, len(value))
    out.extend(value)


def encode_datum(channels: int, height: int, width: int, data: bytes,
                 label: int) -> bytes:
    out = bytearray()
    _varint_field(out, 1, channels)
    _varint_field(out, 2, height)
    _varint_field(out, 3, width)
    _bytes_field(out, 4, data)
    _varint_field(out, 5, label)
    return bytes(out)


def encode_blob(arr: np.ndarray) -> bytes:
    """A BlobProto: the shape padded to (num, channels, height, width)
    and the data as packed floats."""
    shape = tuple(arr.shape) + (1,) * (4 - arr.ndim)
    out = bytearray()
    for fnum, dim in enumerate(shape, start=1):
        _varint_field(out, fnum, dim)
    _bytes_field(out, 5, np.asarray(arr, "<f4").ravel().tobytes())
    return bytes(out)


# ---------------------------------------------------------------- LMDB
def _leaf(pgno: int, entries) -> bytes:
    offsets, bodies = [], []
    upper = PAGE
    for key, value, ovpg in entries:
        if ovpg is not None:
            node = struct.pack("<HHHH", len(value) & 0xFFFF,
                               (len(value) >> 16) & 0xFFFF, F_BIGDATA,
                               len(key)) + key + struct.pack("<Q", ovpg)
        else:
            node = struct.pack("<HHHH", len(value) & 0xFFFF,
                               (len(value) >> 16) & 0xFFFF, 0,
                               len(key)) + key + value
        if len(node) & 1:
            node += b"\0"
        upper -= len(node)
        offsets.append(upper)
        bodies.append(node)
    page = bytearray(PAGE)
    struct.pack_into("<QHHHH", page, 0, pgno, 0, P_LEAF,
                     16 + 2 * len(entries), upper)
    struct.pack_into(f"<{len(offsets)}H", page, 16, *offsets)
    for off, node in zip(offsets, bodies):
        page[off:off + len(node)] = node
    return bytes(page)


def _branch(pgno: int, children) -> bytes:
    offsets, bodies = [], []
    upper = PAGE
    for idx, (key, child) in enumerate(children):
        k = b"" if idx == 0 else key
        node = struct.pack("<HHHH", child & 0xFFFF, (child >> 16) & 0xFFFF,
                           (child >> 32) & 0xFFFF, len(k)) + k
        if len(node) & 1:
            node += b"\0"
        upper -= len(node)
        offsets.append(upper)
        bodies.append(node)
    page = bytearray(PAGE)
    struct.pack_into("<QHHHH", page, 0, pgno, 0, P_BRANCH,
                     16 + 2 * len(children), upper)
    struct.pack_into(f"<{len(offsets)}H", page, 16, *offsets)
    for off, node in zip(offsets, bodies):
        page[off:off + len(node)] = node
    return bytes(page)


def _meta(root: int, entries: int, last_pg: int) -> bytes:
    out = bytearray()
    for pageno, txnid in ((0, 0), (1, 1)):
        page = bytearray(PAGE)
        struct.pack_into("<QHHHH", page, 0, pageno, 0, P_META, 0, 0)
        struct.pack_into("<II", page, 16, MDB_MAGIC, 1)
        struct.pack_into("<QQ", page, 24, 0, 1 << 30)
        struct.pack_into("<IHHQQQQq", page, 40, 0, 0, 0, 0, 0, 0, 0, -1)
        struct.pack_into("<IHHQQQQq", page, 88, 0, 0,
                         1 if root >= 0 else 0, 0, 0, 0, entries, root)
        struct.pack_into("<QQ", page, 136, last_pg, txnid)
        out += page
    return bytes(out)


def write_lmdb(path: str, items: List[Tuple[bytes, bytes]]) -> None:
    """A single-transaction LMDB of ``items`` (sorted by key) at
    ``path/data.mdb``."""
    os.makedirs(path, exist_ok=True)
    items = sorted(items)
    pages: List[bytes] = []
    leaves: List[Tuple[bytes, int]] = []
    i = 0
    while i < len(items):
        used, first, entries = 16, items[i][0], []
        while i < len(items):
            key, value = items[i]
            big = (8 + len(key) + len(value) > PAGE - 18
                   or len(value) > PAGE // 2)
            size = 8 + len(key) + (8 if big else len(value))
            size += size & 1
            if used + 2 + size > PAGE and entries:
                break
            ovpg: Optional[int] = None
            if big:
                ovpg = 2 + len(pages)
                npages = (16 + len(value) + PAGE - 1) // PAGE
                blob = struct.pack("<QHHHH", ovpg, 0, P_OVERFLOW, 0, 0) + value
                blob += b"\0" * (npages * PAGE - len(blob))
                pages.extend(blob[p * PAGE:(p + 1) * PAGE]
                             for p in range(npages))
            entries.append((key, value, ovpg))
            used += 2 + size
            i += 1
        pgno = 2 + len(pages)
        pages.append(_leaf(pgno, entries))
        leaves.append((first, pgno))

    def build(children: List[Tuple[bytes, int]]) -> int:
        if len(children) == 1:
            return children[0][1]
        level, j = [], 0
        while j < len(children):
            group, used, first = [], 16, children[j][0]
            while j < len(children):
                key, child = children[j]
                size = 8 + (0 if not group else len(key))
                size += size & 1
                if used + 2 + size > PAGE and group:
                    break
                group.append((key, child))
                used += 2 + size
                j += 1
            pgno = 2 + len(pages)
            pages.append(_branch(pgno, group))
            level.append((first, pgno))
        return build(level)

    root = build(leaves) if leaves else -1
    with open(os.path.join(path, "data.mdb"), "wb") as f:
        f.write(_meta(root, len(items), 1 + len(pages)))
        for p in pages:
            f.write(p)


def write_dataset(root: str, images: np.ndarray, labels: np.ndarray,
                  mean: np.ndarray) -> Tuple[str, str]:
    """The train LMDB and the mean file under ``root``; -> their
    paths."""
    c, h, w = images.shape[1:]
    db = os.path.join(root, "train_lmdb")
    write_lmdb(db, [(f"{i:08d}".encode(),
                     encode_datum(c, h, w, images[i].tobytes(),
                                  int(labels[i])))
                    for i in range(len(images))])
    mean_path = os.path.join(root, "mean.binaryproto")
    with open(mean_path, "wb") as f:
        f.write(encode_blob(mean[None]))
    return db, mean_path
