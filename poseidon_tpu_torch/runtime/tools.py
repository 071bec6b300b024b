"""Dataset tools and the feature extractor (the port of
``poseidon_tpu/runtime/tools.py``): ``convert_imageset``,
``compute_image_mean``, ``partition_data``, ``convert_db`` and
``extract_features``.

Parity targets: ``tools/convert_imageset.cpp``,
``tools/compute_image_mean.cpp``, ``tools/partition_data.cpp`` (the
LevelDB shard splitter for k clients) and ``src/caffe/
feature_extractor.cpp`` (load weights, forward, dump each named blob's
features). Databases are LMDB through the port's own reader and writer
(``data/lmdb_reader.py``); the reference's default LevelDB backend is
read by ``data/leveldb_reader.py`` and converted. The records and the mean
binaryproto are byte for byte the JAX package's from the same inputs.
``extract_features`` runs the forward wherever its net lives (the card
unless the caller built the net on the CPU). PIL is imported only by
``convert_imageset``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..proto.wire import Datum, decode_datum, encode_blob, encode_datum
from .metrics import log


def convert_imageset(listfile: str, out_db: str, root_folder: str = "",
                     resize_height: int = 0, resize_width: int = 0,
                     shuffle: bool = False, gray: bool = False,
                     seed: int = 0) -> int:
    """An image list ('path label' lines) -> an LMDB of uint8 Datum
    records (BGR, CHW), keyed '<index:08d>_<basename>'; returns the
    count."""
    from PIL import Image

    from ..data.lmdb_reader import LMDBWriter

    entries = []
    with open(listfile) as f:
        for line in f:
            line = line.strip()
            if line:
                path, label = line.rsplit(None, 1)
                entries.append((path, int(label)))
    if shuffle:
        np.random.RandomState(seed).shuffle(entries)

    writer = LMDBWriter(out_db)
    for i, (path, label) in enumerate(entries):
        img = Image.open(os.path.join(root_folder, path))
        img = img.convert("L" if gray else "RGB")
        if resize_height and resize_width:
            img = img.resize((resize_width, resize_height))
        arr = np.asarray(img, np.uint8)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        else:
            arr = arr[:, :, ::-1]  # RGB -> BGR, Caffe's convention
        chw = np.ascontiguousarray(arr.transpose(2, 0, 1))
        datum = Datum(channels=chw.shape[0], height=chw.shape[1],
                      width=chw.shape[2], data=chw.tobytes(), label=label)
        writer.put(f"{i:08d}_{os.path.basename(path)}".encode(),
                   encode_datum(datum))
    writer.close()
    log(f"convert_imageset: wrote {len(entries)} records to {out_db}")
    return len(entries)


def compute_image_mean(db_path: str, out_file: str) -> np.ndarray:
    """An LMDB of Datums -> their mean as a (1, C, H, W) BlobProto
    (.binaryproto), summed in record order in f32; returns the (C, H, W)
    mean."""
    from ..data.lmdb_reader import LMDBReader
    db = LMDBReader(db_path)
    total: Optional[np.ndarray] = None
    count = 0
    try:
        for _, value in db:
            arr = decode_datum(value).to_array()
            total = arr if total is None else total + arr
            count += 1
    finally:
        db.close()
    if count == 0:
        raise ValueError(f"{db_path}: empty database")
    mean = (total / count).astype(np.float32)
    with open(out_file, "wb") as f:
        f.write(encode_blob(mean[None]))
    log(f"compute_image_mean: {count} records -> {out_file}")
    return mean


def partition_data(db_path: str, num_shards: int) -> List[str]:
    """Split a database into contiguous shards '<db>_0' ... '<db>_{k-1}'
    (the shared_file_system convention, tools/partition_data.cpp); the
    first n % k shards take one record more."""
    from ..data.lmdb_reader import LMDBReader, LMDBWriter
    db = LMDBReader(db_path)
    n = len(db)
    base, rem = divmod(n, num_shards)
    out_paths = []
    idx = 0
    try:
        for s in range(num_shards):
            take = base + (1 if s < rem else 0)
            out = f"{db_path.rstrip('/')}_{s}"
            w = LMDBWriter(out)
            for _ in range(take):
                w.put(db.key_at(idx), db.value_at(idx))
                idx += 1
            w.close()
            out_paths.append(out)
    finally:
        db.close()
    log(f"partition_data: {n} records -> {num_shards} shards")
    return out_paths


def convert_db(src_path: str, out_path: str, out_backend: str = "LMDB"
               ) -> int:
    """Copy a database between backends (LevelDB <-> LMDB), records in
    key order; returns the count."""
    from ..data.leveldb_reader import LevelDBReader, LevelDBWriter
    from ..data.lmdb_reader import LMDBReader, LMDBWriter

    try:
        reader = LMDBReader(src_path)
    except Exception:  # noqa: BLE001 — not an LMDB: read it as LevelDB
        reader = LevelDBReader(src_path)
    writer = (LMDBWriter(out_path) if out_backend.upper() == "LMDB"
              else LevelDBWriter(out_path))
    n = 0
    for key, value in reader:
        writer.put(key, value)
        n += 1
    writer.close()
    if hasattr(reader, "close"):
        reader.close()
    log(f"convert_db: {n} records -> {out_path} ({out_backend})")
    return n


def extract_features(net, params, blob_names: List[str], pipeline,
                     num_batches: int, out_prefix: str) -> List[str]:
    """Forward ``num_batches`` batches of ``pipeline`` through ``net`` on
    its device (no gradient) and dump each named blob to an LMDB
    '<out_prefix>_<blob>' ('/' as '_') of f32 Datums (C = the blob's
    per-sample size, H = W = 1), keyed by the running sample index
    (feature_extractor.cpp:16-139); returns the paths."""
    import torch

    from ..data.lmdb_reader import LMDBWriter
    from ..data.pipeline import place_batch

    paths = [f"{out_prefix}_{b.replace('/', '_')}" for b in blob_names]
    writers = {b: LMDBWriter(p) for b, p in zip(blob_names, paths)}
    sample = 0
    for _ in range(num_batches):
        host = next(pipeline)
        with torch.no_grad():
            blobs = net.apply(params, place_batch(host, net.device),
                              train=False, keep_blobs=True).blobs
        n = next(iter(host.values())).shape[0]
        for b in blob_names:
            feats = blobs[b].float().cpu().numpy().reshape(n, -1)
            for i in range(n):
                datum = Datum(channels=feats.shape[1], height=1, width=1,
                              float_data=feats[i])
                writers[b].put(f"{sample + i:010d}".encode(),
                               encode_datum(datum))
        sample += n
    for w in writers.values():
        w.close()
    log(f"extract_features: {sample} samples x {len(blob_names)} blobs")
    return paths
