"""Paged KV-cache pool: fixed-size pages from one preallocated device pool
(the port of ``poseidon_tpu/serving/kv_pool.py``).

Every sequence's KV cache is a list of fixed-size PAGES drawn from one
preallocated per-layer pool, and the decode step reads them through a
page-table indirection (``models/generate.py paged_decode_step``).
Admitting or retiring a sequence touches only the host-side free list; the
device tensors never reshape.

Layout: one pool per layer per K/V, shaped ``(num_pages, n_heads,
page_size, d_head)``, float32, on the executor's device. ONE page table per
sequence is shared by every layer. Page 0 is the reserved SCRATCH page:
inactive decode rows point their table at it, so their writes are harmless
by construction.

The pools are updated IN PLACE, where the JAX package donates them:
``write_prefill`` copies a prefill's caches into the sequence's pages, and
the decode step scatters each new token's K/V into its page.

Pages are never zeroed on free: the ragged visibility mask exposes a
position only after its owner has written it. Admission reserves the WHOLE
request (prompt + max_new, page-aligned), so a running sequence never
meets exhaustion mid-flight.

Thread model: one scheduler thread owns alloc/free/write; the lock exists
for the stats readers racing those mutations.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PagedKVPool", "PoolExhausted"]


class PoolExhausted(RuntimeError):
    """Not enough free pages for an admission: the scheduler keeps the
    request queued until retirements free capacity."""


class PagedKVPool:
    """Preallocated per-layer K/V page pools + the host-side allocator.

    ``cfg`` is a dense ``TransformerConfig``; ``num_pages`` counts the
    usable pages PLUS the scratch page (page 0); ``max_seq_len`` bounds any
    single sequence and fixes the page-table width."""

    def __init__(self, cfg, num_pages: int, page_size: int,
                 max_seq_len: Optional[int] = None, device="cpu"):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (one is scratch), "
                             f"got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.cfg = cfg
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_seq_len = int(max_seq_len or cfg.max_seq)
        self.max_pages_per_seq = -(-self.max_seq_len // self.page_size)
        self.device = torch.device(device)
        dh = cfg.d_model // cfg.n_heads
        shape = (self.num_pages, cfg.n_heads, self.page_size, dh)
        self.caches: Tuple = tuple(
            (torch.zeros(shape, device=self.device),
             torch.zeros(shape, device=self.device))
            for _ in range(cfg.n_layers))
        self._lock = threading.Lock()
        # LIFO free list (recently freed pages are cache-warm); page 0 is
        # the scratch page and never allocated
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._seq_pages: Dict[int, List[int]] = {}
        self.allocs = 0
        self.frees = 0
        self.peak_pages_used = 0

    # ---- capacity ------------------------------------------------------- #
    def pages_for(self, total_len: int) -> int:
        """Pages a sequence of ``total_len`` positions reserves."""
        return -(-int(total_len) // self.page_size)

    @property
    def pages_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def pages_used(self) -> int:
        with self._lock:
            return (self.num_pages - 1) - len(self._free)

    def all_free(self) -> bool:
        """The leak check: after a full drain every page is back."""
        with self._lock:
            return len(self._free) == self.num_pages - 1 \
                and not self._seq_pages

    def can_admit(self, total_len: int) -> bool:
        if total_len > self.max_seq_len:
            raise ValueError(f"sequence of {total_len} positions exceeds "
                             f"pool max_seq_len {self.max_seq_len}")
        with self._lock:
            return self.pages_for(total_len) <= len(self._free)

    # ---- alloc / free --------------------------------------------------- #
    def alloc(self, seq_id: int, total_len: int) -> List[int]:
        """Reserve every page a sequence of ``total_len`` positions will
        ever touch. Raises :class:`PoolExhausted` without allocating
        anything (all-or-nothing)."""
        n = self.pages_for(total_len)
        with self._lock:
            if seq_id in self._seq_pages:
                raise ValueError(f"seq {seq_id} already holds pages")
            if n > len(self._free):
                raise PoolExhausted(
                    f"need {n} pages, {len(self._free)} free "
                    f"(pool {self.num_pages - 1})")
            pages = [self._free.pop() for _ in range(n)]
            self._seq_pages[seq_id] = pages
            self.allocs += 1
            used = (self.num_pages - 1) - len(self._free)
            self.peak_pages_used = max(self.peak_pages_used, used)
            return list(pages)

    def free(self, seq_id: int) -> int:
        """Retire a sequence: its pages return to the free list at once
        (no zeroing). Idempotent."""
        with self._lock:
            pages = self._seq_pages.pop(seq_id, None)
            if pages is None:
                return 0
            self._free.extend(pages)
            self.frees += 1
            return len(pages)

    def pages_of(self, seq_id: int) -> List[int]:
        with self._lock:
            return list(self._seq_pages.get(seq_id, ()))

    # ---- page tables ----------------------------------------------------- #
    def table_row(self, seq_id: int) -> np.ndarray:
        """One sequence's page-table row, padded with the scratch page."""
        row = np.zeros((self.max_pages_per_seq,), np.int32)
        pages = self.pages_of(seq_id)
        row[:len(pages)] = pages
        return row

    def table(self, seq_ids: Sequence[Optional[int]]) -> np.ndarray:
        """(R, max_pages) page table for one decode dispatch; ``None``
        entries (inactive padding rows) get the all-scratch row."""
        rows = np.zeros((len(seq_ids), self.max_pages_per_seq), np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is not None:
                rows[i] = self.table_row(sid)
        return rows

    # ---- prefill scatter -------------------------------------------------- #
    def write_prefill(self, seq_id: int, dense_caches) -> None:
        """Copy a prefill's dense per-layer caches (B=1, shape (1, H, T, Dh)
        with T page-aligned) into the sequence's first T/page_size pages, in
        place: the hand-off from the prompt phase to paged decode."""
        t = int(dense_caches[0][0].shape[2])
        if t % self.page_size:
            raise ValueError(f"prefill cache length {t} is not "
                             f"page-aligned (page_size {self.page_size})")
        n = t // self.page_size
        pages = self.pages_of(seq_id)
        if n > len(pages):
            raise ValueError(f"prefill needs {n} pages, seq {seq_id} "
                             f"holds {len(pages)}")
        h = self.cfg.n_heads
        dh = self.cfg.d_model // self.cfg.n_heads
        idx = torch.as_tensor(pages[:n], dtype=torch.long, device=self.device)
        for (pk, pv), (ck, cv) in zip(self.caches, dense_caches):
            for pool, dense in ((pk, ck), (pv, cv)):
                pool[idx] = dense[0].reshape(h, n, self.page_size, dh) \
                    .transpose(0, 1).to(pool.dtype)

    # ---- introspection ---------------------------------------------------- #
    def snapshot(self) -> Dict:
        with self._lock:
            used = (self.num_pages - 1) - len(self._free)
            return {
                "num_pages": self.num_pages - 1,      # usable (sans scratch)
                "page_size": self.page_size,
                "pages_used": used,
                "pages_free": len(self._free),
                "peak_pages_used": self.peak_pages_used,
                "sequences": len(self._seq_pages),
                "allocs": self.allocs,
                "frees": self.frees,
            }
