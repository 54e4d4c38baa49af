"""Paged session-state slabs: shared storage for many short streams.

The counterpart of ``repro.launch.slab``. A streaming decode session carries
soft symbols between chunks — the inter-block overlap tail plus whatever
arrived since the last launch. With one contiguous ndarray per session (the
default :class:`~repro_torch.core.engine.ArraySessionStore`), a serving
layer admitting many short-lived streams churns an allocation per chunk per
stream. This module is the paged alternative: ONE slab of fixed-size pages
shared by every live session, a LIFO free-list so a dying stream's pages are
reused by the next admit, and per-session stores that are *views* onto
their page list.

* :class:`SymbolSlab` — the allocator: ``(n_pages, page_stages, R)``
  float32 backing array in host memory + free-list. Pages are zeroed on
  release, so a freshly allocated page is all-zero (the BM-neutral erasure
  value the punctured ingest and the zero-padded tail rely on). Integer
  (pre-quantized) chunks are exact in float32; the session casts its window
  back to their dtype on the way to the device.
* :class:`PagedSessionStore` — one session's buffered-symbol window,
  implementing the :class:`~repro_torch.core.engine.ArraySessionStore`
  contract over a list of slab pages.

Exhaustion is an explicit :class:`SlabExhausted`, which the admission layer
(:mod:`repro_torch.launch.serve_async`) maps to backpressure.
"""

from __future__ import annotations

import numpy as np

from repro_torch.launch.faults import CapacityError

__all__ = ["SlabExhausted", "SymbolSlab", "PagedSessionStore"]


class SlabExhausted(CapacityError):
    """No free pages left in the slab (admission should apply backpressure).

    A :class:`~repro_torch.launch.faults.CapacityError`: the service — not the
    stream or the launch — is out of room, so waiting for a dispatch to
    retire pages (or shedding the admission) is the right response.
    """


class SymbolSlab:
    """A pool of fixed-size symbol pages with a LIFO free-list.

    Parameters
    ----------
    n_pages: total pages in the slab (the hard capacity knob).
    page_stages: full-rate stages per page. The serving layer sizes this to
        the session working set — a session holds at most ``D + L`` stages
        between steps plus whatever arrival jitter buffers on top, so
        ``D + 2L`` (one decode window) is a natural default.
    R: symbols per stage (the mother code rate denominator).
    """

    def __init__(self, n_pages: int, page_stages: int, R: int):
        if n_pages <= 0 or page_stages <= 0 or R <= 0:
            raise ValueError(
                f"slab geometry must be positive, got n_pages={n_pages}, "
                f"page_stages={page_stages}, R={R}"
            )
        self.n_pages = int(n_pages)
        self.page_stages = int(page_stages)
        self.R = int(R)
        self._data = np.zeros((n_pages, page_stages, R), np.float32)
        # flat (n_pages*page_stages, R) alias: one fancy-index gathers or
        # scatters any stage window regardless of page boundaries
        self._flat = self._data.reshape(-1, R)
        self._free: list[int] = list(range(n_pages - 1, -1, -1))  # LIFO: pop()
        self.high_water = 0  # max pages simultaneously in use (for reports)

    # ---- allocation ----------------------------------------------------------------
    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self) -> int:
        """Take a (zeroed) page id off the free-list."""
        if not self._free:
            raise SlabExhausted(
                f"slab exhausted: all {self.n_pages} pages "
                f"({self.n_pages * self.page_stages} stages) in use"
            )
        page = self._free.pop()
        self.high_water = max(self.high_water, self.pages_in_use)
        return page

    def free(self, page: int) -> None:
        """Return a page; zero it so the next alloc sees BM-neutral zeros."""
        if not 0 <= page < self.n_pages:
            raise ValueError(f"page {page} outside slab of {self.n_pages}")
        if page in self._free:
            raise ValueError(f"double free of slab page {page}")
        self._data[page] = 0.0
        self._free.append(page)

    def open_store(self) -> "PagedSessionStore":
        """A fresh (empty) session store over this slab."""
        return PagedSessionStore(self)


class PagedSessionStore:
    """One session's symbol buffer as a window over slab pages.

    Logical stage ``i`` (0 = oldest held stage) lives at page
    ``pages[(head + i) // P]``, row ``(head + i) % P`` where ``head`` is the
    intra-page offset of stage 0 and ``P = slab.page_stages``. ``append``/
    ``grow`` extend the tail (allocating pages on demand), ``drop_prefix``
    advances ``head`` and frees pages the window has fully left — so a
    steady-state stream touches exactly ceil(working set / P) pages no
    matter how many chunks flow through it.

    Implements the :class:`~repro_torch.core.engine.ArraySessionStore` contract;
    see that class for method semantics.
    """

    def __init__(self, slab: SymbolSlab):
        self._slab = slab
        self._pages: list[int] = []
        self._head = 0  # intra-page offset of logical stage 0
        self._n = 0  # stages held
        self._closed = False

    def __len__(self) -> int:
        return self._n

    # ---- row addressing ------------------------------------------------------------
    def _rows(self, lo: int, n: int) -> np.ndarray:
        """Flat slab row indices for logical stages [lo, lo+n)."""
        g = self._head + lo + np.arange(n)
        pages = np.asarray(self._pages, np.int64)[g // self._slab.page_stages]
        return pages * self._slab.page_stages + g % self._slab.page_stages

    def _ensure_capacity(self, n_total: int) -> None:
        """Grow the page list to hold ``n_total`` logical stages."""
        P = self._slab.page_stages
        need_pages = -(-(self._head + n_total) // P)
        while len(self._pages) < need_pages:
            self._pages.append(self._slab.alloc())

    # ---- ArraySessionStore contract ------------------------------------------------
    def append(self, rows: np.ndarray) -> None:
        self._check_open()
        rows = np.asarray(rows, np.float32)
        n = len(rows)
        if n == 0:
            return
        self._ensure_capacity(self._n + n)
        self._slab._flat[self._rows(self._n, n)] = rows
        self._n += n

    def grow(self, n: int) -> None:
        # pages arrive zeroed from the free-list and the tail past _n was
        # never written (stores only drop from the head), so growing is just
        # capacity + bookkeeping — no memset
        self._check_open()
        if n > 0:
            self._ensure_capacity(self._n + n)
            self._n += n

    def scatter(self, stage_idx, sym_idx, values) -> None:
        self._check_open()
        stage_idx = np.asarray(stage_idx)
        g = self._head + stage_idx
        P = self._slab.page_stages
        pages = np.asarray(self._pages, np.int64)[g // P]
        self._slab._flat[pages * P + g % P, sym_idx] = values

    def read(self, lo: int, n: int) -> np.ndarray:
        self._check_open()
        n = max(0, min(n, self._n - lo))
        if n <= 0:
            return np.zeros((0, self._slab.R), np.float32)
        return self._slab._flat[self._rows(lo, n)]

    def drop_prefix(self, n: int) -> None:
        self._check_open()
        n = min(n, self._n)
        if n <= 0:
            return
        self._head += n
        self._n -= n
        P = self._slab.page_stages
        while self._head >= P:
            self._slab.free(self._pages.pop(0))
            self._head -= P
        if self._n == 0 and self._head == 0 and self._pages:
            # fully drained on a page boundary: release the idle tail page too
            for p in self._pages:
                self._slab.free(p)
            self._pages.clear()

    def snapshot(self) -> dict:
        """Logical content only — a copy of the held rows, never page ids.

        Restoring allocates FRESH pages from whatever slab backs the target
        store (``_head`` restarts at 0); page boundaries shift but every
        logical stage is identical, which is all the session framing reads.
        """
        self._check_open()
        return {"rows": np.array(self.read(0, self._n), np.float32)}

    def restore(self, snap: dict) -> None:
        self._check_open()
        if self._n or self._pages:
            raise ValueError("restore() target store is not empty")
        self.append(np.asarray(snap["rows"], np.float32))

    def close(self) -> None:
        """Return every page to the slab; safe to call repeatedly."""
        if self._closed:
            return
        for p in self._pages:
            self._slab.free(p)
        self._pages.clear()
        self._head = self._n = 0
        self._closed = True

    # ---- internals -----------------------------------------------------------------
    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("operation on a closed PagedSessionStore")
