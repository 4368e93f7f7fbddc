"""Paged KV-cache bookkeeping — the host side of continuous batching.

Port of ``paddle_tpu/serving/kv_pages.py``: pure host code, copied
as it is (the port imports nothing of the JAX package).

The decode engine's step programs are fixed-shape, so its KV cache is a
static pool ``[n_layers, n_pages, page_size, kv_heads, head_dim]`` and
all dynamism lives in *integer indices*: each active slot owns a set of
pages, listed in a per-slot page TABLE that is fed to the decode-step
program every dispatch. Joining a batch is allocating pages and writing
a table row; leaving is returning the pages. Nothing about request
churn ever changes a traced shape (the vLLM PagedAttention idea, under
this repo's one-executable-per-program discipline).

Page 0 is reserved as the **null page**: inactive slots point every
table entry at it, so their (discarded) lockstep writes land somewhere
harmless, and the attention length mask guarantees it is never read
back into a real row. Freed pages are NOT zeroed — the mask already
makes stale contents unobservable (pinned by test: a request reusing a
retired request's pages is bit-identical to running it alone); the
allocator only enforces the integer invariants (no double alloc, no
double free, exhaustion is a typed shed).

Pure host-side integers: no torch, no numpy, trivially unit-testable.
"""
from .batching import QueueFullError

__all__ = ["PagesExhaustedError", "PageAllocator"]


class PagesExhaustedError(QueueFullError):
    """The page pool cannot satisfy an allocation. Subclasses
    QueueFullError deliberately: to a client this is the same load-shed
    contract — back off and retry (or the request can NEVER fit, which
    submit() rejects up front)."""


class PageAllocator:
    """Fixed pool of ``n_pages`` KV pages of ``page_size`` positions.

    Page 0 is the reserved null page and is never handed out; the
    usable pool is pages 1..n_pages-1. ``alloc`` returns pages in
    ascending order (determinism for tests), ``free`` returns them.
    """

    def __init__(self, n_pages, page_size):
        if n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the reserved null "
                f"page), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free = set(range(1, self.n_pages))

    # -- capacity queries ------------------------------------------------
    @property
    def usable_pages(self):
        """Total allocatable pages (the pool minus the null page)."""
        return self.n_pages - 1

    @property
    def available(self):
        return len(self._free)

    @property
    def in_use(self):
        return self.usable_pages - len(self._free)

    def pages_for(self, n_positions):
        """Pages needed to cover ``n_positions`` sequence positions."""
        if n_positions < 1:
            raise ValueError(
                f"n_positions must be >= 1, got {n_positions}")
        return -(-int(n_positions) // self.page_size)

    # -- alloc / free ----------------------------------------------------
    def alloc(self, n):
        """Allocate ``n`` pages or raise PagesExhaustedError (leaving
        the pool untouched — no partial grants)."""
        n = int(n)
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if n > len(self._free):
            raise PagesExhaustedError(
                f"KV page pool exhausted: need {n} pages, "
                f"{len(self._free)}/{self.usable_pages} free — load "
                "shed, retry with backoff (or grow n_pages)")
        got = sorted(self._free)[:n]
        self._free.difference_update(got)
        return got

    def free(self, pages):
        """Return pages to the pool. Double-free and null-page returns
        are invariant violations and raise."""
        pages = list(pages)
        for p in pages:
            if not 1 <= p < self.n_pages:
                raise ValueError(
                    f"free of page {p} outside the usable pool "
                    f"[1, {self.n_pages})")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
        self._free.update(pages)

    # -- KV handoff hooks ------------------------------------------------
    def export_state(self, pages):
        """Bookkeeping half of a KV handoff export: validate that
        every page is a live allocation of THIS pool (exporting a
        freed or out-of-range page would ship garbage the length mask
        no longer protects) and return the allocator-level state that
        travels with the page contents. Page ids are exporter-local —
        import allocates fresh pages, so the blob is
        location-independent."""
        pages = [int(p) for p in pages]
        for p in pages:
            if not 1 <= p < self.n_pages:
                raise ValueError(
                    f"cannot export page {p}: outside the usable "
                    f"pool [1, {self.n_pages})")
            if p in self._free:
                raise ValueError(
                    f"cannot export page {p}: not a live allocation")
        return {"pages": pages, "page_size": self.page_size}

    def import_alloc(self, state, total=None):
        """Allocation half of a KV handoff import: check geometry
        compatibility (a page_size mismatch would silently misalign
        every position past the first page) and allocate fresh local
        pages — at least as many as the export used, or ``total`` if
        the importer needs headroom for decode. Raises
        PagesExhaustedError like any alloc (the caller requeues)."""
        if int(state.get("page_size", -1)) != self.page_size:
            raise ValueError(
                f"handoff page_size {state.get('page_size')!r} does "
                f"not match this pool's page_size {self.page_size}")
        n = len(state["pages"])
        if total is not None:
            n = max(n, int(total))
        return self.alloc(n)
