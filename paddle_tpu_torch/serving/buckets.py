"""Shape buckets: the fixed-shape contract between serving and XLA.

paddle_tpu compiles one executable per program *and feed-shape
signature* (jax.jit re-specializes on shapes), so a server that let
request shapes float would recompile — seconds to minutes — in the
middle of traffic. The Julia→TPU full-compilation work (Fischer &
Saba, 2018) hits the identical constraint: whole-program XLA wants
every shape pinned ahead of time. The serving answer is a small,
pre-declared set of shape buckets:

- **batch buckets** — allowed padded batch sizes (e.g. 1, 2, 4, 8). A
  micro-batch of 3 requests pads up to the 4-bucket by replicating a
  real row (replication, not zeros, so models with data-dependent
  numerics never see synthetic garbage), runs, and the pad rows are
  sliced off before results return to callers.
- **length buckets** — for sequence inputs (dim 1), allowed padded
  lengths per input name. Requests are *grouped* by their length
  signature before coalescing (batching.py), so a request's numbers
  never depend on which peers it shared a batch with.

``BucketSpec`` is pure policy + padding math: no threads, no executor,
fully unit-testable. ``ServingEngine.warmup`` walks
``all_signatures()`` to pre-compile every executable the spec can ever
produce, and steady-state traffic then hits only those.
"""
import numpy as np

__all__ = ["BucketError", "BucketSpec"]


class BucketError(ValueError):
    """A request does not fit any declared bucket (batch rows or a
    sequence length exceed the largest declared size). Structured —
    admission control rejects the request up front rather than letting
    it poison the compile cache with a novel shape."""


def _validate_sizes(sizes, what):
    sizes = tuple(sorted(set(int(s) for s in sizes)))
    if not sizes or sizes[0] < 1:
        raise ValueError(f"{what} must be a non-empty set of positive "
                         f"ints, got {sizes!r}")
    return sizes


class BucketSpec:
    """Declares the padded-shape lattice the server may run.

    ``batch_sizes``: allowed padded batch sizes, e.g. ``(1, 2, 4, 8)``.
    ``seq_lens``: optional ``{input_name: (lens...)}`` — inputs whose
    dim 1 is variable and must pad up to a declared length.
    ``pad_values``: optional ``{input_name: scalar}`` used when padding
    sequence positions (default 0 — a pad/eos id for token inputs).
    """

    def __init__(self, batch_sizes=(1, 2, 4, 8), seq_lens=None,
                 pad_values=None):
        self.batch_sizes = _validate_sizes(batch_sizes, "batch_sizes")
        self.seq_lens = {name: _validate_sizes(lens, f"seq_lens[{name}]")
                         for name, lens in (seq_lens or {}).items()}
        self.pad_values = dict(pad_values or {})

    @property
    def max_batch(self):
        return self.batch_sizes[-1]

    # -- persistence -----------------------------------------------------
    def to_manifest(self):
        """Plain-JSON form for the save_inference_model serving
        manifest: a fresh replica rebuilds the exact warmup compile
        set from this instead of guessing buckets (io/__init__.py
        writes it, from_saved_model reads it)."""
        return {"batch_sizes": list(self.batch_sizes),
                "seq_lens": {n: list(l)
                             for n, l in self.seq_lens.items()},
                "pad_values": dict(self.pad_values)}

    @classmethod
    def from_manifest(cls, manifest):
        return cls(batch_sizes=manifest["batch_sizes"],
                   seq_lens=manifest.get("seq_lens") or None,
                   pad_values=manifest.get("pad_values") or None)

    # -- bucket selection ------------------------------------------------
    def batch_bucket(self, n_rows):
        """Smallest declared batch size >= n_rows."""
        for b in self.batch_sizes:
            if b >= n_rows:
                return b
        raise BucketError(
            f"batch of {n_rows} rows exceeds the largest declared "
            f"batch bucket {self.max_batch} — declare a bigger bucket "
            f"or split the request")

    def seq_bucket(self, name, length):
        """Smallest declared length bucket >= length for input ``name``
        (inputs without declared length buckets pass through)."""
        lens = self.seq_lens.get(name)
        if lens is None:
            return length
        for l in lens:
            if l >= length:
                return l
        raise BucketError(
            f"input {name!r} length {length} exceeds the largest "
            f"declared length bucket {lens[-1]}")

    def signature(self, feed):
        """The shape-group key for a request feed: a sorted tuple of
        (input_name, padded_seq_len) for every length-bucketed input.
        Only requests with EQUAL signatures may share a micro-batch —
        that keeps each request's padded shapes (hence its numerics)
        independent of its co-batched peers."""
        sig = []
        for name in sorted(self.seq_lens):
            if name in feed:
                arr = np.asarray(feed[name])
                if arr.ndim < 2:
                    raise BucketError(
                        f"input {name!r} declares length buckets but "
                        f"the fed array has no dim 1 (shape "
                        f"{arr.shape})")
                sig.append((name, self.seq_bucket(name, arr.shape[1])))
        return tuple(sig)

    def all_signatures(self, names=None):
        """Every (batch_bucket, signature) pair this spec can produce —
        the warmup compile set. ``names`` restricts which declared
        seq inputs apply (default: all of them)."""
        seq_names = sorted(n for n in self.seq_lens
                           if names is None or n in names)
        sigs = [()]
        for name in seq_names:
            sigs = [s + ((name, l),) for s in sigs
                    for l in self.seq_lens[name]]
        return [(b, s) for b in self.batch_sizes for s in sigs]

    # -- padding / unpadding ---------------------------------------------
    def pad_seq(self, name, arr):
        """Pad ``arr``'s dim 1 up to its length bucket with the input's
        pad value (default 0). No-op for non-bucketed inputs."""
        arr = np.asarray(arr)
        if name not in self.seq_lens:
            return arr
        target = self.seq_bucket(name, arr.shape[1])
        if arr.shape[1] == target:
            return arr
        pad = np.full(
            (arr.shape[0], target - arr.shape[1]) + arr.shape[2:],
            self.pad_values.get(name, 0), dtype=arr.dtype)
        return np.concatenate([arr, pad], axis=1)

    def pad_batch(self, feeds):
        """Coalesce per-request feeds (same signature, each value an
        array with a leading rows dim) into ONE bucket-shaped feed.

        Returns ``(batch_feed, n_real_rows, bucket_rows)``. Pad rows
        replicate row 0 of the assembled batch — real data, so
        numerics of real rows cannot be perturbed and the pad rows
        cannot produce NaN side effects in models that reduce over the
        batch. Callers slice results back with :meth:`unpad_rows`.
        """
        if not feeds:
            raise ValueError("pad_batch needs at least one request feed")
        names = sorted(feeds[0])
        for f in feeds[1:]:
            if sorted(f) != names:
                raise ValueError(
                    f"coalesced requests disagree on feed names: "
                    f"{names} vs {sorted(f)}")
        batch_feed = {}
        n_rows = None
        for name in names:
            parts = [self.pad_seq(name, f[name]) for f in feeds]
            stacked = np.concatenate(parts, axis=0)
            if n_rows is None:
                n_rows = stacked.shape[0]
            elif stacked.shape[0] != n_rows:
                raise ValueError(
                    f"input {name!r} has {stacked.shape[0]} rows but "
                    f"other inputs have {n_rows}")
            batch_feed[name] = stacked
        bucket_rows = self.batch_bucket(n_rows)
        if bucket_rows > n_rows:
            for name in names:
                arr = batch_feed[name]
                fill = np.broadcast_to(
                    arr[:1], (bucket_rows - n_rows,) + arr.shape[1:])
                batch_feed[name] = np.concatenate([arr, fill], axis=0)
        return batch_feed, n_rows, bucket_rows

    @staticmethod
    def unpad_rows(fetches, row_counts):
        """Split batched fetch arrays back into per-request slices.
        ``row_counts`` is the real row count per coalesced request, in
        batch order; trailing pad rows are dropped. Fetches without a
        batch dim that covers the rows (e.g. scalar metrics) are
        replicated to every request as-is."""
        total = sum(row_counts)
        out = [[] for _ in row_counts]
        for arr in fetches:
            arr = np.asarray(arr)
            if arr.ndim >= 1 and arr.shape[0] >= total:
                ofs = 0
                for i, n in enumerate(row_counts):
                    out[i].append(arr[ofs:ofs + n])
                    ofs += n
            else:
                for slot in out:
                    slot.append(arr)
        return out
