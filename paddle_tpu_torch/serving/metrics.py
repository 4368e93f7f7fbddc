"""Serving metrics registry — the latency/throughput instruments an
operator tunes batching with.

One lock-guarded registry per engine: monotonic counters (requests,
responses, batches, sheds, timeouts, errors, retries, breaker
opens/sheds/probes, watchdog firings, drained requests), row accounting
for the batch-fill ratio (real rows vs padded bucket capacity — THE
number that says whether max_wait is too short or buckets too coarse),
a queue-depth gauge sampled by the worker, and a bounded reservoir of
per-request latencies for p50/p95/p99. ``stats()`` returns a plain
dict snapshot (json-serializable — tools/servebench.py prints it
verbatim); ``counter_deltas`` helps tests assert exact increments.

Deliberately not the fluid-parity training metrics in
paddle_tpu/metrics.py (accuracy/auc over minibatches): these are
server-side operational metrics, a different axis entirely.
"""
import threading

import numpy as np

__all__ = ["ServingMetrics"]

_COUNTERS = ("requests_total", "responses_total", "batches_total",
             "shed_total", "timeouts_total", "errors_total",
             "retries_total", "rows_total", "padded_rows_total",
             "warmup_compiles",
             # hardening counters (docs/SERVING.md "Operating under
             # failure"): breaker lifecycle, watchdog firings, drain
             "breaker_open_total", "breaker_shed_total",
             "breaker_probe_total", "worker_died_total",
             "drained_total")

# bounded latency reservoir: enough samples for stable tail estimates,
# O(1) memory under sustained traffic (newest-window semantics)
_LATENCY_WINDOW = 4096


class ServingMetrics:
    """Thread-safe counters + latency percentiles for one engine.

    ``extra_counters`` extends the counter vocabulary for specialized
    engines (the continuous-batching decode engine counts prefills,
    decode dispatches, generated tokens, speculation acceptance);
    ``observe_window``/named windows do the same for latency axes
    beyond request latency (TTFT, TPOT, per-step service time).
    """

    def __init__(self, extra_counters=()):
        self._lock = threading.Lock()
        self._counters = {name: 0
                          for name in _COUNTERS + tuple(extra_counters)}
        self._latencies = []          # seconds, newest-window bounded
        self._batch_latencies = []
        self._windows = {}            # name -> bounded sample list
        self._queue_depth = 0
        self._queue_depth_peak = 0

    # -- recording -------------------------------------------------------
    def incr(self, name, n=1):
        with self._lock:
            if name not in self._counters:
                raise KeyError(f"unknown serving counter {name!r}; one "
                               f"of {sorted(self._counters)}")
            self._counters[name] += n

    def observe_batch(self, n_rows, bucket_rows, batch_latency_s):
        """One executed micro-batch: real rows, padded bucket capacity,
        and the worker-side batch service time."""
        with self._lock:
            self._counters["batches_total"] += 1
            self._counters["rows_total"] += int(n_rows)
            self._counters["padded_rows_total"] += int(bucket_rows)
            self._batch_latencies.append(float(batch_latency_s))
            del self._batch_latencies[:-_LATENCY_WINDOW]

    def observe_latency(self, seconds):
        """One fulfilled request's enqueue→response latency."""
        with self._lock:
            self._latencies.append(float(seconds))
            del self._latencies[:-_LATENCY_WINDOW]

    def observe_window(self, name, seconds):
        """One sample into the named latency window (created on first
        use; bounded like the request-latency reservoir). Non-finite
        samples are dropped at the door — a single NaN must never
        poison every percentile in the snapshot."""
        v = float(seconds)
        if not np.isfinite(v):
            return
        with self._lock:
            w = self._windows.setdefault(name, [])
            w.append(v)
            del w[:-_LATENCY_WINDOW]

    def set_queue_depth(self, depth):
        with self._lock:
            self._queue_depth = int(depth)
            self._queue_depth_peak = max(self._queue_depth_peak, depth)

    # -- snapshot --------------------------------------------------------
    @staticmethod
    def _percentiles(samples):
        """Percentile summary that is safe on an empty or one-sample
        window and in the presence of non-finite samples: an engine's
        stats() must be callable from the first instant of its life
        (servebench polls it mid-warmup) without IndexError/NaN."""
        arr = np.asarray(samples, dtype=np.float64)
        if arr.size:
            arr = arr[np.isfinite(arr)]
        if not arr.size:
            return {"p50_ms": None, "p95_ms": None, "p99_ms": None,
                    "count": 0}
        arr = arr * 1e3
        p50, p95, p99 = np.percentile(arr, [50.0, 95.0, 99.0])
        return {"p50_ms": round(float(p50), 3),
                "p95_ms": round(float(p95), 3),
                "p99_ms": round(float(p99), 3),
                "count": int(arr.size)}

    def stats(self):
        """Plain-dict snapshot: counters, batch-fill ratio, queue
        depth, request-latency percentiles."""
        with self._lock:
            counters = dict(self._counters)
            padded = counters["padded_rows_total"]
            snap = dict(counters)
            snap["batch_fill_ratio"] = (
                round(counters["rows_total"] / padded, 4) if padded
                else None)
            snap["mean_batch_rows"] = (
                round(counters["rows_total"]
                      / counters["batches_total"], 3)
                if counters["batches_total"] else None)
            snap["queue_depth"] = self._queue_depth
            snap["queue_depth_peak"] = self._queue_depth_peak
            snap["request_latency"] = self._percentiles(self._latencies)
            snap["batch_latency"] = self._percentiles(
                self._batch_latencies)
            for name, w in sorted(self._windows.items()):
                snap[name] = self._percentiles(w)
            return snap

    @classmethod
    def merge(cls, *others, label=None):
        """Combine per-replica registries into one cluster-level view
        (paddle_tpu/cluster/ pool ``stats()`` builds its pool-wide
        p50/p95/p99 with this). Counters sum over the UNION of the
        vocabularies (a pool may mix classifier and decode replicas,
        whose extra counters differ); latency reservoirs and named
        windows concatenate and re-bound to the newest
        ``_LATENCY_WINDOW`` samples, so the merged percentiles weight
        each replica by how many samples it actually served. Queue
        depth sums (the cluster's total backlog); the peak sum is an
        upper bound, not a witnessed instant — replicas peak at
        different times. Empty registries and non-finite samples merge
        harmlessly (``_percentiles`` already filters non-finite).

        ``label`` namespaces the merge: every merged counter and
        latency window lands under ``"<label>/<name>"`` (the base
        request/batch reservoirs become the ``<label>/request_latency``
        and ``<label>/batch_latency`` windows) so a pool serving two
        model versions side by side can merge each version under its
        own prefix and then merge THOSE into one registry without the
        versions' counters colliding — the canary's error count must
        never be laundered into the incumbent's."""
        merged = cls()
        prefix = "" if label is None else f"{label}/"
        for o in others:
            with o._lock:
                counters = dict(o._counters)
                lat = list(o._latencies)
                blat = list(o._batch_latencies)
                windows = {n: list(w) for n, w in o._windows.items()}
                depth = o._queue_depth
                peak = o._queue_depth_peak
            for name, v in counters.items():
                key = prefix + name
                merged._counters[key] = \
                    merged._counters.get(key, 0) + v
            if label is None:
                merged._latencies.extend(lat)
                merged._batch_latencies.extend(blat)
            else:
                merged._windows.setdefault(
                    prefix + "request_latency", []).extend(lat)
                merged._windows.setdefault(
                    prefix + "batch_latency", []).extend(blat)
            for name, w in windows.items():
                merged._windows.setdefault(prefix + name, []).extend(w)
            merged._queue_depth += depth
            merged._queue_depth_peak += peak
        del merged._latencies[:-_LATENCY_WINDOW]
        del merged._batch_latencies[:-_LATENCY_WINDOW]
        for w in merged._windows.values():
            del w[:-_LATENCY_WINDOW]
        return merged

    def counter_deltas(self, before):
        """Counter changes since a previous ``stats()`` snapshot —
        tests assert exact shed/timeout increments with this."""
        now = self.stats()
        with self._lock:
            names = tuple(self._counters)
        return {k: now[k] - before.get(k, 0) for k in names}
