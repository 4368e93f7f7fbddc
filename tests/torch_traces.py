"""Overload-trace helpers for the port's tests: a jax-free copy of
``gen_overload_trace``, ``load_rich_trace`` and ``load_trace`` from the
JAX package's ``tools/servebench.py`` (which imports ``paddle_tpu``).
The shipped recorded trace stays where it is, under ``tools/traces/``,
and is read as data.
"""
import json

import numpy as np

__all__ = ["gen_overload_trace", "load_rich_trace", "load_trace"]


def load_rich_trace(path):
    """A recorded trace (the reference's docs/SERVING.md "Trace-file
    schema"): JSON —
    either a bare list of absolute arrival offsets (seconds), or a
    dict with ``offsets`` plus optional per-request columns:

    - ``class``:  priority tier per request ("interactive" /
      "standard" / "batch")
    - ``bucket``: prompt-length bucket per request (int)
    - ``phase``:  segment label per request ("diurnal" / "flash" ...);
      ``"flash"`` rows double as the burst mask
    - ``burst``:  explicit bool burst mask (overrides ``phase``)

    Returns a dict with ``offsets`` (float64 array), ``burst`` (bool
    array) and — None when the file doesn't carry them — ``classes``,
    ``buckets``, ``phases``. Every present column must match
    ``offsets`` in length."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        data = {"offsets": data}
    offsets = np.asarray(data["offsets"], dtype=np.float64)
    n = len(offsets)
    phases = data.get("phase")
    if "burst" in data:
        burst = np.asarray(data["burst"], dtype=bool)
    elif phases is not None:
        burst = np.asarray([p == "flash" for p in phases], dtype=bool)
    else:
        burst = np.zeros(n, dtype=bool)
    classes = data.get("class")
    buckets = data.get("bucket")
    buckets = None if buckets is None else [int(b) for b in buckets]
    for col_name, col in (("class", classes), ("bucket", buckets),
                          ("phase", phases), ("burst", burst)):
        if col is not None and len(col) != n:
            raise ValueError(
                f"trace column {col_name!r} has {len(col)} entries "
                f"for {n} offsets — every per-request column must "
                "align with 'offsets'")
    return {"offsets": offsets, "burst": burst, "classes": classes,
            "buckets": buckets, "phases": phases}


def load_trace(path):
    """Back-compat view of :func:`load_rich_trace`: (offsets,
    burst_mask) — what the plain ``--arrival trace`` ladder needs."""
    rich = load_rich_trace(path)
    return rich["offsets"], rich["burst"]


def gen_overload_trace(n, rate, rng, buckets=(8, 16), flash_factor=4.0,
                       diurnal_cycles=2.0, flash_start=0.55,
                       flash_len=0.15, mix=(0.2, 0.45, 0.35)):
    """Deterministic overload trace (the --overload referee's input):
    ``n`` arrivals whose instantaneous rate follows ``diurnal_cycles``
    sinusoidal day/night cycles around ``rate`` (0.4x troughs, 1.0x
    peaks), with one contiguous FLASH CROWD — the ``flash_len``
    fraction of the trace starting at the ``flash_start`` fraction
    arrives at ``flash_factor`` x the diurnal rate. Request classes
    are drawn from ``mix`` = (interactive, standard, batch) fractions,
    and the prompt-bucket skew DRIFTS long across the trace (20% long
    at the start, 80% at the end) so bucketed prefill sees a changing
    shape mix, not a stationary one. Same shape as
    :func:`load_rich_trace`'s return."""
    if rate <= 0:
        raise ValueError(f"trace rate must be > 0, got {rate}")
    names = ("interactive", "standard", "batch")
    cum = np.cumsum(np.asarray(mix, dtype=np.float64))
    if abs(cum[-1] - 1.0) > 1e-9:
        raise ValueError(f"class mix must sum to 1, got {mix}")
    gaps = np.empty(n)
    bucket_col = []
    classes = []
    phases = []
    for i in range(n):
        frac = i / max(1, n - 1)
        m = 0.7 + 0.3 * np.sin(2.0 * np.pi * diurnal_cycles * frac)
        in_flash = flash_start <= frac < flash_start + flash_len
        if in_flash:
            m *= flash_factor
        gaps[i] = rng.exponential(1.0 / (rate * m))
        phases.append("flash" if in_flash else "diurnal")
        classes.append(names[int(np.searchsorted(cum, rng.uniform(),
                                                 side="left"))])
        p_long = 0.2 + 0.6 * frac       # bucket-skew drift
        bucket_col.append(int(buckets[-1] if rng.uniform() < p_long
                              else buckets[0]))
    return {"offsets": np.cumsum(gaps),
            "burst": np.asarray([p == "flash" for p in phases]),
            "classes": classes, "buckets": bucket_col,
            "phases": phases}
