"""Reader decorators (port of ``paddle_tpu/reader/decorator.py``, a
copy: the module never touched jax).

Parity with python/paddle/reader/decorator.py: composable generators —
batch, shuffle, map_readers, buffered, cache, chain, compose, firstn,
xmap_readers. A "reader" is a zero-arg callable returning an iterator of
samples, exactly the reference contract.

Beyond parity: ``retry_reader`` (resilience subsystem, see
docs/RELIABILITY.md) survives flaky sources — exponential backoff per
failing position, a skip budget for poisoned batches, and a
deterministic fault-injection point for tier-1 tests.
"""
import itertools
import queue
import random
import threading
import time

from ..resilience import faultinject

__all__ = ["batch", "shuffle", "map_readers", "buffered", "cache", "chain",
           "compose", "firstn", "retry_reader", "xmap_readers",
           "ComposeNotAligned"]


class ComposeNotAligned(ValueError):
    pass


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size):
    def shuffled():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            random.shuffle(buf)
            yield from buf
    return shuffled


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()
    return reader


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum((make_tuple(x) for x in outputs), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum((make_tuple(x) for x in outputs), ())
    return reader


def buffered(reader, size):
    """Prefetches up to ``size`` samples on a background thread."""

    class _End:
        pass

    def readr():
        q = queue.Queue(maxsize=size)
        err = []

        def feed():
            try:
                for e in reader():
                    q.put(e)
            except BaseException as exc:   # surface, don't truncate epochs
                err.append(exc)
            finally:
                q.put(_End)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e
        if err:
            raise err[0]
    return readr


def batch(reader, batch_size, drop_last=False):
    def batch_reader():
        b = []
        for ins in reader():
            b.append(ins)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


def cache(reader):
    all_data = []
    filled = []

    def cached():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        yield from all_data
    return cached


def retry_reader(reader, max_attempts=3, initial_backoff=0.05,
                 max_backoff=2.0, skip_budget=0,
                 retry_on=(IOError, OSError), sleep=None):
    """Survive a flaky reader: retry failing pulls with exponential
    backoff, optionally skipping batches that never come clean.

    A position that raises one of ``retry_on`` is retried up to
    ``max_attempts`` total attempts, sleeping
    ``initial_backoff * 2**(k-1)`` (capped at ``max_backoff``) between
    them; each retry rebuilds the source iterator and fast-forwards to
    the failing position, since a generator that raised is dead. When
    attempts are exhausted, up to ``skip_budget`` positions may be
    abandoned (the poisoned-batch budget — think one corrupt shard in
    an epoch); past the budget the last error propagates. Skipping
    requires a source whose iterator can get PAST the bad position on
    re-iteration (map-style pipelines, decode-after-read readers); a
    generator that deterministically raises at the same position makes
    everything after it unreachable, and that surfaces as the original
    error rather than a silently truncated epoch.

    ``sleep`` is injectable so tests assert the exact backoff schedule
    without waiting. Checks the ``reader_io_error`` fault-injection
    point before every pull, so tier-1 can exercise each path
    deterministically (docs/RELIABILITY.md)."""
    if max_attempts < 1:
        raise ValueError("max_attempts must be >= 1")
    do_sleep = sleep or time.sleep

    def retried():
        consumed = 0        # positions delivered or abandoned
        skipped = 0
        failures_here = 0   # attempts burned at the current position
        last_exc = [None]

        def repositioned():
            """Fresh iterator fast-forwarded past ``consumed``
            positions. Errors on already-handled positions are
            tolerated for iterators that survive a raise (map-style
            pipelines); a GENERATOR that raises is closed — everything
            past the poison is unreachable, so the error propagates
            instead of the epoch silently truncating. A source that
            ENDS before the resume point surfaces the original failure
            too (the data shrank, or a dead frame is replaying)."""
            import types
            it = reader()
            done = 0
            while done < consumed:
                try:
                    next(it)
                except StopIteration:
                    if last_exc[0] is not None:
                        raise last_exc[0]
                    raise RuntimeError(
                        f"retry_reader: source ended at position {done} "
                        f"before the resume point {consumed} — did the "
                        "underlying data shrink between attempts?")
                except retry_on:
                    if isinstance(it, types.GeneratorType):
                        raise       # closed generator: poison is unskippable
                done += 1
            return it

        it = reader()
        while True:
            try:
                if faultinject.fires("reader_io_error"):
                    raise IOError("injected reader failure")
                item = next(it)
            except StopIteration:
                return
            except retry_on as exc:
                last_exc[0] = exc
                failures_here += 1
                if failures_here < max_attempts:
                    do_sleep(min(max_backoff,
                                 initial_backoff
                                 * 2.0 ** (failures_here - 1)))
                elif skipped < skip_budget:
                    skipped += 1
                    consumed += 1       # abandon the poisoned position
                    failures_here = 0
                else:
                    raise
                it = repositioned()     # retry (or continue) from a
                continue                # freshly positioned iterator
            consumed += 1
            failures_here = 0
            yield item
    return retried


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                break
            yield item
    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader using worker threads (reference
    xmap_readers). ``order=True`` preserves input order."""

    end_token = object()

    def xreader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feed():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(end_token)

        errors = []

        def work():
            try:
                while True:
                    item = in_q.get()
                    if item is end_token:
                        break
                    i, sample = item
                    out_q.put((i, mapper(sample)))
            except BaseException as exc:
                errors.append(exc)
            finally:
                out_q.put(end_token)

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()

        finished = 0
        if order:
            pending = {}
            want = 0
            while finished < process_num:
                item = out_q.get()
                if item is end_token:
                    finished += 1
                    continue
                i, mapped = item
                pending[i] = mapped
                while want in pending:
                    yield pending.pop(want)
                    want += 1
            for i in sorted(pending):
                yield pending[i]
        else:
            while finished < process_num:
                item = out_q.get()
                if item is end_token:
                    finished += 1
                    continue
                yield item[1]
        if errors:
            raise errors[0]
    return xreader
