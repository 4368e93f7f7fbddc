"""Async device-prefetch loader.

Port of ``paddle_tpu/io/device_loader.py``. A background thread runs the
(possibly native-recordio-backed) reader and moves batches to the card
``buffer_size`` steps ahead, so the host→device copy of batch N+1 rides
under the device compute of batch N.

On CUDA each host array is staged in pinned memory (PyTorch's caching
host allocator, which holds a pinned block until the copy that reads it
has finished) and copied with ``non_blocking=True`` on a side stream;
an event recorded after the batch's copies is what the consumer's
stream waits on before the batch is handed out, and every tensor is
``record_stream``-ed on the consumer's stream, so the caching allocator
never hands its memory to the side stream while a step still reads it.
``Executor.run`` takes the CUDA tensors as feeds without a host round
trip. On the CPU (``device="cpu"`` or ``CPUPlace()``) batches become CPU
tensors, in order, through the same queue.
"""
import os
import queue
import threading

import numpy as np
import torch

from ..resilience.retry import default_policy, with_retries

__all__ = ["DeviceLoader"]

_END = object()


def _resolve_device(device):
    """A torch.device from a device, a string or a Place; None is the
    card (``CUDAPlace(0)``), which raises where CUDA is absent, or the
    host after ``force_cpu()``."""
    if device is None:
        from ..core.executor import default_place
        return default_place().device
    if hasattr(device, "device"):
        return device.device
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("DeviceLoader: CUDA is not available on this "
                           "machine; pass device=CPUPlace()")
    return dev


class DeviceLoader:
    """Wraps ``reader`` (a generator fn of feed dicts, or of tuples to
    be zipped with ``feed_names``) and yields dicts of device-resident
    tensors, transferred ``buffer_size`` batches ahead by a background
    thread.

    with DeviceLoader(reader, feed_names=["img", "label"]) as dl:
        for feed in dl:
            exe.run(main, feed=feed, fetch_list=[loss])

    Resilience: ``reader_retries`` > 1 wraps the source in
    ``reader.retry_reader`` (IOError-class failures retried with
    exponential backoff; default from PADDLE_TPU_READER_RETRIES, 1 =
    off), and each host→device copy runs under the shared transient
    retry policy — a failed transfer during prefetch re-sends the batch
    instead of killing the epoch.
    """

    def __init__(self, reader, feed_names=None, buffer_size=2,
                 device=None, reader_retries=None, skip_budget=0):
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        if reader_retries is None:
            reader_retries = int(
                os.environ.get("PADDLE_TPU_READER_RETRIES", "1"))
        if reader_retries > 1 or skip_budget > 0:
            from ..reader import retry_reader
            reader = retry_reader(reader,
                                  max_attempts=max(1, reader_retries),
                                  skip_budget=skip_budget)
        self._reader = reader
        self._feed_names = feed_names
        self._buffer = buffer_size
        self.device = _resolve_device(device)
        self._copy_stream = None
        self._thread = None
        self._queue = None
        self._stop = threading.Event()
        self._error = None

    # ------------------------------------------------------------------
    def _to_feed_dict(self, item):
        if isinstance(item, dict):
            return item
        if self._feed_names is None:
            raise ValueError(
                "reader yields tuples — pass feed_names to map them")
        if len(item) != len(self._feed_names):
            raise ValueError(
                f"reader yielded {len(item)} fields for "
                f"{len(self._feed_names)} feed names")
        return dict(zip(self._feed_names, item))

    def _stage(self, v):
        """One host value as a tensor on the device; on CUDA through a
        pinned buffer and a non-blocking copy on the side stream."""
        if isinstance(v, torch.Tensor):
            host = v
        else:
            host = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
        if self.device.type != "cuda":
            return host.to(self.device, copy=True)
        if host.device.type == "cpu" and not host.is_pinned():
            pinned = torch.empty(host.shape, dtype=host.dtype,
                                 pin_memory=True)
            pinned.copy_(host)
            host = pinned
        with torch.cuda.stream(self._copy_stream):
            return host.to(self.device, non_blocking=True)

    def _worker(self):
        policy = default_policy()
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            for item in self._reader():
                if self._stop.is_set():
                    return
                feed = self._to_feed_dict(item)
                # transient copy failures re-send the batch under the
                # shared retry policy
                staged = {k: with_retries(lambda v=v: self._stage(v),
                                          policy=policy)
                          for k, v in feed.items()}
                event = None
                if self.device.type == "cuda":
                    event = torch.cuda.Event()
                    event.record(self._copy_stream)
                self._queue.put((staged, event))
            self._queue.put(_END)
        except BaseException as e:                 # surfaced on next()
            self._error = e
            self._queue.put(_END)

    # ------------------------------------------------------------------
    def start(self):
        if self._thread is not None:
            raise RuntimeError("DeviceLoader already started")
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        self._stop.clear()
        self._error = None
        self._queue = queue.Queue(maxsize=self._buffer)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            # unblock a producer waiting on a full queue
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _hand_out(self, staged, event):
        """The consumer's stream waits for the batch's copies; each
        tensor is marked as used on that stream."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in staged.values():
                t.record_stream(stream)
        return staged

    def __iter__(self):
        if self._thread is None:
            self.start()
        try:
            while True:
                item = self._queue.get()
                if item is _END:
                    self._thread.join(timeout=5)
                    self._thread = None
                    if self._error is not None:
                        raise self._error
                    return
                yield self._hand_out(*item)
        finally:
            # early generator close (break / exception in the consumer):
            # unblock and retire the producer so buffered device tensors
            # don't stay pinned and a later iter() starts fresh
            if self._thread is not None:
                self.stop()
