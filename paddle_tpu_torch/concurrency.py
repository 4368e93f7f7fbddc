"""CSP channels (port of ``paddle_tpu/concurrency.py``, a copy: the
reference module imports no jax) — host-side parity with
python/paddle/fluid/concurrency.py (make_channel:40, channel_send:282,
channel_recv, channel_close, Select:64).

Fluid runs Go-style channel ops INSIDE the interpreted program so ops
can overlap. A Program here runs as one step function per
``Executor.run``, with no interpreter to block inside it (cross-step
overlap comes from asynchronous CUDA launches and io.DeviceLoader).
What channels still usefully provide is
host-side producer/consumer coordination AROUND executor runs —
feeding pipelines, metric draining, checkpoint writers — so this module
implements the same five APIs at the host level with Go semantics:
bounded/unbuffered channels, send/recv blocking, close() waking every
blocked sender and receiver, recv on a closed drained channel
returning not-ok, Select picking the first ready case.
"""
import threading

__all__ = [
    "make_channel", "channel_send", "channel_recv", "channel_close",
    "Select",
]


class Channel:
    """Go-semantics channel: ``capacity=0`` is a rendezvous (send
    returns once a receiver has taken the value), ``capacity>0`` a
    bounded buffer. ``dtype`` is advisory (API parity). ``close()``
    wakes every blocked sender (send returns False) and receiver."""

    def __init__(self, dtype=None, capacity=0):
        self.dtype = dtype
        self.capacity = capacity
        self._buf = []
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._closed = False
        self._pending_takes = 0   # rendezvous: values handed out

    def send(self, value, timeout=None):
        """Blocks per Go semantics; returns False if the channel closes
        (or ``timeout`` elapses) before the value is accepted. The
        timeout is one deadline across the whole call — a rendezvous
        send does not get a second full window for the receiver take."""
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        remaining = (lambda: None) if deadline is None else (
            lambda: max(0.0, deadline - _time.monotonic()))
        cap = self.capacity if self.capacity > 0 else 1
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._closed or len(self._buf) < cap,
                    timeout=remaining()):
                return False
            if self._closed:
                return False
            self._buf.append(value)
            self._cond.notify_all()
            if self.capacity == 0:
                # rendezvous: wait until a receiver took it (or close)
                target = self._pending_takes + len(self._buf) - 1
                ok = self._cond.wait_for(
                    lambda: self._closed or self._pending_takes > target,
                    timeout=remaining())
                if ok and self._pending_takes > target:
                    return True
                # closed (or timed out) before a receiver took it:
                # withdraw the value so a post-close drain can't see a
                # send that reported failure
                if self._buf:
                    self._buf.pop()
                return False
            return True

    def recv(self, timeout=None):
        """Returns (value, ok). ok=False once the channel is closed and
        drained. With an explicit ``timeout``, raises
        :class:`TimeoutError` if nothing arrives and the channel is
        still open — a timeout is not a close."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._buf or self._closed, timeout=timeout):
                raise TimeoutError("channel_recv timed out (channel open)")
            if self._buf:
                v = self._buf.pop(0)
                self._pending_takes += 1
                self._cond.notify_all()
                return v, True
            return None, False

    def ready_to_recv(self):
        with self._mu:
            return bool(self._buf) or self._closed

    def is_closed(self):
        with self._mu:
            return self._closed

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()


def make_channel(dtype=None, capacity=0):
    return Channel(dtype, capacity)


def channel_send(channel, value, is_copy=False, timeout=None):
    """Returns a success status, like the reference's Status output."""
    import copy as _copy
    return channel.send(_copy.deepcopy(value) if is_copy else value,
                        timeout=timeout)


def channel_recv(channel, timeout=None):
    """Returns (value, status). See :meth:`Channel.recv` for the
    explicit-timeout contract."""
    return channel.recv(timeout=timeout)


def channel_close(channel):
    channel.close()


class Select:
    """First-ready case dispatch over channels (reference Select op).

    >>> sel = Select()
    >>> sel.case_recv(ch_a, lambda v: ...)
    >>> sel.case_send(ch_b, value, lambda ok: ...)
    >>> sel.default(lambda: ...)        # optional: makes execute non-blocking
    >>> sel.execute()                   # runs exactly one case's body
    """

    def __init__(self):
        self._recv_cases = []
        self._send_cases = []
        self._default = None

    def case_recv(self, channel, body):
        self._recv_cases.append((channel, body))
        return self

    def case_send(self, channel, value, body):
        self._send_cases.append((channel, value, body))
        return self

    def default(self, body):
        self._default = body
        return self

    def execute(self, poll_interval=0.01):
        """Block until one case fires (or run the default immediately if
        nothing is ready); returns that case's body() result."""
        if not (self._recv_cases or self._send_cases or self._default):
            raise ValueError("Select with no cases")
        while True:
            for ch, body in self._recv_cases:
                if ch.ready_to_recv():
                    try:
                        v, ok = ch.recv(timeout=poll_interval)
                    except TimeoutError:
                        continue          # raced with another receiver
                    return body(v if ok else None)
            for ch, value, body in self._send_cases:
                # only attempt sends that can complete without blocking
                # past the poll window (close() also unblocks them)
                if ch.send(value, timeout=poll_interval):
                    return body(True)
                if ch.is_closed():
                    # the send failed because the channel is closed —
                    # fire the case with ok=False ('close() wakes every
                    # blocked sender') instead of polling forever
                    return body(False)
            if self._default is not None:
                return self._default()
            threading.Event().wait(poll_interval)
