"""Unique name generator for program variables.

Capability parity with python/paddle/fluid/unique_name.py (reference
python/paddle/fluid/unique_name.py:1) — per-prefix counters plus a
guard that lets callers scope name generation (used by tests to get
reproducible programs).
"""
import contextlib

__all__ = ["generate", "switch", "guard"]


class NameGenerator:
    def __init__(self, prefix=""):
        self._counters = {}
        self._prefix = prefix

    def generate(self, prefix):
        idx = self._counters.get(prefix, 0)
        self._counters[prefix] = idx + 1
        return f"{self._prefix}{prefix}_{idx}"


_generator = NameGenerator()


def generate(prefix):
    return _generator.generate(prefix)


def switch(new_generator=None):
    global _generator
    old = _generator
    _generator = new_generator if new_generator is not None else NameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    """``new_generator`` may be a NameGenerator or, as in the
    reference, a string prefix stamped onto every generated name."""
    if isinstance(new_generator, str):
        new_generator = NameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
