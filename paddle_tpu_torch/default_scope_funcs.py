"""Default scope functions (port of ``paddle_tpu/default_scope_funcs.py``)
— parity with python/paddle/fluid/default_scope_funcs.py: a
thread-local stack of Scopes; ``var``/``find_var`` act on the top,
``find_var`` falls back through enclosing scopes, ``scoped_function``
runs a callable inside a fresh local scope that is dropped afterwards.

Scopes here hold persistable state only (parameters, optimizer
accumulators; a step's intermediates live and die inside
``Executor.run``), so the stack is a plain list of flat Scopes with
lookup chaining done in this module (reference scope.h parent
pointers).
"""
import threading

from .core.executor import Scope, global_scope

__all__ = [
    "get_cur_scope", "enter_local_scope", "leave_local_scope", "var",
    "find_var", "scoped_function",
]

_tl = threading.local()


def _stack():
    if not hasattr(_tl, "stack"):
        _tl.stack = [global_scope()]
    return _tl.stack


def get_cur_scope():
    """The innermost (current) Scope."""
    return _stack()[-1]


def enter_local_scope():
    """Push a fresh local scope; returns it."""
    s = Scope()
    _stack().append(s)
    return s


def leave_local_scope():
    """Pop and discard the current local scope (the root global scope
    cannot be left)."""
    stack = _stack()
    if len(stack) == 1:
        raise RuntimeError("cannot leave the global scope")
    stack.pop()


def var(name):
    """Create (or return) ``name`` in the current scope."""
    return get_cur_scope().var(name)


def find_var(name):
    """Look ``name`` up through the scope chain, innermost first."""
    for s in reversed(_stack()):
        if s.has(name):
            return s.find_var(name)
    return None


def scoped_function(fn):
    """Run ``fn`` inside a new local scope, dropping it afterwards."""
    enter_local_scope()
    try:
        return fn()
    finally:
        leave_local_scope()
