"""Refusals by name for what the port has not ported yet.

Every name of the reference that the port does not have yet raises
``NotImplementedError`` naming the ROADMAP.md item (section 1) that
ports it, never a bare ``AttributeError``: a module keeps a ``WAITING``
map of its missing public names and installs :func:`module_getattr` as
its module ``__getattr__`` (PEP 562), which Python calls only for a
name the module does not define.
"""

__all__ = ["REST", "FLEET", "module_getattr"]

# the ROADMAP.md section-1 items the refusals name. REST is item 7's
# name; what it still refuses is item 7d's (the rest of debugger.py and
# Program.to_string, profiler.py, contrib's memory_usage_calc,
# concurrency.py, default_scope_funcs.py, recordio_writer.py, dataset/,
# utils/plot.py). get_op refuses nothing: every op type is ported.
REST = "Remaining op families and the zoo"
FLEET = "Fleet and analyzers"


def module_getattr(module, waiting):
    """The module ``__getattr__`` of ``module`` (its dotted name):
    a name in ``waiting`` (name -> item) raises NotImplementedError
    naming its item; any other missing name the usual AttributeError."""
    def __getattr__(name):
        item = waiting.get(name)
        if item is not None:
            raise NotImplementedError(
                f"{module}.{name} is not ported yet: it comes with "
                f"ROADMAP.md item '{item}'")
        raise AttributeError(
            f"module {module!r} has no attribute {name!r}")
    return __getattr__
