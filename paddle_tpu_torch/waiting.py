"""Refusals by name for what the port has not ported yet.

Every name of the reference that the port does not have yet raises
``NotImplementedError`` naming the ROADMAP.md item (section 1) that
ports it, never a bare ``AttributeError``: a module keeps a ``WAITING``
map of its missing public names and installs :func:`module_getattr` as
its module ``__getattr__`` (PEP 562), which Python calls only for a
name the module does not define.
"""

__all__ = ["FLEET", "module_getattr"]

# the ROADMAP.md section-1 item the refusals name: item 8's (cluster/,
# racecheck, protocheck). get_op refuses nothing: every op type is
# ported.
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
