"""Debugging switches (port of ``paddle_tpu/debugger.py``): the NaN
guard. The rest of the reference's module (program printing, graphviz
export) is a later slice of the torch port (ROADMAP.md item 'Remaining
op families and the zoo')."""
from .core import framework

__all__ = ["enable_nan_guard", "disable_nan_guard"]


def enable_nan_guard(program=None):
    """Op-level numeric check mode: every float op output of the program
    gets an is-finite flag; ``Executor.run`` raises FloatingPointError
    naming the first non-finite op. Costs one reduction per op output —
    a debug tool, not for production steps."""
    program = program or framework.default_main_program()
    program._nan_guard = True
    program._bump()
    return program


def disable_nan_guard(program=None):
    program = program or framework.default_main_program()
    program._nan_guard = False
    program._bump()
    return program
