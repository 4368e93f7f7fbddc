"""Program debugging / visualization tools (port of
``paddle_tpu/debugger.py``).

Capability parity with python/paddle/fluid/debugger.py:
``pprint_program_codes`` (debugger.py:105) / ``pprint_block_codes``
renders a Program as readable pseudo-code; ``draw_block_graphviz``
(debugger.py:222) emits a Graphviz dot file of the op/var dataflow.
Both render the port's Program IR, which is the reference's name for
name, so the same layer code prints the same text and dot file in
either package. The NaN/Inf guard replaces the reference's per-op
nan-checking executor mode (operators.cc FLAGS_check_nan_inf): the
lowering adds an is-finite flag per float op output and the Executor
raises naming the first offending op.
"""
import re

from .core import framework

__all__ = ["pprint_program_codes", "pprint_block_codes",
           "program_to_code", "draw_block_graphviz", "enable_nan_guard",
           "disable_nan_guard"]

_INDENT = "    "


def _var_brief(var):
    try:
        shape = list(var.shape) if var.shape is not None else "?"
    except Exception:
        shape = "?"
    lod = f", lod={var.lod_level}" if getattr(var, "lod_level", 0) else ""
    kind = "param" if isinstance(var, framework.Parameter) else "var"
    return f"{kind} {var.name}[{var.dtype}, {shape}{lod}]"


def _attr_brief(v):
    if isinstance(v, framework.Block):
        return f"<block {v.idx}>"
    s = repr(v)
    return s if len(s) <= 40 else s[:37] + "..."


def _block_code(block, depth=0):
    pad = _INDENT * depth
    lines = [f"{pad}// block {block.idx}" +
             (f" (parent {block.parent_idx})"
              if getattr(block, 'parent_idx', None) not in (None, -1)
              else "")]
    for var in block.vars.values():
        lines.append(pad + _var_brief(var))
    for op in block.ops:
        ins = ", ".join(f"{k}={v}" for k, v in sorted(op.inputs.items())
                        if v)
        outs = ", ".join(f"{k}={v}"
                         for k, v in sorted(op.outputs.items()) if v)
        attrs = ", ".join(
            f"{k}={_attr_brief(v)}" for k, v in sorted(op.attrs.items()))
        lines.append(f"{pad}{outs or '()'} = {op.type}({ins})"
                     + (f"  # {attrs}" if attrs else ""))
        for v in op.attrs.values():
            if isinstance(v, framework.Block):
                lines.extend(_block_code(v, depth + 1))
    return lines


def program_to_code(program):
    """Readable pseudo-code for the whole program (all blocks reachable
    from block 0, sub-blocks inline under their owning op)."""
    return "\n".join(_block_code(program.global_block()))


def pprint_block_codes(block, show_backward=False):
    print("\n".join(_block_code(block)))


def pprint_program_codes(program, show_backward=False):
    """Prints the program pseudo-code (reference debugger.py:105)."""
    print(program_to_code(program))


def _dot_escape(s):
    return re.sub(r'[^a-zA-Z0-9_.]', "_", str(s))


def draw_block_graphviz(block, highlights=None, path="./temp.dot"):
    """Writes a Graphviz dot rendering of the block's dataflow
    (reference debugger.py:222): ellipse nodes for vars (doubled border
    for parameters), box nodes for ops, edges input-var → op →
    output-var. Returns the dot source."""
    highlights = set(highlights or [])
    lines = ["digraph G {", '  rankdir=TB;']
    emitted = set()

    def var_node(name):
        nid = "var_" + _dot_escape(name)
        if nid not in emitted:
            emitted.add(nid)
            var = block._find_var_recursive(name)
            is_param = isinstance(var, framework.Parameter)
            color = ', style=filled, fillcolor="lightcoral"' \
                if name in highlights else (
                    ', style=filled, fillcolor="lightgrey"'
                    if is_param else "")
            peri = ", peripheries=2" if is_param else ""
            lines.append(
                f'  {nid} [label="{name}", shape=ellipse{peri}{color}];')
        return nid

    for i, op in enumerate(block.ops):
        oid = f"op_{i}_{_dot_escape(op.type)}"
        lines.append(f'  {oid} [label="{op.type}", shape=box, '
                     'style=filled, fillcolor="lightblue"];')
        for names in op.inputs.values():
            for n in names:
                lines.append(f"  {var_node(n)} -> {oid};")
        for names in op.outputs.values():
            for n in names:
                lines.append(f"  {oid} -> {var_node(n)};")
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot


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
