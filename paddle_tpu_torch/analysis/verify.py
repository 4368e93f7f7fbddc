"""Structural verifier passes over the Program IR (port of
``paddle_tpu/analysis/verify.py``: the same 13 passes, codes and
anchors, so a program's findings in the two packages compare one for
one).

Each pass is the static-analysis counterpart of a check the reference
performs eagerly in C++ at op-build time (InferShape enforce failures,
reference paddle/fluid/framework/shape_inference.h) or not at all:

* use-before-def / dangling fetch — catches the mis-wirings that
  otherwise surface as opaque KeyErrors deep inside core/lowering.py;
* dtype/shape contradictions — from the no-run inference engine;
* startup/main parameter drift — the two-program protocol's classic
  silent failure (startup initializes a [784, 10] w, main declares
  [784, 100]: the executor would feed the stale tensor straight into
  the step and torch would error in lowered-variable language);
* dead ops — ops whose outputs nothing consumes or fetches. They are
  almost always author mistakes (the optimize pass's DCE removes
  them);
* grad-name hygiene — core/backward.py's ``X@GRAD`` convention;
* donation aliasing — the executor donates read-write state (a train
  step writes each update into the scope's own tensor), so feeds
  overlapping written persistables are overwritten.
"""
import difflib

from ..core import framework
from ..core.registry import registered_op_types, has_op
from .diagnostics import Diagnostic, ERROR, WARNING
from .passes import Pass

__all__ = ["verify_program", "NoLoweringRulePass", "UseBeforeDefPass",
           "DanglingFetchPass", "DanglingFeedPass", "GradNamePass",
           "DonationAliasPass", "ShapeDtypePass", "ParamShapeDriftPass",
           "DeadOpPass", "DeadWritePass", "CrossBlockUseBeforeDefPass",
           "FetchOfDeadVarPass", "InferCoveragePass"]

# elementwise/accumulating op families whose same-slot inputs must agree
# in dtype family (float/int/bool) — mixing families here is a provable
# authoring bug, not an implicit-cast site
_DTYPE_STRICT_OPS = ("elementwise_add", "elementwise_sub",
                     "elementwise_mul", "elementwise_div",
                     "elementwise_max", "elementwise_min",
                     "elementwise_pow", "mul", "matmul", "sum", "concat")

_FLOAT_DTYPES = {"float16", "bfloat16", "float32", "float64"}
_INT_DTYPES = {"int8", "int16", "int32", "int64", "uint8"}


def _family(dtype):
    if dtype in _FLOAT_DTYPES:
        return "float"
    if dtype in _INT_DTYPES:
        return "int"
    if dtype == "bool":
        return "bool"
    return None


def _near(name, candidates, n=4):
    hits = difflib.get_close_matches(name, list(candidates), n=n,
                                     cutoff=0.6)
    return f"did you mean: {', '.join(hits)}?" if hits else None


def _written_in_block(block):
    """All names written by ops of ``block``, descending into nested
    sub-blocks (loop bodies may define-and-carry across iterations)."""
    out = set()
    for op in block.ops:
        for ns in op.outputs.values():
            out.update(ns)
        if op.type == "backward":
            for p in op.attr("parameter_names") or []:
                out.add(framework.grad_var_name(p))
        for v in op.attrs.values():
            if isinstance(v, framework.Block):
                out |= _written_in_block(v)
    return out


def _iter_all_ops(program):
    """Yields (block, op_idx, op) over every block of the program."""
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            yield block, i, op


class NoLoweringRulePass(Pass):
    """Every op type must have a lowering rule — statically, and all at
    once, instead of one NotImplementedError per run attempt."""

    name = "no-lowering-rule"
    cheap = True

    def run(self, ctx):
        diags = []
        for block, i, op in _iter_all_ops(ctx.program):
            if op.type == "backward" or has_op(op.type):
                continue
            diags.append(Diagnostic(
                ERROR, "no-lowering-rule",
                f"op type {op.type!r} has no registered lowering rule",
                op_idx=i, block_idx=block.idx,
                hint=_near(op.type, registered_op_types())))
        return diags


class UseBeforeDefPass(Pass):
    """An op may only read names provided by a feed (is_data), the
    scope (persistable/Parameter), or an earlier op. Sub-blocks are
    checked conservatively: anything written anywhere inside a loop
    body counts as available inside it (loop-carried state)."""

    name = "use-before-def"
    cheap = True

    def run(self, ctx):
        diags = []
        gb = ctx.program.global_block()
        defined = {n for n, v in gb.vars.items()
                   if v.is_data or v.persistable
                   or isinstance(v, framework.Parameter)}
        # the executor seeds the env with whatever the caller feeds,
        # declared or not — known feed names count as defined
        defined |= set(ctx.feed_names or ())

        def sub_bindings(op):
            # ops that run sub-blocks bind names into them through
            # string-list attrs (scan's x_names/state_in_names, ...);
            # those names are defined inside the body by the combinator
            out = set()
            for v in op.attrs.values():
                if isinstance(v, (list, tuple)) \
                        and v and all(isinstance(s, str) for s in v):
                    out.update(v)
            return out

        def check_sub(block, available):
            # loop semantics: a value written by ANY op of the body is
            # available to every op of the body (carried state)
            available = available | _written_in_block(block) \
                | {n for n, v in block.vars.items()
                   if v.is_data or v.persistable}
            for i, op in enumerate(block.ops):
                for slot, names in op.inputs.items():
                    for n in names:
                        if n not in available:
                            diags.append(self._diag(op, i, block, slot,
                                                    n, available))
                for v in op.attrs.values():
                    if isinstance(v, framework.Block):
                        check_sub(v, available | sub_bindings(op))

        for i, op in enumerate(gb.ops):
            for slot, names in op.inputs.items():
                for n in names:
                    if n not in defined:
                        diags.append(self._diag(op, i, gb, slot, n,
                                                defined))
            for v in op.attrs.values():
                if isinstance(v, framework.Block):
                    check_sub(v, defined | sub_bindings(op))
            if op.type == "backward":
                for p in op.attr("parameter_names") or []:
                    defined.add(framework.grad_var_name(p))
            for ns in op.outputs.values():
                defined.update(ns)
        return diags

    @staticmethod
    def _diag(op, op_idx, block, slot, name, available):
        return Diagnostic(
            ERROR, "use-before-def",
            f"op {op.type!r} reads {name!r} (slot {slot}) but no feed, "
            "scope entry, or prior op provides it",
            op_idx=op_idx, block_idx=block.idx,
            hint=_near(name, available))


class DanglingFetchPass(Pass):
    """Fetch targets must exist somewhere: produced by an op, fed, or
    scope-resident. A dangling fetch today dies as a KeyError inside
    the traced function."""

    name = "dangling-fetch"
    cheap = True

    def run(self, ctx):
        if not ctx.fetch_names:
            return []
        gb = ctx.program.global_block()
        available = ctx.produced_names() \
            | {n for n, v in gb.vars.items()
               if v.is_data or v.persistable} \
            | set(ctx.feed_names or ())
        diags = []
        for n in ctx.fetch_names:
            if n not in available:
                diags.append(Diagnostic(
                    ERROR, "dangling-fetch",
                    f"fetch target {n!r} is produced by no op and held "
                    "by no feed or persistable",
                    hint=_near(n, available | set(gb.vars))))
        return diags


class DanglingFeedPass(Pass):
    """A declared data variable no op consumes (and nothing fetches) is
    dead input — usually a renamed layer left behind."""

    name = "dangling-feed"

    def run(self, ctx):
        consumed = ctx.consumed_names()
        fetches = set(ctx.fetch_names or ())
        feed_names = ctx.feed_names
        diags = []
        for n, v in ctx.data_vars().items():
            if n in consumed or n in fetches:
                continue
            if feed_names is not None and n not in feed_names:
                continue
            diags.append(Diagnostic(
                WARNING, "dangling-feed",
                f"data variable {n!r} is consumed by no op",
                hint="remove the layers.data call or wire it into the "
                     "model"))
        return diags


class GradNamePass(Pass):
    """core/backward.py's contract: the backward marker's parameters
    exist, each has its ``<name>@GRAD`` variable, and every ``@GRAD``
    name the optimizer segment reads traces back to a marked
    parameter."""

    name = "grad-name"
    cheap = True

    def run(self, ctx):
        gb = ctx.program.global_block()
        bwd_idx, bwd = None, None
        for i, op in enumerate(gb.ops):
            if op.type == "backward":
                bwd_idx, bwd = i, op
                break
        diags = []
        # @GRAD vars whose base name is unknown are suspicious even
        # without a backward marker (hand-built grads)
        for n in gb.vars:
            if n.endswith(framework.GRAD_SUFFIX):
                base = n[: -len(framework.GRAD_SUFFIX)]
                if base not in gb.vars:
                    diags.append(Diagnostic(
                        WARNING, "grad-name-mismatch",
                        f"gradient variable {n!r} has no base variable "
                        f"{base!r}",
                        hint=_near(base, gb.vars)))
        if bwd is None:
            return diags
        params = bwd.attr("parameter_names") or []
        for p in params:
            if p not in gb.vars:
                diags.append(Diagnostic(
                    ERROR, "grad-name-mismatch",
                    f"backward marker lists parameter {p!r} which does "
                    "not exist in the global block",
                    op_idx=bwd_idx, block_idx=0,
                    hint=_near(p, gb.vars)))
                continue
            g = framework.grad_var_name(p)
            if g not in gb.vars:
                diags.append(Diagnostic(
                    ERROR, "grad-name-mismatch",
                    f"parameter {p!r} is marked for autodiff but its "
                    f"gradient variable {g!r} was never created",
                    op_idx=bwd_idx, block_idx=0,
                    hint="append_backward creates <param>@GRAD vars; "
                         "hand-edited programs must too"))
        param_set = set(params)
        for i in range(bwd_idx + 1, len(gb.ops)):
            op = gb.ops[i]
            for slot, names in op.inputs.items():
                for n in names:
                    if not n.endswith(framework.GRAD_SUFFIX):
                        continue
                    base = n[: -len(framework.GRAD_SUFFIX)]
                    if base in param_set:
                        continue
                    var = gb.vars.get(base)
                    if isinstance(var, framework.Parameter):
                        diags.append(Diagnostic(
                            ERROR, "grad-name-mismatch",
                            f"op {op.type!r} consumes {n!r} but "
                            f"{base!r} is not in the backward marker's "
                            "parameter list — its gradient is never "
                            "computed",
                            op_idx=i, block_idx=0,
                            hint="pass the parameter to "
                                 "append_backward / check no_grad_set"))
        return diags


class DonationAliasPass(Pass):
    """The executor donates the read-write state (donate_argnums=(0,)):
    after dispatch those buffers are dead. Feeds that alias that state
    — a data var that is also a written persistable, or an op writing
    into a feed target — risk reading freed device memory or silently
    shadowing the fed value."""

    name = "donation-alias"
    cheap = True

    def run(self, ctx):
        gb = ctx.program.global_block()
        diags = []
        from ..core.lowering import written_names
        written = written_names(gb)
        for n, v in gb.vars.items():
            if v.is_data and v.persistable and n in written:
                diags.append(Diagnostic(
                    WARNING, "donation-alias",
                    f"variable {n!r} is both a feed target and a "
                    "written persistable — its donated buffer aliases "
                    "the feed",
                    hint="feed values are staged per run; make the var "
                         "either data or persistable state, not both"))
        for i, op in enumerate(gb.ops):
            for ns in op.outputs.values():
                for n in ns:
                    var = gb.vars.get(n)
                    if var is not None and var.is_data:
                        diags.append(Diagnostic(
                            WARNING, "donation-alias",
                            f"op {op.type!r} writes into data variable "
                            f"{n!r} — the fed value is shadowed "
                            "mid-program",
                            op_idx=i, block_idx=0,
                            hint="write to a fresh variable instead of "
                                 "the feed target"))
        return diags


class ShapeDtypePass(Pass):
    """Runs the no-trace inference engine and reports (a) the shape
    contradictions its rules prove and (b) dtype-family mismatches at
    the inputs of strict ops (elementwise/matmul/concat/sum)."""

    name = "shape-dtype"

    def run(self, ctx):
        infer = ctx.infer
        diags = list(infer.diagnostics)
        for block, i, op in _iter_all_ops(ctx.program):
            if op.type not in _DTYPE_STRICT_OPS:
                continue
            seen = {}
            for slot in ("X", "Y"):
                for n in op.inputs.get(slot, []):
                    info = infer.info(block.idx, n)
                    if not info.confident or info.dtype is None:
                        continue
                    fam = _family(info.dtype)
                    if fam is None:
                        continue
                    seen[n] = (fam, info.dtype)
            fams = {f for f, _ in seen.values()}
            if len(fams) > 1:
                detail = ", ".join(f"{n}: {d}" for n, (_, d)
                                   in seen.items())
                diags.append(Diagnostic(
                    ERROR, "dtype-mismatch",
                    f"op {op.type!r} mixes dtype families at its "
                    f"inputs ({detail})",
                    op_idx=i, block_idx=block.idx,
                    hint="insert a cast op (layers.cast) on the "
                         "odd-one-out input"))
        return diags


class ParamShapeDriftPass(Pass):
    """A persistable declared with one shape in the startup program and
    another in the main program means the initializer writes a buffer
    the step function cannot consume."""

    name = "param-shape-drift"

    def run(self, ctx):
        if ctx.startup is None:
            return []
        main_vars = ctx.program.global_block().vars
        diags = []
        for n, sv in ctx.startup.global_block().vars.items():
            mv = main_vars.get(n)
            if mv is None or not (sv.persistable and mv.persistable):
                continue
            if sv.shape is None or mv.shape is None:
                continue
            drift = len(sv.shape) != len(mv.shape) or any(
                a >= 0 and b >= 0 and a != b
                for a, b in zip(sv.shape, mv.shape))
            if drift:
                diags.append(Diagnostic(
                    ERROR, "param-shape-drift",
                    f"persistable {n!r} is {list(sv.shape)} in the "
                    f"startup program but {list(mv.shape)} in the main "
                    "program",
                    hint="re-run the layer definition under the same "
                         "program_guard so both programs agree"))
        return diags


class DeadOpPass(Pass):
    """Reverse-liveness over the global block: an op is dead when no
    transitive consumer reaches a fetch target or a persistable. Only
    meaningful when the fetch set is known (Program.verify(fetch_list=)
    or the executor's per-run validation)."""

    name = "dead-op"

    def run(self, ctx):
        if ctx.fetch_names is None:
            return []
        gb = ctx.program.global_block()
        needed = set(ctx.fetch_names)
        needed |= {n for n, v in gb.vars.items() if v.persistable}
        diags = []
        for i in range(len(gb.ops) - 1, -1, -1):
            op = gb.ops[i]
            keep = op.type in ("backward", "print") \
                or any(isinstance(v, framework.Block)
                       for v in op.attrs.values())
            outs = {n for ns in op.outputs.values() for n in ns}
            if keep or (outs & needed):
                framework.collect_op_input_names(op, needed)
                if op.type == "backward":
                    needed.update(op.input("Loss"))
                continue
            diags.append(Diagnostic(
                WARNING, "dead-op",
                f"op {op.type!r} (outputs {sorted(outs)[:4]}) is never "
                "consumed, fetched, or persisted",
                op_idx=i, block_idx=0,
                hint="XLA DCE removes it from the executable, but it "
                     "still costs trace/compile time — drop the layer "
                     "or fetch its output"))
        return diags


class DeadWritePass(Pass):
    """Dataflow def-use check: a write that is overwritten before ANY
    read (op input, sub-block read, attr reference) is wasted compute —
    only the final binding of a name flows to fetches and the scope.
    The backward marker is a barrier (the autodiff segment re-reads
    the whole forward env), so writes before it are never flagged
    against writes after it."""

    name = "dead-write"

    def run(self, ctx):
        from .dataflow import op_effects
        diags = []
        for block in ctx.program.blocks:
            last = {}   # name -> (op_idx, op_type) of a not-yet-read write
            for i, op in enumerate(block.ops):
                eff = op_effects(op)
                if op.type == "backward":
                    last.clear()
                    continue
                for n in eff.reads:
                    last.pop(n, None)
                for n in eff.writes:
                    prev = last.get(n)
                    if prev is not None:
                        diags.append(Diagnostic(
                            WARNING, "dead-write",
                            f"op {prev[1]!r} writes {n!r} but op "
                            f"{op.type!r} (op #{i}) overwrites it "
                            "before anything reads it",
                            op_idx=prev[0], block_idx=block.idx,
                            hint="drop the first write or rename its "
                                 "output — only the final binding is "
                                 "observable"))
                    last[n] = (i, op.type)
        return diags


class CrossBlockUseBeforeDefPass(Pass):
    """Refines use-before-def for the cross-block case the generic
    message obscures: a sub-block reads a name that IS defined in its
    outer block — but only by an op AFTER the control-flow op, so at
    trace time the body sees nothing. Fires only where UseBeforeDefPass
    also fires; the dedicated code pinpoints the fix (reorder)."""

    name = "use-before-def-cross-block"
    cheap = True

    def run(self, ctx):
        from .dataflow import attr_name_refs
        diags = []
        gb = ctx.program.global_block()
        defined = {n for n, v in gb.vars.items()
                   if v.is_data or v.persistable
                   or isinstance(v, framework.Parameter)}
        defined |= set(ctx.feed_names or ())
        # names written at-or-after each op index (suffix sets)
        n_ops = len(gb.ops)
        suffix = [set() for _ in range(n_ops + 1)]
        for i in range(n_ops - 1, -1, -1):
            suffix[i] = set(suffix[i + 1])
            for ns in gb.ops[i].outputs.values():
                suffix[i].update(ns)

        def sub_reads(op):
            reads = set()
            for v in op.attrs.values():
                if isinstance(v, framework.Block):
                    body_writes = _written_in_block(v)
                    for sub_op in v.ops:
                        for ns in sub_op.inputs.values():
                            reads.update(ns)
                    reads -= body_writes       # loop-carried state
                    reads -= {n for n, var in v.vars.items()
                              if var.is_data or var.persistable}
            reads -= attr_name_refs(op)        # combinator bindings
            return reads

        for i, op in enumerate(gb.ops):
            has_sub = any(isinstance(v, framework.Block)
                          for v in op.attrs.values())
            if has_sub:
                for n in sub_reads(op):
                    if n not in defined and n in suffix[i + 1]:
                        diags.append(Diagnostic(
                            ERROR, "use-before-def-cross-block",
                            f"the sub-block of op {op.type!r} reads "
                            f"{n!r}, which the outer block only "
                            "defines after this op runs",
                            op_idx=i, block_idx=0,
                            hint="move the op producing "
                                 f"{n!r} above the {op.type!r} op"))
            if op.type == "backward":
                for p in op.attr("parameter_names") or []:
                    defined.add(framework.grad_var_name(p))
            for ns in op.outputs.values():
                defined.update(ns)
        return diags


class FetchOfDeadVarPass(Pass):
    """A fetch target produced ONLY inside control-flow sub-blocks is
    dead at the top level: lowering evaluates bodies in a child Env
    whose writes never escape (only the op's declared outputs do), so
    the fetch would die as a tracer KeyError. DanglingFetchPass cannot
    see this — its produced-names set spans all blocks."""

    name = "fetch-of-dead-var"
    cheap = True

    def run(self, ctx):
        if not ctx.fetch_names:
            return []
        gb = ctx.program.global_block()
        top = set()
        for op in gb.ops:
            for ns in op.outputs.values():
                top.update(ns)
            if op.type == "backward":
                for p in op.attr("parameter_names") or []:
                    top.add(framework.grad_var_name(p))
        top |= {n for n, v in gb.vars.items()
                if v.is_data or v.persistable}
        top |= set(ctx.feed_names or ())
        sub_produced = ctx.produced_names()
        diags = []
        for n in ctx.fetch_names:
            if n not in top and n in sub_produced:
                diags.append(Diagnostic(
                    ERROR, "fetch-of-dead-var",
                    f"fetch target {n!r} is written only inside a "
                    "control-flow sub-block — the value never escapes "
                    "to the top-level environment",
                    hint="route it through the control-flow op's "
                         "carry/out names (While carry_names, if_else "
                         "out_names) so the binding survives the "
                         "block"))
        return diags


class InferCoveragePass(Pass):
    """Coverage lint: op types used by this program that HAVE a
    lowering rule but NO static infer rule — the inference engine is
    blind to them (their outputs fall to the unknown lattice element),
    so shape/dtype passes and the cost model under-report. One warning
    per op type."""

    name = "no-infer-rule"

    def run(self, ctx):
        from ..core.registry import has_infer
        counts = {}
        for block, i, op in _iter_all_ops(ctx.program):
            if op.type == "backward" or not has_op(op.type):
                continue
            if not has_infer(op.type):
                counts[op.type] = counts.get(op.type, 0) + 1
        return [Diagnostic(
            WARNING, "no-infer-rule",
            f"op type {t!r} ({n} use{'s' if n > 1 else ''}) has a "
            "lowering rule but no registered infer rule — static "
            "shape/dtype analysis treats its outputs as unknown",
            hint="add a register_infer rule next to the lowering rule "
                 f"for {t!r}")
            for t, n in sorted(counts.items())]


def verify_program(program, startup=None, fetch_list=None,
                   feed_names=None, feed_shapes=None, passes=None,
                   level="full"):
    """Runs the verifier over ``program``; returns sorted Diagnostics.

    ``level="cheap"`` restricts to the structural per-compile subset.
    Never runs an op or touches device state.
    """
    from .passes import PassManager, VerifyContext, default_passes, \
        cheap_passes
    if passes is None:
        passes = cheap_passes() if level == "cheap" else default_passes()
    ctx = VerifyContext(program, startup=startup, fetch_list=fetch_list,
                        feed_names=feed_names, feed_shapes=feed_shapes)
    return PassManager(passes).run(ctx)
