"""Verifier pass manager (port of ``paddle_tpu/analysis/passes.py``).

A pass is a named, independent check over a Program that emits
``Diagnostic`` records. The manager mirrors the reference's pass
registry shape (reference paddle/fluid/framework/ir/pass.h — there the
passes rewrite the graph; here they only report, because the lowering
consumes the IR unchanged) and TPU-MLIR's verifier-per-op design
(arXiv:2210.15016): cheap structural passes run on every new
executable, the full set runs on demand (``Program.verify()``,
tools/fluidlint.py).

Passes never mutate the program and never run it: the whole point is
diagnostics BEFORE anything is lowered.
"""
from ..core import framework
from .diagnostics import Diagnostic, WARNING, sort_diagnostics

__all__ = ["Pass", "PassManager", "VerifyContext", "default_passes",
           "cheap_passes"]


class VerifyContext:
    """Shared state the passes read: the program, optional startup
    program / fetch list / feed names, and the lazily-computed
    inference result (shared so only one pass pays for it)."""

    def __init__(self, program, startup=None, fetch_list=None,
                 feed_names=None, feed_shapes=None):
        self.program = program
        self.startup = startup
        if fetch_list is None:
            self.fetch_names = None
        else:
            self.fetch_names = [
                v.name if isinstance(v, framework.Variable) else v
                for v in fetch_list]
        self.feed_names = feed_names
        self.feed_shapes = feed_shapes
        self._infer = None

    @property
    def infer(self):
        """InferenceResult for the program (computed once, shared)."""
        if self._infer is None:
            from .infer import infer_program
            self._infer = infer_program(self.program,
                                        feed_shapes=self.feed_shapes)
        return self._infer

    # ---- shared program facts -----------------------------------------
    def data_vars(self):
        gb = self.program.global_block()
        return {n: v for n, v in gb.vars.items() if v.is_data}

    def produced_names(self):
        """Every name some op (in any block) writes, plus backward-
        marker grad definitions."""
        names = set()
        for block in self.program.blocks:
            for op in block.ops:
                for ns in op.outputs.values():
                    names.update(ns)
                if op.type == "backward":
                    for p in op.attr("parameter_names") or []:
                        names.add(framework.grad_var_name(p))
        return names

    def consumed_names(self):
        """Every name any op (descending into sub-blocks) reads."""
        acc = set()
        for op in self.program.global_block().ops:
            framework.collect_op_input_names(op, acc)
        return acc


class Pass:
    """Base class: subclasses set ``name``/``cheap`` and implement
    ``run(ctx) -> [Diagnostic]``."""

    name = "pass"
    cheap = False   # cheap passes run per-compile in the Executor

    def run(self, ctx):
        raise NotImplementedError


class PassManager:
    def __init__(self, passes):
        self.passes = list(passes)

    def run(self, ctx):
        diags = []
        for p in self.passes:
            try:
                diags.extend(p.run(ctx))
            except Exception as e:  # a verifier bug must not block runs
                diags.append(Diagnostic(
                    WARNING, "pass-crashed",
                    f"analysis pass {p.name!r} raised "
                    f"{type(e).__name__}: {e}",
                    hint="this is a verifier bug, not a program bug — "
                         "please report it"))
        return sort_diagnostics(diags)


def default_passes():
    """The full pipeline (Program.verify, fluidlint, strict mode)."""
    from . import verify as v
    from . import lints as l
    from . import layout as lay
    return [v.NoLoweringRulePass(), v.UseBeforeDefPass(),
            v.DanglingFetchPass(), v.DanglingFeedPass(),
            v.GradNamePass(), v.DonationAliasPass(),
            v.ShapeDtypePass(), v.ParamShapeDriftPass(),
            v.DeadOpPass(), v.DeadWritePass(),
            v.CrossBlockUseBeforeDefPass(), v.FetchOfDeadVarPass(),
            v.InferCoveragePass(), lay.LayoutConsistencyPass(),
            l.TpuMatmulPadPass(), l.RecompileHazardPass(),
            l.DecodeShapeHazardPass(), l.TpuHostileLayoutPass()]


def cheap_passes():
    """Structural subset the Executor runs once per newly-compiled
    program (PADDLE_TPU_VALIDATE=1, the default): pure set/walk logic,
    no shape inference."""
    return [p for p in default_passes() if p.cheap]
