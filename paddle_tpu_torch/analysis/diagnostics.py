"""Structured diagnostics for the static program verifier (port of
``paddle_tpu/analysis/diagnostics.py``).

Fluid surfaces graph mis-wirings through each C++ op's
InferShape/InferVarType (reference paddle/fluid/framework/
shape_inference.h) — an enforce failure names the op and variable at
build time. Here a program has no per-op build step, so diagnostics are
first-class records instead: every verifier pass emits ``Diagnostic``
objects that render human-readable and serialize to JSON.

``CODES`` is the JAX package's vocabulary — codes, levels and
meanings, the TPU-named lints (``tpu-pad``, ``tpu-hostile-layout``)
included — so the two packages' findings compare one for one (two
source-level meanings drop the reference's history notes). The
source-level codes (racecheck, protocheck) belong to analysis passes
the port has not ported yet (ROADMAP.md item 'Fleet and analyzers').
"""

__all__ = ["Diagnostic", "SourceDiagnostic", "VerifyError",
           "VerifyWarning", "ERROR", "WARNING", "INFO", "CODES",
           "errors", "warnings_of"]

ERROR = "error"
WARNING = "warning"
INFO = "info"
_LEVEL_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

# Diagnostic codes — the stable, documented vocabulary (ARCHITECTURE.md
# "Static analysis"). code → (default level, one-line meaning).
CODES = {
    "use-before-def": (
        ERROR, "an op reads a variable no feed, scope entry, or prior "
               "op provides"),
    "dangling-fetch": (
        ERROR, "a fetch target is produced by no op and held by no "
               "feed/persistable"),
    "dangling-feed": (
        WARNING, "a declared data variable is consumed by no op"),
    "dtype-mismatch": (
        ERROR, "an op's input dtypes are provably incompatible"),
    "shape-mismatch": (
        ERROR, "an op's input shapes are provably incompatible"),
    "param-shape-drift": (
        ERROR, "a persistable's shape differs between startup and main "
               "programs"),
    "dead-op": (
        WARNING, "an op's outputs are never consumed, fetched, or "
                 "persisted"),
    "grad-name-mismatch": (
        ERROR, "autodiff wiring is inconsistent with the X@GRAD naming "
               "convention"),
    "donation-alias": (
        WARNING, "a value aliases the executor's donated state (feed "
                 "overlapping read-write persistables)"),
    "no-lowering-rule": (
        ERROR, "an op type has no registered lowering rule"),
    "tpu-pad": (
        WARNING, "a matmul operand dim is unaligned to the MXU tile "
                 "(last dim % 128, second-minor % 8)"),
    "recompile-hazard": (
        WARNING, "feed shapes can vary in a way that recompiles the "
                 "step executable per distinct shape"),
    "pass-crashed": (
        WARNING, "an analysis pass raised internally (verifier bug, "
                 "not a program bug)"),
    "dead-write": (
        WARNING, "a write is overwritten before any op, fetch, or "
                 "scope flush can observe it"),
    "use-before-def-cross-block": (
        ERROR, "a sub-block reads a name its outer block only defines "
               "AFTER the control-flow op runs"),
    "fetch-of-dead-var": (
        ERROR, "a fetch target is produced only inside a sub-block — "
               "the value never escapes to the top-level env"),
    "no-infer-rule": (
        WARNING, "an op type has a lowering rule but no static "
                 "shape/dtype inference rule (analysis is blind to "
                 "it)"),
    "decode-shape-hazard": (
        WARNING, "a decode-shaped program grows a traced sequence dim "
                 "per step (concat along an unknown non-batch dim) — "
                 "every decode step compiles a fresh executable"),
    "tpu-hostile-layout": (
        WARNING, "the program runs conv/pool ops in NCHW and the "
                 "layout analysis found a profitable NHWC conversion "
                 "region (enable passes=('layout',...) / "
                 "PADDLE_TPU_OPTIMIZE=layout)"),
    "layout-mismatch": (
        ERROR, "layout-inconsistent wiring: an op's declared "
               "data_format disagrees with the layout its input "
               "provably carries, or an elementwise op mixes NCHW and "
               "NHWC operands"),
    # -- racecheck (analysis/racecheck.py): source-level concurrency
    #    rules over the runtime packages. These anchor to file:line via
    #    SourceDiagnostic rather than block/op indices.
    "run-without-scope": (
        ERROR, "a program-execution Executor.run call in runtime code "
               "omits scope= — it races on the process-global scope"),
    "global-mutation": (
        ERROR, "scope_guard/force_cpu/os.environ mutation inside a "
               "function body — process-global state flipped at "
               "runtime, visible to every thread"),
    "unlocked-mutation": (
        ERROR, "an attribute the class mutates under its lock is also "
               "mutated without it — a torn read/write window"),
    "blocking-under-lock": (
        ERROR, "a blocking call (sleep, socket/pipe I/O, queue, join, "
               "subprocess wait, retry loop) runs while holding a "
               "lock — every other acquirer stalls behind it"),
    "lock-order-cycle": (
        ERROR, "lock acquisition cycle (or non-reentrant "
               "self-reacquisition) — a deadlock waiting for the "
               "right interleaving"),
    "thread-hygiene": (
        WARNING, "a Thread is started without a stop-event/join "
                 "shutdown path (non-daemon variants are errors)"),
    "bad-suppression": (
        WARNING, "a '# racecheck: ok(...)' comment is malformed or "
                 "missing its required reason"),
    # -- numcheck (analysis/numcheck.py): static numerics &
    #    precision-flow analysis over the Program IR. Findings anchor
    #    to block/op indices like the verifier passes; tools/numlint.py
    #    supports the racecheck suppression grammar with the
    #    'numcheck:' tag.
    "fp16-overflow-risk": (
        ERROR, "a float16 value's propagated range provably escapes "
               "the dtype's representable span (|v| > 65504) — e.g. an "
               "unscaled loss or pre-softmax logits kept in fp16"),
    "cast-precision-loss": (
        WARNING, "a narrowing cast on a value whose propagated range "
                 "exceeds the target dtype's mantissa — integers past "
                 "2^(mantissa+1) stop being exactly representable"),
    "int8-scale-clip": (
        ERROR, "a quantized value provably clips: the propagated range "
               "exceeds the int8 span (or the declared max_range of a "
               "dequantize step)"),
    "domain-hazard": (
        WARNING, "div/log/rsqrt/sqrt is reachable with an operand "
                 "interval that provably contains 0 or negatives — "
                 "inf/NaN at run time for some feed"),
    "amp-unprotected-reduce": (
        WARNING, "a wide-range reduction (sum/mean) is computed in "
                 "float16 — accumulate in f32/bf16 or rescale first"),
    # -- protocheck (analysis/protocheck.py): static contract rules
    #    over the distributed fabric's shared vocabularies (wire
    #    verbs, typed errors, fault points, counters, env knobs).
    #    Source-anchored like racecheck; tools/protolint.py is the
    #    CLI, suppression tag 'protocheck:' (the code or its rule
    #    family name both match).
    "verb-unserved": (
        ERROR, "a wire verb is sent by a transport's client but no "
               "server dispatch arm serves it — the request can only "
               "come back as a protocol refusal"),
    "verb-dead": (
        WARNING, "a server dispatch arm exists for a verb no client "
                 "of that transport ever sends"),
    "verb-asymmetric": (
        WARNING, "a verb real traffic uses is served by only a "
                 "strict subset of the pipe/socket replica-transport "
                 "family"),
    "wire-error-unregistered": (
        ERROR, "a typed ServingError-family exception is raised by "
               "runtime code but absent from net.WIRE_ERRORS — "
               "across the wire it degrades to a bare ServingError"),
    "fault-point-unknown": (
        ERROR, "a fires()/arm()/FaultSpec site names a fault point "
               "that is not in faultinject.KNOWN_POINTS"),
    "fault-point-dead": (
        WARNING, "a registered fault point has no arming site in "
                 "tests/ or tools/ — an unexercised chaos hook"),
    "counter-dead": (
        WARNING, "a metrics counter is incremented but never read, "
                 "asserted, or documented anywhere else"),
    "counter-near-miss": (
        WARNING, "two counter names differ by one character — the "
                 "silent-typo split brain between writer and reader"),
    "knob-undocumented": (
        WARNING, "a PADDLE_TPU_* knob is read by code but appears in "
                 "no docs/*.md (regenerate the reference table: "
                 "protolint --knobs-table)"),
}


class Diagnostic:
    """One verifier finding. ``op_idx``/``block_idx`` locate the op when
    the finding is op-anchored (None for program-level findings);
    ``hint`` says how to fix it."""

    __slots__ = ("level", "code", "op_idx", "block_idx", "message", "hint")

    def __init__(self, level, code, message, op_idx=None, block_idx=None,
                 hint=None):
        assert level in _LEVEL_ORDER, level
        self.level = level
        self.code = code
        self.message = message
        self.op_idx = op_idx
        self.block_idx = block_idx
        self.hint = hint

    def to_dict(self):
        return {"level": self.level, "code": self.code,
                "block_idx": self.block_idx, "op_idx": self.op_idx,
                "message": self.message, "hint": self.hint}

    def format(self):
        loc = ""
        if self.block_idx is not None:
            loc = f" block {self.block_idx}"
            if self.op_idx is not None:
                loc += f" op #{self.op_idx}"
        text = f"{self.level}[{self.code}]{loc}: {self.message}"
        if self.hint:
            text += f"\n    hint: {self.hint}"
        return text

    def __repr__(self):
        return f"Diagnostic({self.format()!r})"

    __str__ = format


class SourceDiagnostic(Diagnostic):
    """A finding anchored to source text (file:line) rather than to a
    program op — the racecheck rules emit these. ``rule`` is the
    suppression name (`# racecheck: ok(<rule>) — reason`), normally the
    same as ``code``."""

    __slots__ = ("path", "line", "rule")

    def __init__(self, level, code, message, path, line, hint=None,
                 rule=None):
        super().__init__(level, code, message, hint=hint)
        self.path = path
        self.line = int(line)
        self.rule = rule or code

    def to_dict(self):
        d = super().to_dict()
        del d["block_idx"], d["op_idx"]
        d.update(path=self.path, line=self.line, rule=self.rule)
        return d

    def format(self):
        text = (f"{self.level}[{self.code}] {self.path}:{self.line}: "
                f"{self.message}")
        if self.hint:
            text += f"\n    hint: {self.hint}"
        return text

    __str__ = format

    def __repr__(self):
        return f"SourceDiagnostic({self.format()!r})"


def errors(diags):
    return [d for d in diags if d.level == ERROR]


def warnings_of(diags):
    return [d for d in diags if d.level == WARNING]


def sort_diagnostics(diags):
    """Errors first, then by location — the order the CLI prints."""
    return sorted(diags, key=lambda d: (
        _LEVEL_ORDER[d.level],
        d.block_idx if d.block_idx is not None else -1,
        d.op_idx if d.op_idx is not None else -1,
        d.code))


class VerifyError(RuntimeError):
    """Raised when error-level diagnostics are promoted (strict mode /
    ``Program.verify(strict=True)``). Carries the full diagnostic list
    so callers can still inspect the structured records."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        errs = errors(self.diagnostics)
        lines = [f"program verification failed with {len(errs)} error(s):"]
        lines += ["  " + d.format().replace("\n", "\n  ")
                  for d in sort_diagnostics(errs)]
        super().__init__("\n".join(lines))


class VerifyWarning(UserWarning):
    """Warning category for error-level diagnostics found in non-strict
    executor validation (PADDLE_TPU_VALIDATE=1, the default)."""
