"""Graph-rewriting optimization passes: constant folding, elementwise-
chain fusion, CSE, and DCE (port of ``paddle_tpu/analysis/optimize.py``:
the same passes, the same admission rules, the same reports).

The passes in this package that MUTATE a program (the verifier passes
only report). All are built on the dataflow facts in dataflow.py and
are deliberately conservative — the contract, enforced by
tests/test_torch_optimize.py's zoo sweep, is that ``optimize`` is
numerics-preserving to the BIT on fetch outputs and scope writes:

* constant folding evaluates ops whose inputs are all compile-time
  constants (fill_constant / assign_value chains — never
  initializer-fed persistables, whose values live in the Scope) by
  calling the op's OWN torch lowering rule eagerly, and splices the
  result back as an ``assign_value`` op. The rule runs on a device:
  the executor's and the serving engine's hooks fold on their own
  device, so a folded value is the value that device computes (CUDA's
  ``exp``/``log``/``pow`` may differ from the CPU's in the last bit);
  a direct ``Program.optimize`` folds on the card when CUDA is
  available and on the CPU otherwise (``default_fold_device``), as the
  reference folds on jax's default backend. A fold budget
  (PADDLE_TPU_FOLD_BUDGET bytes, default 256 KiB) caps every
  materialized value so a huge weight is never embedded in the IR;
* elementwise-chain fusion collapses straight-line chains of
  elementwise ops (add/sub/mul, scale, cast, the pure unary
  activations, eval-mode dropout) whose interior values have exactly
  one consumer into ONE ``fused_elementwise`` op (ops/basic.py) that
  replays the chain's torch ops in order — fewer ops for the
  ProgramDesc walk per dispatch, and the same values bit for bit;
* common-subexpression elimination merges ops that provably compute
  the same value: same type, same attrs, and same input VALUES (name ×
  reaching-definition version, so a name rebound between two
  textually-identical ops never false-merges);
* dead-op elimination removes ops no fetch target, scope write, or
  surviving op transitively depends on (dataflow.removable_ops).

One OPT-IN pass lives outside the default pipeline: ``"layout"``
(analysis/layout.py) converts NCHW conv/pool/BN regions to NHWC under
a cost-model gate. It must be requested explicitly —
``passes=("layout", ...)`` or ``PADDLE_TPU_OPTIMIZE=layout,...``; the
port registers no conv op yet, so it finds nothing to convert.

No pass ever touches:
  * stateful ops (dropout-in-train, random init, sampling) — removing
    or merging one shifts the rng stream of every later stateful op
    (the ONE exception: fusion may absorb an eval-mode dropout, whose
    lowering provably consumes no rng key);
  * ops writing persistables (parameters, optimizer accumulators,
    batch-norm statistics) or data vars; fusion/CSE also skip fetch
    targets and any name referenced from a control-flow sub-block /
    string attr (folding may replace a fetched op — the name keeps an
    identical binding);
  * barrier ops (backward marker, print, sub-block carriers).

The program runs op by op, so every op the rewrite removes is one
dispatch fewer on every step. Unlike the rest of analysis/, the FOLD
pass evaluates lowering rules eagerly and therefore imports torch and
the op rules — but only when it actually runs (lazy import), so the
verifier/lint paths stay device-free.
"""
import functools
import os

from ..core import framework
from .dataflow import (BARRIER_OPS, _collect_block_names, def_use,
                       op_effects, pinned_names, removable_ops)

__all__ = ["OptimizeReport", "optimize_program", "DEFAULT_PASSES",
           "KNOWN_PASSES", "parse_passes", "default_fold_device",
           "fold_constants",
           "fuse_elementwise_chains", "eliminate_dead_ops",
           "merge_common_subexpressions"]

# pipeline order: folding creates constants fusion/CSE can see, fusion
# shortens chains before CSE hashes them, DCE sweeps the orphaned
# producers last
DEFAULT_PASSES = ("fold", "fuse", "cse", "dce")

# every pass a spec may name. "layout" (analysis/layout.py: cost-gated
# NCHW→NHWC conversion) is opt-in — passes=("layout", ...) or
# PADDLE_TPU_OPTIMIZE=layout,... — because converted conv paths are
# tolerance-exact rather than bit-exact in the reference (a conv's
# reduction order may change with its layout)
KNOWN_PASSES = ("layout",) + DEFAULT_PASSES

# ops that ARE constants: their outputs seed the fold environment but
# the ops themselves are never rewritten (nothing to gain)
_CONST_PRODUCERS = frozenset(["fill_constant", "assign_value"])

# never folded even when input-free/const-fed: their values come from
# OUTSIDE the IR (the filesystem), so folding would pin whatever the
# file held at optimize time instead of at trace time
_FOLD_EXCLUDED = frozenset(["load"])

# default per-value cap for materialized folded constants (bytes)
_FOLD_BUDGET_DEFAULT = 256 * 1024

def parse_passes(spec):
    """Pass tuple from a user/env spec: True/"1"/"on" → the default
    pipeline; a comma-separated string ("fold,dce") or iterable →
    exactly those passes, validated."""
    if spec in (True, 1, "1", "on", "true", "yes", "default"):
        return DEFAULT_PASSES
    names = ([s.strip() for s in spec.split(",") if s.strip()]
             if isinstance(spec, str) else list(spec))
    unknown = [n for n in names if n not in KNOWN_PASSES]
    if unknown:
        raise ValueError(
            f"unknown optimize pass(es) {unknown}; valid: "
            f"{list(KNOWN_PASSES)}")
    return tuple(names)


class OptimizeReport:
    """What one ``optimize_program`` call did.

    ``folded``/``fused``/``merged``/``removed``/``converted`` hold
    (op_type(s), output_names) tuples per rewrite (``converted``
    additionally records the frontier ``transpose2`` ops the layout
    pass inserted); ``passes`` is the pipeline that ran;
    ``cost_deltas`` (``collect_cost=True`` only) maps each pass name
    to the static cost-model movement it caused: ``{"flops":
    after-before, "bytes": after-before, "n_ops": ...}`` summed over
    every iteration. Truthy iff anything changed."""

    def __init__(self, passes=DEFAULT_PASSES):
        self.passes = tuple(passes)
        self.folded = []
        self.fused = []
        self.merged = []
        self.removed = []
        self.converted = []
        self.iterations = 0
        self.cost_deltas = None

    @property
    def n_folded(self):
        return len(self.folded)

    @property
    def n_fused(self):
        return len(self.fused)

    @property
    def n_removed(self):
        return len(self.removed)

    @property
    def n_merged(self):
        return len(self.merged)

    @property
    def n_converted(self):
        """Ops the layout pass flipped to NHWC (transposes excluded)."""
        return sum(1 for t, _ in self.converted if t != "transpose2")

    @property
    def n_layout_transposes(self):
        return sum(1 for t, _ in self.converted if t == "transpose2")

    def counts(self):
        return {"folded": self.n_folded, "fused": self.n_fused,
                "merged": self.n_merged, "removed": self.n_removed,
                "converted": self.n_converted,
                "layout_transposes": self.n_layout_transposes}

    def to_dict(self):
        d = {"passes": list(self.passes),
             "iterations": self.iterations}
        d.update(self.counts())
        if self.cost_deltas is not None:
            d["cost_deltas"] = {k: dict(v)
                                for k, v in self.cost_deltas.items()}
        return d

    def __bool__(self):
        return bool(self.folded or self.fused or self.merged
                    or self.removed or self.converted)

    def __repr__(self):
        return (f"OptimizeReport(folded={self.n_folded}, "
                f"fused={self.n_fused}, merged={self.n_merged}, "
                f"removed={self.n_removed}, "
                f"converted={self.n_converted}, "
                f"iterations={self.iterations})")


def _fetch_name_set(fetch_list):
    return {v.name if isinstance(v, framework.Variable) else v
            for v in (fetch_list or [])}


class _Unhashable(Exception):
    pass


def _canon(v):
    """Hashable canonical form of an attr value; Blocks and unknown
    objects make the op ineligible rather than crashing the pass."""
    if isinstance(v, framework.Block):
        raise _Unhashable
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _canon(x)) for k, x in v.items()))
    try:
        import numpy as np
        if isinstance(v, np.ndarray):
            return ("__nd__", v.dtype.str, v.shape, v.tobytes())
        if isinstance(v, (np.integer, np.floating, np.bool_)):
            return v.item()
    except Exception:
        pass
    if isinstance(v, (str, int, float, bool, bytes, type(None))):
        return v
    raise _Unhashable


def _var_signature(block, name):
    """The declared metadata lowering keys off the WRITTEN name
    (stop_gradient wraps, SequenceBatch rewrap by lod_level): two ops
    may only merge when their outputs carry identical metadata."""
    v = block._find_var_recursive(name)
    if v is None:
        return None
    return (v.dtype, v.lod_level, v.stop_gradient, v.persistable,
            v.type, isinstance(v, framework.Parameter))


# ---------------------------------------------------------------------------
# constant folding
# ---------------------------------------------------------------------------

class _FoldSkip(Exception):
    """Internal: this op cannot (or should not) be folded."""


class _FoldCtx:
    """Minimal LoweringContext stand-in for eager constant evaluation:
    just enough surface for non-stateful lowering rules (``device`` for
    the tensors they create, ``op`` for output-name lookups,
    ``is_test``/``mode`` for inference-mode branches, every output
    wanted, nothing donated). ``next_key`` raises so a mis-classified
    stateful rule can never fold — the rng stream is an observable
    effect."""

    def __init__(self, op, is_test, device):
        self.op = op
        self.is_test = bool(is_test)
        self.mode = "test" if is_test else "train"
        self.device = device

    def next_key(self):
        raise _FoldSkip("stateful op reached the fold evaluator")

    def wants(self, slot):
        return True

    def donated_output(self, in_slot, out_slot, value):
        return None


def _fold_budget(budget_bytes):
    if budget_bytes is not None:
        return int(budget_bytes)
    return int(os.environ.get("PADDLE_TPU_FOLD_BUDGET",
                              _FOLD_BUDGET_DEFAULT))


def _declared_bytes(block, name):
    """Upper-bound estimate from the var declaration (None when any
    dim is unknown) — the pre-evaluation budget gate, so an
    over-budget constant is never even materialized."""
    import numpy as np
    v = block._find_var_recursive(name)
    if v is None or v.shape is None:
        return None
    numel = 1
    for d in v.shape:
        if d is None or d < 0:
            return None
        numel *= d
    try:
        item = np.dtype(v.dtype).itemsize
    except Exception:
        item = 4
    return numel * item


def _eval_const_op(op, const, is_test, device):
    """Evaluates one op's lowering rule eagerly on known-constant
    inputs, on ``device``. Returns {output name: np.ndarray}. Raises
    _FoldSkip when the rule cannot run outside a step, returns an
    unexpected output structure, or gives a dtype numpy cannot hold
    (bfloat16). Using the op's OWN lowering rule (not a
    reimplementation) on the device the program runs on is what makes
    folding bit-exact by construction: the folded value IS the value
    the program computes there."""
    from ..core.registry import get_op
    import numpy as np
    import torch
    opdef = get_op(op.type)
    try:
        ins = {slot: [torch.as_tensor(const[n], device=device)
                      for n in names]
               for slot, names in op.inputs.items()}
        with torch.no_grad():
            outs = opdef.lower(_FoldCtx(op, is_test, device), ins,
                               op.attrs)
    except _FoldSkip:
        raise
    except Exception as e:
        raise _FoldSkip(f"lowering rule failed eagerly: {e!r}")
    if not isinstance(outs, dict):
        raise _FoldSkip("rule returned no output dict")
    result = {}
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            raise _FoldSkip(f"rule produced no {slot!r} slot")
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        if len(vals) != len(names):
            raise _FoldSkip(f"slot {slot!r} arity mismatch")
        for name, val in zip(names, vals):
            if not isinstance(val, torch.Tensor) \
                    or val.dtype == torch.bfloat16:
                raise _FoldSkip("not a tensor numpy can hold")
            # a copy of its own: a rule may hand back an input (assign)
            result[name] = val.detach().cpu().numpy().copy()
    return result


def default_fold_device():
    """Where a fold runs when the caller names no device: the card when
    CUDA is available, the counterpart of jax's default backend (the
    accelerator on its host), else the CPU — and the CPU after
    ``force_cpu()``, as the reference's routes all of jax there."""
    import torch
    from ..core import executor
    if executor._FORCED_CPU:
        return torch.device("cpu")
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def fold_constants(program, fetch_list=None, budget_bytes=None,
                   device=None):
    """One forward constant-folding pass over the global block, run on
    ``device`` (a ``torch.device``; None: ``default_fold_device()``).

    Maintains a constant environment seeded by ``fill_constant`` /
    ``assign_value`` outputs; any later op all of whose inputs are
    known constants — and that is effect-free: known to the registry,
    not stateful, not seq-aware, no sub-blocks, writes no persistable
    or data var — is evaluated eagerly through its own lowering rule
    and replaced by one ``assign_value`` per output. Initializer-fed
    persistables are never constants (their values live in the Scope
    and can change between runs), so parameter math never folds.

    Integer results keep the port's widths (``canonical_int``: int64
    where the reference's are int32 without x64); they equal the
    reference's by value.

    Every value the pass materializes (tracked or spliced) is capped
    at ``budget_bytes`` (default PADDLE_TPU_FOLD_BUDGET, 256 KiB): a
    huge weight is never embedded into the IR on top of living in the
    executable. Returns the folded (op_type, output_names) list."""
    gb = program.global_block()
    # AMP rewrites op inputs/outputs at lowering time (bf16 casts); the
    # eager fold computes in declared dtypes, so it may only touch ops
    # numcheck proves compute wide at run time anyway (not
    # matmul-shaped, no bf16-narrowed input) — per-op gating instead of
    # the old wholesale refusal
    from .numcheck import amp_fold_admissible
    amp_ok = amp_fold_admissible(program)
    from ..core.registry import has_op, get_op
    import torch
    device = default_fold_device() if device is None else device
    budget = _fold_budget(budget_bytes)
    persist = {n for n, v in gb.vars.items() if v.persistable}
    datas = {n for n, v in gb.vars.items() if v.is_data}
    is_test = bool(program._is_test)

    const = {}        # name -> np.ndarray (current binding, in order)
    folded = []
    new_ops = []
    changed = False

    def _record(values):
        """Track outputs whose size fits the budget; an over-budget
        value is dropped from the environment (its consumers then
        cannot fold), never materialized into the IR."""
        for n, arr in values.items():
            if arr.nbytes <= budget:
                const[n] = arr
            else:
                const.pop(n, None)

    for op_idx, op in enumerate(gb.ops):
        eff = op_effects(op)
        eligible = (
            (amp_ok is None or op_idx in amp_ok)
            and has_op(op.type)
            and op.type not in _FOLD_EXCLUDED
            and not get_op(op.type).stateful
            and not get_op(op.type).seq_aware
            and not eff.barrier and op.type not in BARRIER_OPS
            and eff.writes
            and not (eff.writes & (persist | datas))
            and all(n in const
                    for ns in op.inputs.values() for n in ns)
            and all((gb._find_var_recursive(n) is not None
                     and gb._find_var_recursive(n).lod_level == 0)
                    for n in eff.writes))
        if eligible and op.type in _CONST_PRODUCERS:
            # already a constant: seed the environment, keep the op
            try:
                _record(_eval_const_op(op, const, is_test, device))
            except _FoldSkip:
                for n in eff.writes:
                    const.pop(n, None)
            new_ops.append(op)
            continue
        if eligible:
            # pre-gate on declared shapes so an over-budget result is
            # never even computed
            decl = [_declared_bytes(gb, n) for n in eff.writes]
            if any(b is not None and b > budget for b in decl):
                eligible = False
        if eligible:
            try:
                values = _eval_const_op(op, const, is_test, device)
            except _FoldSkip:
                values = None
            if values is not None and all(
                    arr.nbytes <= budget for arr in values.values()):
                _record(values)
                for slot, names in op.outputs.items():
                    for name in names:
                        rep = framework.Operator(
                            gb, "assign_value", None, None,
                            {"values": values[name],
                             "dtype": str(values[name].dtype),
                             "folded_from": op.type})
                        rep.outputs = {"Out": [name]}
                        new_ops.append(rep)
                folded.append((op.type, sorted(eff.writes)))
                changed = True
                continue
        # not folded: its writes are no longer known constants
        for n in op_effects(op).writes:
            const.pop(n, None)
        new_ops.append(op)

    if changed:
        gb.ops = new_ops
        program._bump()
    return folded


# ---------------------------------------------------------------------------
# elementwise-chain fusion
# ---------------------------------------------------------------------------

# binary elementwise ops a chain may flow through (X carries the chain)
FUSE_BINARY_OPS = frozenset([
    "elementwise_add", "elementwise_sub", "elementwise_mul"])
# pure unary elementwise ops (shape- and order-preserving, attr-driven)
FUSE_UNARY_OPS = frozenset([
    "relu", "sigmoid", "tanh", "exp", "sqrt", "square", "abs",
    "cast", "scale"])


def _fusible_step(op, du, dead_ok):
    """None, or (head_name, side_name|None, out_name) when ``op`` can
    be a link of an elementwise chain. ``dead_ok(name)`` decides
    whether a secondary output (dropout's Mask) may be dropped."""
    t = op.type
    if t in FUSE_BINARY_OPS:
        xs, ys, outs = op.input("X"), op.input("Y"), op.output("Out")
        if len(xs) == 1 and len(ys) == 1 and len(outs) == 1:
            side = None if ys[0] == xs[0] else ys[0]
            return xs[0], side, outs[0]
        return None
    if t in FUSE_UNARY_OPS:
        xs, outs = op.input("X"), op.output("Out")
        if len(xs) == 1 and len(outs) == 1 \
                and set(op.outputs) == {"Out"}:
            return xs[0], None, outs[0]
        return None
    if t == "dropout":
        # ONLY the eval-mode form: its lowering is a deterministic
        # scale (or identity) and provably consumes no rng key, so
        # absorbing it cannot shift the stream of later stateful ops.
        # The Mask output must be observably dead.
        if op.attrs.get("is_test") is not True:
            return None
        xs, outs = op.input("X"), op.output("Out")
        masks = op.output("Mask")
        if len(xs) != 1 or len(outs) != 1:
            return None
        if any(not dead_ok(m) for m in masks):
            return None
        return xs[0], None, outs[0]
    return None


def _step_attrs(op):
    """The simple attrs the fused lowering replays (Blocks/arrays can
    never appear on these op types; lists aren't consumed by any
    fusible rule)."""
    return {k: v for k, v in op.attrs.items()
            if isinstance(v, (str, int, float, bool))}


def fuse_elementwise_chains(program, fetch_list=None):
    """One fusion pass over the global block: maximal straight-line
    chains of fusible elementwise ops — every interior value has
    exactly ONE consumer (def-use), is not fetched / persistable /
    data / pinned, and is singly-defined — collapse into one
    ``fused_elementwise`` op (ops/basic.py) placed at the last link's
    position. Side inputs (the Y of binary links) stay ordinary
    inputs; a version check refuses any chain whose external inputs
    are rebound between their original read point and the fusion
    point, and chains never cross a barrier op (backward/print/
    sub-block carriers). Returns the fused (op_types, out_name) list.
    """
    gb = program.global_block()
    fetch = _fetch_name_set(fetch_list)
    persist = {n for n, v in gb.vars.items() if v.persistable}
    datas = {n for n, v in gb.vars.items() if v.is_data}
    pinned = pinned_names(gb)
    du = def_use(program)
    ops = gb.ops
    n = len(ops)
    untouchable = fetch | persist | datas | pinned

    # lowering detaches per WRITTEN var declaration (stop_gradient);
    # fusing away an interior write would drop that gradient cut, so
    # under autodiff (a backward marker present) stop_gradient
    # interiors refuse fusion. Inference programs never differentiate,
    # so the flag is numerics-inert there.
    has_bwd = any(op.type == "backward" for op in ops)

    def _lod0(name):
        v = gb._find_var_recursive(name)
        return v is not None and v.lod_level == 0

    def _grad_safe_interior(name):
        if not has_bwd:
            return True
        v = gb._find_var_recursive(name)
        return v is not None and not v.stop_gradient

    def _dead_ok(name):
        return (not du.use_sites(0, name) and name not in untouchable)

    barrier_idx = sorted(
        i for i, op in enumerate(ops) if op_effects(op).barrier)

    def _barrier_between(a, b):
        return any(a < i < b for i in barrier_idx)

    steps_of = [_fusible_step(op, du, _dead_ok) for op in ops]

    used = set()
    chains = []                      # (indices, steps, head, sides)
    for i in range(n):
        if i in used or steps_of[i] is None:
            continue
        head, side, out = steps_of[i]
        if not (_lod0(head) and _lod0(out)) \
                or (side is not None and not _lod0(side)):
            continue
        idxs = [i]
        sides = [] if side is None else [side]
        steps = [{"op": ops[i].type, "attrs": _step_attrs(ops[i]),
                  "arg": (-1 if ops[i].type not in FUSE_BINARY_OPS
                          else (-2 if side is None else 0))}]
        cur = out
        while True:
            uses = du.use_sites(0, cur)
            if len(uses) != 1:
                break
            j = uses[0]
            if (j <= idxs[-1] or j in used or steps_of[j] is None
                    or cur in untouchable
                    or not du.single_def(0, cur)
                    or not _grad_safe_interior(cur)
                    or _barrier_between(idxs[-1], j)):
                break
            h2, s2, o2 = steps_of[j]
            if h2 != cur:
                break              # chain value must enter through X
            if not _lod0(o2) or (s2 is not None and not _lod0(s2)):
                break
            if s2 is not None and s2 == cur:
                s2 = None          # both operands are the chain value
                arg = -2
            elif ops[j].type in FUSE_BINARY_OPS:
                arg = -2 if s2 is None else len(sides)
            else:
                arg = -1
            idxs.append(j)
            if s2 is not None:
                sides.append(s2)
            steps.append({"op": ops[j].type,
                          "attrs": _step_attrs(ops[j]), "arg": arg})
            cur = o2
        if len(idxs) < 2:
            continue
        last = idxs[-1]
        # version safety: every external input must still hold the
        # SAME binding at the fusion point as at its original read
        safe = True
        reads = [(head, idxs[0])]
        si = 0
        for k, step in enumerate(steps):
            if step["arg"] is not None and step["arg"] >= 0:
                reads.append((sides[step["arg"]], idxs[k]))
        for name, at in reads:
            if any(at < d <= last for d in du.def_sites(0, name)):
                safe = False
                break
        # the final output must be singly-defined too (rebinding would
        # entangle versions once intermediate writes disappear)
        if not du.single_def(0, cur):
            safe = False
        if not safe:
            continue
        used.update(idxs)
        chains.append((idxs, steps, head, sides, cur))

    if chains and getattr(program, "_amp", False):
        # per-chain AMP admission (numcheck precision-flow proof):
        # only chains whose fused dtype flow provably replays the
        # unfused ops' — the old behavior fused blindly, silently
        # rewidening bf16 chains to f32 under O2
        from .numcheck import amp_fuse_admissible
        admit = amp_fuse_admissible(program)
        chains = [c for c in chains
                  if admit(c[2], c[1], c[3])]
    if not chains:
        return []

    fused = []
    replace_at = {}                 # last idx -> new op
    drop = set()
    for idxs, steps, head, sides, out in chains:
        new = framework.Operator(gb, "fused_elementwise", None, None,
                                 {"steps": steps})
        new.inputs = {"X": [head]}
        if sides:
            new.inputs["Args"] = list(sides)
        new.outputs = {"Out": [out]}
        replace_at[idxs[-1]] = new
        drop.update(idxs[:-1])
        fused.append((tuple(ops[k].type for k in idxs), out))
    gb.ops = [replace_at.get(i, op) for i, op in enumerate(ops)
              if i not in drop]
    program._bump()
    return fused


def merge_common_subexpressions(program, fetch_list=None):
    """One forward CSE pass over the global block. Returns the list of
    merged (op_type, output_names) records. Later reads of a merged
    op's outputs are rewritten to the representative's outputs; the
    merged op itself is dropped."""
    gb = program.global_block()
    fetch = _fetch_name_set(fetch_list)
    persist = {n for n, v in gb.vars.items() if v.persistable}
    datas = {n for n, v in gb.vars.items() if v.is_data}
    pinned = pinned_names(gb)
    du = def_use(program)

    ver = {}           # name -> writes seen so far (reaching version)
    rename = {}        # merged output name -> representative name
    seen = {}          # value key -> representative op
    kept, merged = [], []

    for op in gb.ops:
        # apply pending renames to this op's reads first — chains of
        # identical ops collapse in one pass
        for slot, names in op.inputs.items():
            op.inputs[slot] = [rename.get(n, n) for n in names]
        eff = op_effects(op)
        key = None
        if (not eff.barrier and not eff.stateful and not eff.inplace
                and op.type not in BARRIER_OPS and eff.writes
                and not (eff.writes & (persist | datas | fetch | pinned))
                and all(du.single_def(0, n) for n in eff.writes)):
            try:
                slot_names = {n for ns in op.inputs.values() for n in ns}
                # attr-referenced reads (dataflow.attr_name_refs) are
                # part of the value too: version them so a name rebound
                # between two attr-identical ops never false-merges
                extra_key = tuple(sorted(
                    (n, ver.get(n, 0))
                    for n in eff.reads - slot_names))
                in_key = tuple(sorted(
                    (slot, tuple((n, ver.get(n, 0)) for n in names))
                    for slot, names in op.inputs.items())) + (extra_key,)
                attr_key = tuple(sorted(
                    (k, _canon(v)) for k, v in op.attrs.items()))
                out_key = tuple(sorted(
                    (slot, len(names))
                    for slot, names in op.outputs.items()))
                key = (op.type, in_key, attr_key, out_key)
            except _Unhashable:
                key = None
        rep = seen.get(key) if key is not None else None
        if rep is not None:
            sigs_match = all(
                _var_signature(gb, n) == _var_signature(gb, rn)
                for slot in op.outputs
                for n, rn in zip(op.outputs[slot], rep.outputs[slot]))
            if sigs_match:
                for slot in op.outputs:
                    for n, rn in zip(op.outputs[slot],
                                     rep.outputs[slot]):
                        rename[n] = rename.get(rn, rn)
                merged.append((op.type, sorted(eff.writes)))
                continue
        if key is not None:
            seen[key] = op
        kept.append(op)
        for n in eff.writes:
            ver[n] = ver.get(n, 0) + 1

    if merged:
        gb.ops = kept
        program._bump()
    return merged


def eliminate_dead_ops(program, fetch_list=None):
    """One DCE pass over the global block (dataflow.removable_ops does
    the proving). Returns the removed (op_type, output_names) list."""
    gb = program.global_block()
    fetch = _fetch_name_set(fetch_list)
    dead = set(removable_ops(program, fetch))
    if not dead:
        return []
    removed = []
    kept = []
    for i, op in enumerate(gb.ops):
        if i in dead:
            removed.append((op.type, sorted(op_effects(op).writes)))
        else:
            kept.append(op)
    gb.ops = kept
    program._bump()
    return removed


def _prune_unreferenced_vars(program, fetch_list):
    """Drops global-block declarations of plain temporaries no
    surviving op references. Persistables, parameters, and data vars
    always keep their declarations (they carry scope/feed contracts)."""
    gb = program.global_block()
    referenced = set(_fetch_name_set(fetch_list))
    for block in program.blocks:
        _collect_block_names(block, referenced)
    before = len(gb.vars)
    gb.vars = {n: v for n, v in gb.vars.items()
               if v.persistable or v.is_data
               or isinstance(v, framework.Parameter) or n in referenced}
    return before - len(gb.vars)


def optimize_program(program, fetch_list=None, passes=DEFAULT_PASSES,
                     max_iterations=4, collect_cost=False, device=None):
    """Runs the rewrite pipeline to a fixpoint (folding creates
    constants fusion/CSE can see, fusion/CSE expose dead ops, DCE
    sweeps — 2-3 iterations usually converge). ``passes`` selects and
    orders the pipeline (any of "fold", "fuse", "cse", "dce", plus the
    opt-in "layout" NCHW→NHWC conversion from analysis/layout.py; also
    accepts a comma-separated string). The layout pass is idempotent
    (converted ops are no longer in NCHW), so fixpoint iteration
    terminates with it in the pipeline.

    ``fetch_list`` is the observation contract: without it nothing is
    provably dead or safely rewritable (any name could be fetched at
    run time), so the call is a no-op. Mutates ``program`` in place
    (bumping its version so executor step caches refresh) and returns
    an :class:`OptimizeReport`.

    ``device`` (port-only) is where the fold pass evaluates lowering
    rules: the device the program will run on, so folded values are
    that device's bit for bit (None: ``default_fold_device()``, the card
    when CUDA is available, what a direct ``Program.optimize`` does).

    ``collect_cost=True`` additionally snapshots the static cost model
    (cost.py) around every pass application and records the per-pass
    FLOPs/bytes/op-count deltas in ``report.cost_deltas`` — the
    logged evidence each rewrite actually shrank the program. Off by
    default: the snapshot runs shape inference, which the serving
    construction hot path doesn't need."""
    passes = parse_passes(passes)
    report = OptimizeReport(passes)
    if fetch_list is None:
        return report

    cost_state = None
    if collect_cost:
        from .cost import program_cost

        def _snap():
            c = program_cost(program, fetch_list=fetch_list)
            return {"flops": c.total_flops, "bytes": c.total_bytes,
                    "n_ops": len(c.per_op)}

        report.cost_deltas = {}
        cost_state = _snap()

    def _apply(name, records):
        nonlocal cost_state
        if collect_cost and records:
            new = _snap()
            delta = report.cost_deltas.setdefault(
                name, {"flops": 0.0, "bytes": 0.0, "n_ops": 0})
            for k in delta:
                delta[k] += new[k] - cost_state[k]
            cost_state = new
        return bool(records)

    from .layout import convert_layout
    runners = {
        "layout": (convert_layout, report.converted),
        "fold": (functools.partial(fold_constants, device=device),
                 report.folded),
        "fuse": (fuse_elementwise_chains, report.fused),
        "cse": (merge_common_subexpressions, report.merged),
        "dce": (eliminate_dead_ops, report.removed),
    }
    for _ in range(max_iterations):
        changed = False
        for name in passes:
            fn, acc = runners[name]
            records = fn(program, fetch_list)
            acc.extend(records)
            changed |= _apply(name, records)
        report.iterations += 1
        if not changed:
            break
    if report:
        _prune_unreferenced_vars(program, fetch_list)
    return report
