"""Static numerics & precision-flow analysis over the Program IR (port
of ``paddle_tpu/analysis/numcheck.py``, the same lattice, engine and
rewrite gates).

An abstract interpreter that propagates, per value, a numerics lattice
element (:class:`NumInfo`):

* a **dtype-promotion state** — the dtype the value actually carries at
  run time, replaying the AMP policy (core/amp_policy.py) symbolically:
  under ``program._amp`` matmul-shaped ops compute bf16, O2 flow ops
  carry bf16 activations through, everything else stays wide;
* a **value-range interval** ``[lo, hi]`` (±inf = no bound known) moved
  through per-op transfer functions registered beside the infer rules
  via ``core.registry.register_numerics`` — matmul/conv are
  accumulate-width aware (bounds scale with the contraction size),
  reductions scale with the reduced element count, activations clamp
  (sigmoid → [0,1], softmax → [0,1], tanh → [-1,1]);
* a **finiteness** bit — True when the value is provably finite for
  every finite feed (f32/f64 range escapes are deliberately out of
  model: the wide dtypes are the "master" domain, mirroring AMP
  practice; what the bit tracks is division/log/rsqrt domain safety
  and narrow-dtype overflow).

Ops without a transfer function join to the conservative top element
(unbounded, finiteness unproven) — a missing rule can silence the
analysis but never make it wrong.

Findings use the documented CODES vocabulary (diagnostics.py):
``fp16-overflow-risk``, ``cast-precision-loss``, ``int8-scale-clip``,
``domain-hazard``, ``amp-unprotected-reduce``. The reference's CLIs
over it (``tools/numlint.py``, ``tools/fluidlint.py``) are tools of the
JAX package, which the port does not copy.

The analysis also *gates rewrites*: ``amp_fold_admissible``,
``amp_fuse_admissible`` and ``amp_layout_admissible`` replace the old
wholesale AMP refusals in optimize.py / layout.py with per-op and
per-region decisions — fold only ops provably computing in their
declared (wide) dtype, fuse only chains whose fused dtype flow
provably replays the unfused one, convert only regions whose precision
contract the transfer functions can see through. Every admitted
rewrite is bit-exact: tests/test_torch_optimize.py holds the optimized
AMP programs to the unoptimized ones.

Pure analysis: never imports torch, never runs an op.
"""
import math

from ..core import framework
from ..core.amp_policy import (AMP_MATMUL_OPS, AMP_BF16_FLOW_OPS,
                               AMP_SELF_MANAGED_DTYPE_OPS)
from ..core.registry import get_numerics, has_numerics
from .diagnostics import Diagnostic, ERROR, WARNING
from .infer import infer_program

__all__ = ["NumInfo", "NumericsReport", "check_program", "TOP",
           "interval", "num_first", "FLOAT_MAX", "MANTISSA_BITS",
           "INT_RANGE", "amp_fold_admissible", "amp_fuse_admissible",
           "amp_layout_admissible"]

INF = math.inf

# representable-span and mantissa tables for the dtypes the lattice
# distinguishes. bf16 shares f32's exponent range (overflow there is
# out of model like f32); its hazard is the 8-bit mantissa, which the
# cast-precision-loss check covers.
FLOAT_MAX = {"float16": 65504.0, "bfloat16": 3.3895e38,
             "float32": 3.4028e38, "float64": 1.7977e308}
MANTISSA_BITS = {"float16": 10, "bfloat16": 7, "float32": 23,
                 "float64": 52}
INT_RANGE = {"int8": (-128.0, 127.0), "uint8": (0.0, 255.0),
             "int16": (-32768.0, 32767.0),
             "int32": (-2147483648.0, 2147483647.0),
             "int64": (-9.2233720368547758e18, 9.2233720368547758e18),
             "bool": (0.0, 1.0)}


class NumInfo:
    """What the numerics lattice knows about one value.

    lo, hi     interval bounds (floats; ±inf = unbounded on that side)
    finite     True — provably finite for every finite feed
    dtype      the RUN-TIME dtype state (AMP-aware; may be narrower
               than the declared dtype under O2 bf16 flow)
    shape      the inferred symbolic shape (from analysis/infer.py),
               carried so transfer functions can scale bounds by
               reduction/contraction sizes
    confident  facts came from trusted seeds through registered
               transfer functions all the way (findings only fire on
               confident intervals — a missing rule can never produce
               a false positive)
    """

    __slots__ = ("lo", "hi", "finite", "dtype", "shape", "confident")

    def __init__(self, lo=-INF, hi=INF, finite=False, dtype=None,
                 shape=None, confident=False):
        self.lo = float(lo)
        self.hi = float(hi)
        self.finite = bool(finite)
        self.dtype = dtype
        self.shape = tuple(shape) if shape is not None else None
        self.confident = bool(confident)

    @property
    def bounded(self):
        """At least one informative bound (not the top interval)."""
        return self.lo > -INF or self.hi < INF

    @property
    def mag(self):
        """Largest absolute value the interval admits."""
        return max(abs(self.lo), abs(self.hi))

    def with_range(self, lo, hi, finite=None):
        return NumInfo(lo, hi,
                       self.finite if finite is None else finite,
                       self.dtype, self.shape, self.confident)

    def contains(self, x):
        return self.lo <= x <= self.hi

    def __repr__(self):
        c = "" if self.confident else "?"
        f = "fin" if self.finite else "~"
        return f"NumInfo([{self.lo:g},{self.hi:g}] {f} {self.dtype}{c})"


TOP = NumInfo()


def interval(lo, hi, finite=True):
    """Transfer-rule helper: a fresh confident interval (the engine
    re-stamps dtype/shape/confidence from its own bookkeeping)."""
    return NumInfo(lo, hi, finite=finite, confident=True)


def num_first(ins, *slots):
    """First NumInfo present in any of ``slots`` (else TOP) — the
    numerics twin of infer.first_in."""
    for s in slots:
        vs = ins.get(s)
        if vs:
            return vs[0]
    return TOP


# interval arithmetic helpers usable by transfer rules ------------------

def add_iv(a, b):
    return (a.lo + b.lo, a.hi + b.hi)


def sub_iv(a, b):
    return (a.lo - b.hi, a.hi - b.lo)


def mul_iv(a, b):
    ps = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
    ps = [0.0 if math.isnan(p) else p for p in ps]  # inf * 0 corners
    return (min(ps), max(ps))


def div_iv(a, b):
    """Quotient interval; only meaningful when b excludes 0."""
    if b.lo > 0 or b.hi < 0:
        qs = []
        for x in (a.lo, a.hi):
            for y in (b.lo, b.hi):
                q = x / y if y not in (0.0, -0.0) else math.copysign(
                    INF, x * y)
                qs.append(0.0 if math.isnan(q) else q)
        return (min(qs), max(qs))
    return (-INF, INF)


def join_iv(infos):
    """Least upper bound of several NumInfos' ranges/finiteness."""
    if not infos:
        return TOP
    return NumInfo(min(i.lo for i in infos), max(i.hi for i in infos),
                   all(i.finite for i in infos),
                   confident=all(i.confident for i in infos))


def _safe_exp(x):
    try:
        return math.exp(x)
    except OverflowError:
        return INF


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class _Env:
    __slots__ = ("d", "parent")

    def __init__(self, parent=None):
        self.d = {}
        self.parent = parent

    def get(self, name):
        e = self
        while e is not None:
            if name in e.d:
                return e.d[name]
            e = e.parent
        return None

    def set(self, name, info):
        self.d[name] = info


class NumericsReport:
    """vars: (block_idx, name) → NumInfo for every binding the engine
    saw; findings: the CODES diagnostics; amp: the program's AMP level;
    narrowed: bindings whose run-time dtype is narrower than declared
    (the AMP bf16 flow — what the rewrite gates consult)."""

    def __init__(self, amp=False):
        self.vars = {}
        self.findings = []
        self.amp = amp
        self.narrowed = set()        # (block_idx, name)
        self.fetch_names = []
        self.error_op_idxs = set()   # (block_idx, op_idx) of ERRORs

    def info(self, block_idx, name):
        v = self.vars.get((block_idx, name))
        if v is None and block_idx != 0:
            v = self.vars.get((0, name))
        return v if v is not None else TOP

    def errors(self):
        return [d for d in self.findings if d.level == ERROR]

    def warnings(self):
        return [d for d in self.findings if d.level == WARNING]

    @property
    def finite_safe(self):
        """True when the analysis proves every fetch target finite and
        found no error-level hazard — the static claim the dynamic
        cross-check sweep (tests/test_numcheck.py) validates eagerly."""
        if self.errors():
            return False
        if not self.fetch_names:
            return False
        return all(self.info(0, n).finite for n in self.fetch_names)

    def to_dict(self):
        by_code = {}
        for d in self.findings:
            by_code[d.code] = by_code.get(d.code, 0) + 1
        return {"amp": self.amp, "n_findings": len(self.findings),
                "n_errors": len(self.errors()),
                "n_warnings": len(self.warnings()),
                "by_code": by_code,
                "finite_safe": self.finite_safe,
                "n_narrowed": len(self.narrowed),
                "findings": [d.to_dict() for d in self.findings]}


def _seed_info(var, shape, dtype):
    # feeds / scope entries / parameters hold real (finite) data of
    # unknown magnitude; int seeds get their dtype's natural span
    lo, hi = INT_RANGE.get(dtype, (-INF, INF))
    return NumInfo(lo, hi, finite=True, dtype=dtype, shape=shape,
                   confident=True)


# ops whose listed input slot must not contain 0 / negatives: checked
# against confident, informative intervals only
_DOMAIN_HAZARDS = {
    "elementwise_div": ("Y", "zero"),
    "elementwise_mod": ("Y", "zero"),
    "elementwise_floordiv": ("Y", "zero"),
    "log": ("X", "nonpos"),
    "rsqrt": ("X", "nonpos"),
    "sqrt": ("X", "neg"),
    "reciprocal": ("X", "zero"),
}

_REDUCE_OPS = frozenset(["reduce_sum", "reduce_mean", "reduce_prod",
                         "sum", "mean", "softmax",
                         "softmax_with_cross_entropy"])


def check_program(program, feed_shapes=None, fetch_list=None,
                  infer_result=None):
    """Abstract numerics interpretation of every block of ``program``.

    Returns a :class:`NumericsReport`. Never raises for a malformed
    program — hazards become findings, unknown ops become top.
    """
    amp = getattr(program, "_amp", False)
    inf_res = infer_result or infer_program(program,
                                            feed_shapes=feed_shapes)
    report = NumericsReport(amp=amp)
    if fetch_list:
        report.fetch_names = [v.name if hasattr(v, "name") else v
                              for v in fetch_list]
    gb = program.global_block()
    env = _Env()

    def declared_dtype(block, name):
        v = block._find_var_recursive(name)
        return v.dtype if v is not None else None

    def fallback(block, name):
        info = inf_res.info(block.idx, name)
        return NumInfo(dtype=info.dtype or declared_dtype(block, name),
                       shape=info.shape, confident=False)

    for name, var in gb.vars.items():
        seed = var.is_data or var.persistable \
            or isinstance(var, framework.Parameter)
        if seed:
            vi = inf_res.info(0, name)
            info = _seed_info(var, vi.shape, vi.dtype or var.dtype)
            env.set(name, info)
            report.vars[(0, name)] = info

    def _out_runtime_dtype(op, slot, declared, any_bf16_in):
        """Replay the AMP cast policy (core/lowering.py _eval_op)
        symbolically for one output binding."""
        if declared != "float32" or not amp:
            return declared
        if op.type in AMP_MATMUL_OPS:
            return "bfloat16" if amp == "O2" else declared
        if amp == "O2" and op.type in AMP_BF16_FLOW_OPS:
            if op.type in AMP_SELF_MANAGED_DTYPE_OPS and slot != "Y":
                return declared          # batch_norm f32 statistics
            return "bfloat16" if any_bf16_in else declared
        return declared

    def _compute_dtype(op, ins):
        """The dtype the op's arithmetic actually runs in."""
        in_dts = [i.dtype for vs in ins.values() for i in vs
                  if i.dtype is not None]
        float_ins = [d for d in in_dts if d in FLOAT_MAX]
        base = min(float_ins, key=lambda d: MANTISSA_BITS[d]) \
            if float_ins else (in_dts[0] if in_dts else None)
        if not amp:
            return base
        if op.type in AMP_MATMUL_OPS:
            return "bfloat16"
        if amp == "O2" and op.type in AMP_BF16_FLOW_OPS:
            return base                  # flow: native promotion
        # non-flow under O2 / everything else under O1: bf16 upcast
        return "float32" if base == "bfloat16" else base

    def _check_op(op, op_idx, block, ins, outs_env):
        """Engine-level hazard checks on one op's in/out lattice."""
        t = op.type
        # -- domain hazards ------------------------------------------
        hz = _DOMAIN_HAZARDS.get(t)
        if hz is not None:
            slot, kind = hz
            v = num_first(ins, slot)
            if v.confident and v.bounded:
                bad = (kind == "zero" and v.lo <= 0 <= v.hi) \
                    or (kind == "nonpos" and v.lo <= 0) \
                    or (kind == "neg" and v.lo < 0)
                if bad:
                    report.findings.append(Diagnostic(
                        WARNING, "domain-hazard",
                        f"op {t!r}: operand {op.input(slot)[0]!r} has "
                        f"propagated range [{v.lo:g}, {v.hi:g}], which "
                        f"admits {'0' if kind == 'zero' else 'non-positive values' if kind == 'nonpos' else 'negatives'}"
                        f" — inf/NaN reachable at run time",
                        op_idx=op_idx, block_idx=block.idx,
                        hint="clip/shift the operand or add an epsilon "
                             "before the hazardous op"))
        # -- explicit narrowing casts --------------------------------
        if t == "cast":
            x = num_first(ins, "X")
            out_names = op.output("Out")
            tgt = None
            if out_names:
                o = outs_env.get(out_names[0])
                tgt = o.dtype if o is not None else None
            src = x.dtype
            if tgt in INT_RANGE and x.confident and x.bounded:
                lo, hi = INT_RANGE[tgt]
                if (x.lo < lo or x.hi > hi) and tgt in ("int8", "uint8",
                                                        "int16"):
                    report.findings.append(Diagnostic(
                        ERROR, "int8-scale-clip",
                        f"cast to {tgt}: propagated range "
                        f"[{x.lo:g}, {x.hi:g}] provably escapes the "
                        f"{tgt} span [{lo:g}, {hi:g}] — values clip",
                        op_idx=op_idx, block_idx=block.idx,
                        hint="rescale before quantizing (per-channel "
                             "scale too small for the activation "
                             "range)"))
            elif tgt in FLOAT_MAX and x.confident:
                overflow = x.bounded and x.mag > FLOAT_MAX[tgt]
                if overflow and tgt == "float16":
                    report.findings.append(Diagnostic(
                        ERROR, "fp16-overflow-risk",
                        f"cast to float16: propagated range "
                        f"[{x.lo:g}, {x.hi:g}] escapes the float16 "
                        f"span (max 65504) — inf at run time",
                        op_idx=op_idx, block_idx=block.idx,
                        hint="loss-scale / normalize before the cast, "
                             "or keep this value in bf16/f32"))
                elif src in MANTISSA_BITS and tgt in MANTISSA_BITS \
                        and MANTISSA_BITS[tgt] < MANTISSA_BITS[src] \
                        and x.bounded \
                        and x.mag > float(2 ** (MANTISSA_BITS[tgt] + 1)):
                    report.findings.append(Diagnostic(
                        WARNING, "cast-precision-loss",
                        f"narrowing cast {src}->{tgt}: propagated "
                        f"range [{x.lo:g}, {x.hi:g}] exceeds the "
                        f"{tgt} mantissa "
                        f"(2^{MANTISSA_BITS[tgt] + 1} = "
                        f"{2 ** (MANTISSA_BITS[tgt] + 1)}) — adjacent "
                        f"values collapse",
                        op_idx=op_idx, block_idx=block.idx,
                        hint="normalize first, or keep the wide "
                             "dtype through this value"))
        # -- quantization clips --------------------------------------
        if t == "fake_dequantize_max_abs":
            x = num_first(ins, "X")
            r = float(op.attrs.get("max_range", 127.0))
            if x.confident and x.bounded and x.mag > r:
                report.findings.append(Diagnostic(
                    ERROR, "int8-scale-clip",
                    f"fake_dequantize_max_abs: quantized input range "
                    f"[{x.lo:g}, {x.hi:g}] exceeds max_range {r:g} — "
                    f"the paired quantize step provably clipped",
                    op_idx=op_idx, block_idx=block.idx,
                    hint="raise bit_length / max_range, or rescale "
                         "the tensor before quantization"))
        # -- overflow of fp16 compute --------------------------------
        for slot, names in op.outputs.items():
            for name in names:
                o = outs_env.get(name)
                if o is None or not o.confident:
                    continue
                if o.dtype == "float16" and o.bounded \
                        and o.mag > FLOAT_MAX["float16"] and t != "cast":
                    report.findings.append(Diagnostic(
                        ERROR, "fp16-overflow-risk",
                        f"op {t!r}: output {name!r} is float16 but its "
                        f"propagated range [{o.lo:g}, {o.hi:g}] "
                        f"escapes the float16 span (max 65504)",
                        op_idx=op_idx, block_idx=block.idx,
                        hint="rescale the operands or compute this "
                             "value in a wider dtype"))
        # -- reductions kept in fp16 ---------------------------------
        if t in _REDUCE_OPS:
            cd = _compute_dtype(op, ins)
            if cd == "float16":
                out = None
                for names in op.outputs.values():
                    for n in names:
                        out = outs_env.get(n) or out
                within = (out is not None and out.confident
                          and out.bounded
                          and out.mag <= FLOAT_MAX["float16"])
                if not within:
                    report.findings.append(Diagnostic(
                        WARNING, "amp-unprotected-reduce",
                        f"op {t!r}: reduction computed in float16 with "
                        f"no provable range bound — accumulate in "
                        f"f32/bf16 or rescale first",
                        op_idx=op_idx, block_idx=block.idx,
                        hint="cast the operand up before reducing; "
                             "fp16 sums overflow at 65504"))

    def _run_op(op, op_idx, block, env):
        # sub-blocks see the outer env; their writes stay local
        for attr in op.attrs.values():
            if isinstance(attr, framework.Block):
                sub_env = _Env(parent=env)
                for name, var in attr.vars.items():
                    if var.is_data or var.persistable:
                        vi = inf_res.info(attr.idx, name)
                        sub_env.set(name, _seed_info(
                            var, vi.shape, vi.dtype or var.dtype))
                for j, sub_op in enumerate(attr.ops):
                    _run_op(sub_op, j, attr, sub_env)
                for name, info in sub_env.d.items():
                    report.vars[(attr.idx, name)] = info

        if op.type == "backward":
            # autodiff marker: <param>@GRAD exists from here on. Grad
            # ranges are not modeled (reverse-mode transfer functions
            # are out of scope) — grads join to finite-unproven top.
            for p in op.attr("parameter_names") or []:
                g = framework.grad_var_name(p)
                pv = env.get(p)
                info = NumInfo(dtype=pv.dtype if pv else None,
                               shape=pv.shape if pv else None)
                env.set(g, info)
                report.vars[(block.idx, g)] = info
            return

        ins = {slot: [env.get(n) or fallback(block, n) for n in names]
               for slot, names in op.inputs.items()}
        any_bf16_in = any(i.dtype == "bfloat16"
                          for vs in ins.values() for i in vs)
        all_confident = all(i.confident
                            for vs in ins.values() for i in vs)
        all_finite = all(i.finite for vs in ins.values() for i in vs)

        rule = get_numerics(op.type)
        outs = None
        if rule is not None:
            try:
                outs = rule(op, ins, op.attrs)
            except Exception as e:   # a rule bug must not kill the pass
                report.findings.append(Diagnostic(
                    WARNING, "pass-crashed",
                    f"numerics rule for {op.type!r} raised "
                    f"{type(e).__name__}: {e}", op_idx=op_idx,
                    block_idx=block.idx))
                outs = None

        outs_env = {}
        for slot, names in op.outputs.items():
            vals = (outs or {}).get(slot)
            for k, name in enumerate(names):
                if vals is not None and k < len(vals) \
                        and vals[k] is not None:
                    info = vals[k]
                    info.confident = info.confident and all_confident
                    info.finite = info.finite and (
                        all_finite or finite_clamp(op.type))
                else:
                    info = NumInfo()
                vi = inf_res.info(block.idx, name)
                declared = vi.dtype or declared_dtype(block, name)
                info.shape = vi.shape
                info.dtype = _out_runtime_dtype(op, slot, declared,
                                                any_bf16_in)
                if info.dtype == "bfloat16" and declared == "float32":
                    report.narrowed.add((block.idx, name))
                env.set(name, info)
                report.vars[(block.idx, name)] = info
                outs_env[name] = info

        n_before = len(report.findings)
        _check_op(op, op_idx, block, ins, outs_env)
        for d in report.findings[n_before:]:
            if d.level == ERROR:
                report.error_op_idxs.add((block.idx, op_idx))

    for i, op in enumerate(gb.ops):
        _run_op(op, i, gb, env)
    return report


def finite_clamp(op_type):
    """Ops whose transfer functions assert finiteness independently of
    their inputs (saturating clamps — sigmoid(±inf) is 0/1, clip pins
    to its bounds): the engine's finite &= inputs-finite conjunction is
    skipped for them. Generator ops ride along harmlessly (no inputs,
    so the conjunction is vacuous anyway)."""
    return op_type in ("sigmoid", "tanh", "clip", "hard_sigmoid",
                       "brelu", "relu6", "soft_relu", "sin", "cos",
                       "sign", "logical_not", "softmax", "accuracy",
                       "fill_constant", "assign_value",
                       "fill_zeros_like", "uniform_random",
                       "gaussian_random")


# ---------------------------------------------------------------------------
# rewrite gates — the per-op/per-region decisions that replace the old
# wholesale AMP refusals (optimize.py fold/fuse, layout.py)
# ---------------------------------------------------------------------------

def amp_fold_admissible(program, report=None):
    """The set of global-block op indices constant folding may touch
    under the program's AMP level, or None when no gating is needed
    (no AMP). An op is admissible iff it provably computes in its
    declared wide dtype at run time: not matmul-shaped (those compute
    bf16 under any level, so an eager f32 fold diverges) and none of
    its inputs carry an AMP-narrowed (bf16) run-time dtype — then the
    eager fold through the op's own lowering rule replays the run-time
    computation exactly and stays bit-exact by construction."""
    if not getattr(program, "_amp", False):
        return None
    rep = report or check_program(program)
    gb = program.global_block()
    adm = set()
    for i, op in enumerate(gb.ops):
        if op.type in AMP_MATMUL_OPS:
            continue
        if any((0, n) in rep.narrowed
               for ns in op.inputs.values() for n in ns):
            continue
        adm.add(i)
    return adm


def amp_fuse_admissible(program, report=None):
    """Returns admit(head, steps, sides) deciding whether one
    elementwise chain may fuse under the program's AMP level (always
    True without AMP). The precision contract the transfer state must
    prove: the fused replay (one flow op, casts only at the frontier)
    is bit-identical to the unfused ops. That holds iff

    * no value in the chain carries bf16 at run time (the AMP casts
      are then no-ops on both forms), or
    * every step is a bf16-flow op and no INTERIOR step mixes bf16
      with f32 (an interior mix makes the unfused form downcast
      mid-chain while the fused replay stays wide — the final step may
      mix, because both forms then end with the same single downcast).
    """
    if not getattr(program, "_amp", False):
        return lambda head, steps, sides: True
    rep = report or check_program(program)

    def _bf16(name):
        return (0, name) in rep.narrowed \
            or rep.info(0, name).dtype == "bfloat16"

    def admit(head, steps, sides):
        state_bf = _bf16(head)
        last = len(steps) - 1
        for k, step in enumerate(steps):
            arg = step.get("arg", -1)
            side = sides[arg] if arg is not None and arg >= 0 else None
            side_bf = side is not None and _bf16(side)
            any_bf = state_bf or side_bf
            if any_bf:
                if step["op"] not in AMP_BF16_FLOW_OPS:
                    return False     # unfused upcasts, fused would not
                if side is not None and side_bf != state_bf and k < last:
                    return False     # interior mixed-dtype downcast
                state_bf = True
        return True
    return admit


def amp_layout_admissible(program, report=None):
    """Returns refuse(op_types, op_idxs) → None | reason, the
    per-region AMP admission for the layout pass (None without AMP).
    A region converts only when the precision contract is provable:
    every region op's dtype behavior under AMP is known to the policy
    (matmul/flow sets — frontier transposes are flow ops, so the
    conversion preserves each value's run-time dtype state) or its
    value ranges are analyzable (a registered transfer function), and
    numcheck anchored no error-level finding inside the region."""
    if not getattr(program, "_amp", False):
        return None
    rep = report or check_program(program)

    def refuse(op_types, op_idxs):
        for t in op_types:
            if t not in AMP_MATMUL_OPS and t not in AMP_BF16_FLOW_OPS \
                    and not has_numerics(t):
                return "amp-unproven"
        if any((0, i) in rep.error_op_idxs for i in op_idxs):
            return "amp-numerics-hazard"
        return None
    return refuse
