"""Cost-model-driven layout analysis: whole-program NCHW→NHWC
conversion (port of ``paddle_tpu/analysis/layout.py``, pure IR code;
the reference's account of the analysis follows).

Fluid's conv/pool/BN kernels are NCHW and the layers default to it for
API parity — but NCHW is the TPU-hostile layout: the lane (128-wide)
dimension should be the feature dim, and an NCHW graph pays an
activation layout copy on both sides of every convolution (measured as
the #1 kernel/bytes bucket of the NCHW ResNet-50 step — see
docs/PERFORMANCE.md §5/§9c). The per-op lowering rules already accept
``data_format="NHWC"``; this module turns that per-op knob into a
whole-program static analysis + rewrite, the way TPU-MLIR
(arXiv:2210.15016) treats layout assignment as a compiler pass
verified against the unconverted graph and the TensorFlow paper
(arXiv:1605.08695) folds layout into graph-level rewriting rather than
per-op user choice.

Two halves:

* ``analyze_layout`` — the PROPAGATION ANALYSIS. Walks def-use chains
  assigning each 4-D value a layout from a small lattice
  (NCHW / NHWC / layout-agnostic / layout-fixed), seeded by the
  layout-sensitive ops (conv2d, depthwise_conv2d, conv2d_transpose,
  pool2d, batch_norm, lrn) and by the names that must keep their
  declared layout (feed/fetch/persistable/pinned names, LoD values,
  reshape/flatten boundaries). Sensitive and transparent ops flood
  into connected REGIONS; each region's conversion is gated by the
  static cost model: convert only when the bytes of the implicit
  per-conv NCHW relayouts the conversion removes exceed the bytes of
  the explicit ``transpose2`` ops it must insert at the region's
  frontiers.
* ``convert_layout`` — the REWRITE PASS (``passes=("layout", ...)`` /
  ``PADDLE_TPU_OPTIMIZE=layout``; NOT in the default pipeline). Flips
  the selected regions' sensitive ops to ``data_format="NHWC"``,
  remaps channel-axis attributes on the transparent ops (elementwise
  ``axis``, ``fused_elementwise`` step attrs), and inserts the minimal
  set of ``transpose2`` ops at the frontiers. Parameters stay in the
  fluid ``[cout, cin/g, kh, kw]`` layout, so Scope contents,
  checkpoints, and saved models are untouched — this is an IR-only
  rewrite.

Verification contract (tools/optcheck.py ``--passes layout``, gated on
all 16 zoo configs): on programs where nothing converts the pass is a
no-op and outputs stay bit-exact; on converted conv paths outputs must
match within the documented tight tolerance (XLA may reassociate conv
and batch-norm reductions across layouts) and be bit-stable
run-to-run. ``LayoutConsistencyPass`` (registered in the default
verifier pipeline) re-derives every 4-D value's layout AFTER any
conversion and ERRORs on layout-inconsistent wiring.

Like the rest of analysis/, this module never imports torch.
"""
from ..core import framework
from .dataflow import (attr_name_refs, axis_permutation, def_use,
                       pinned_names)
from .cost import DTYPE_BYTES
from .infer import infer_program

__all__ = ["NCHW", "NHWC", "AGNOSTIC", "FIXED", "join",
           "NCHW_TO_NHWC", "NHWC_TO_NCHW", "LayoutRegion", "LayoutPlan",
           "analyze_layout", "convert_layout", "SENSITIVE_OPS",
           "LayoutConsistencyPass"]

# ---------------------------------------------------------------------------
# the lattice
# ---------------------------------------------------------------------------

# AGNOSTIC ⊑ {NCHW, NHWC} ⊑ FIXED: agnostic values take whatever
# layout their neighbors settle on; a value claimed as both NCHW and
# NHWC (or observable from outside the IR) is FIXED — it must keep its
# declared layout and conversion stops at it.
NCHW = "NCHW"
NHWC = "NHWC"
AGNOSTIC = "agnostic"
FIXED = "fixed"

NCHW_TO_NHWC = (0, 2, 3, 1)     # out[i] = in[perm[i]]
NHWC_TO_NCHW = (0, 3, 1, 2)


def join(a, b):
    """Lattice join: agnostic yields, agreement stands, conflict (or
    anything already fixed) is fixed."""
    if a == AGNOSTIC:
        return b
    if b == AGNOSTIC or a == b:
        return a
    return FIXED


def permute_shape(shape, perm):
    """Applies an axis permutation to a (possibly symbolic) shape."""
    if shape is None:
        return None
    return tuple(shape[p] for p in perm)


# ---------------------------------------------------------------------------
# op classification
# ---------------------------------------------------------------------------

# layout-sensitive ops with an NHWC lowering branch:
# type -> (activation input slot, activation output slot, format attr)
SENSITIVE_OPS = {
    "conv2d": ("Input", "Output", "data_format"),
    "depthwise_conv2d": ("Input", "Output", "data_format"),
    "conv2d_transpose": ("Input", "Output", "data_format"),
    "pool2d": ("X", "Out", "data_format"),
    "batch_norm": ("X", "Y", "data_layout"),
    "lrn": ("X", "Out", "data_format"),
}

# pure elementwise unary rules (ops/basic.py _unary_table + friends):
# value-per-element, no axis semantics — layout-transparent as is
_TRANSPARENT_UNARY = frozenset([
    "relu", "relu6", "leaky_relu", "sigmoid", "logsigmoid", "tanh",
    "tanh_shrink", "exp", "log", "sqrt", "rsqrt", "abs", "square",
    "reciprocal", "floor", "ceil", "round", "sin", "cos", "softplus",
    "softsign", "softshrink", "hard_shrink", "thresholded_relu", "elu",
    "gelu", "swish", "stanh", "brelu", "soft_relu", "hard_sigmoid",
    "pow", "mish", "sign", "logical_not", "cast", "scale", "clip",
])

# binary elementwise with fluid axis-broadcast semantics: transparent
# when the Y span stays contiguous under the permutation (axis remap)
_TRANSPARENT_BINARY = frozenset([
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow",
])


def _remap_broadcast_axis(axis, y_rank, x_rank=4,
                          perm=NCHW_TO_NHWC):
    """New ``axis`` attr for a fluid-broadcast Y operand after the X
    operand's layout permutation, or None when the spanned dims do not
    stay contiguous and in order (the op then refuses conversion).

    Y's shape matches X dims [axis, axis+y_rank); under the
    permutation those dims land at positions ``pos`` — convertible iff
    ``pos`` is a run of consecutive, increasing indices."""
    if y_rank == 0:
        return -1
    if axis is None or axis == -1:
        axis = x_rank - y_rank
    span = range(axis, axis + y_rank)
    if axis < 0 or axis + y_rank > x_rank:
        return None
    inv = [0] * x_rank             # inv[old_dim] = new position
    for new, old in enumerate(perm):
        inv[old] = new
    pos = [inv[d] for d in span]
    if any(b - a != 1 for a, b in zip(pos, pos[1:])):
        return None
    return pos[0]


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------

class LayoutRegion:
    """One connected layout domain the analysis found.

    values          region value names (become NHWC if selected)
    op_idxs         global-block indices of the region's candidate ops
    n_sensitive     how many are layout-sensitive (conv/pool/BN/...)
    frontier_in     [(name, first-use op idx)] — NCHW values the region
                    reads; each costs one inserted NCHW→NHWC transpose
    frontier_out    [(name, producer op idx)] — region values that also
                    have NCHW consumers; each costs one NHWC→NCHW
                    transpose
    benefit_bytes   estimated bytes of implicit per-op NCHW relayouts
                    removed by converting (None: unknown shapes)
    transpose_bytes estimated bytes the frontier transposes cost
    selected        the cost gate's verdict (benefit > cost)
    reason          why an unselected region was refused
    """

    def __init__(self):
        self.values = set()
        self.op_idxs = []
        self.n_sensitive = 0
        self.frontier_in = []
        self.frontier_out = []
        self.benefit_bytes = 0
        self.transpose_bytes = 0
        self.selected = False
        self.reason = None

    @property
    def n_transposes(self):
        return len(self.frontier_in) + len(self.frontier_out)

    @property
    def bytes_delta(self):
        """Estimated bytes SAVED by converting (positive = profitable)."""
        if self.benefit_bytes is None:
            return None
        return self.benefit_bytes - self.transpose_bytes

    def to_dict(self):
        return {"n_values": len(self.values),
                "n_ops": len(self.op_idxs),
                "n_sensitive": self.n_sensitive,
                "n_transposes": self.n_transposes,
                "benefit_bytes": self.benefit_bytes,
                "transpose_bytes": self.transpose_bytes,
                "bytes_delta": self.bytes_delta,
                "selected": self.selected,
                "reason": self.reason}


class LayoutPlan:
    """What ``analyze_layout`` decided: the regions, the per-value
    lattice assignment, and the whole-program refusal reason (AMP)."""

    def __init__(self):
        self.regions = []
        self.value_layout = {}       # 4-D value name -> lattice element
        self.refused = None          # program-level refusal ("amp")

    @property
    def selected_regions(self):
        return [r for r in self.regions if r.selected]

    @property
    def n_transposes(self):
        return sum(r.n_transposes for r in self.selected_regions)

    @property
    def bytes_delta(self):
        return sum(r.bytes_delta or 0 for r in self.selected_regions)

    def to_dict(self):
        return {"refused": self.refused,
                "n_regions": len(self.regions),
                "n_selected": len(self.selected_regions),
                "n_transposes": self.n_transposes,
                "bytes_delta": self.bytes_delta,
                "regions": [r.to_dict() for r in self.regions]}


class _Candidate:
    """One op the conversion could rewrite."""

    __slots__ = ("idx", "op", "sensitive", "act_ins", "act_outs",
                 "attr_rewrites")

    def __init__(self, idx, op, sensitive, act_ins, act_outs,
                 attr_rewrites):
        self.idx = idx
        self.op = op
        self.sensitive = sensitive
        self.act_ins = act_ins       # rank-4 activation input names
        self.act_outs = act_outs     # rank-4 output names
        self.attr_rewrites = attr_rewrites  # {attr: new value}


def _fetch_names(fetch_list):
    return {v.name if isinstance(v, framework.Variable) else v
            for v in (fetch_list or [])}


def _classify(op, rank, is_fixed):
    """Returns a _Candidate for ops the conversion knows how to flip
    (sensitive in NCHW, or layout-transparent with remappable attrs),
    else None. ``rank(name)`` reads the inference result;
    ``is_fixed(name)`` the fixed set."""
    t = op.type
    if t in SENSITIVE_OPS:
        in_slot, out_slot, fmt_attr = SENSITIVE_OPS[t]
        fmt = op.attrs.get(fmt_attr,
                           op.attrs.get("data_layout", "NCHW"))
        ins = op.input(in_slot)
        if fmt != "NCHW" or len(ins) != 1 or rank(ins[0]) != 4:
            return None
        # global pooling reads spatial dims from x.shape per format —
        # fine; ALL rank-4 outputs flip (lrn's MidOut rides along)
        act_outs = [n for ns in op.outputs.values() for n in ns
                    if rank(n) == 4]
        outs = op.output(out_slot)
        if len(outs) != 1 or outs[0] not in act_outs:
            return None
        if any(is_fixed(n) for n in act_outs):
            return None
        return _Candidate(None, op, True, [ins[0]], act_outs,
                          {fmt_attr: "NHWC"})

    if t in _TRANSPARENT_UNARY:
        xs, outs = op.input("X"), op.output("Out")
        if len(xs) != 1 or len(outs) != 1 or rank(xs[0]) != 4 \
                or rank(outs[0]) != 4:
            return None
        if set(op.outputs) - {"Out"}:
            return None              # norm-style extra outputs: refuse
        if is_fixed(outs[0]):
            return None
        return _Candidate(None, op, False, [xs[0]], [outs[0]], {})

    if t in _TRANSPARENT_BINARY:
        xs, ys, outs = op.input("X"), op.input("Y"), op.output("Out")
        if len(xs) != 1 or len(ys) != 1 or len(outs) != 1 \
                or rank(xs[0]) != 4 or rank(outs[0]) != 4:
            return None
        if is_fixed(outs[0]):
            return None
        yr = rank(ys[0])
        if yr is None:
            return None
        if yr == 4:
            # full-rank operand: handled as an activation (transposed
            # or frontier), no axis remap needed
            return _Candidate(None, op, False, [xs[0], ys[0]],
                              [outs[0]], {})
        new_axis = _remap_broadcast_axis(op.attrs.get("axis", -1), yr)
        if new_axis is None:
            return None
        return _Candidate(None, op, False, [xs[0]], [outs[0]],
                          {"axis": new_axis})

    if t == "dropout":
        # ONLY the eval-mode form is transparent: the train-mode mask
        # draw depends on the traced shape ORDER, so converting would
        # move every kept/dropped position
        if op.attrs.get("is_test") is not True:
            return None
        xs, outs = op.input("X"), op.output("Out")
        masks = op.output("Mask")
        if len(xs) != 1 or len(outs) != 1 or rank(xs[0]) != 4:
            return None
        act_outs = [n for n in outs + masks if rank(n) == 4]
        if any(is_fixed(n) for n in act_outs) or outs[0] not in act_outs:
            return None
        return _Candidate(None, op, False, [xs[0]], act_outs, {})

    if t == "pad2d":
        xs, outs = op.input("X"), op.output("Out")
        if len(xs) != 1 or len(outs) != 1 or rank(xs[0]) != 4 \
                or op.attrs.get("data_format", "NCHW") != "NCHW" \
                or is_fixed(outs[0]):
            return None
        return _Candidate(None, op, False, [xs[0]], [outs[0]],
                          {"data_format": "NHWC"})

    if t == "sum":
        xs, outs = op.input("X"), op.output("Out")
        if not xs or len(outs) != 1 or is_fixed(outs[0]) \
                or any(rank(n) != 4 for n in xs) or rank(outs[0]) != 4:
            return None
        return _Candidate(None, op, False, list(xs), [outs[0]], {})

    if t == "fused_elementwise":
        xs, outs = op.input("X"), op.output("Out")
        args = op.input("Args")
        if len(xs) != 1 or len(outs) != 1 or rank(xs[0]) != 4 \
                or rank(outs[0]) != 4 or is_fixed(outs[0]):
            return None
        act_ins = [xs[0]]
        new_steps = []
        for step in op.attrs.get("steps", []):
            st, attrs = step.get("op"), dict(step.get("attrs", {}))
            if st in _TRANSPARENT_BINARY and step.get("arg", -1) >= 0:
                yn = args[step["arg"]]
                yr = rank(yn)
                if yr is None:
                    return None
                if yr == 4:
                    act_ins.append(yn)
                else:
                    new_axis = _remap_broadcast_axis(
                        attrs.get("axis", -1), yr)
                    if new_axis is None:
                        return None
                    attrs["axis"] = new_axis
            elif st in _TRANSPARENT_BINARY:
                pass                       # chain-with-itself: no remap
            elif st == "dropout":
                if attrs.get("is_test") is not True:
                    return None
            elif st not in _TRANSPARENT_UNARY:
                return None
            new_steps.append({**step, "attrs": attrs})
        return _Candidate(None, op, False, act_ins, [outs[0]],
                          {"steps": new_steps})

    return None


def analyze_layout(program, fetch_list=None, assume_batch=1,
                   infer_result=None):
    """Runs the propagation analysis over the global block and returns
    a :class:`LayoutPlan` — which regions exist, which the cost model
    selects for conversion, and the per-value lattice assignment.
    Pure analysis: never mutates the program, never imports torch.

    ``fetch_list`` feeds the fixed set (fetched names keep their
    declared layout); ``None`` means "analysis only" — callers that
    REWRITE must pass the real observation contract."""
    from .infer import dim_prod

    plan = LayoutPlan()
    # AMP no longer refuses wholesale: the frontier transposes are AMP
    # flow ops, so conversion preserves every value's run-time dtype
    # state — admission is decided per region below against numcheck's
    # precision-flow proof (analysis/numcheck.py amp_layout_admissible)
    from .numcheck import amp_layout_admissible
    amp_refuse = amp_layout_admissible(program)
    gb = program.global_block()
    infer = infer_result or infer_program(program)
    du = def_use(program)
    fetch = _fetch_names(fetch_list)
    pinned = pinned_names(gb)
    other_blocks = set()
    for block in program.blocks[1:]:
        for op in block.ops:
            for ns in op.inputs.values():
                other_blocks.update(ns)
            for ns in op.outputs.values():
                other_blocks.update(ns)
            other_blocks |= attr_name_refs(op)

    def rank(name):
        info = infer.info(0, name)
        return None if info.shape is None else len(info.shape)

    def value_bytes(name):
        info = infer.info(0, name)
        n = dim_prod(tuple(assume_batch if d < 0 else d
                           for d in (info.shape or ())) or (0,))
        if info.shape is None or n < 0:
            return None
        return n * DTYPE_BYTES.get(info.dtype or "float32", 4)

    def is_fixed(name):
        if name in fetch or name in pinned or name in other_blocks:
            return True
        v = gb._find_var_recursive(name)
        if v is None:
            return True
        if v.is_data or v.persistable \
                or isinstance(v, framework.Parameter):
            return True
        if v.lod_level > 0 or v.type != "lod_tensor":
            return True
        return du.def_count(0, name) != 1

    # ---- candidate collection + union-find over region values --------
    candidates = {}
    produced_by = {}                 # value -> candidate op idx
    for i, op in enumerate(gb.ops):
        cand = _classify(op, rank, is_fixed)
        if cand is None:
            continue
        cand.idx = i
        candidates[i] = cand
        for n in cand.act_outs:
            produced_by[n] = i

    parent = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for cand in candidates.values():
        outs = cand.act_outs
        for n in outs[1:]:
            union(outs[0], n)
        for n in cand.act_ins:
            if n in produced_by:     # NHWC-capable producer: bridge
                union(n, outs[0])

    regions = {}                     # root -> LayoutRegion
    for cand in candidates.values():
        root = find(cand.act_outs[0])
        region = regions.setdefault(root, LayoutRegion())
        region.op_idxs.append(cand.idx)
        region.values.update(cand.act_outs)
        if cand.sensitive:
            region.n_sensitive += 1

    # ---- frontiers + cost gate per region -----------------------------
    for region in regions.values():
        region.op_idxs.sort()
        in_region_ops = set(region.op_idxs)
        seen_in = set()
        unknown = False
        for i in region.op_idxs:
            cand = candidates[i]
            for n in cand.act_ins:
                if n in region.values or n in seen_in:
                    continue
                if n in produced_by:
                    continue         # belongs to another region
                if du.def_count(0, n) > 1:
                    region.reason = "rebound-frontier-input"
                    break
                seen_in.add(n)
                region.frontier_in.append((n, i))
            if region.reason:
                break
            if cand.sensitive:
                b_in = [value_bytes(n) for n in cand.act_ins]
                b_out = [value_bytes(n) for n in cand.act_outs]
                if any(b is None for b in b_in + b_out):
                    unknown = True
                else:
                    region.benefit_bytes += sum(b_in) + sum(b_out)
        for n in sorted(region.values):
            uses = du.use_sites(0, n)
            if n in fetch or any(u not in in_region_ops for u in uses):
                region.frontier_out.append((n, produced_by[n]))
        if region.reason:
            region.benefit_bytes = None
            continue
        t_bytes = 0
        for n, _ in region.frontier_in + region.frontier_out:
            b = value_bytes(n)
            if b is None:
                unknown = True
                break
            t_bytes += 2 * b         # one read + one write per copy
        region.transpose_bytes = t_bytes
        amp_reason = None
        if amp_refuse is not None:
            amp_reason = amp_refuse(
                [gb.ops[i].type for i in region.op_idxs],
                region.op_idxs)
        if unknown:
            region.benefit_bytes = None
            region.reason = "unknown-shapes"
        elif amp_reason is not None:
            # the precision contract is unprovable here (an op whose
            # AMP dtype behavior the policy doesn't know, or a
            # numerics ERROR anchored inside the region)
            region.reason = amp_reason
        elif region.n_sensitive == 0:
            region.reason = "no-sensitive-op"
        elif region.benefit_bytes <= region.transpose_bytes:
            region.reason = "not-profitable"
        else:
            region.selected = True

    plan.regions = sorted(regions.values(),
                          key=lambda r: r.op_idxs[0])

    # ---- lattice assignment (reporting / verifier seeds) --------------
    for block in (gb,):
        for name in block.vars:
            if rank(name) != 4:
                continue
            if is_fixed(name):
                plan.value_layout[name] = FIXED
            else:
                plan.value_layout[name] = AGNOSTIC
    for region in plan.regions:
        lay = NHWC if region.selected else \
            (AGNOSTIC if region.n_sensitive == 0 else NCHW)
        for n in region.values:
            plan.value_layout[n] = lay
    return plan


# ---------------------------------------------------------------------------
# the rewrite pass
# ---------------------------------------------------------------------------

def convert_layout(program, fetch_list=None, assume_batch=1,
                   force=False):
    """One NCHW→NHWC conversion pass over the global block (the
    ``"layout"`` entry of the optimize pipeline). Mutates ``program``
    in place; returns the rewrite records — ``(op_type, output_names)``
    per converted op plus ``("transpose2", [name])`` per inserted
    frontier transpose — in the same shape the other optimize passes
    report. Without a fetch contract nothing is provably safe to
    rewrite, so ``fetch_list=None`` is a no-op. ``force=True`` skips
    the profitability gate (every structurally-convertible region
    converts) — the A/B lever benches use; safety refusals still hold.
    Idempotent: converted ops are no longer in NCHW, so a second run
    finds nothing."""
    if fetch_list is None:
        return []
    plan = analyze_layout(program, fetch_list=fetch_list,
                          assume_batch=assume_batch)
    regions = [r for r in plan.regions
               if (r.selected or (force and r.n_sensitive > 0
                                  and r.reason in ("not-profitable",)))]
    if not regions:
        return []
    gb = program.global_block()
    records = []

    convert = {}                     # op idx -> _Candidate (re-derived)
    entry_before = {}                # op idx -> [(src, new)]
    exit_after = {}                  # op idx -> [(src, new)]
    region_of_op = {}
    for region in regions:
        for i in region.op_idxs:
            region_of_op[i] = region

    # re-derive candidates exactly as the analysis saw them (the plan
    # stores indices; attrs/rewrites come from _classify — is_fixed is
    # moot here, the analysis already excluded fixed-output ops)
    infer = infer_program(program)

    def rank(name):
        info = infer.info(0, name)
        return None if info.shape is None else len(info.shape)

    for region in regions:
        for i in region.op_idxs:
            cand = _classify(gb.ops[i], rank, lambda n: False)
            cand.idx = i
            convert[i] = cand
        for n, first_use in region.frontier_in:
            entry_before.setdefault(first_use, []).append(n)
        for n, producer in region.frontier_out:
            exit_after.setdefault(producer, []).append(n)

    def _mk_transpose(src, dst, perm, out_shape):
        like = gb._find_var_recursive(src)
        if dst not in gb.vars:
            gb.create_var(name=dst,
                          dtype=like.dtype if like else "float32",
                          shape=out_shape,
                          stop_gradient=like.stop_gradient
                          if like else False)
        op = framework.Operator(gb, "transpose2", None, None,
                                {"axis": list(perm)})
        op.inputs = {"X": [src]}
        op.outputs = {"Out": [dst]}
        return op

    nhwc_name = {}                   # frontier-in src -> NHWC twin
    nchw_name = {}                   # frontier-out src -> NCHW twin

    new_ops = []
    for i, op in enumerate(gb.ops):
        for src in entry_before.get(i, []):
            dst = src + "@NHWC"
            nhwc_name[src] = dst
            new_ops.append(_mk_transpose(
                src, dst, NCHW_TO_NHWC,
                permute_shape(infer.info(0, src).shape, NCHW_TO_NHWC)))
            records.append(("transpose2", [dst]))
        cand = convert.get(i)
        if cand is not None:
            region = region_of_op[i]
            # reads of frontier-in values go through the NHWC twin
            for slot, names in op.inputs.items():
                op.inputs[slot] = [nhwc_name.get(n, n)
                                   if n not in region.values else n
                                   for n in names]
            op.attrs.update(cand.attr_rewrites)
            # keep declared metadata honest: converted outputs are NHWC
            for n in cand.act_outs:
                v = gb.vars.get(n)
                if v is not None and v.shape is not None \
                        and len(v.shape) == 4:
                    v.shape = permute_shape(v.shape, NCHW_TO_NHWC)
            records.append((op.type, sorted(cand.act_outs)))
        elif nchw_name:
            # NCHW consumers of converted values read the NCHW twin
            for slot, names in op.inputs.items():
                op.inputs[slot] = [nchw_name.get(n, n) for n in names]
        new_ops.append(op)
        for src in exit_after.get(i, []):
            dst = src + "@NCHW"
            nchw_name[src] = dst
            # the twin restores the ORIGINAL (pre-conversion) layout,
            # so its shape is src's shape as inference saw it BEFORE
            # the rewrite flipped the region
            new_ops.append(_mk_transpose(src, dst, NHWC_TO_NCHW,
                                         infer.info(0, src).shape))
            records.append(("transpose2", [dst]))

    gb.ops = new_ops
    program._bump()
    return records


# ---------------------------------------------------------------------------
# the verifier pass: layout-inconsistent wiring is an ERROR
# ---------------------------------------------------------------------------

from .passes import Pass  # noqa: E402  (no cycle: passes only imports
#                                        diagnostics at module scope)


class LayoutConsistencyPass(Pass):
    """Re-derives every 4-D value's layout by forward propagation —
    feeds/persistables seed NCHW (the declared fluid layout),
    transpose ops with the two canonical permutations flip it,
    transparent ops carry it, layout-sensitive ops REQUIRE their input
    layout to match their declared ``data_format`` — and ERRORs on any
    mismatch. Runs in the default verifier pipeline, so a buggy
    conversion (or a hand-edited NHWC program missing its stem
    transpose) fails ``Program.verify`` instead of silently computing
    convolutions over mis-ordered axes. Registered via
    analysis/passes.py; the ``layout-mismatch`` code is documented in
    diagnostics.CODES."""

    name = "layout-verify"
    cheap = False

    def run(self, ctx):
        from .diagnostics import Diagnostic, ERROR
        program = ctx.program
        gb = program.global_block()
        infer = ctx.infer
        diags = []
        layout = {}

        def rank(name):
            info = infer.info(0, name)
            return None if info.shape is None else len(info.shape)

        for name, v in gb.vars.items():
            if (v.is_data or v.persistable
                    or isinstance(v, framework.Parameter)) \
                    and rank(name) == 4:
                layout[name] = NCHW

        for i, op in enumerate(gb.ops):
            t = op.type
            perm = axis_permutation(op)
            if t in ("transpose", "transpose2"):
                src = op.input("X")
                cur = layout.get(src[0]) if src else None
                out = op.output("Out")
                if out:
                    layout.pop(out[0], None)
                if isinstance(perm, tuple) and cur in (NCHW, NHWC) \
                        and out:
                    if perm == NCHW_TO_NHWC and cur == NCHW:
                        layout[out[0]] = NHWC
                    elif perm == NHWC_TO_NCHW and cur == NHWC:
                        layout[out[0]] = NCHW
                    elif perm == (0, 1, 2, 3):
                        layout[out[0]] = cur
                continue
            if t in SENSITIVE_OPS:
                in_slot, out_slot, fmt_attr = SENSITIVE_OPS[t]
                fmt = op.attrs.get(fmt_attr,
                                   op.attrs.get("data_layout", "NCHW"))
                ins = op.input(in_slot)
                cur = layout.get(ins[0]) if ins else None
                if cur in (NCHW, NHWC) and fmt in (NCHW, NHWC) \
                        and cur != fmt:
                    diags.append(Diagnostic(
                        ERROR, "layout-mismatch",
                        f"op {t!r} declares {fmt_attr}={fmt!r} but its "
                        f"input {ins[0]!r} carries layout {cur}",
                        op_idx=i, block_idx=0,
                        hint="insert a transpose2 at the layout "
                             "frontier or fix the op's format attr — "
                             "the layout pass (passes=('layout',...)) "
                             "does both automatically"))
                for ns in op.outputs.values():
                    for n in ns:
                        if rank(n) != 4:
                            continue
                        if fmt in (NCHW, NHWC):
                            layout[n] = fmt
                        else:
                            layout.pop(n, None)
                continue
            transparent = (t in _TRANSPARENT_UNARY
                           or t in _TRANSPARENT_BINARY
                           or t in ("sum", "fused_elementwise",
                                    "dropout", "pad2d"))
            if transparent:
                ins4 = [n for ns in op.inputs.values() for n in ns
                        if layout.get(n) in (NCHW, NHWC)]
                lays = {layout[n] for n in ins4}
                if len(lays) == 2:
                    detail = ", ".join(f"{n}: {layout[n]}"
                                       for n in ins4[:4])
                    diags.append(Diagnostic(
                        ERROR, "layout-mismatch",
                        f"op {t!r} mixes NCHW and NHWC operands "
                        f"({detail}) — elementwise math over "
                        "mis-ordered axes",
                        op_idx=i, block_idx=0,
                        hint="transpose one operand to the other's "
                             "layout at the frontier"))
                    continue
                out_lay = lays.pop() if lays else None
                for ns in op.outputs.values():
                    for n in ns:
                        if rank(n) != 4:
                            continue
                        if out_lay:
                            layout[n] = out_lay
                        else:
                            layout.pop(n, None)
                continue
            # unknown/opaque op: its 4-D outputs' layout is unknown
            for ns in op.outputs.values():
                for n in ns:
                    layout.pop(n, None)
        return diags
