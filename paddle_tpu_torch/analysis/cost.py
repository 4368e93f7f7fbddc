"""Static per-op FLOPs/bytes cost model and liveness-based residency
estimate (port of ``paddle_tpu/analysis/cost.py``, a copy: a pure IR
analysis, so its numbers and choices are the reference's on the same
program).

``Executor.compiled_stats`` reports measured numbers — but it has to
RUN a step to get them. This module answers the same questions (where
do the FLOPs go, how much device memory does a step hold) from the IR
alone, in milliseconds, with the shape/dtype facts the no-trace
inference engine (infer.py) already computes. It runs no op.

Assumptions:
  * unknown (batch, -1) dims count as ``assume_batch`` (default 1) —
    costs scale linearly in batch, so relative rankings are
    batch-independent;
  * FLOPs: matmul-family 2·M·K·N, conv 2·out·Cin/groups·kh·kw, pools
    out·k², norms/softmax a small per-element constant, everything
    else 1 FLOP per output element (the conservative floor);
  * bytes: every op reads its inputs and writes its outputs once —
    fusion will beat this, so it is an upper bound per op, but the
    RANKING matches what bytes-bound steps care about;
  * peak residency: parameters/persistables are always resident
    (donated state), plus the liveness-maximal set of temporaries
    (dataflow.program_liveness) — sub-block internals excluded;
  * sub-block op costs count ONCE (static trip counts are unknowable);
    whole-loop totals are therefore a lower bound.

The remat recommendation replaces folklore with the static fact that
matters: WHICH op family's outputs dominate the fwd→bwd residual set.
"""
from .dataflow import op_effects, program_liveness, removable_ops
from ..core import framework

__all__ = ["OpCost", "CostReport", "program_cost",
           "recommend_remat_policy", "estimate_remat_residuals",
           "estimate_remat_policies", "DTYPE_BYTES"]

DTYPE_BYTES = {
    "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
    "int8": 1, "int16": 2, "int32": 4, "int64": 8, "uint8": 1,
    "bool": 1,
}

# op families the FLOPs model treats specially
MATMUL_OPS = {"mul", "matmul"}
CONV_OPS = {"conv2d", "depthwise_conv2d", "conv2d_transpose", "conv3d"}
# per-output-element FLOP constants for common nonlinear/norm ops
_ELEMENT_FLOPS = {
    "softmax": 5.0, "batch_norm": 8.0, "layer_norm": 8.0,
    "rms_norm": 6.0, "sigmoid": 4.0, "tanh": 4.0, "exp": 2.0,
    "cross_entropy": 6.0, "softmax_with_cross_entropy": 8.0,
    "dropout": 2.0, "gelu": 8.0, "swish": 6.0,
}


def _numel(shape, assume_batch):
    if shape is None:
        return None
    n = 1
    for d in shape:
        n *= assume_batch if d < 0 else d
    return n


def _info_bytes(info, assume_batch):
    """Bytes of one VarInfo; None when shape or dtype is unknown."""
    n = _numel(info.shape, assume_batch)
    if n is None:
        return None
    return n * DTYPE_BYTES.get(info.dtype or "float32", 4)


class OpCost:
    """Static cost of one op instance."""

    __slots__ = ("op_type", "block_idx", "op_idx", "outputs", "flops",
                 "bytes")

    def __init__(self, op_type, block_idx, op_idx, outputs, flops,
                 bytes_):
        self.op_type = op_type
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.outputs = outputs
        self.flops = flops
        self.bytes = bytes_

    def to_dict(self):
        return {"op_type": self.op_type, "block_idx": self.block_idx,
                "op_idx": self.op_idx, "outputs": self.outputs,
                "flops": self.flops, "bytes": self.bytes}

    def __repr__(self):
        return (f"OpCost({self.op_type} b{self.block_idx}#{self.op_idx}"
                f" flops={self.flops:.3g} bytes={self.bytes:.3g})")


def _op_flops(op, slot_infos, out_infos, assume_batch):
    """FLOPs for one op from its inferred input/output shapes.
    ``slot_infos`` maps input slot name → [VarInfo]."""
    out_elems = sum(_numel(i.shape, assume_batch) or 0
                    for i in out_infos)

    def _slot_shape(*slots):
        for s in slots:
            infos = slot_infos.get(s)
            if infos and infos[0].shape is not None:
                return infos[0].shape
        return None

    if op.type in MATMUL_OPS:
        # 2 * (output elements) * contraction length; mul contracts
        # over Y's leading dim, matmul over X's trailing dim
        y = _slot_shape("Y")
        x = _slot_shape("X", "Input")
        k = None
        if op.type == "mul" and y:
            k = y[0]
        elif x:
            k = x[-1]
        if k is not None and k < 0:
            k = assume_batch
        if out_elems and k:
            return 2.0 * out_elems * k
        return 2.0 * out_elems
    if op.type in CONV_OPS:
        # filter shape (Cout, Cin/groups, kh, kw) carries the
        # per-output-element contraction size directly
        f = _slot_shape("Filter", "W")
        if out_elems and f and len(f) >= 2 and all(d > 0 for d in f[1:]):
            contraction = 1
            for d in f[1:]:
                contraction *= d
            return 2.0 * out_elems * contraction
        return 2.0 * out_elems
    if op.type in ("pool2d", "pool3d"):
        k = op.attr("pool_size", 2)
        k = k[0] if isinstance(k, (list, tuple)) else k
        return float(out_elems) * k * k
    if op.type in ("sum", "mean", "reduce_sum", "reduce_mean",
                   "reduce_max"):
        in_elems = sum(_numel(i.shape, assume_batch) or 0
                       for infos in slot_infos.values() for i in infos)
        return float(max(in_elems, out_elems))
    if op.type == "fused_elementwise":
        # one composed chain (analysis/optimize.py): the per-element
        # work is the sum of its steps'; the BYTES win (interior
        # tensors never touch HBM) falls out of the default
        # inputs+outputs accounting automatically
        steps = op.attr("steps") or []
        return float(sum(_ELEMENT_FLOPS.get(s.get("op"), 1.0)
                         for s in steps)) * out_elems
    return _ELEMENT_FLOPS.get(op.type, 1.0) * out_elems


class CostReport:
    """The static cost/residency summary ``program_cost`` builds."""

    def __init__(self, per_op, total_flops, total_bytes,
                 params_bytes, peak_residency_bytes,
                 residual_at_backward_bytes, n_unknown_shape_ops,
                 dead_op_count, recommended_remat_policy,
                 assume_batch):
        self.per_op = per_op
        self.total_flops = total_flops
        self.total_bytes = total_bytes
        self.params_bytes = params_bytes
        self.peak_residency_bytes = peak_residency_bytes
        self.residual_at_backward_bytes = residual_at_backward_bytes
        self.n_unknown_shape_ops = n_unknown_shape_ops
        self.dead_op_count = dead_op_count
        self.recommended_remat_policy = recommended_remat_policy
        self.assume_batch = assume_batch

    def top_ops(self, k=10, by="flops"):
        key = (lambda c: c.flops) if by == "flops" else \
            (lambda c: c.bytes)
        return sorted(self.per_op, key=key, reverse=True)[:k]

    def to_dict(self, top_k=10):
        return {
            "assumed_batch": self.assume_batch,
            "total_flops": self.total_flops,
            "total_bytes": self.total_bytes,
            "params_bytes": self.params_bytes,
            "peak_residency_bytes": self.peak_residency_bytes,
            "residual_at_backward_bytes":
                self.residual_at_backward_bytes,
            "n_ops": len(self.per_op),
            "n_unknown_shape_ops": self.n_unknown_shape_ops,
            "dead_op_count": self.dead_op_count,
            "recommended_remat_policy": self.recommended_remat_policy,
            "top_ops": [c.to_dict() for c in self.top_ops(top_k)],
        }


def program_cost(program, fetch_list=None, assume_batch=1,
                 infer_result=None):
    """Builds the :class:`CostReport` for ``program`` — per-op
    FLOPs/bytes for every op in every block, the liveness-based peak
    residency over the global block, the fwd→bwd residual estimate,
    the DCE-provable dead-op count (None without a fetch contract),
    and the static remat recommendation. Never traces or compiles."""
    from .infer import infer_program
    infer = infer_result or infer_program(program)
    fetch_names = [v.name if isinstance(v, framework.Variable) else v
                   for v in (fetch_list or [])] or None

    per_op = []
    n_unknown = 0
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            if op.type == "backward":
                continue
            slot_infos = {slot: [infer.info(block.idx, n) for n in ns]
                          for slot, ns in op.inputs.items()}
            out_infos = [infer.info(block.idx, n)
                         for ns in op.outputs.values() for n in ns]
            in_bytes = [_info_bytes(x, assume_batch)
                        for infos in slot_infos.values() for x in infos]
            out_bytes = [_info_bytes(x, assume_batch) for x in out_infos]
            if any(b is None for b in in_bytes + out_bytes):
                n_unknown += 1
            bytes_ = sum(b or 0 for b in in_bytes + out_bytes)
            flops = _op_flops(op, slot_infos, out_infos, assume_batch)
            per_op.append(OpCost(
                op.type, block.idx, i,
                [n for ns in op.outputs.values() for n in ns][:4],
                float(flops), float(bytes_)))

    gb = program.global_block()
    params_bytes = 0
    for n, v in gb.vars.items():
        if v.persistable and v.shape is not None:
            params_bytes += (_numel(v.shape, assume_batch) or 0) * \
                DTYPE_BYTES.get(v.dtype, 4)

    # liveness-based residency over the global block: at each program
    # point the resident temporaries are the live non-persistable names
    lv = program_liveness(program, fetch_names)
    persist = {n for n, v in gb.vars.items() if v.persistable}

    def _bytes_of(name):
        b = _info_bytes(infer.info(0, name), assume_batch)
        return b or 0

    peak = 0
    for i in range(len(gb.ops)):
        live = (lv.live_after[i] | op_effects(gb.ops[i]).writes) \
            - persist
        resident = sum(_bytes_of(n) for n in live)
        peak = max(peak, resident)
    residual = None
    if lv.backward_idx is not None:
        residual = sum(_bytes_of(n)
                       for n in lv.residual_names - persist)

    dead = None
    if fetch_names is not None:
        dead = len(removable_ops(program, fetch_names))

    return CostReport(
        per_op,
        total_flops=float(sum(c.flops for c in per_op)),
        total_bytes=float(sum(c.bytes for c in per_op)),
        params_bytes=params_bytes,
        peak_residency_bytes=params_bytes + peak,
        residual_at_backward_bytes=residual,
        n_unknown_shape_ops=n_unknown,
        dead_op_count=dead,
        recommended_remat_policy=recommend_remat_policy(
            program, infer_result=infer, assume_batch=assume_batch),
        assume_batch=assume_batch)


def estimate_remat_residuals(program, infer_result=None,
                             assume_batch=1):
    """Estimated fwd→bwd residual bytes per remat policy, from the
    liveness facts: which values live across the backward marker, and
    which op family produced each.

    Returns ``{policy_name: bytes}`` for 'everything_saveable' (the
    no-remat baseline: every residual held), 'dots_saveable' (matmul
    outputs held, the rest recomputed), 'save_conv_only' (conv outputs
    only), and 'nothing_saveable' (feeds/params only — everything
    recomputed). Empty when the program has no backward marker."""
    from .infer import infer_program
    infer = infer_result or infer_program(program)
    lv = program_liveness(program)
    if lv.backward_idx is None:
        return {}
    gb = program.global_block()
    persist = {n for n, v in gb.vars.items() if v.persistable}
    datas = {n for n, v in gb.vars.items() if v.is_data}
    producer = {}
    for op in gb.ops[:lv.backward_idx]:
        for ns in op.outputs.values():
            for n in ns:
                producer[n] = op.type

    def _bytes_of(name):
        b = _info_bytes(infer.info(0, name), assume_batch)
        return b or 0

    totals = {"everything_saveable": 0, "dots_saveable": 0,
              "save_conv_only": 0, "nothing_saveable": 0}
    for n in lv.residual_names:
        if n in persist or n in datas:
            continue  # resident regardless of policy
        b = _bytes_of(n)
        ptype = producer.get(n)
        totals["everything_saveable"] += b
        if ptype in MATMUL_OPS or ptype in CONV_OPS:
            totals["dots_saveable"] += b
        if ptype in CONV_OPS:
            totals["save_conv_only"] += b
    return totals


def estimate_remat_policies(program, infer_result=None, assume_batch=1,
                            fetch_list=None):
    """Full per-policy cost estimates for the remat decision: for each
    policy, the fwd→bwd residual bytes it HOLDS and the forward FLOPs
    it must RECOMPUTE in the backward (the FLOPs of every forward op
    whose residual output the policy discards — the checkpoint re-runs
    those ops inside the backward). Returns::

        {policy: {"residual_bytes": int, "recompute_flops": float}}

    plus a ``"__forward_flops__"`` entry (the whole forward segment's
    FLOPs, the denominator recompute overhead is judged against).
    Empty when the program has no backward marker. This is what
    :func:`recommend_remat_policy` now ranks on — the estimates, not a
    per-family heuristic table."""
    from .infer import infer_program
    infer = infer_result or infer_program(program)
    lv = program_liveness(program)
    if lv.backward_idx is None:
        return {}
    gb = program.global_block()
    persist = {n for n, v in gb.vars.items() if v.persistable}
    datas = {n for n, v in gb.vars.items() if v.is_data}

    def _bytes_of(name):
        b = _info_bytes(infer.info(0, name), assume_batch)
        return b or 0

    # per-op flops + the op type producing each forward value
    producer = {}
    op_flops = {}
    forward_flops = 0.0
    for i, op in enumerate(gb.ops[:lv.backward_idx]):
        slot_infos = {slot: [infer.info(0, n) for n in ns]
                      for slot, ns in op.inputs.items()}
        out_infos = [infer.info(0, n)
                     for ns in op.outputs.values() for n in ns]
        f = float(_op_flops(op, slot_infos, out_infos, assume_batch))
        op_flops[i] = f
        forward_flops += f
        for ns in op.outputs.values():
            for n in ns:
                producer[n] = (i, op.type)

    def _saved(policy, ptype):
        if policy == "everything_saveable":
            return True
        if policy == "dots_saveable":
            return ptype in MATMUL_OPS or ptype in CONV_OPS
        if policy == "save_conv_only":
            return ptype in CONV_OPS
        return False                       # nothing_saveable

    policies = ("everything_saveable", "dots_saveable",
                "save_conv_only", "nothing_saveable")
    out = {p: {"residual_bytes": 0, "recompute_flops": 0.0}
           for p in policies}
    for n in lv.residual_names:
        if n in persist or n in datas:
            continue                       # resident regardless
        prod = producer.get(n)
        if prod is None:
            continue
        i, ptype = prod
        b = _bytes_of(n)
        for p in policies:
            if _saved(p, ptype):
                out[p]["residual_bytes"] += b
            else:
                out[p]["recompute_flops"] += op_flops.get(i, 0.0)
    out["__forward_flops__"] = forward_flops
    return out


def _heuristic_remat_policy(residuals):
    """The pre-cost-model per-family table, kept as the tie-break:
    conv residuals substantial → 'save_conv_only', matmul-dominated →
    'dots_saveable', neither → 'nothing_saveable'."""
    conv_b = residuals["save_conv_only"]
    dot_b = residuals["dots_saveable"]
    if conv_b > 0 and conv_b * 2 >= dot_b:
        return "save_conv_only"
    if dot_b > 0:
        return "dots_saveable"
    return "nothing_saveable"


# recompute budget: a policy is viable when re-running its discarded
# forward ops in the backward costs at most this fraction of the whole
# forward segment's FLOPs. 0.5 keeps the worst case under one extra
# half-forward per step.
_REMAT_RECOMPUTE_BUDGET = 0.5


def recommend_remat_policy(program, infer_result=None, assume_batch=1):
    """Static remat recommendation, ranked on the cost model's
    per-policy estimates (:func:`estimate_remat_policies`): take the
    most restrictive policy — least residual bytes held — whose
    recompute overhead fits the budget (≤ half the forward FLOPs
    re-run in the backward). The policies are nested
    (nothing ⊆ save_conv_only ⊆ dots_saveable ⊆ everything), so
    "least residual bytes subject to the budget" is simply the first
    viable entry of that order; 'everything_saveable' (zero recompute)
    is always viable.

    The old per-family heuristic table survives as the TIE-BREAK: when
    its answer holds the same estimated residual bytes as the
    cost-model pick (e.g. a conv-free net where 'save_conv_only' and
    'nothing_saveable' are the same set), the table's answer wins —
    stable recommendations across the upgrade except where the
    estimates actually disagree (covered by tests/test_torch_layout.py).

    * no backward marker → None (inference: nothing to remat).
    """
    estimates = estimate_remat_policies(program, infer_result,
                                        assume_batch)
    if not estimates:
        return None
    fwd = estimates.pop("__forward_flops__")
    budget = _REMAT_RECOMPUTE_BUDGET * fwd
    order = ("nothing_saveable", "save_conv_only", "dots_saveable",
             "everything_saveable")
    pick = next(p for p in order
                if estimates[p]["recompute_flops"] <= budget)
    residuals = {p: estimates[p]["residual_bytes"] for p in order}
    heuristic = _heuristic_remat_policy(residuals)
    if residuals[heuristic] == residuals[pick] \
            and estimates[heuristic]["recompute_flops"] <= budget:
        return heuristic
    return pick
