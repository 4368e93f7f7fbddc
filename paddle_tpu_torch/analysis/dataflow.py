"""Dataflow analysis over the Program IR — def-use chains, effect
summaries, and a liveness solver (port of
``paddle_tpu/analysis/dataflow.py``, unchanged in substance).

The reference's memory_optimization_transpiler (reference
python/paddle/fluid/transpiler/memory_optimization_transpiler.py,
ControlFlowGraph class) computes per-op live-in/live-out sets to reuse
buffers in place; the same dataflow facts drive which ops are provably
dead (optimize.py) and whether a write can ever be observed (verify.py
dead-write / fetch-of-dead-var passes).

Like the rest of analysis/, this module never imports torch — every
fact is computed from the IR alone.

Vocabulary
----------
* ``op_effects(op)`` — one op's read/write/in-place summary. Reads are
  conservative: slot inputs, everything read inside control-flow
  sub-blocks, and any string(-list) attr that names variables (the
  while op's ``condition``/``carry_names`` convention). Writes are the
  declared outputs (plus ``<p>@GRAD`` for the backward marker);
  sub-block writes do NOT escape (lowering evaluates bodies in a child
  Env), so they are not part of the parent op's write set.
* ``def_use(program)`` — per-block def-use chains keyed by
  ``(block_idx, name)``.
* ``live_sets(block, live_out)`` — the backward liveness solve; the
  forward half (reaching-definition versions for value numbering) is
  ``def_versions``.
* ``removable_ops(program, fetch_names)`` — the DCE core: ops whose
  removal provably cannot change any fetch output, any persistable
  flowing back to the scope, or the rng stream of stateful ops.
"""
from ..core import framework

__all__ = ["OpEffects", "op_effects", "attr_name_refs", "DefUse",
           "def_use", "def_versions", "live_sets", "program_liveness",
           "removable_ops", "pinned_names", "axis_permutation",
           "BARRIER_OPS"]

# ops whose execution is an observable effect regardless of dataflow:
# the autodiff marker restructures lowering, print emits host output.
BARRIER_OPS = frozenset(["backward", "print"])


def _is_stateful(op_type):
    """Whether the op's lowering rule draws from the per-step rng
    stream (ctx.next_key: draws are keyed by their count). Removing or merging a stateful op would
    shift the key indices of every later stateful op — numerics of
    surviving dropout/random ops would silently change — so dataflow
    consumers treat statefulness as an observable effect. Unknown op
    types are assumed stateful (conservative)."""
    from ..core import registry
    if registry.has_op(op_type):
        return registry.get_op(op_type).stateful
    return True


def attr_name_refs(op):
    """Variable names referenced through attrs rather than input slots:
    plain string attrs (while's ``condition``) and homogeneous string
    lists (``carry_names``, scan's ``x_names``...). Over-approximates —
    a string attr that is not a variable name (an activation label, a
    message) rides along harmlessly, since consumers only use this to
    KEEP values alive, never to prove deadness."""
    refs = set()
    for k, v in op.attrs.items():
        if isinstance(v, str):
            refs.add(v)
        elif isinstance(v, (list, tuple)) and v \
                and all(isinstance(s, str) for s in v):
            refs.update(v)
    return refs


def _sub_block_reads(op, acc):
    """Names read by ops inside ``op``'s sub-blocks (recursively),
    including the sub-ops' own attr refs."""
    for v in op.attrs.values():
        if isinstance(v, framework.Block):
            for sub_op in v.ops:
                for ns in sub_op.inputs.values():
                    acc.update(ns)
                acc |= attr_name_refs(sub_op)
                _sub_block_reads(sub_op, acc)


class OpEffects:
    """One op's dataflow summary.

    reads       names whose values the op consumes (conservative)
    writes      names the op binds in ITS block's env
    inplace     reads ∩ writes — read-modify-write (optimizer updates:
                ParamOut aliases Param)
    stateful    consumes the rng stream (order-sensitive)
    barrier     observable beyond dataflow (backward/print, sub-block
                control flow, output-less ops) — never removable
    has_subblock  carries control-flow bodies
    """

    __slots__ = ("reads", "writes", "inplace", "stateful", "barrier",
                 "has_subblock")

    def __init__(self, reads, writes, inplace, stateful, barrier,
                 has_subblock):
        self.reads = reads
        self.writes = writes
        self.inplace = inplace
        self.stateful = stateful
        self.barrier = barrier
        self.has_subblock = has_subblock

    def __repr__(self):
        flags = "".join(f for f, on in
                        (("S", self.stateful), ("B", self.barrier))
                        if on)
        return (f"OpEffects(reads={sorted(self.reads)}, "
                f"writes={sorted(self.writes)}{flags and ' ' + flags})")


def op_effects(op):
    """Computes the :class:`OpEffects` summary for one op."""
    reads = set()
    for ns in op.inputs.values():
        reads.update(ns)
    reads |= attr_name_refs(op)
    _sub_block_reads(op, reads)
    writes = {n for ns in op.outputs.values() for n in ns}
    has_subblock = any(isinstance(v, framework.Block)
                       for v in op.attrs.values())
    if op.type == "backward":
        for p in op.attr("parameter_names") or []:
            writes.add(framework.grad_var_name(p))
    barrier = op.type in BARRIER_OPS or has_subblock or not writes
    return OpEffects(reads, writes, reads & writes,
                     _is_stateful(op.type), barrier, has_subblock)


def pinned_names(block):
    """Names that must keep their bindings: anything referenced from a
    string(-list) attr or read/written inside a control-flow sub-block.
    Rewriting those would require rewriting sub-block bodies and
    binding lists — out of scope for a provably-safe rewrite, so the
    mutating passes (optimize.py fusion/CSE, layout.py conversion)
    all refuse them."""
    pinned = set()
    for op in block.ops:
        pinned |= attr_name_refs(op)
        for v in op.attrs.values():
            if isinstance(v, framework.Block):
                _collect_block_names(v, pinned)
    return pinned


def _collect_block_names(block, acc):
    for op in block.ops:
        for ns in op.inputs.values():
            acc.update(ns)
        for ns in op.outputs.values():
            acc.update(ns)
        acc |= attr_name_refs(op)
        for v in op.attrs.values():
            if isinstance(v, framework.Block):
                _collect_block_names(v, acc)


def axis_permutation(op):
    """The axis permutation ``op`` applies to its activation value, as
    an effect summary for layout analysis (analysis/layout.py): a
    tuple ``perm`` with ``out[i] = in[perm[i]]`` for transpose ops,
    ``None`` for ops that apply no explicit permutation of their own
    (elementwise and most compute ops — whether they are layout-
    transparent is the consumer's call), and ``False`` for ops that
    collapse or reorder dims in a non-permutation way (the reshape /
    flatten family; unknown op types are assumed order-destroying —
    conservative, like the stateful default)."""
    if op.type in ("transpose", "transpose2"):
        perm = op.attr("axis")
        if isinstance(perm, (list, tuple)) and perm:
            return tuple(int(p) for p in perm)
        return False
    if op.type in ("reshape", "reshape2", "flatten", "flatten2",
                   "squeeze", "squeeze2", "unsqueeze", "unsqueeze2"):
        return False
    from ..core import registry
    if registry.has_op(op.type):
        return None
    return False


# ---------------------------------------------------------------------------
# def-use chains
# ---------------------------------------------------------------------------

class DefUse:
    """Per-block def-use chains.

    defs[(block_idx, name)] — op indices (in that block) that write name
    uses[(block_idx, name)] — op indices that read name (conservative:
    attr refs and sub-block reads count as reads AT the parent op)
    """

    def __init__(self):
        self.defs = {}
        self.uses = {}

    def def_sites(self, block_idx, name):
        return self.defs.get((block_idx, name), [])

    def use_sites(self, block_idx, name):
        return self.uses.get((block_idx, name), [])

    def def_count(self, block_idx, name):
        return len(self.def_sites(block_idx, name))

    def single_def(self, block_idx, name):
        return self.def_count(block_idx, name) == 1


def def_use(program):
    """Builds :class:`DefUse` chains for every block of ``program``."""
    du = DefUse()
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            eff = op_effects(op)
            for n in eff.reads:
                du.uses.setdefault((block.idx, n), []).append(i)
            for n in eff.writes:
                du.defs.setdefault((block.idx, n), []).append(i)
    return du


def def_versions(block, seed_names=()):
    """Forward reaching-definition versions for value numbering: returns
    a list, one dict per op, mapping each input name to the number of
    prior writes to it in this block (0 = the seed binding). Two reads
    of the same (name, version) provably see the same value."""
    ver = {n: 0 for n in seed_names}
    out = []
    for op in block.ops:
        eff = op_effects(op)
        out.append({n: ver.get(n, 0) for n in eff.reads})
        for n in eff.writes:
            ver[n] = ver.get(n, 0) + 1
    return out


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------

def live_sets(block, live_out):
    """Backward liveness over one block's straight-line op list.

    ``live_out`` is the set of names observed after the block (fetch
    targets, written persistables). Returns ``(live_before, live_after)``
    — two lists of frozensets, one entry per op. The standard transfer
    function: live_before = (live_after - writes) | reads; in-place ops
    (reads ∩ writes) stay correct because reads are added back."""
    n = len(block.ops)
    before = [None] * n
    after = [None] * n
    live = set(live_out)
    for i in range(n - 1, -1, -1):
        eff = op_effects(block.ops[i])
        after[i] = frozenset(live)
        live = (live - eff.writes) | eff.reads
        before[i] = frozenset(live)
    return before, after


class ProgramLiveness:
    """Liveness facts for a program's global block.

    live_before/live_after — per-op frozensets
    live_out — the observed-after-program seed set
    backward_idx — the autodiff marker's op index (None if absent)
    residual_names — names live ACROSS the backward marker (the
    fwd→bwd activation residuals the remat policy trades against HBM)
    """

    def __init__(self, live_before, live_after, live_out, backward_idx):
        self.live_before = live_before
        self.live_after = live_after
        self.live_out = live_out
        self.backward_idx = backward_idx

    @property
    def residual_names(self):
        if self.backward_idx is None:
            return frozenset()
        return self.live_before[self.backward_idx]


def program_liveness(program, fetch_names=None):
    """Solves liveness for the global block. The observed-after set is
    the fetch targets plus every persistable the program writes (those
    flow back to the Scope after dispatch — core/executor.py).

    The backward marker is modeled as READING every name the forward
    segment writes: autograd holds forward activations as fwd→bwd
    residuals (the default everything-saveable behavior),
    so at the marker they are genuinely resident even though no later
    op names them. That makes ``residual_names`` the static estimate
    of what remat policies trade against HBM."""
    gb = program.global_block()
    persist = {n for n, v in gb.vars.items() if v.persistable}
    written = set()
    bwd_idx = None
    for i, op in enumerate(gb.ops):
        if op.type == "backward" and bwd_idx is None:
            bwd_idx = i
        written |= op_effects(op).writes
    live_out = set(fetch_names or ()) | (persist & written)

    fwd_written = set()
    if bwd_idx is not None:
        for op in gb.ops[:bwd_idx]:
            fwd_written |= op_effects(op).writes

    n = len(gb.ops)
    before = [None] * n
    after = [None] * n
    live = set(live_out)
    for i in range(n - 1, -1, -1):
        eff = op_effects(gb.ops[i])
        after[i] = frozenset(live)
        reads = eff.reads | fwd_written if i == bwd_idx else eff.reads
        live = (live - eff.writes) | reads
        before[i] = frozenset(live)
    return ProgramLiveness(before, after, live_out, bwd_idx)


# ---------------------------------------------------------------------------
# dead-op computation (the DCE core)
# ---------------------------------------------------------------------------

def removable_ops(program, fetch_names):
    """Op indices (global block) whose removal provably preserves every
    fetch output and every scope write.

    An op is kept when any of these hold:
      * it is a barrier (backward/print, has sub-blocks, no outputs);
      * it is stateful (removing it would shift the rng stream of every
        later stateful op — surviving numerics would change);
      * it writes a persistable (the value flows back to the Scope);
      * it writes a data variable (a deliberate feed shadow — flagged
        by the donation-alias lint, but removal would change what later
        readers see);
      * any of its outputs is live (transitively reaches a fetch or a
        kept op's reads).

    Requires the fetch contract: with ``fetch_names=None`` nothing can
    be proven dead (any name might be fetched at run time) and the
    result is empty.
    """
    if fetch_names is None:
        return []
    gb = program.global_block()
    persist = {n for n, v in gb.vars.items() if v.persistable}
    datas = {n for n, v in gb.vars.items() if v.is_data}
    live = set(fetch_names)
    dead = []
    for i in range(len(gb.ops) - 1, -1, -1):
        eff = op_effects(gb.ops[i])
        keep = (eff.barrier or eff.stateful
                or eff.writes & persist
                or eff.writes & datas
                or eff.writes & live)
        if keep:
            live = (live - eff.writes) | eff.reads
        else:
            dead.append(i)
    dead.reverse()
    return dead
