"""Operator registry: op type → torch lowering rule.

Port of ``paddle_tpu/core/registry.py``. A lowering rule keeps the
reference's signature::

    def rule(ctx, ins, attrs) -> {slot: [torch.Tensor, ...]}

where ``ins`` maps input slot names to lists of tensors on the
executor's device and ``ctx`` is the LoweringContext (device, rng, mode).

Beside it, as in the reference, the two static registries the analysis
package reads: an op's infer rule (shapes and dtypes,
``analysis/infer.py``) and its numerics rule (value ranges,
``analysis/numcheck.py``). Both are pure Python over the IR: they never
touch a tensor.
"""
import torch

__all__ = ["register_op", "get_op", "has_op", "registered_ops",
           "registered_op_types", "register_infer", "get_infer",
           "has_infer", "registered_infer_types", "register_numerics",
           "get_numerics", "has_numerics", "registered_numerics_types",
           "canonical_int", "draws_rng", "WAITING"]

_REGISTRY = {}

# op type → static shape/dtype inference rule (analysis/infer.py engine),
# kept beside the lowering registry so an op's halves — how it computes
# and what it computes — register in the same place (reference
# paddle/fluid/framework/shape_inference.h). Rules MUST NOT touch a
# tensor or a device: the verifier runs before anything is lowered.
_INFER = {}

# op type → numerics transfer function (analysis/numcheck.py engine):
# how an op's value RANGES behave. Same colocation and purity rule.
_NUMERICS = {}

# The reference's op types the port does not register yet, by the
# ROADMAP.md item (section 1) that ports them; ``get_op`` names it.
_ITEMS = {
    "Remaining op families and the zoo": (
        # ops/nn.py
        "hierarchical_sigmoid", "nce",
        # detection.py, eval_ops.py, extras.py
        "iou_similarity", "box_coder", "prior_box", "bipartite_match",
        "target_assign", "multiclass_nms", "polygon_box_transform",
        "ssd_loss", "anchor_generator", "rpn_target_assign",
        "generate_proposals", "generate_proposal_labels",
        "detection_map",
        "minus", "modified_huber_loss", "pad_constant_like", "conv_shift",
        "max_pool2d_with_index", "unpool", "spp", "positive_negative_pair",
        "precision_recall", "fake_quantize_abs_max",
        "fake_dequantize_max_abs", "weight_norm", "weight_norm_g_init"),
}
#: op type -> the ROADMAP.md item that ports it
WAITING = {op: item for item, ops in _ITEMS.items() for op in ops}


def canonical_int():
    """The integer dtype ops emit where the reference kernels emit
    int64. The reference asks JAX (int32 unless x64 is on); torch
    indexes with int64 natively, so the port always uses it. Tests
    compare integer outputs by value, not by width."""
    return torch.int64


class OpDef:
    __slots__ = ("type", "lower", "stateful", "seq_aware")

    def __init__(self, type, lower, stateful=False, seq_aware=False):
        self.type = type
        self.lower = lower
        self.stateful = stateful   # uses rng (dropout, random init ops)
        # seq_aware ops take SequenceBatch values as they are; the
        # lowering hands every other op the padded data and rewraps its
        # outputs whose variables have lod_level > 0
        self.seq_aware = seq_aware


# stateful ops whose draws depend on their temperature: greedy (<= 0)
# generation takes the argmax and draws nothing
_SAMPLES_IFF_TEMPERATURE = ("llama_generate", "llama_spec_generate")


def draws_rng(op):
    """Whether ``op`` draws random numbers in a test-mode step: a
    ``stateful`` op, but dropout (the identity, or a scale, at test time)
    and greedy generation (reference ``io/aot.py``'s exemptions)."""
    od = _REGISTRY.get(op.type)
    if od is None or not od.stateful or op.type == "dropout":
        return False
    if op.type in _SAMPLES_IFF_TEMPERATURE:
        return float(op.attrs.get("temperature") or 0.0) > 0.0
    return True


def register_op(type, stateful=False, seq_aware=False):
    """Decorator: register a lowering rule for ``type``.

    A second registration for the same type is rejected loudly — a
    silent shadow would let a later import replace the lowering of an
    op with whatever module happened to load last, and the mis-wiring
    would only surface as wrong numerics."""
    def deco(fn):
        if type in _REGISTRY:
            raise ValueError(
                f"op {type!r} registered twice (existing rule: "
                f"{_REGISTRY[type].lower.__module__}."
                f"{_REGISTRY[type].lower.__qualname__})")
        _REGISTRY[type] = OpDef(type, fn, stateful, seq_aware)
        return fn
    return deco


def get_op(type):
    try:
        return _REGISTRY[type]
    except KeyError:
        if type in WAITING:
            raise NotImplementedError(
                f"no lowering rule registered for op {type!r} in the torch "
                f"port yet: it is ported with ROADMAP.md item "
                f"'{WAITING[type]}'") from None
        raise NotImplementedError(
            f"no lowering rule registered for op {type!r} in the torch "
            f"port; ported ops: {sorted(_REGISTRY)}") from None


def has_op(type):
    return type in _REGISTRY


def registered_ops():
    return sorted(_REGISTRY)


def registered_op_types():
    """All op types with a lowering rule — the analysis-visible surface
    (analysis/verify.py checks programs against it)."""
    return sorted(_REGISTRY)


def register_infer(type):
    """Decorator: register a static shape/dtype inference rule for
    ``type``. Signature::

        def rule(op, ins, attrs) -> {slot: [VarInfo, ...]} | None

    where ``ins`` maps input slot names to lists of
    ``analysis.infer.VarInfo`` and returning None means "unknown" (the
    conservative lattice bottom). Rules may raise
    ``analysis.infer.InferError`` to report a statically-provable
    shape/dtype contradiction."""
    def deco(fn):
        if type in _INFER:
            raise ValueError(
                f"infer rule for op {type!r} registered twice (existing: "
                f"{_INFER[type].__module__}.{_INFER[type].__qualname__})")
        _INFER[type] = fn
        return fn
    return deco


def get_infer(type):
    """The registered inference rule for ``type``, or None (unknown)."""
    return _INFER.get(type)


def has_infer(type):
    return type in _INFER


def registered_infer_types():
    """All op types with a static infer rule: an op with a lowering rule
    but none is a blind spot for every shape/dtype pass
    (analysis/verify.py InferCoveragePass)."""
    return sorted(_INFER)


def register_numerics(type):
    """Decorator: register a numerics transfer function for ``type``
    (the abstract interpreter in analysis/numcheck.py). Signature::

        def rule(op, ins, attrs) -> {slot: [NumInfo, ...]} | None

    where ``ins`` maps input slot names to lists of
    ``analysis.numcheck.NumInfo`` (value-range interval + provable
    finiteness, with the inferred shape along for reduction-size
    scaling) and returning None means "unknown" — the engine joins the
    outputs to the conservative top element."""
    def deco(fn):
        if type in _NUMERICS:
            raise ValueError(
                f"numerics rule for op {type!r} registered twice "
                f"(existing: {_NUMERICS[type].__module__}."
                f"{_NUMERICS[type].__qualname__})")
        _NUMERICS[type] = fn
        return fn
    return deco


def get_numerics(type):
    """The registered numerics transfer function for ``type``, or None
    (unknown — numcheck joins to top)."""
    return _NUMERICS.get(type)


def has_numerics(type):
    return type in _NUMERICS


def registered_numerics_types():
    """All op types with a numerics transfer function — the surface
    numcheck can see through."""
    return sorted(_NUMERICS)
