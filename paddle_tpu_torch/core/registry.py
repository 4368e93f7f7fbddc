"""Operator registry: op type → torch lowering rule.

Port of ``paddle_tpu/core/registry.py``. A lowering rule keeps the
reference's signature::

    def rule(ctx, ins, attrs) -> {slot: [torch.Tensor, ...]}

where ``ins`` maps input slot names to lists of tensors on the
executor's device and ``ctx`` is the LoweringContext (device, rng, mode).
The static infer and numerics registries of the reference arrive with
the analysis package.
"""
import torch

__all__ = ["register_op", "get_op", "has_op", "registered_ops",
           "canonical_int"]

_REGISTRY = {}


def canonical_int():
    """The integer dtype ops emit where the reference kernels emit
    int64. The reference asks JAX (int32 unless x64 is on); torch
    indexes with int64 natively, so the port always uses it. Tests
    compare integer outputs by value, not by width."""
    return torch.int64


class OpDef:
    __slots__ = ("type", "lower", "stateful")

    def __init__(self, type, lower, stateful=False):
        self.type = type
        self.lower = lower
        self.stateful = stateful   # uses rng (dropout, random init ops)


def register_op(type, stateful=False):
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
        _REGISTRY[type] = OpDef(type, fn, stateful)
        return fn
    return deco


def get_op(type):
    try:
        return _REGISTRY[type]
    except KeyError:
        raise NotImplementedError(
            f"no lowering rule registered for op {type!r} in the torch "
            f"port; ported ops: {sorted(_REGISTRY)}") from None


def has_op(type):
    return type in _REGISTRY


def registered_ops():
    return sorted(_REGISTRY)
