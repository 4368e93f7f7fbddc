"""Memory-usage estimation (port of
``paddle_tpu/contrib/memory_usage_calc.py``; reference
python/paddle/fluid/contrib/memory_usage_calc.py:46 memory_usage).

Two forms: the reference's shape-walk estimate (``memory_usage``, a
copy: every block variable's numel × dtype size, batch dims resolved,
+5–10% slack) and ``compiled_memory_usage``, which runs one step and
reads what it held.
"""
import contextlib

from ..core import framework

__all__ = ["memory_usage", "compiled_memory_usage"]

_DTYPE_SIZE = {
    "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
    "int8": 1, "uint8": 1, "int16": 2, "int32": 4, "int64": 8,
    "bool": 1,
}


def memory_usage(program, batch_size):
    """Estimated (min, max, unit) activation+parameter footprint of one
    iteration, from variable shapes alone. -1 dims count as
    ``batch_size``."""
    if not isinstance(program, framework.Program):
        raise TypeError(
            "Calculating Memory Usage requires Program as its Parameter."
            f"But you passed in {type(program)}")
    if batch_size <= 0:
        raise ValueError("The batch size need to be positive.")

    # every block variable counts: parameters, feeds, op outputs (the
    # reference walks only op outputs, which misses params and feeds in
    # forward-only programs — here the docstring's promise holds)
    gb = program.global_block()
    total = 0.0
    for name, var in gb.vars.items():
        if var.shape is None:
            continue
        count = 1
        neg = 0
        for x in var.shape:
            if x < 0:
                neg += 1
                if neg > 1:
                    raise ValueError(
                        f"Var {name} has more than one negative dim.")
                count *= batch_size * (-x)
            else:
                count *= x
        total += count * _DTYPE_SIZE.get(str(var.dtype), 4)

    unit = "B"
    if total > 1024:
        total, unit = total / 1024, "KB"
        if total > 1024:
            total, unit = total / 1024, "MB"
    return total * 1.05, total * 1.1, unit


def _nbytes(values):
    """Bytes of the tensors in ``values`` (a SequenceBatch counts its
    leaves)."""
    import torch
    total = 0
    for v in values:
        leaves = [v] if isinstance(v, torch.Tensor) else \
            [getattr(v, k) for k in ("data", "lengths", "outer_counts")
             if getattr(v, k, None) is not None]
        total += sum(t.numel() * t.element_size() for t in leaves)
    return total


def compiled_memory_usage(program, feed_shapes, mode="train",
                          fetch_list=None, scope=None, place=None):
    """Per-step memory of one measured step, under the reference's keys.

    The reference compiles the step and reads XLA's memory analysis of
    the executable. Eager torch has no compiled module, so this runs
    the step once — on ``place`` (default: the process's default place,
    the card) over a copy of ``scope``'s state (default: the global
    scope; a persistable it lacks is made as zeros of its declared
    shape) and zero feeds of ``feed_shapes`` (name -> (shape tuple,
    dtype str)) — through ``core.executor.compiled_cost_stats``, and
    counts:

    - ``argument_bytes``: the state the step reads plus the feeds;
    - ``output_bytes``: the fetches plus the state the step writes;
    - ``temp_bytes``: the allocator's peak over the step less the
      arguments, on the card; None on the host, where torch keeps no
      allocator statistics;
    - ``generated_code_bytes``: 0, since there is no compiled module.

    The caller's scope, program and executors are left as they were.
    """
    import torch
    from ..core.executor import Executor, Scope, compiled_cost_stats, \
        global_scope
    from ..core.lowering import lower_program

    scope = scope or global_scope()
    exe = Executor(place)
    dev = exe.device
    gb = program.global_block()
    fetch_names = [v.name if isinstance(v, framework.Variable) else v
                   for v in (fetch_list or [])]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        resident = torch.cuda.memory_allocated(dev)
    # the step's own copy of the state: a step donates what it writes
    shadow = Scope()
    for n, var in gb.vars.items():
        if not var.persistable:
            continue
        val = scope.find_var(n)
        if val is None:
            if var.shape is None or any(d < 0 for d in var.shape):
                continue
            val = torch.zeros(tuple(var.shape),
                              dtype=framework.torch_dtype(var.dtype))
        shadow.set(n, val.detach().to(dev).clone()
                   if isinstance(val, torch.Tensor) else val)
    feed = {k: torch.zeros(tuple(s), dtype=framework.torch_dtype(d),
                           device=dev)
            for k, (s, d) in feed_shapes.items()}
    _, mode, state, feed_vals = exe._prepare(program, feed, fetch_names,
                                             shadow, mode)
    step_fn = lower_program(program, fetch_names, mode)
    out = {}

    def step():
        grad = contextlib.nullcontext() if step_fn.trains \
            else torch.no_grad()
        with grad:
            out["state"], out["fetches"] = step_fn(
                state, feed_vals, dev, program.random_seed or 0, 1)

    stats = compiled_cost_stats(step, dev, top_k=0)
    argument_bytes = _nbytes(state.values()) + _nbytes(feed_vals.values())
    output_bytes = _nbytes(out["fetches"]) + _nbytes(
        out["state"].values())
    temp_bytes = None
    if cuda:
        temp_bytes = max(0, stats["peak_memory_bytes"] - resident
                         - argument_bytes)
    return {"argument_bytes": argument_bytes, "output_bytes": output_bytes,
            "temp_bytes": temp_bytes, "generated_code_bytes": 0}

