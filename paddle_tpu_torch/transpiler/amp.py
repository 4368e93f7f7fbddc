"""Automatic mixed precision — bf16 products, f32 master state (port of
``paddle_tpu/transpiler/amp.py``).

Parameters, optimizer state and the program's dtype annotations stay
float32. As each op runs, the matmul-shaped ones
(``core/amp_policy.AMP_MATMUL_OPS``) cast their float32 operands to
bfloat16 and, under O1, their results back (``core/lowering.py``): the
products take the card's bf16 rate — the attention kernels' bf16 route
among them — while softmax, normalisation and loss math keep float32.
bf16 keeps float32's exponent range, so no loss scaling is needed.
"""

__all__ = ["amp_transpile", "decorate_amp"]


def amp_transpile(program, enable=True, level="O1"):
    """Mark ``program`` so matmul-shaped ops run in bf16. Idempotent;
    bumps the program version so cached step functions rebuild.

    level="O1" (default): the products compute bf16, every activation
    between ops stays f32. level="O2": activations flow bf16 through the
    matmul ops and ``core/amp_policy.AMP_BF16_FLOW_OPS``; any other op
    upcasts its inputs to f32."""
    if level not in ("O1", "O2"):
        raise ValueError(f"amp level must be 'O1' or 'O2', got {level!r}")
    # _amp is False | "O1" | "O2" (any truthy value is amp on, and only
    # "O2" the flow mode, so a legacy True means O1)
    program._amp = level if enable else False
    program._bump()
    return program


def decorate_amp(optimizer):
    """Optimizer wrapper for API symmetry with later fluid AMP
    decorators: marks the program at minimize() time."""
    orig_minimize = optimizer.minimize

    def minimize(loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        amp_transpile(loss.block.program)
        return orig_minimize(loss, startup_program=startup_program,
                             parameter_list=parameter_list,
                             no_grad_set=no_grad_set)

    optimizer.minimize = minimize
    return optimizer
