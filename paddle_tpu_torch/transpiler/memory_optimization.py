"""Memory-optimisation transpiler: rematerialisation (port of
``paddle_tpu/transpiler/memory_optimization.py``).

``memory_optimize(program, policy=...)`` sets the program's remat
policy; the lowering runs the forward segment of a train step under
non-reentrant ``torch.utils.checkpoint``, so activations are recomputed
in the backward pass instead of held. The policy names are the
reference's jax.checkpoint names; ``core/lowering.py``
``REMAT_POLICIES`` gives each its torch form:

- ``"nothing_saveable"``: a plain checkpoint (recompute everything);
- ``"dots_saveable"`` (the default; alias ``"checkpoint_dots"``):
  selective checkpointing that saves the outputs of ``aten.mm``,
  ``aten.addmm`` and ``aten.bmm`` and recomputes the rest;
- ``"dots_with_no_batch_dims_saveable"`` (alias
  ``"checkpoint_dots_with_no_batch_dims"``): the same without ``bmm``;
- ``"everything_saveable"``: no checkpoint.

The reference's other names raise NotImplementedError naming what they
need: ``recompute_norms`` and ``save_conv_only`` (the conv-net tags),
the name-taking policy factories and the host-offload policies.
"""
from ..core import framework
from ..core.lowering import remat_saves

__all__ = ["memory_optimize"]

_ANALYZERS = ("ROADMAP.md item 'Fleet and analyzers': analysis/cost.py's "
              "static residual analysis")


def memory_optimize(input_program=None, skip_opt_set=None, print_log=False,
                    level=0, policy="dots_saveable"):
    """Enables rematerialisation for the program's forward segment with
    the jax.checkpoint policy named ``policy`` (None turns it off).
    ``policy="auto"`` and ``print_log=True`` read the reference's static
    cost analysis, a later slice of the torch port."""
    if policy == "auto" or print_log:
        what = "policy='auto'" if policy == "auto" else "print_log=True"
        raise NotImplementedError(
            f"memory_optimize({what}) is a later slice of the torch port "
            f"({_ANALYZERS})")
    program = input_program or framework.default_main_program()
    if policy is not None:
        remat_saves(policy)    # raises for what the port does not take
    program._remat_policy = policy
    program._bump()
    return program
