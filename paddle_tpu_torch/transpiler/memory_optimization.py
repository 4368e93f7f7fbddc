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
- ``"everything_saveable"``: no checkpoint;
- the conv-net policies over the values the ops tag by name
  (``lowering.NAMED_POLICIES``): ``"save_conv_only"`` saves only the
  conv2d outputs (``conv_out``) and recomputes the rest,
  ``"recompute_norms"`` saves all but the batch_norm normalize
  (``batch_norm_out``), which it recomputes in the backward.

``"auto"`` takes the static recommendation of ``analysis/cost.py``
(``recommend_remat_policy``: the most restrictive policy whose
recomputed forward FLOPs fit half the forward's), the reference's pick
on the same program. The reference's other names raise
NotImplementedError naming what they need: the name-taking policy
factories and the host-offload policies.
"""
from ..core import framework
from ..core.lowering import remat_saves

__all__ = ["memory_optimize", "release_memory"]


def memory_optimize(input_program=None, skip_opt_set=None, print_log=False,
                    level=0, policy="dots_saveable"):
    """Enables rematerialisation for the program's forward segment with
    the jax.checkpoint policy named ``policy`` (None turns it off;
    ``"auto"`` picks from static dataflow facts, and None — no backward
    marker — keeps remat off).

    print_log=True reports the STATIC analysis behind that choice
    (analysis/cost.py — liveness over the IR, nothing run), in the
    reference's words: the estimated fwd->bwd residual bytes per
    policy, the savings of the chosen policy against the no-remat
    baseline, and the recommended policy when it differs from the
    chosen one.
    """
    program = input_program or framework.default_main_program()
    recommended = None
    if policy == "auto" or print_log:
        from ..analysis.cost import (estimate_remat_residuals,
                                     recommend_remat_policy)
        residuals = estimate_remat_residuals(program)
        recommended = recommend_remat_policy(program)
    if policy == "auto":
        policy = recommended
    if policy is not None:
        remat_saves(policy)    # raises for what the port does not take
    if print_log:
        def _mb(b):
            return f"{b / 2**20:.2f} MiB"
        if not residuals:
            print("memory_optimize: no backward marker — nothing held "
                  "across fwd->bwd, remat is a no-op for this program")
        else:
            baseline = residuals["everything_saveable"]
            chosen = residuals.get(policy, 0 if policy ==
                                   "nothing_saveable" else baseline)
            print("memory_optimize: estimated fwd->bwd residuals "
                  "(static liveness, batch=1): "
                  + ", ".join(f"{k}={_mb(v)}"
                              for k, v in sorted(residuals.items())))
            print(f"memory_optimize: policy {policy!r} holds "
                  f"~{_mb(chosen)} of {_mb(baseline)} "
                  f"(saves ~{_mb(baseline - chosen)})"
                  + (f"; recommended: {recommended!r}"
                     if recommended not in (None, policy) else
                     " — matches the static recommendation"))
    program._remat_policy = policy
    program._bump()
    return program


def release_memory(input_program=None, skip_opt_set=None):
    """fluid-compat alias, as the reference's: there are no intermediate
    buffers to release at the Python level (a train step donates its
    state); returns the program."""
    return input_program or framework.default_main_program()
