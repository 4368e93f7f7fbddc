"""Static analysis over the Program IR (port of ``paddle_tpu.analysis``)
— shape/dtype inference, a verifier pass pipeline, the reference's TPU
performance lints, dataflow analysis (def-use chains, liveness, effect
summaries), static numerics, and the numerics-preserving rewrite passes
(constant folding / elementwise-chain fusion / CSE / DCE via
``Program.optimize``), and the static FLOPs/bytes cost + residency
model (``cost``: ``program_cost`` and the remat estimators). The
verifier/lint/cost paths never run an op, so they are safe to run over
any program before the first executor dispatch — the build-time
diagnostics layer the reference gets from per-op C++ InferShape. The
ONE exception is the rewrite pipeline's fold pass, which evaluates the
port's lowering rules eagerly (lazy import, only when it runs). The
source-level checkers ``racecheck`` and ``protocheck`` lint the port's
own concurrency and wire code (``python -m
paddle_tpu_torch.analysis.racecheck`` / ``.protocheck``).
"""
from .diagnostics import (Diagnostic, SourceDiagnostic,  # noqa: F401
                          VerifyError, VerifyWarning,
                          ERROR, WARNING, INFO, CODES, errors)
from .infer import (VarInfo, InferError, InferenceResult,  # noqa: F401
                    infer_program)
from .numcheck import (NumInfo, NumericsReport,  # noqa: F401
                       check_program)
from .passes import (Pass, PassManager, VerifyContext,  # noqa: F401
                     default_passes, cheap_passes)
from .verify import verify_program  # noqa: F401
from .dataflow import (OpEffects, op_effects, def_use,  # noqa: F401
                       program_liveness, live_sets, removable_ops,
                       pinned_names, axis_permutation)
from .optimize import (OptimizeReport, optimize_program,  # noqa: F401
                       DEFAULT_PASSES, KNOWN_PASSES, parse_passes,
                       fold_constants, fuse_elementwise_chains)
from .layout import (LayoutPlan, LayoutRegion,  # noqa: F401
                     analyze_layout, convert_layout)
from .cost import (OpCost, CostReport, program_cost,  # noqa: F401
                   recommend_remat_policy, estimate_remat_residuals,
                   estimate_remat_policies)
from . import lints  # noqa: F401
from . import racecheck  # noqa: F401  (source-level; no IR imports)
from . import protocheck  # noqa: F401  (source-level; no IR imports)

__all__ = ["Diagnostic", "SourceDiagnostic", "VerifyError",
           "VerifyWarning", "ERROR",
           "WARNING", "INFO", "CODES", "errors", "VarInfo", "InferError",
           "InferenceResult", "infer_program", "NumInfo",
           "NumericsReport", "check_program", "Pass", "PassManager",
           "VerifyContext", "default_passes", "cheap_passes",
           "verify_program", "OpEffects", "op_effects", "def_use",
           "program_liveness", "live_sets", "removable_ops",
           "OptimizeReport", "optimize_program", "DEFAULT_PASSES",
           "KNOWN_PASSES", "parse_passes", "fold_constants",
           "fuse_elementwise_chains", "LayoutPlan", "LayoutRegion",
           "analyze_layout", "convert_layout", "pinned_names",
           "axis_permutation", "OpCost", "CostReport", "program_cost",
           "recommend_remat_policy", "estimate_remat_residuals",
           "estimate_remat_policies"]
