"""paddle_tpu_torch.serving — the bucketed model server (port of
``paddle_tpu.serving``): dynamic micro-batching over pre-declared shape
buckets, admission control, health and serving metrics. Continuous
decode batching (the decode engine, its page allocator, schedulers and
overload control) arrives with ROADMAP.md item 'Generation and the paged
decode engine' (4b) and is refused by name.

    from paddle_tpu_torch import serving
    eng = serving.ServingEngine(program, ["tokens"], [logits], scope=scope,
              buckets=serving.BucketSpec(batch_sizes=(1, 2, 4),
                                         seq_lens={"tokens": (128, 256)}))
    eng.warmup()
    out = eng.infer({"tokens": toks})          # toks: [1, T]
"""
from ..waiting import DECODE, module_getattr
from .batching import (MicroBatcher, PendingResult, QueueFullError,  # noqa: F401
                       RequestTimeoutError, ServerClosedError,
                       ServingError)
from .buckets import BucketError, BucketSpec                         # noqa: F401
from .engine import ServingConfig, ServingEngine                     # noqa: F401
from .health import (CircuitBreaker, HealthMonitor, HealthState,     # noqa: F401
                     ServiceUnavailableError, WorkerDiedError)
from .metrics import ServingMetrics                                  # noqa: F401

__all__ = ["BucketError", "BucketSpec", "CircuitBreaker",
           "HealthMonitor", "HealthState", "MicroBatcher",
           "PendingResult", "QueueFullError", "RequestTimeoutError",
           "ServerClosedError", "ServiceUnavailableError", "ServingError",
           "ServingConfig", "ServingEngine", "ServingMetrics",
           "WorkerDiedError"]

WAITING = dict.fromkeys((
    "AdmissionController", "BrownoutController", "DecodeConfig",
    "DecodeEngine", "DecodeRequest", "FIFOScheduler", "PRIORITIES",
    "PageAllocator", "PagesExhaustedError", "RetryBudget",
    "RetryBudgetExhaustedError", "SLOClass", "SLOScheduler",
    "get_scheduler", "priority_rank"), DECODE)
__getattr__ = module_getattr(__name__, WAITING)
