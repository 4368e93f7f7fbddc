"""paddle_tpu_torch.serving — the model servers (port of
``paddle_tpu.serving``): the bucketed ``ServingEngine`` (dynamic
micro-batching over pre-declared shape buckets, admission control,
health and serving metrics) and the continuous-batching
``DecodeEngine`` over a paged KV cache, with its page allocator,
admission schedulers and overload control.

    from paddle_tpu_torch import serving
    eng = serving.ServingEngine(program, ["tokens"], [logits], scope=scope,
              buckets=serving.BucketSpec(batch_sizes=(1, 2, 4),
                                         seq_lens={"tokens": (128, 256)}))
    eng.warmup()
    out = eng.infer({"tokens": toks})          # toks: [1, T]

    dec = serving.DecodeEngine(cfg, scope=scope,
              config=serving.DecodeConfig(max_batch=8,
                                          prompt_buckets=(128, 256)))
    dec.warmup()
    tokens = dec.generate(prompt)              # prompt: 1-D int
"""
from .batching import (MicroBatcher, PendingResult, QueueFullError,  # noqa: F401
                       RequestTimeoutError, ServerClosedError,
                       ServingError)
from .buckets import BucketError, BucketSpec                         # noqa: F401
from .decode_engine import (DecodeConfig, DecodeEngine,              # noqa: F401
                            DecodeRequest)
from .engine import ServingConfig, ServingEngine                     # noqa: F401
from .health import (CircuitBreaker, HealthMonitor, HealthState,     # noqa: F401
                     ServiceUnavailableError, WorkerDiedError)
from .kv_pages import PageAllocator, PagesExhaustedError             # noqa: F401
from .metrics import ServingMetrics                                  # noqa: F401
from .overload import (AdmissionController, BrownoutController,      # noqa: F401
                       RetryBudget, RetryBudgetExhaustedError)
from .sched import (PRIORITIES, FIFOScheduler, SLOClass,             # noqa: F401
                    SLOScheduler, get_scheduler, priority_rank)

__all__ = ["AdmissionController", "BrownoutController", "BucketError",
           "BucketSpec", "CircuitBreaker", "DecodeConfig",
           "DecodeEngine", "DecodeRequest", "FIFOScheduler",
           "HealthMonitor", "HealthState", "MicroBatcher",
           "PRIORITIES", "PageAllocator", "PagesExhaustedError",
           "PendingResult", "QueueFullError", "RequestTimeoutError",
           "RetryBudget", "RetryBudgetExhaustedError", "SLOClass",
           "SLOScheduler", "ServerClosedError",
           "ServiceUnavailableError", "ServingError", "ServingConfig",
           "ServingEngine", "ServingMetrics", "WorkerDiedError",
           "get_scheduler", "priority_rank"]
