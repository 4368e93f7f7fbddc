"""paddle_tpu_torch.serving — the bucketed model server (port of
``paddle_tpu.serving``): dynamic micro-batching over pre-declared shape
buckets, admission control, health and serving metrics. Continuous
decode batching arrives with the generation slice.

    from paddle_tpu_torch import serving
    eng = serving.ServingEngine(program, ["tokens"], [logits], scope=scope,
              buckets=serving.BucketSpec(batch_sizes=(1, 2, 4),
                                         seq_lens={"tokens": (128, 256)}))
    eng.warmup()
    out = eng.infer({"tokens": toks})          # toks: [1, T]
"""
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
