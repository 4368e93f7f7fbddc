"""Fault tolerance (port of ``paddle_tpu/resilience``): the crash-safe
checkpoint store (``checkpoint.py``: atomic temp→fsync→rename, per-array
sha256 MANIFEST, quarantine and newest-valid fallback), fault injection
and retries, which the executor, the serving engine, the Trainer and
the readers use."""
from . import checkpoint, faultinject, retry           # noqa: F401
from .checkpoint import (CheckpointError, ChecksumMismatch,  # noqa: F401
                         load_latest_valid, save_state)
from .faultinject import SimulatedCrash                # noqa: F401
from .retry import (RetryPolicy, TransientDeviceError,  # noqa: F401
                    default_policy, with_retries)

__all__ = ["checkpoint", "faultinject", "retry", "CheckpointError",
           "ChecksumMismatch", "SimulatedCrash", "RetryPolicy",
           "TransientDeviceError", "default_policy", "with_retries",
           "save_state", "load_latest_valid"]
