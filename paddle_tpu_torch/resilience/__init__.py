"""Fault injection and retries (copies of ``paddle_tpu/resilience``'s
``faultinject.py`` and ``retry.py``, which the executor and the serving
engine use). Crash-safe checkpoints arrive with the io slice."""
from . import faultinject, retry                       # noqa: F401
from .faultinject import SimulatedCrash                # noqa: F401
from .retry import (RetryPolicy, TransientDeviceError,  # noqa: F401
                    default_policy, with_retries)

__all__ = ["faultinject", "retry", "SimulatedCrash", "RetryPolicy",
           "TransientDeviceError", "default_policy", "with_retries"]
