"""Contrib surface (port of ``paddle_tpu/contrib``; parity with
python/paddle/fluid/contrib): memory_usage_calc and the decoder package
(beam_search_decoder).
"""
from .memory_usage_calc import memory_usage, compiled_memory_usage  # noqa: F401
from . import decoder                                               # noqa: F401
from .decoder import (InitState, StateCell, TrainingDecoder,
                      BeamSearchDecoder)                            # noqa: F401

__all__ = ["memory_usage", "compiled_memory_usage", "decoder",
           "InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]
