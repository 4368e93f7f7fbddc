"""Contrib surface (port of ``paddle_tpu/contrib``; parity with
python/paddle/fluid/contrib): the decoder package (beam_search_decoder).
``memory_usage_calc`` waits for ROADMAP.md item 'Remaining op families
and the zoo' and is refused by name.
"""
from ..waiting import REST, module_getattr
from . import decoder                                               # noqa: F401
from .decoder import (InitState, StateCell, TrainingDecoder,
                      BeamSearchDecoder)                            # noqa: F401

__all__ = ["decoder", "InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]

WAITING = dict.fromkeys(("memory_usage_calc", "memory_usage",
                         "compiled_memory_usage"), REST)
__getattr__ = module_getattr(__name__, WAITING)
