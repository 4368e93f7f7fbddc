from .beam_search_decoder import (InitState, StateCell,          # noqa: F401
                                  TrainingDecoder, BeamSearchDecoder)

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]
