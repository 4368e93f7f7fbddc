"""Reader composition — parity with python/paddle/reader, plus the
resilience-subsystem ``retry_reader`` (port of ``paddle_tpu/reader``'s
decorators; its other modules and ``dataset/`` are ROADMAP.md item
'Remaining op families and the zoo')."""
from .decorator import (batch, shuffle, map_readers, buffered, cache,
                        chain, compose, firstn, retry_reader,
                        xmap_readers, ComposeNotAligned)  # noqa: F401
