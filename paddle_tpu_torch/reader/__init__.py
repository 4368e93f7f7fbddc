"""Reader composition — parity with python/paddle/reader, plus the
resilience-subsystem ``retry_reader`` (port of ``paddle_tpu/reader``;
the datasets are ``paddle_tpu_torch.dataset``)."""
from .decorator import (batch, shuffle, map_readers, buffered, cache,
                        chain, compose, firstn, retry_reader,
                        xmap_readers, ComposeNotAligned)  # noqa: F401
