"""Datasets (port of ``paddle_tpu/dataset``, a copy: the reference's
modules import no jax) — parity with python/paddle/dataset.

Each module parses the reference's real file format from local files
(common.DATA_HOME, the same directory the reference reads); nothing is
ever downloaded, and a missing file falls back to the shape-compatible
synthetic generator with a warning, so every model remains runnable
either way.
"""
from . import common                            # noqa: F401
from . import synthetic                         # noqa: F401
from . import mnist                             # noqa: F401
from . import cifar                             # noqa: F401
from . import imdb                              # noqa: F401
from . import uci_housing                       # noqa: F401
from . import conll05                           # noqa: F401
from . import movielens                         # noqa: F401
from . import wmt14                             # noqa: F401
from . import wmt16                             # noqa: F401
from . import imikolov                          # noqa: F401
from . import sentiment                         # noqa: F401
from . import mq2007                            # noqa: F401
from . import flowers                           # noqa: F401
from . import voc2012                           # noqa: F401
from . import image                             # noqa: F401
from .synthetic import cifar10, wmt_translation, ctr  # noqa: F401
