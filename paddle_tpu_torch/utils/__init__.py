"""Utilities (port of ``paddle_tpu/utils``) — parity with the useful
survivors of python/paddle/utils (the rest of that package is v1-config-era
tooling whose roles moved: model diagrams → debugger.draw_block_graphviz,
image preprocessing → dataset.image, protobuf dumps → Program.to_json).
"""
from .plot import Ploter, PlotData  # noqa: F401

__all__ = ["Ploter", "PlotData"]
