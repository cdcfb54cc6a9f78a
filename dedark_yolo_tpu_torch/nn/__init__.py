"""The detector's modules: the layers, layer 0's enhance, the heads and the
graph builder (JAX nn/__init__.py)."""

from . import enhance, graph, heads, layers
from .graph import DetectionModel, parse_model

__all__ = ["layers", "enhance", "heads", "graph", "DetectionModel",
           "parse_model"]
