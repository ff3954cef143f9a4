"""The memory-budgeted task-graph executor behind every pipeline."""

from .executor import Budget, GraphExecutor
from .graph import Node

__all__ = ["Budget", "GraphExecutor", "Node"]
