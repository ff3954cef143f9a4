"""The memory-budgeted, priority-classed task-graph executor behind every
pipeline, and the process-wide QoS arbiter (``FOREGROUND > NORMAL >
BACKGROUND``) whose demand pauses lower classes' admissions."""

from .executor import Budget, GraphExecutor, NodeContext, ProgressReporter, run_graph
from .graph import Node
from .qos import (
    Priority,
    QoSArbiter,
    current_priority,
    demand_scope,
    get_arbiter,
    parse_priority,
    pause_point,
    priority_scope,
)

__all__ = [
    "Budget",
    "GraphExecutor",
    "Node",
    "NodeContext",
    "Priority",
    "ProgressReporter",
    "QoSArbiter",
    "current_priority",
    "demand_scope",
    "get_arbiter",
    "parse_priority",
    "pause_point",
    "priority_scope",
    "run_graph",
]
