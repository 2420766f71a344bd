"""UTP core: the paper's unified task-based programming model in PyTorch.

Public surface mirrors the paper's programming interface (Fig. 2):
``GData`` / ``GTask`` / ``Operation`` / ``Dispatcher`` plus the external
task-flow graph configuration (G1-G4 analogs).
"""

from .api import dispatcher, utp_finalize, utp_get_parameters, utp_initialize
from .data import GData, GView, Region, dd_matrix, resolve_device, spd_matrix
from .dispatcher import Dispatcher, DrainHandle
from .graph import GRAPHS, TaskFlowGraph, get_graph
from .operation import Operation, OpRegistry
from .task import Access, GTask, TaskState
from .versioning import DepTracker, InFlightEpoch, TaskDag

__all__ = [
    "Access",
    "DepTracker",
    "Dispatcher",
    "DrainHandle",
    "GData",
    "GRAPHS",
    "GTask",
    "GView",
    "InFlightEpoch",
    "Operation",
    "OpRegistry",
    "Region",
    "TaskDag",
    "TaskFlowGraph",
    "TaskState",
    "dd_matrix",
    "dispatcher",
    "get_graph",
    "resolve_device",
    "spd_matrix",
    "utp_finalize",
    "utp_get_parameters",
    "utp_initialize",
]
