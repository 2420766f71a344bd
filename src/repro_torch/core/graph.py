"""Task-flow graph configurations (paper §2.1, Fig. 1a).

A ``TaskFlowGraph`` describes how tasks flow from the program through the
dispatcher to framework wrappers: how many hierarchy levels tasks are split
into, and which executor acts at the leaf level.  The paper's G1-G4 map to:

    g1  -> no split, inline leaf          (program -> D -> torch ops)
    g2  -> 1 level,  wave leaf            (program -> D -> SuperGlue -> torch ops)
    g2p -> 1 level,  cuda leaf            (SuperGlue -> hand-written CUDA tiles)
    g3  -> 2 levels, shard + wave         (D -> DuctTeip -> SuperGlue -> torch ops)
    g4  -> 2 levels, shard + cuda         (D -> DuctTeip -> CUDA tiles)

Leaf backends: ``"torch"`` runs the library leaves (``kernels/ref.py``),
``"cuda"`` the hand-written tile kernels (``kernels/tile_linalg.py``).
The configuration is *external* to the program: the same ``utp_cholesky``
runs under any graph.  The distributed graphs run their leaves through
``executors.sharded.ShardExecutor`` over a ``torch.distributed``
``DeviceMesh`` (``Dispatcher(mesh=...)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class TaskFlowGraph:
    name: str
    split_levels: int  # hierarchy depth: 0 = run root tasks directly
    leaf_executor: str  # 'inline' | 'wave' | 'cuda'
    distributed: bool = False  # insert the shard (DuctTeip) stage on top
    shard_axes: Tuple[Optional[str], ...] = ("data", None)

    def describe(self) -> str:
        stages = ["program", "D"]
        if self.distributed:
            stages.append("DT(shard)")
        if self.split_levels >= 1:
            stages.append("SG(wave)" if self.leaf_executor in ("wave", "cuda") else self.leaf_executor)
        stages.append({"inline": "CB(torch)", "wave": "CB(torch)", "cuda": "GB(cuda)"}[self.leaf_executor])
        return " -> ".join(stages)


GRAPHS = {
    "g1": TaskFlowGraph("g1", split_levels=0, leaf_executor="inline"),
    "g2": TaskFlowGraph("g2", split_levels=1, leaf_executor="wave"),
    "g2p": TaskFlowGraph("g2p", split_levels=1, leaf_executor="cuda"),
    "g3": TaskFlowGraph("g3", split_levels=2, leaf_executor="wave", distributed=True),
    "g4": TaskFlowGraph("g4", split_levels=2, leaf_executor="cuda", distributed=True),
    # single-level distributed (DuctTeip without inner SuperGlue)
    "g3flat": TaskFlowGraph(
        "g3flat", split_levels=1, leaf_executor="wave", distributed=True
    ),
}


def get_graph(name: str) -> TaskFlowGraph:
    try:
        return GRAPHS[name]
    except KeyError:
        raise KeyError(f"unknown task-flow graph {name!r}; have {sorted(GRAPHS)}")
