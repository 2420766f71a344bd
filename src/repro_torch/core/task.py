"""Generic tasks (paper §2.2): operation + parent + data args with access modes."""

from __future__ import annotations

import enum
import itertools
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

from .data import GView

if TYPE_CHECKING:  # pragma: no cover
    from .operation import Operation

_uid = itertools.count()


class Access(enum.Enum):
    READ = "r"
    WRITE = "w"
    READWRITE = "rw"

    @property
    def writes(self) -> bool:
        return self is not Access.READ

    @property
    def reads(self) -> bool:
        return self is not Access.WRITE


class TaskState(enum.Enum):
    CREATED = 0
    SUBMITTED = 1
    READY = 2
    RUNNING = 3
    SPLIT = 4
    FINISHED = 5


class GTask:
    """The paper's ``GTask``: constructor takes an Operation object, a parent
    task (or None), and the data arguments (Fig. 2(a) lines 22-23)."""

    __slots__ = (
        "id",
        "op",
        "parent",
        "args",
        "modes",
        "state",
        "children",
        "_unfinished_children",
        "level",
    )

    def __init__(
        self,
        op: "Operation",
        parent: Optional["GTask"],
        args: Sequence[GView],
        modes: Optional[Sequence[Access]] = None,
    ):
        self.id = next(_uid)
        self.op = op
        self.parent = parent
        self.args: List[GView] = list(args)
        self.modes: List[Access] = (
            list(modes) if modes is not None else list(op.default_modes(len(args)))
        )
        if len(self.modes) != len(self.args):
            raise ValueError("modes/args length mismatch")
        self.state = TaskState.CREATED
        self.children: List[GTask] = []
        self._unfinished_children = 0
        self.level = 0 if parent is None else parent.level + 1

    # -- dependency bookkeeping ---------------------------------------------
    def accesses(self) -> List[Tuple[GView, Access]]:
        return list(zip(self.args, self.modes))

    def outputs(self) -> List[GView]:
        return [v for v, m in zip(self.args, self.modes) if m.writes]

    def inputs(self) -> List[GView]:
        return [v for v, m in zip(self.args, self.modes) if m.reads]

    def add_child(self, child: "GTask") -> None:
        self.children.append(child)
        self._unfinished_children += 1

    def child_finished(self) -> bool:
        """Returns True when the last child finished (parent completes)."""
        self._unfinished_children -= 1
        return self._unfinished_children == 0

    def __repr__(self) -> str:  # pragma: no cover
        return f"GTask#{self.id}({self.op.name}, lvl={self.level}, {self.args})"
