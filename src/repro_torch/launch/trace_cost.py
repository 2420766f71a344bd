"""Cost of one eager call of a step, from its op stream (the JAX package's
``launch/hlo_cost.py``: ``HloCost`` :158, ``analyze_hlo`` :174).

The reference re-derives the roofline's three inputs from the compiled HLO
text, with loop trip counts as call-graph multipliers.  torch has no HLO:
the port's compiled program is the stream of aten ops that one eager call
of the step dispatches (``StepPlan.jitted`` captures the same stream).
``trace_cost(fn, *args)`` runs ``fn`` once under a ``TorchDispatchMode``
stacked with ``torch.utils.flop_counter.FlopCounterMode`` and counts, by
the reference's conventions:

  * FLOPs: matmul-class FLOPs only (the reference sums its ``dot`` ops):
    the set ``FlopCounterMode`` counts (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, SDPA and convolutions), 2 * m * n * k a product;
  * traffic: the bytes of every op's tensor inputs and outputs (an op is a
    kernel in eager mode, so its boundary is its HBM traffic, as a fusion's
    is in the reference).  View and metadata ops (``view``,
    ``_unsafe_view``, ``t``, ``transpose``, ``expand``, ``slice``,
    ``select``, ``alias``, ``detach``, ``as_strided``, ``prim.device``,
    ``sym_size``, ...) and allocations without a kernel (``empty``) count
    zero, as the reference skips ``bitcast``, ``reshape`` and
    ``get-tuple-element``;
  * collectives: the result bytes of each c10d call, an all-reduce twice
    (the ring's reduce-scatter and all-gather phases), keyed by the
    reference's five kinds: ``all-gather`` (``_allgather_base_``),
    ``reduce-scatter`` (``_reduce_scatter_base_``), ``all-reduce``
    (``allreduce_``), ``all-to-all`` (``alltoall_base_``) and
    ``collective-permute`` (a ``send``/``recv_`` pair, counted at the
    receive).  A collective's operand and result bytes are traffic too, as
    in the reference.

Python loops unroll, so every trip is counted by construction: the
reference's ``n_while`` and its loop table have no counterpart.  Shapes are
this rank's (its blocks, and the whole tensors its gathers make), so every
figure is per rank, as the reference's post-SPMD shapes are per chip.

With fake tensors (``torch._subclasses.FakeTensorMode``) nothing is
computed or allocated: the counts come from shapes alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops that launch no kernel: allocations, and views the schema does not
# mark as such (``_unsafe_view``); ops that return no tensor (``prim.device``,
# ``sym_size``) are skipped too
_NO_KERNEL = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "lift_fresh", "detach",
              "_unsafe_view", "_local_scalar_dense"}
# c10d's ops by the reference's kinds; each takes its result buffers as its
# first argument and its operand as its second (all-reduce: in place)
_KIND = {"_allgather_base_": "all-gather", "_reduce_scatter_base_": "reduce-scatter", "allreduce_": "all-reduce",
         "alltoall_base_": "all-to-all", "recv_": "collective-permute"}
_NO_BYTES = {"send", "barrier"}  # a send is its pair's other half, counted at the receive


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


@dataclass
class TraceCost:
    """The reference's ``HloCost`` fields: ``flops``, ``traffic``,
    ``collectives`` ({kind: {count, bytes}}), ``notes``; ``ops`` counts the
    aten ops dispatched (the reference's loop table has no counterpart)."""

    flops: float = 0.0
    traffic: float = 0.0
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)
    notes: str = ""
    ops: int = 0
    calls: List[Tuple[str, float]] = field(default_factory=list)  # (kind, result bytes), in order

    @property
    def coll_bytes(self) -> float:
        return sum(v["bytes"] for v in self.collectives.values())

    def coll_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self.collectives.items() if v["count"]}


class _CostMode(TorchDispatchMode):
    """Traffic and collectives of every op dispatched under it (FLOPs come
    from the ``FlopCounterMode`` beside it)."""

    def __init__(self, cost: TraceCost):
        super().__init__()
        self.cost = cost
        self.other: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor run its local ops, which are counted
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.cost
        c.ops += 1
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "c10d":
            if name in _KIND:
                result = _nbytes(args[0])
                operand = result if name == "allreduce_" else 0 if name == "recv_" else _nbytes(args[1])
                c.calls.append((_KIND[name], float(result)))
                c.traffic += operand + result
            elif name not in _NO_BYTES:
                self.other.append(f"{ns}.{name}")
            return out
        if func.is_view or name in _NO_KERNEL or next(_tensors(out), None) is None:
            return out
        c.traffic += _nbytes(list(args) + list(kwargs.values())) + _nbytes(out)
        return out


def trace_cost(fn: Callable, *args, **kwargs) -> Tuple[TraceCost, Any]:
    """Run ``fn(*args, **kwargs)`` once and count its FLOPs, traffic and
    collectives (module docstring).  Returns (cost, fn's result)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .roofline import parse_collectives

    cost = TraceCost()
    flop = FlopCounterMode(display=False)
    mode = _CostMode(cost)
    with flop, mode:
        out = fn(*args, **kwargs)
    cost.flops = float(flop.get_total_flops())
    cost.collectives = parse_collectives(cost.calls)
    if mode.other:
        cost.notes = "uncounted collectives: " + ", ".join(sorted(set(mode.other)))
    return cost, out
