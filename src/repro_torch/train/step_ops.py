"""The LM train step expressed as a UTP task tree (the JAX package's
``train/step_ops.py``; paper §2.3 applied to the framework's own training
loop).

    TrainStepOp.split ->  [MicroGradOp x m]  ->  GradSumOp  ->  AdamOp
                           (reads params,          (reads grads_i*)   (RW params/opt)
                            batch block i,
                            writes grads_i)

The *same* submission code runs under two executor stacks:

  ``eager``  (cpuBLAS-wrapper analog): every leaf task executes
             immediately, its kernels launched one by one.
  ``fused``  the dispatcher's wave schedule runs as ONE program: on the
             card the ordered tasks are captured once per structural key
             into a CUDA graph (the capture helper of ``StepPlan.jitted``,
             ``core/executors/captured.py`` ``CapturedCall``) and replayed;
             on the CPU the same ordered schedule runs eagerly.  This is
             the "whole program is a task tree" limit case from DESIGN.md
             §2; ``compiles`` counts a key's first sighting, as the JAX
             executor counts its ``jax.jit``.

Data handles are 1x1 (or mx1 for the microbatched input) ``GData``
surrogates: the UTP dependency machinery (versioning, waves) works on the
handles while the tree values live in the executor's store.

The port takes the model's ``value_and_grad`` (``Model.value_and_grad``)
where the reference takes a loss function and differentiates it with
``jax.value_and_grad``: a rematerialised block must run its backward
inside the model's parameter substitution.

Aliasing (``src/repro_torch/DESIGN.md``): parameters and optimizer state
are donated and updated in place, as ``StepPlan.jitted`` does (the fused
executor adopts them as its static buffers on its first call and copies a
later call's other tensors in); the batch is copied in; the metrics leave
as clones.  The intermediates (each microbatch's gradients, their mean)
stay inside the step: ``GradSumOp`` consumes the microbatch gradients as
it sums them, so at most two gradient trees live at once.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from .. import optim
from ..core import Access, Dispatcher, GData, GTask, Operation
from ..core.executors.base import Executor
from ..core.executors.captured import CapturedCall


# --------------------------------------------------------------------------
# tree-valued operations
# --------------------------------------------------------------------------
class TreeOp(Operation):
    """Operation whose leaves act on trees held in the executor store."""

    def run_tree(self, task: GTask, store: Dict[Any, Any]) -> None:
        raise NotImplementedError


class MicroGradOp(TreeOp):
    name = "micrograd"

    def __init__(self, grad_fn: Callable):
        self.grad_fn = grad_fn

    def default_modes(self, n):
        return [Access.READ, Access.READ, Access.WRITE]  # params, batch_i, grads_i

    def run_tree(self, task, store):
        params = store[task.args[0].data.id]
        mb_index = task.args[1].block_index()[0]
        batch = store[task.args[1].data.id]
        mb = {k: v[mb_index] for k, v in batch.items()}
        (_, metrics), g = self.grad_fn(params, mb)
        store[task.args[2].data.id] = g
        store.setdefault("metrics", []).append(metrics)


class GradSumOp(TreeOp):
    name = "gradsum"

    def default_modes(self, n):
        return [Access.READ] * (n - 1) + [Access.WRITE]

    def run_tree(self, task, store):
        # the microbatch gradients are intermediates this task reads last:
        # taken out of the store and summed leaf by leaf into the first
        parts = [store.pop(v.data.id) for v in task.args[:-1]]
        n = float(len(parts))
        total = {}
        for k in list(parts[0]):
            s = parts[0].pop(k)
            for p in parts[1:]:
                s.add_(p.pop(k))
            total[k] = s.div_(n)
        store[task.args[-1].data.id] = total


class AdamOp(TreeOp):
    name = "adam"

    def __init__(self, opt_cfg):
        self.opt_cfg = opt_cfg

    def default_modes(self, n):
        return [Access.READ, Access.READWRITE, Access.READWRITE]

    def run_tree(self, task, store):
        grads = store[task.args[0].data.id]
        params = store[task.args[1].data.id]
        opt = store[task.args[2].data.id]
        new_p, new_o, m = optim.update(grads, opt, params, self.opt_cfg)
        store[task.args[1].data.id] = new_p
        store[task.args[2].data.id] = new_o
        store.setdefault("metrics", []).append(m)


class TrainStepOp(TreeOp):
    """Root task: splits into the microbatch/reduce/update children.

    Intermediate handles (per-microbatch grads, the reduced grads) are
    created ONCE and reused across steps so the fused executor's program is
    keyed on a stable structure — step 2 onward is a cache hit.
    """

    name = "train_step"

    def __init__(self, grad_fn, opt_cfg, microbatches: int, device=None):
        self.grad_fn = grad_fn
        self.opt_cfg = opt_cfg
        self.m = microbatches
        self._micrograd = MicroGradOp(grad_fn)
        self._gradsum = GradSumOp()
        self._adam = AdamOp(opt_cfg)
        self._grads = [GData((1, 1), name=f"grads{i}", device=device) for i in range(self.m)]
        self._total = GData((1, 1), name="grads", device=device)

    def default_modes(self, n):
        return [Access.READWRITE, Access.READWRITE, Access.READ]

    def can_split(self, task):
        return True

    def split(self, task, submit):
        params_v, opt_v, batch_v = task.args
        for i in range(self.m):
            submit(GTask(self._micrograd, task, [params_v, batch_v(i, 0), self._grads[i].root_view()]))
        submit(GTask(self._gradsum, task, [g.root_view() for g in self._grads] + [self._total.root_view()]))
        submit(GTask(self._adam, task, [self._total.root_view(), params_v, opt_v]))


# --------------------------------------------------------------------------
# executors
# --------------------------------------------------------------------------
class EagerTreeExecutor(Executor):
    """Every leaf task runs as it comes (the paper's immediate-execution leaf)."""

    name = "tree_eager"

    def __init__(self, store: Dict[Any, Any], **kw):
        super().__init__(**kw)
        self.store = store

    def execute_wave(self, wave):
        for t in wave:
            t.op.run_tree(t, self.store)
            self.stats["tasks"] += 1
            self._finished(t)
        return len(wave)


class FusedTreeExecutor(Executor):
    """The ENTIRE wave schedule as one program: the dispatcher's level
    schedule fixes a topological order, and running the tasks in that order
    through a functional store turns the task DAG into one computation,
    captured once per key into a CUDA graph on the card."""

    name = "tree_fused"

    def __init__(self, store: Dict[Any, Any], **kw):
        super().__init__(**kw)
        self.store = store
        self._cache: Dict[Any, CapturedCall] = {}

    def execute_waves(self, waves):
        order = [t for w in waves for t in w]
        key = tuple((t.op.name, tuple(v.data.id for v in t.args)) for t in order)
        # external inputs = handles READ before any task WRITES them; values
        # produced inside the schedule (microbatch grads etc.) must not leak
        # back in as arguments or the program signature grows call-to-call.
        written = set()
        ext = set()
        for t in order:
            for v, m in t.accesses():
                if m.reads and v.data.id not in written and v.data.id in self.store:
                    ext.add(v.data.id)
            for v in t.outputs():
                written.add(v.data.id)
        in_ids = sorted(ext)

        if key not in self._cache:
            def fused(*vals):
                st: Dict[Any, Any] = dict(zip(in_ids, vals))
                for t in order:
                    t.op.run_tree(t, st)
                return {k: st[k] for k in in_ids}, st.get("metrics", [])

            # inputs some task writes are updated in place (donated); the
            # rest (the batch) are copied in
            self._cache[key] = CapturedCall(fused, "the fused train-step schedule",
                                            donate=[k in written for k in in_ids])
            self.stats["compiles"] += 1
        program = self._cache[key]
        out, metrics = program(*(self.store[k] for k in in_ids))
        self.stats["graph_replays"] = sum(p.graph_replays for p in self._cache.values())
        self.store.update(out)
        self.store["metrics"] = metrics
        for t in order:
            self.stats["tasks"] += 1
            self._finished(t)
        return len(order)

    def execute_wave(self, wave):  # pragma: no cover - waves run fused
        return self.execute_waves([wave])


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------
class UTPTrainStep:
    """Submit/run the train-step task tree through the UTP dispatcher.

    ``grad_fn(params, batch) -> ((loss, metrics), grads)`` is the model's
    ``value_and_grad``.  Handles, the root operation and the executor are
    created once on ``device`` (CUDA unless the caller names another;
    raises without it); every call submits a fresh task tree over the SAME
    handles, so the fused executor's captured program is reused
    (compile-once, run-many)."""

    def __init__(self, grad_fn, opt_cfg, microbatches: int = 1, executor: str = "fused", device=None):
        self.grad_fn = grad_fn
        self.opt_cfg = opt_cfg
        self.m = microbatches
        self.op = TrainStepOp(grad_fn, opt_cfg, microbatches, device=device)
        self.h_params = GData((1, 1), name="params", device=device)
        self.h_opt = GData((1, 1), name="opt", device=device)
        self.h_batch = GData((self.m, 1), partitions=((self.m, 1),), name="batch", device=device)
        self.store: Dict[Any, Any] = {}
        self.executor = FusedTreeExecutor(self.store) if executor == "fused" else EagerTreeExecutor(self.store)

    def __call__(self, params, opt_state, batch):
        store = self.store
        store.pop("metrics", None)
        d = Dispatcher(graph="g2")  # graph name only picks split depth here
        self.executor.on_task_finished = d._on_finished
        d.executor = self.executor

        store[self.h_params.id] = params
        store[self.h_opt.id] = opt_state
        store[self.h_batch.id] = {k: v.reshape((self.m, v.shape[0] // self.m) + v.shape[1:])
                                  for k, v in batch.items()}

        root = GTask(self.op, None, [self.h_params.root_view(), self.h_opt.root_view(), self.h_batch.root_view()])
        d.submit_task(root)
        d.run()
        metrics = store.get("metrics", [])
        agg = {}
        if metrics:
            agg = {k: torch.stack([m[k] for m in metrics if k in m]).mean() for k in metrics[0]}
        return store[self.h_params.id], store[self.h_opt.id], agg
