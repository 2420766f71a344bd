"""Training loop with checkpoint/restart, failure recovery and straggler
watchdog (the JAX package's ``train/trainer.py``) — the step program comes
from ``make_train_step(...).jitted()``: captured into a CUDA graph on its
first call on the card and replayed every step after.

Fault-tolerance model (scaled from the 1000-node design to this harness):
  * **checkpoint/restart** — async atomic checkpoints every
    ``ckpt_every`` steps; on construction the trainer auto-resumes from the
    latest complete checkpoint (data iterator included: the synthetic
    pipeline is an indexed pure function, so the batch index IS the data
    state).
  * **step failure recovery** — a failing step (``RuntimeError``, or a
    non-finite loss with ``abort_on_nan``) triggers restore-from-last-
    checkpoint and replay; ``max_failures`` bounds the retry budget.  A
    failed capture (``CaptureError``) is no step failure: it raises.
    Failures are injectable for tests (``inject_failure``).  Over a mesh
    of more than one device a ``RuntimeError`` may be one rank's alone
    (an OOM, a fault on one card) while the other ranks wait in the step's
    collectives, where no rank can recover on its own: the rank re-raises
    once its checkpoint write has finished, the job ends (a peer's
    collective fails once the rank is gone) and its restart resumes from
    the latest checkpoint (torchrun's restart, ``restore(shardings=)``).
    A non-finite loss is the global batch's, so every rank sees it at the
    same step and all recover together.
  * **straggler watchdog** — per-step wall times feed a rolling median;
    steps slower than ``straggler_factor`` x median are counted.
  * **preemption** — SIGTERM triggers a synchronous final checkpoint;
    over a mesh the ranks agree after every step whether any was
    signalled, so all stop after the same step.
"""

from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .. import optim
from ..configs.base import ArchConfig, ShapeConfig
from ..core.data import resolve_device
from ..core.executors.captured import CaptureError
from ..data.pipeline import DataConfig, SyntheticLMDataset, sharded_batches
from ..launch.steps import StepPlan, make_train_step, train_state
from ..models.model import build_model
from .checkpoint import Checkpointer


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_keep: int = 3
    log_every: int = 10
    seed: int = 0
    abort_on_nan: bool = True
    max_failures: int = 3
    straggler_factor: float = 3.0


@dataclass
class StepStats:
    times: List[float] = field(default_factory=list)
    stragglers: int = 0

    def record(self, dt: float, factor: float) -> bool:
        """Returns True if this step counts as a straggler."""
        med = float(np.median(self.times)) if self.times else dt
        self.times.append(dt)
        if len(self.times) > 200:
            self.times.pop(0)
        if len(self.times) > 5 and dt > factor * med:
            self.stragglers += 1
            return True
        return False


class Trainer:
    """Trains ``cfg`` at ``shape`` on ``device`` (CUDA unless the caller
    names another; raises without it).  ``mesh``: None, or a
    ``DeviceMesh`` over ("data", "model") (every rank builds the same
    ``Trainer``).  Over more than one device the state is ``DTensor``s split
    as the plan places them: each rank draws the seeded init leaf by leaf
    and keeps its blocks (bit for bit the one-device init's), the batches
    are each rank's rows, checkpoints are written whole by rank 0 and
    restored onto whatever mesh the resuming trainer has."""

    def __init__(
        self,
        cfg: ArchConfig,
        shape: ShapeConfig,
        mesh=None,
        tcfg: Optional[TrainerConfig] = None,
        opt_cfg: Optional[optim.AdamWConfig] = None,
        data_cfg: Optional[DataConfig] = None,
        device=None,
    ):
        self.cfg = cfg
        self.shape = shape
        self.mesh = mesh
        self.device = resolve_device(device)
        self.tcfg = tcfg or TrainerConfig()
        self.opt_cfg = opt_cfg or optim.AdamWConfig(state_dtype=cfg.optim_state_dtype)
        self.plan: StepPlan = make_train_step(cfg, mesh, shape, opt_cfg=self.opt_cfg, device=self.device)
        self.step_fn = self.plan.jitted()
        self.ckpt = Checkpointer(self.tcfg.ckpt_dir, keep=self.tcfg.ckpt_keep)
        self.stats = StepStats()
        self.data_cfg = data_cfg or DataConfig(
            vocab=cfg.vocab, seq_len=shape.seq_len, global_batch=shape.global_batch,
            seed=self.tcfg.seed,
        )
        self.dataset = SyntheticLMDataset(self.data_cfg)
        self._preempted = False
        self.metrics_log: List[Dict[str, float]] = []

    # -- state ----------------------------------------------------------------
    def init_state(self):
        """Masters drawn from a generator seeded with ``tcfg.seed``, on the
        trainer's device, and AdamW's zero state."""
        if not self._split:
            params = build_model(self.cfg, seed=self.tcfg.seed, device=self.device, train=True).train_params()
            return params, optim.init(params, self.opt_cfg)
        blocks = build_model(self.cfg, seed=self.tcfg.seed, device=self.device, train=True,
                             shardings=self.plan.in_shardings[0]).train_params()
        return train_state(self.plan, blocks, self.opt_cfg)

    @property
    def _split(self) -> bool:
        return self.mesh is not None and self.mesh.size() > 1

    def _barrier(self) -> None:
        """Every rank at once (a checkpoint rank 0 wrote is complete)."""
        if self._split:
            import torch.distributed as dist

            dist.barrier()

    def _any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (every rank calls it)."""
        if not self._split:
            return flag
        import torch
        import torch.distributed as dist

        x = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return bool(x.item())

    # -- fault handling ---------------------------------------------------------
    def _install_sigterm(self):
        """Route SIGTERM to a preemption flag; returns the handler it
        replaced (None off the main thread), which ``train`` puts back."""
        def handler(signum, frame):
            self._preempted = True
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None  # non-main thread (tests)

    def _batches(self, start: int):
        shardings = self.plan.in_shardings[2] if self._split else None
        return sharded_batches(self.dataset, self.device, start_index=start, embeds_cfg=self.cfg, shardings=shardings)

    # -- loop ------------------------------------------------------------------
    def train(
        self,
        inject_failure: Optional[Callable[[int], bool]] = None,
        on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None,
    ) -> Dict[str, Any]:
        t = self.tcfg
        start_step = 0
        params = opt_state = None
        if self.ckpt.latest_step() is not None:
            params, opt_state, start_step = self._restore()
            print(f"[trainer] resumed from step {start_step}")
        if params is None:
            params, opt_state = self.init_state()
        previous = self._install_sigterm()
        try:
            return self._loop(params, opt_state, start_step, inject_failure, on_metrics)
        finally:
            # the handler holds the trainer (and through it the captured
            # step's buffers and graph): put the caller's back
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _loop(self, params, opt_state, start_step, inject_failure, on_metrics) -> Dict[str, Any]:
        t = self.tcfg
        batches = self._batches(start_step)
        failures = 0
        step = start_step
        stop = self._any_rank(self._preempted)  # SIGTERM, agreed by every rank
        while step < t.steps and not stop:
            batch = next(batches)
            t0 = time.time()
            try:
                if inject_failure is not None and inject_failure(step):
                    raise RuntimeError(f"injected failure at step {step}")
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])
                if t.abort_on_nan and not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
            except CaptureError:
                raise
            except (RuntimeError, FloatingPointError) as e:
                failures += 1
                if self._split and not isinstance(e, FloatingPointError):
                    print(f"[trainer] step {step} failed ({e}) on a mesh; the job restarts "
                          "from the latest checkpoint")
                    self.ckpt.wait()
                    raise
                print(f"[trainer] step {step} failed ({e}); "
                      f"restoring (failure {failures}/{t.max_failures})")
                if failures > t.max_failures:
                    raise
                self.ckpt.wait()
                self._barrier()
                if self.ckpt.latest_step() is not None:
                    params, opt_state, step = self._restore()
                else:
                    params, opt_state = self.init_state()
                    step = 0
                batches = self._batches(step)
                continue
            dt = time.time() - t0
            slow = self.stats.record(dt, t.straggler_factor)
            step += 1
            m = {k: float(v) for k, v in metrics.items()}
            m["step_time_s"] = dt
            self.metrics_log.append({"step": step, **m})
            if on_metrics:
                on_metrics(step, m)
            stop = self._any_rank(self._preempted)
            if step % t.log_every == 0 or step == t.steps:
                print(
                    f"[trainer] step {step:5d} loss={m['loss']:.4f} "
                    f"acc={m.get('accuracy', 0):.3f} "
                    f"gnorm={m.get('grad_norm', 0):.2f} {dt*1e3:.0f}ms"
                    + (" STRAGGLER" if slow else "")
                )
            if step % t.ckpt_every == 0 or step == t.steps or stop:
                self.ckpt.save_async(step, {"params": params, "opt": opt_state})
        self.ckpt.wait()
        if stop:
            self.ckpt.save(step, {"params": params, "opt": opt_state})
            print(f"[trainer] preempted; checkpointed step {step}")
        self._barrier()
        return {
            "params": params,
            "opt_state": opt_state,
            "step": step,
            "metrics": self.metrics_log,
            "stragglers": self.stats.stragglers,
            "failures": failures,
        }

    def _restore(self):
        target = {"params": self.plan.args[0], "opt": self.plan.args[1]}
        if self._split:
            shardings = {"params": self.plan.in_shardings[0], "opt": self.plan.in_shardings[1]}
            state, step = self.ckpt.restore(target, device=self.device, shardings=shardings)
            return state["params"], state["opt"], step
        state, step = self.ckpt.restore(target, device=self.device)
        for p in state["params"].values():
            p.requires_grad_(p.is_floating_point())
        return state["params"], state["opt"], step
