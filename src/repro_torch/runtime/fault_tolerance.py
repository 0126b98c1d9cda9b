"""Fault-tolerant training runtime: resume and stragglers (port of
``repro.runtime.fault_tolerance``).

``TrainLoop`` is the restartable loop of ``launch/train.py``: every run
begins with restore-from-latest (a no-op for a fresh job), checkpoints at
step 0, every ``ckpt_every`` steps and at the last step (in the
background), and since the data pipeline is a pure function of the step
index, a killed-and-restarted job replays the exact remaining batches and
ends on the same parameters bit for bit.  Its checkpoints are the
reference's: ``{"params", "opt", "step"}`` with the block leaves stacked
on a layer axis (``checkpoint.lm_train_state_to_reference``), so a run
of either package resumes in the other.

``StragglerMonitor`` records steps slower than ``timeout_factor`` x the
trailing median (on one host it records and exposes the events).

``shardings`` (the reference's restore placed on a device mesh) is a
placement with the sharding plan, as ``launch.steps.build_train_step``'s
step is: a restored state is placed by it (``shardings.place(model,
opt_state)``: each leaf and moment sharded on the plan's FSDP dim over
the mesh's 'data' axis; at world size 1, whole on the model's device),
and a checkpoint is gathered whole by it (``full_tree``, ``gather_opt``,
collectives every rank joins) and written by rank 0 only.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch.distributed as dist

from ..checkpoint.checkpointer import Checkpointer, restore_pytree
from ..checkpoint.reference import (lm_train_state_from_reference,
                                    lm_train_state_to_reference)

__all__ = ["StragglerMonitor", "TrainLoop"]


@dataclass
class StragglerMonitor:
    timeout_factor: float = 3.0
    window: int = 32
    history: list = field(default_factory=list)
    events: list = field(default_factory=list)

    def observe(self, step: int, dt: float):
        self.history.append(dt)
        tail = self.history[-self.window:]
        if len(tail) >= 8:
            med = statistics.median(tail)
            if dt > self.timeout_factor * med:
                self.events.append({"step": step, "dt": dt, "median": med})

    @property
    def median(self) -> float:
        return statistics.median(self.history) if self.history else 0.0


class TrainLoop:
    """Restartable (model, opt_state) training loop for an LM of the
    registry (``model.cfg`` an ``ArchConfig``) and an ``optim.adamw``
    state.

    ``step_fn(model, opt_state, batch) -> (model, opt_state, loss)`` (as
    ``launch.train.make_local_train_step`` makes it) and ``batch_fn(step)
    -> batch`` (tensors on the model's device).  With a checkpoint under
    ``ckpt_dir`` the loop starts from it, on a model rebuilt on the given
    model's device (``self.model``) and placed by ``shardings`` when
    given (module docstring)."""

    def __init__(self, step_fn, model, opt_state, batch_fn, *,
                 ckpt_dir, ckpt_every: int = 50, keep: int = 3,
                 shardings=None, log_every: int = 50):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = Checkpointer(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.monitor = StragglerMonitor()
        self.shardings = shardings
        self.writer = not (dist.is_available() and dist.is_initialized()) \
            or dist.get_rank() == 0

        # resume-from-latest: a fresh job restores nothing
        latest = self.ckpt.latest_step()
        if latest is not None:
            flat = restore_pytree(self.ckpt.path(latest))
            device = next(model.parameters()).device
            model, opt_state, done = lm_train_state_from_reference(
                flat, model.cfg, device=device)
            if shardings is not None:
                model, opt_state = shardings.place(model, opt_state)
            self.start_step = done + 1
        else:
            self.start_step = 0
        self.model, self.opt_state = model, opt_state
        self.losses: list[tuple[int, float]] = []

    def run(self, n_steps: int, *, crash_at: int | None = None):
        """Run to global step ``n_steps``; returns ``(model, opt_state)``.
        ``crash_at`` (tests only) raises after that step, once a checkpoint
        in flight is written, to exercise the restart path.  ``float(loss)`` (a host
        sync) is taken only at log steps."""
        step = self.start_step
        while step < n_steps:
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            self.model, self.opt_state, loss = self.step_fn(
                self.model, self.opt_state, batch)
            if step % self.log_every == 0 or step == n_steps - 1:
                self.losses.append((step, float(loss)))
            self.monitor.observe(step, time.perf_counter() - t0)
            if step % self.ckpt_every == 0 or step == n_steps - 1:
                self._save(step)
            if crash_at is not None and step == crash_at:
                self.ckpt.wait()
                if self.shardings is not None and dist.is_initialized():
                    dist.barrier()
                raise RuntimeError(f"simulated node failure at step {step}")
            step += 1
        self.ckpt.wait()
        if self.shardings is not None and dist.is_initialized():
            dist.barrier()          # every rank returns once the file is whole
        return self.model, self.opt_state

    def _save(self, step: int) -> None:
        if self.shardings is None:
            state = lm_train_state_to_reference(self.model, self.opt_state,
                                                step)
        else:
            state = lm_train_state_to_reference(
                self.model, self.shardings.gather_opt(self.model,
                                                      self.opt_state),
                step, params=self.shardings.full_tree(self.model))
        if self.writer:
            self.ckpt.save_async(step, state)
