"""Fault-tolerance machinery: the resumable training loop, failure
injection, and a straggler watchdog (reference:
``repro.training.fault_tolerance``).

  * checkpoint/restart — ``run_training`` checkpoints every ``ckpt_every``
    steps (async, atomic; a pending save is joined before the next one)
    and auto-resumes from the latest complete checkpoint; data is a pure
    function of step (skip-ahead), so the restarted trajectory is
    bit-identical where the step itself is deterministic.
  * node failure — ``FailureInjector`` raises at a given step once,
    simulating a crash in-process.
  * stragglers — ``StepWatchdog`` keeps the last 100 step times; a step
    slower than ``threshold_x`` times their median is recorded and handed
    to a callback.

A step's clock stops after a synchronize on the loss's device (the
reference's ``jax.block_until_ready``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.training import checkpoint as ckpt_lib


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raises at a given step, once — simulates a mid-run node failure."""
    fail_at_step: int | None = None
    fired: bool = False

    def maybe_fail(self, step: int):
        if (self.fail_at_step is not None and not self.fired
                and step == self.fail_at_step):
            self.fired = True
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StepWatchdog:
    threshold_x: float = 3.0
    on_straggler: Callable[[int, float, float], None] | None = None
    times: list = dataclasses.field(default_factory=list)
    straggler_steps: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float):
        if len(self.times) >= 5:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.threshold_x * med:
                self.straggler_steps.append(step)
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self.times.append(dt)
        if len(self.times) > 100:
            self.times.pop(0)


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def run_training(*, train_step, init_state_fn, batch_fn, num_steps: int,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 injector: FailureInjector | None = None,
                 watchdog: StepWatchdog | None = None,
                 log_every: int = 10,
                 log_fn: Callable[[str], None] = print) -> tuple[Any, list]:
    """Resumable loop. Returns (final_state, metrics_history)."""
    state = init_state_fn()
    start = 0
    if ckpt_dir:
        restored, step, _ = ckpt_lib.restore_latest(ckpt_dir, state)
        if restored is not None:
            state, start = restored, step
            log_fn(f"[ft] resumed from checkpoint step {step}")

    history = []
    pending = None
    try:
        for step in range(start, num_steps):
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.perf_counter()
            batch = batch_fn(step)
            state, metrics = train_step(state, batch)
            _sync(metrics["loss"])
            dt = time.perf_counter() - t0
            if watchdog is not None:
                watchdog.observe(step, dt)
            history.append({k: float(v) for k, v in metrics.items()})
            if log_every and step % log_every == 0:
                log_fn(f"[train] step={step} loss={history[-1]['loss']:.4f} "
                       f"({dt*1e3:.0f} ms)")
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                if pending is not None:
                    pending.join()
                pending = ckpt_lib.save(ckpt_dir, step + 1, state,
                                        async_=True)
    finally:
        # a crash leaves the last started save to finish, as a process
        # that keeps its writer thread would
        if pending is not None:
            pending.join()
    if ckpt_dir:
        ckpt_lib.save(ckpt_dir, num_steps, state)
    return state, history
