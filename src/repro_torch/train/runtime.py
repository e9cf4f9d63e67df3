"""Fault-tolerant training loop, port of `repro/train/runtime.py`.

  * auto-resume — at construction, restore the newest checkpoint (the
    atomic directories make the newest one complete); the data pipeline is
    a pure function of the step, so nothing is replayed or skipped;
  * checkpoints — every ``ckpt_every`` steps (asynchronous), and on
    SIGTERM or SIGINT a synchronous emergency save, then a clean exit;
  * watchdog — a step slower than ``straggler_factor`` × the median of
    the last 50 counts as a straggler and is logged;
  * metrics — JSONL lines (step, loss, wall time) in
    ``<workdir>/metrics.jsonl``.
"""
from __future__ import annotations

import json
import os
import signal
import statistics
import time
from typing import Any, Callable, Dict, Optional

from . import checkpoint as ckpt

__all__ = ["TrainLoop"]


def _scalar(x) -> float:
    """A 0-d loss as a float: a mesh run's DTensor loss reduced first."""
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return float(x)


class TrainLoop:
    """``train_step(params, opt_state, batch, step) → (params, opt_state,
    metrics)`` over ``batch_fn(step)``, from the newest checkpoint under
    ``<workdir>/ckpt`` if there is one (restored as whole tensors onto
    ``params``' and ``opt_state``'s devices and dtypes, then passed
    through ``shard_fn``, default the identity: a mesh run places them
    again as DTensors, `launch.train.build`).  A mesh run's every rank
    runs the loop; its checkpoints are written once (`train.checkpoint`)
    and restore in a one-process run, and the other way round."""

    def __init__(self, *, train_step, batch_fn, params, opt_state,
                 workdir: str, ckpt_every: int = 100, keep_last: int = 3,
                 straggler_factor: float = 3.0,
                 shard_fn: Optional[Callable[[Any], Any]] = None,
                 log_every: int = 10):
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.workdir = workdir
        self.ckpt_dir = os.path.join(workdir, "ckpt")
        self.ckpt_every = ckpt_every
        self.keep_last = keep_last
        self.straggler_factor = straggler_factor
        self.log_every = log_every
        self.shard_fn = shard_fn or (lambda x: x)
        self.metrics_path = os.path.join(workdir, "metrics.jsonl")
        self.straggler_events = 0
        self._terminate = False
        self._step_times: list[float] = []

        os.makedirs(workdir, exist_ok=True)
        self.start_step = 0
        last = ckpt.latest_step(self.ckpt_dir)
        if last is not None:
            (params, opt_state), _ = ckpt.restore(
                self.ckpt_dir, last, (params, opt_state))
            params = self.shard_fn(params)
            opt_state = self.shard_fn(opt_state)
            self.start_step = last + 1
        self.params, self.opt_state = params, opt_state

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._terminate = True
        self._old = {s: signal.signal(s, handler)
                     for s in (signal.SIGTERM, signal.SIGINT)}

    def _restore_signal_handlers(self):
        for s, h in self._old.items():
            signal.signal(s, h)

    def _save(self, step: int, blocking: bool) -> None:
        ckpt.save(self.ckpt_dir, step, (self.params, self.opt_state),
                  keep_last=self.keep_last, blocking=blocking)

    def run(self, total_steps: int) -> Dict[str, Any]:
        """Steps from ``start_step`` up to ``total_steps`` (or a signal):
        {"losses", "stragglers", "last_step"}."""
        self._install_signal_handlers()
        losses = []
        step = self.start_step - 1
        try:
            with open(self.metrics_path, "a") as mf:
                for step in range(self.start_step, total_steps):
                    t0 = time.perf_counter()
                    batch = self.batch_fn(step)
                    self.params, self.opt_state, metrics = self.train_step(
                        self.params, self.opt_state, batch, step)
                    loss = _scalar(metrics["loss"])
                    dt = time.perf_counter() - t0
                    losses.append(loss)

                    self._step_times.append(dt)
                    if len(self._step_times) >= 8:
                        med = statistics.median(self._step_times[-50:])
                        if dt > self.straggler_factor * med:
                            self.straggler_events += 1
                            mf.write(json.dumps(
                                {"step": step, "event": "straggler",
                                 "dt": dt, "median": med}) + "\n")
                    if step % self.log_every == 0:
                        mf.write(json.dumps({"step": step, "loss": loss,
                                             "dt": dt}) + "\n")
                        mf.flush()
                    if self.ckpt_every and (step + 1) % self.ckpt_every == 0:
                        self._save(step, blocking=False)
                    if self._terminate:
                        self._save(step, blocking=True)
                        mf.write(json.dumps({"step": step,
                                             "event": "sigterm_save"}) + "\n")
                        break
        finally:
            ckpt.wait_for_pending()
            self._restore_signal_handlers()
        return {"losses": losses, "stragglers": self.straggler_events,
                "last_step": step}
