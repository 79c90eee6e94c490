"""Throughput and phase timing; the counterparts of
``lsfa_tpu.utils.profiler``'s `Speedometer` (the train loop's log line,
dff_rfcn/core/callback.py:19-51), `PhaseTimer` (the evaluation loops'
data/net/post breakdown) and `trace` (a device profile of a region)."""

from __future__ import annotations

import contextlib
import os
import time

import torch


class Speedometer:
    """Logs samples/s over the last `frequent` steps, with the step's
    metrics, every `frequent` calls after the first (which starts the
    clock). The metrics may be device tensors: they are read, a host
    sync, only on the steps that log."""

    def __init__(self, batch_size: int, frequent: int = 20, logger=None):
        self.batch_size = batch_size
        self.frequent = frequent
        self.logger = logger
        self._t0 = None
        self._count = 0

    def __call__(self, step: int, metrics: dict | None = None):
        self._count += 1
        if self._t0 is None:
            self._t0 = time.perf_counter()
            self._count = 0
            return
        if self._count % self.frequent == 0:
            speed = self.frequent * self.batch_size / (time.perf_counter() - self._t0)
            msg = f"step [{step}]\tspeed: {speed:.2f} samples/sec"
            if metrics:
                msg += "\t" + "\t".join(f"{k}={float(v):.5f}" for k, v in metrics.items())
            (self.logger.info if self.logger else print)(msg)
            self._t0 = time.perf_counter()


class PhaseTimer:
    """Accumulates host seconds per named phase (data, net, post) and
    reports them per tick. PyTorch enqueues device work without waiting, so
    a phase holds the device's time only where it reads a result back."""

    def __init__(self):
        self.totals: dict = {}
        self.count = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def tick(self):
        self.count += 1

    def summary(self) -> str:
        if not self.count:
            return "no frames"
        parts = [f"{k} {v / self.count * 1e3:.1f}ms" for k, v in self.totals.items()]
        return f"per-tick: {' '.join(parts)} over {self.count} ticks"


@contextlib.contextmanager
def trace(log_dir: str = "lsfa_trace"):
    """Profile the region with ``torch.profiler`` (the CPU, and CUDA where
    a card is present) and export a Chrome trace (``trace.json``, open it
    in chrome://tracing or Perfetto) into log_dir; the counterpart of JAX's
    ``jax.profiler`` trace. Yields the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
