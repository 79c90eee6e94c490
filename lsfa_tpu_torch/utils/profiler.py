"""Phase timing of the evaluation loops; the counterpart of
``lsfa_tpu.utils.profiler.PhaseTimer``."""

from __future__ import annotations

import contextlib
import time


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
