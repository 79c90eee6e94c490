"""Throughput, phase timing, and the program's spans and counters; the
counterparts of ``lsfa_tpu.utils.profiler``'s `Speedometer` (the train
loop's log line, dff_rfcn/core/callback.py:19-51), `PhaseTimer` (the
evaluation loops' data/net/post breakdown) and `trace` (a device profile
of a region).

Spans and counters: the port marks each layer's work with `span(name)`
(stream driver ``stream.*`` and ``rfcn.detect``, model step ``model.*``,
detection ``detect*``, kernel ``nms``) and counts what the host already
knows with `count(name, n)`. Both do nothing until `tracing()` turns
recording on; inside it a span keeps its name, host start and end
(``time.perf_counter_ns``), parent and request, and, while a
``torch.profiler`` is recording, is also a ``record_function`` range, so
the profiler's trace holds it on the device trace's clock.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
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
        """Times the block into `totals[name]`; under `tracing()` it is also
        the span ``eval.<name>``."""
        t0 = time.perf_counter()
        try:
            with span(f"eval.{name}"):
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


class Span:
    """One span, and the context manager that records it: its name, host
    start and end (perf_counter_ns), the enclosing span of its thread
    (`parent`, None at the top) and the id of the request it belongs to
    (None outside any request)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "_rec", "_stack", "_range")

    def __init__(self, rec, name, request):
        self.name, self._rec, self._range = name, rec, None
        self.start_ns = self.end_ns = self.parent = None
        self.request = request          # until it opens: whether it starts a request

    def __enter__(self):
        rec = self._rec
        stack = self._stack = rec.stack()
        parent = self.parent = stack[-1] if stack else None
        if self.request:
            self.request = next(rec._requests)
        else:
            self.request = parent.request if parent is not None else None
        rec.spans.append(self)
        stack.append(self)
        # a range only where a profiler records: it costs microseconds
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        self._stack.pop()
        return None

    def __repr__(self):
        return (f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"parent={self.parent.name if self.parent else None}, request={self.request})")


class Recorder:
    """What one `tracing()` region recorded: `spans` in the order they
    opened and `counters` (name -> sum)."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self._requests = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()

    def stack(self) -> list:
        """The calling thread's open spans, innermost last."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st


# the recorder of the open `tracing()` region; None while tracing is off
_RECORDER: Recorder | None = None


class _Off:
    """The span while tracing is off: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def span(name: str, request: bool = False):
    """A context manager marking a block of the program as the span `name`.
    With `request` it is an entry's span and starts a new request id;
    other spans belong to their parent's request. Off (outside
    `tracing()`), it is one shared no-op context."""
    rec = _RECORDER
    if rec is None:
        return _OFF
    return Span(rec, name, request)


def count(name: str, n: int = 1):
    """Adds `n` to the counter `name` while tracing is on."""
    rec = _RECORDER
    if rec is not None:
        with rec._lock:
            rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def tracing():
    """Turns spans and counters on for the region and yields its
    `Recorder`, to be read once the region ends. Inside an open region it
    yields that region's recorder and leaves recording on."""
    global _RECORDER
    if _RECORDER is not None:
        yield _RECORDER
        return
    rec = _RECORDER = Recorder()
    try:
        yield rec
    finally:
        _RECORDER = None


@contextlib.contextmanager
def trace(log_dir: str = "lsfa_trace"):
    """Profile the region with ``torch.profiler`` (the CPU, and CUDA where
    a card is present) under `tracing()`, and export a Chrome trace
    (``trace.json``, open it in chrome://tracing or Perfetto) into log_dir,
    which then holds the program's spans as ranges; the counterpart of
    JAX's ``jax.profiler`` trace. Yields the profiler (``key_averages()``);
    ``with tracing() as rec, trace(log_dir) as prof`` gives the recorder
    too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing(), profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---- the measurement tools' shared helpers (bench.py, tools/bench_train.py,
# the profilers, report_mfu, ab_interleaved) ----

CPU_PREFIX = "cpu_smoke_"


def tool_device(name: str | None = None) -> torch.device:
    """The device a measurement tool runs on: the card unless `name` says
    otherwise. Without a card it raises (SystemExit): a tool never falls
    back to the CPU, which runs only when asked for (``--device cpu``)."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is available: pass --device cpu to run on the CPU "
                         f"(its numbers are named {CPU_PREFIX}*)")
    return device


def device_info(device) -> dict:
    """{"name", "power_limit_w", "count"} of the card (from
    torch.cuda.get_device_name and nvidia-smi), or of the CPU (no power
    limit, count 0)."""
    import subprocess

    if torch.device(device).type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "count": 0}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    limit = smi[0].rsplit(",", 1)[1].strip().split()[0]
    return {"name": torch.cuda.get_device_name(0), "power_limit_w": float(limit),
            "count": torch.cuda.device_count()}


def labelled(result: dict, device, metrics=()) -> dict:
    """`result` with its device named. On the CPU its "metric" and the
    keys in `metrics` get the prefix CPU_PREFIX and "vs_baseline" becomes
    None: a CPU run's numbers are never a device metric."""
    out = dict(result)
    if torch.device(device).type != "cuda":
        out["metric"] = CPU_PREFIX + out["metric"]
        for key in metrics:
            if key in out:
                out[CPU_PREFIX + key] = out.pop(key)
        if "vs_baseline" in out:
            out["vs_baseline"] = None
    out["device"] = device_info(device)
    return out


def sync(device):
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, device, reps: int = 10, warmup: int = 1) -> float:
    """Median milliseconds of fn() after `warmup` calls: CUDA events
    around each call on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        if torch.device(device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def profile_window(fn, device, log_dir: str, top: int = 10) -> dict:
    """One call of fn() under `trace` (a Chrome trace in log_dir): the
    `top` device kernels by device time (name cut to 80 characters, ms,
    share), the device's busy share of the window (the union of its
    kernels' intervals over the span of every recorded event, host and
    device) and the kernel count. A window in which the profiler recorded
    no device event gives None for the busy share and the device time
    ("not measured")."""
    sync(device)
    with trace(log_dir) as prof:
        fn()
        sync(device)
    every = list(prof.events())
    wall_us = (max(e.time_range.end for e in every) - min(e.time_range.start for e in every)
               if every else 0.0)
    # device kernels and copies; a record_function region mirrored onto
    # the device's timeline (a user annotation) is not one
    events = [e for e in every if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    by_name: dict = {}
    for e in events:
        name = e.name.removeprefix("void ")[:80]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"trace": os.path.join(log_dir, "trace.json"), "kernels": len(events),
            "device_ms": total / 1e3 if events else None,
            "busy_share": busy / wall_us if events else None, "window_ms": wall_us / 1e3,
            "top": [{"name": n, "ms": us / 1e3, "share": us / total} for n, us in ranked]}
