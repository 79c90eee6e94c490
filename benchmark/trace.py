"""Reduction of a ``torch.profiler`` window to what the per-layer readers
read: device operations with their intervals, the busy union, the
window's span, device time by name, and the idle gaps with the host
operation running across each.

The traced calls begin from an empty queue, so the first calls' enqueue
leaves the device idle as the measured window never does. The busy share
and the gaps are read once the loop has run LEAD_IN calls: from the start
of the next call's staging, when the device holds one whole call queued,
as in the measured window.

The busy-share and by-name arithmetic is that of the port's
``utils/profiler.py::profile_window``, frozen here: the union of the
device intervals over the span of every recorded event, host and device;
a region that ``record_function`` mirrors onto the device's timeline is
not a device operation.
"""

from __future__ import annotations

import subprocess

import torch

MARK = "benchmark.call"
LEAD_IN = 2


def device_info() -> dict:
    """The card's name, count and power limit (W)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "power_limit_w": float(smi[0].rsplit(",", 1)[1].strip().split()[0])}


def _name(n: str) -> str:
    return n.removeprefix("void ")[:120]


def _union(dev, lo, hi):
    """Busy seconds of device intervals clipped to [lo, hi] (us), and the
    gaps between them there."""
    busy, last, union = 0.0, lo, []
    for s, t, _ in sorted(dev):
        s, t = max(s, lo), min(t, hi)
        if t > last:
            busy += t - max(s, last)
            if union and s <= union[-1][1]:
                union[-1][1] = t
            else:
                union.append([max(s, last), t])
            last = t
    bounds = [lo] + [x for iv in union for x in iv] + [hi]
    idle = [(bounds[i], bounds[i + 1]) for i in range(0, len(bounds), 2)
            if bounds[i + 1] > bounds[i]]
    return busy, idle


def reduce(events) -> dict:
    """Summary of a profiler's `events()`; times in seconds. The busy share
    (`busy_s` over `window_s`) and the idle gaps are taken from the start of
    the (LEAD_IN + 1)-th range named MARK, once the loop runs as in the
    measured window, to the last event; `whole_busy_s` and
    `whole_window_s` over every event. Kernel counts and device time by
    name cover every traced call."""
    dev, host = [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.time_range.start, e.time_range.end, _name(e.name)))
        else:
            host.append((e.time_range.start, e.time_range.end, e.name))
    every = [(s, t) for s, t, _ in dev] + [(s, t) for s, t, _ in host]
    start, end = (min(s for s, _ in every), max(t for _, t in every)) if every else (0.0, 0.0)
    marks = sorted(s for s, _, n in host if n == MARK)
    steady = marks[LEAD_IN] if len(marks) > LEAD_IN else start
    by_name: dict = {}
    for s, t, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-6
    whole_busy, _ = _union(dev, start, end)
    busy, idle = _union(dev, steady, end)
    host.sort()
    gaps = []
    for s, t in sorted(idle, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (s + t)
        inner = [h for h in host if h[0] <= mid <= h[1] and h[2] != MARK]
        label = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host between calls"
        gaps.append([label, (t - s) * 1e-6])
    copies = ("Memcpy", "Memset")
    return {"window_s": (end - steady) * 1e-6, "busy_s": busy * 1e-6,
            "whole_window_s": (end - start) * 1e-6, "whole_busy_s": whole_busy * 1e-6,
            "kernels": sum(1 for _, _, n in dev if not n.startswith(copies)),
            "by_name": by_name,
            "device_ops": sorted(([n, v] for n, v in by_name.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": gaps}
