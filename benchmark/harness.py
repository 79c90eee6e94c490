"""One run of one cell: set-up, the measured window, the traced windows,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is data or a file of its own, found by name:

- ``benchmark/configs/<config>.json``: the configuration as run (the
  program's config overlay, with ``model``, ``source``, ``reduced``,
  ``assumed``, the weight recipe and ``flops_per_frame``);
- ``benchmark/kinds/<model>.py``: the configuration's model kind (the
  program's network, the plain reference network, the FLOPs a frame);
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, driven by
  the ``Driver`` of ``benchmark/entries/<entry>.py``, which makes its pool
  of inputs with ``benchmark/gen.py``;
- ``benchmark/checks/<workload>.json``: the numbers compared and their
  limits;
- ``benchmark/metrics/<metric>.py``: ``read(run) -> float | None``; a
  metric ``<name>.<part>`` without a file of its own is read by
  ``<name>.py``, as a quantity split by the end-to-end metric it moves.

The window keeps one call in flight: call k+1 is enqueued before call k's
detections are read back, and each call's detections are copied to pinned
host buffers behind its kernels, so the read-back waits for that call
alone.

A traced run (``trace``) runs three windows of ``LEAD_IN + trace_calls``
calls after the measured one: the profiled window (``run["trace"]``), then
``benchmark/spans.py::span_windows``: the span window under the program's
``tracing()`` (``run["spans"]``: each span's host time, the counters) and
the profiled window under ``tracing()`` (``run["span_trace"]``: the device
time of the kernels launched inside each span).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from benchmark import entries, judge, kinds, spans, trace as trace_mod
from benchmark.reference import model as ref
from benchmark.weights import make_state_dict

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lsfa_tpu")


def load_json(*parts) -> dict:
    with open(ROOT.joinpath(*parts)) as f:
        return json.load(f)


def metric_reader(name: str):
    """The `read` function of ``benchmark/metrics/<name>.py``, or of the
    name with its last ``.<part>`` cut off where that has no file."""
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        return metric_reader(name.rsplit(".", 1)[0])
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is of the JAX stack or the JAX package."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def seeds(seed: int) -> dict:
    """Independent 64-bit seeds of the run's weights, inputs and sample."""
    kids = np.random.SeedSequence(seed % 2**64).spawn(3)
    vals = [int(k.generate_state(1, np.uint64)[0]) for k in kids]
    return dict(zip(("weights", "inputs", "sample"), vals))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiler_activities(device) -> list:
    """What ``torch.profiler`` records on `device`: the host, and the card's
    kernels where there is one."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


class _Readback:
    """Ping-pong pinned host buffers for one call's outputs; `start` queues
    the copies behind the call, `wait` returns a host copy of them."""

    def __init__(self, device):
        self.device = device
        self.bufs = {}

    def start(self, out, slot: int):
        if self.device.type != "cuda":
            return [t.clone() for t in out], None
        bufs = self.bufs.get(slot)
        if bufs is None:
            bufs = self.bufs[slot] = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                      for t in out]
        for b, t in zip(bufs, out):
            b.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return bufs, ev

    @staticmethod
    def wait(started):
        bufs, ev = started
        if ev is not None:
            ev.synchronize()
        return [b.clone() for b in bufs]


def window_loop(drv, readback, w0: int, until: float | None = None, count: int = 0,
                keep: bool = True, mark: bool = False) -> dict:
    """Calls from index w0 while the host clock is before `until` (or
    `count` calls), one in flight; returns the loop's record. With `mark`
    each call's staging and enqueue is a profiler range named `trace.MARK`."""
    rec = {"calls": 0, "enqueue_s": 0.0, "latencies": [], "failed": 0, "t_start": time.perf_counter()}
    pending, w = None, w0
    while True:
        new = None
        if (until is not None and time.perf_counter() < until) or (until is None
                                                                   and rec["calls"] < count):
            t_stage = time.perf_counter()
            with torch.profiler.record_function(trace_mod.MARK) if mark else nullcontext():
                staged = drv.stage(w)
                t_call = time.perf_counter()
                out = drv.call(staged, w)
                rec["enqueue_s"] += time.perf_counter() - t_call
            new = (w, t_stage, readback.start(out, w % 2))
            rec["calls"] += 1
            w += 1
        if pending is not None:
            pw, t_stage, started = pending
            host = readback.wait(started)
            t_done = time.perf_counter()
            rec["latencies"] += [t_done - t_stage] * drv.requests_per_window
            if not all(bool(torch.isfinite(h.float()).all()) for h in host):
                rec["failed"] += drv.requests_per_window
            if keep:
                drv.keep(pw, host)
            rec["t_end"] = t_done
        pending = new
        if pending is None:
            rec["w_next"] = w
            return rec


def set_up(cfg: dict, mix: dict, s: dict, device, t0: float):
    """The program's network with the seeded weights, the mix's driver built
    on it and its warm-up calls; prints the set-up's phases (from `t0`).
    Returns (model, driver, read-back buffers, next window, setup seconds)."""
    kind, driver = kinds.find(cfg["model"]), entries.driver(mix["entry"])
    phases = [("imports", time.perf_counter())]
    model, pcfg = kind.program(cfg, device)
    phases.append(("model", time.perf_counter()))
    model.load_state_dict(make_state_dict(cfg, s["weights"], device))
    phases.append(("weights", time.perf_counter()))
    drv = driver(cfg, mix, s["inputs"], device)
    drv.build(model, pcfg)
    phases.append(("inputs", time.perf_counter()))
    readback = _Readback(device)
    w = window_loop(drv, readback, 0, count=mix["warmup_calls"], keep=False)["w_next"]
    _sync(device)
    phases.append(("warm-up", time.perf_counter()))
    starts = [t0] + [t for _, t in phases[:-1]]
    print("setup " + " ".join(f"{n} {t - a:.3f}" for (n, t), a in zip(phases, starts)) + " s",
          file=sys.stderr)
    return model, drv, readback, w, phases[-1][1] - t0


def run_cell(cfg: dict, mix: dict, checks: dict, metric_names: list, seed: int, seconds: float,
             trace: bool, device, t0: float) -> dict:
    """One run; returns the result line as a dict (without printing)."""
    device = torch.device(device)
    s = seeds(seed)
    model, drv, readback, w, setup_s = set_up(cfg, mix, s, device, t0)

    rec = window_loop(drv, readback, w, until=time.perf_counter() + seconds)
    run = {"cfg": cfg, "mix": mix, "setup_s": setup_s, "request": mix["request"],
           "frames": rec["calls"] * drv.frames_per_window,
           "window_s": rec["t_end"] - rec["t_start"], "enqueue_s": rec["enqueue_s"],
           "latencies_s": rec["latencies"]}
    if trace:
        from torch.profiler import profile

        _sync(device)
        calls = trace_mod.LEAD_IN + mix["trace_calls"]
        with profile(activities=profiler_activities(device)) as prof:
            w = window_loop(drv, readback, rec["w_next"], count=calls, keep=False,
                            mark=True)["w_next"]
            _sync(device)
        run["trace"] = trace_mod.reduce(prof.events())
        run["trace_frames"] = calls * drv.frames_per_window
        del prof
        t = run["trace"]
        print(f"trace idle {100 * (1 - t['busy_s'] / t['window_s'])} % of {t['window_s']} s "
              f"after the lead-in; {100 * (1 - t['whole_busy_s'] / t['whole_window_s'])} % of "
              f"{t['whole_window_s']} s with it", file=sys.stderr)
        run.update(spans.span_windows(drv, readback, w, calls, device)[0])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    rng = np.random.default_rng(s["sample"])
    sample = drv.sample(rng)
    prog = drv.program_frames(sample)
    drv.release()
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = reference_readings(cfg, s["weights"], drv, sample, prog, device)

    metrics = {}
    for name, unit in metric_names:
        v = metric_reader(name)(run)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}
    limits = checks["limits"]
    compared = {k: {"value": got[k], "limit": limits[k]} for k in limits}
    extra = {k: v for k, v in got.items() if k not in limits and k != "frames_compared"}
    correct = (all(c["value"] <= c["limit"] for c in compared.values())
               and rec["failed"] == 0 and got["frames_compared"] > 0)
    compared["frames_compared"] = {"value": got["frames_compared"], "limit": "> 0"}
    result = {"correct": correct, "attempted": rec["calls"] * drv.requests_per_window,
              "failed": rec["failed"], "metrics": metrics,
              "device": device_record(device, peak, run.get("trace"))}
    if run.get("trace"):
        t = run["trace"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["readings"] = extra
    result["checks"] = compared
    return result


def reference_readings(cfg, weights_seed, drv, sample, prog, device) -> dict:
    """The numbers compared: the program's detections of the sample judged
    by the plain float32 reference (TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = kinds.find(cfg["model"]).reference(cfg, ref.Precision("float32"), device)
    net.load_state_dict(make_state_dict(cfg, weights_seed, device))
    net.eval()
    refs = drv.reference_frames(net, sample)
    del net
    return judge.readings(prog, refs, cfg["TEST"])


def device_record(device, peak: int, tr) -> dict:
    if device.type == "cuda":
        info = trace_mod.device_info()
        out = {"platform": "gpu", "kind": info["name"], "count": 1,
               "memory_peak_bytes": int(peak), "power_limit_w": info["power_limit_w"]}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if tr:
        out["busy_s"] = tr["busy_s"]
        out["window_s"] = tr["window_s"]
    return out
