"""The program's own spans and counters in one run of a cell, and what the
detection and model-step metrics read from them.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the card. It sets the cell up as
``benchmark/run.py`` does, runs the measured window untraced for
`--seconds` (the host enqueue that tracing's on-cost is measured
against), then two windows of ``LEAD_IN + trace_calls`` calls each:

- the span window, under the program's ``utils.profiler.tracing()`` and
  no profiler: each span's host time, inclusive and self, the counters,
  and the window's enqueue per frame (the on-cost of tracing, against the
  measured window's);
- the profiled window, under ``tracing()`` and ``torch.profiler``, where
  each span is also a profiler range: each kernel is put to the spans
  open on the host when its launch call began, found through the
  profiler's correlation of the kernel with that call (not by the
  kernel's own time: with one call in flight, call k's kernels run while
  call k+1 is enqueued); the device's
  idle time after the lead-in (``device_idle_pct``'s) to the innermost
  span open on the host meanwhile, ``harness`` where none was.

The two windows are `span_windows`, which a traced run of
``benchmark/run.py`` (``--trace 1``) runs too, after its own profiled
window, so that a metric file (``benchmark/metrics/``) reads any span or
counter by name from ``run["spans"]`` and ``run["span_trace"]``; the four
span metrics below are such readers. This tool also reads the tracing's
on-cost in alternating traced and untraced calls, which a run leaves out.

It prints the per-span table to standard error and one JSON line to
standard output (also under ``chiprun_out/spans/``). The check against
the reference is not run: ``benchmark/run.py`` judges `correct`. A program
without ``tracing()`` prints why and exits 2.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time

import torch

from benchmark import trace as trace_mod
from benchmark.trace import LEAD_IN, MARK, _name, _union

HARNESS = "harness"             # device idle while no program span is open
UNLINKED = "unlinked"           # device time the profiler linked to no host operation
COPIES = ("Memcpy", "Memset")
MODEL_SPANS = ("model.forward_key", "model.forward_cur", "model.forward")
MODEL_FRAMES = ("model.frames.key", "model.frames.cur", "model.frames.rfcn")


# ---- reductions -------------------------------------------------------------

def host_table(spans) -> dict:
    """Recorded spans (``name``, ``start_ns``, ``end_ns``, ``parent``) ->
    {name: {"calls", "incl_s", "self_s"}}: self time is the span's less
    its direct children's."""
    out: dict = {}
    child_ns: dict = {}
    for s in spans:
        if s.parent is not None:
            child_ns[id(s.parent)] = child_ns.get(id(s.parent), 0) + s.end_ns - s.start_ns
    for s in spans:
        row = out.setdefault(s.name, {"calls": 0, "incl_s": 0.0, "self_s": 0.0})
        dur = s.end_ns - s.start_ns
        row["calls"] += 1
        row["incl_s"] += dur * 1e-9
        row["self_s"] += (dur - child_ns.get(id(s), 0)) * 1e-9
    return out


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


class _Window:
    """A profiler window split as ``trace.reduce`` splits it (device
    operations, host events, first and last instant, the start of the
    steady part after LEAD_IN calls), with the program spans open on the
    loop's thread (the one that ran the MARK ranges) as (from, to, open
    spans outermost first) segments from the first instant to the last."""

    def __init__(self, events, span_names):
        self.dev, self.host = [], []
        for e in events:
            if _is_device(e):
                if not getattr(e, "is_user_annotation", False):
                    self.dev.append(e)
            else:
                self.host.append(e)
        every = [e.time_range for e in self.dev + self.host]
        self.start = min((r.start for r in every), default=0.0)
        self.end = max((r.end for r in every), default=0.0)
        marks = sorted((e.time_range.start, e.thread) for e in self.host if e.name == MARK)
        self.steady = marks[LEAD_IN][0] if len(marks) > LEAD_IN else self.start
        loop = marks[0][1] if marks else None
        edges = []
        for e in self.host:
            if e.name in span_names and (loop is None or e.thread == loop):
                edges += [(e.time_range.start, 1, -e.time_range.end, e.name),
                          (e.time_range.end, 0, 0, e.name)]
        edges.sort()
        self.segs, stack, last = [], [], self.start
        for at, opens, _, n in edges:
            if at > last:
                self.segs.append((last, at, tuple(stack)))
            last = max(last, at)
            if opens:
                stack.append(n)
            elif n in stack:
                del stack[len(stack) - 1 - stack[::-1].index(n)]
        self.segs.append((last, max(last, self.end), ()))
        self._starts = [s for s, _, _ in self.segs]

    def open_at(self, t) -> tuple:
        """The program spans open on the loop's thread at host instant t."""
        i = bisect.bisect_right(self._starts, t) - 1
        return self.segs[i][2] if i >= 0 and t < self.segs[i][1] else ()


def launches(events, span_names) -> list:
    """[(spans innermost first, device operation's name, seconds)] for every
    device operation (kernel, copy, memset): the spans open on the host
    when the runtime or driver call that launched it (its correlation id,
    a host event named ``cu*``) began, none for HARNESS; UNLINKED where no
    launch call was recorded."""
    w = _Window(events, span_names)
    calls = {e.id: e.time_range.start for e in w.host if e.name.startswith("cu")}
    out = []
    for d in w.dev:
        sec = d.time_range.elapsed_us() * 1e-6
        t = calls.get(d.id)
        chain = [UNLINKED] if t is None else list(reversed(w.open_at(t)))
        out.append((chain, _name(d.name), sec))
    return out


def kernels_by_owner(events, span_names) -> dict:
    """{innermost span (HARNESS outside any): {kernel name: seconds}}."""
    out: dict = {}
    for chain, name, sec in launches(events, span_names):
        row = out.setdefault(chain[0] if chain else HARNESS, {})
        row[name] = row.get(name, 0.0) + sec
    return out


def owners_of(events, span_names, kernel_names) -> dict:
    """{kernel name: [[innermost span, seconds], ...] largest first} for the
    given names (``trace.reduce``'s ``device_ops``)."""
    out = {k: {} for k in kernel_names}
    for owner, kernels in kernels_by_owner(events, span_names).items():
        for k, sec in kernels.items():
            if k in out:
                out[k][owner] = out[k].get(owner, 0.0) + sec
    return {k: sorted(([n, v] for n, v in o.items()), key=lambda x: -x[1])
            for k, o in out.items()}


def idle_by_span(events, span_names) -> dict:
    """{innermost program span open on the host: device idle seconds} over
    the steady window of ``trace.reduce`` (from the (LEAD_IN + 1)-th MARK
    to the last event), HARNESS where no span was open. The values sum to
    that window's idle time."""
    w = _Window(events, span_names)
    if not w.dev and not w.host:
        return {}
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in w.dev]
    _, idle = _union(dev, w.steady, w.end)
    out: dict = {}
    i = 0
    for lo, hi in idle:
        while i < len(w.segs) and w.segs[i][1] <= lo:
            i += 1
        j = i
        while j < len(w.segs) and w.segs[j][0] < hi:
            a, b = max(lo, w.segs[j][0]), min(hi, w.segs[j][1])
            if b > a:
                n = w.segs[j][2][-1] if w.segs[j][2] else HARNESS
                out[n] = out.get(n, 0.0) + (b - a) * 1e-6
            j += 1
    return out


def device_table(events, span_names) -> dict:
    """{span: {"self_s", "incl_s", "kernel_s", "kernel_incl_s", "kernels",
    "top"}}: device seconds launched with the span innermost (self) or
    anywhere inside it (incl), the same with copies and memsets left out
    (kernel_), the count of kernels launched with it innermost (copies and
    memsets left out), and its top 3 by self time. HARNESS holds what was
    launched under no span, UNLINKED what the profiler linked to nothing."""
    out: dict = {}

    def row(n):
        return out.setdefault(n, {"self_s": 0.0, "incl_s": 0.0, "kernel_s": 0.0,
                                  "kernel_incl_s": 0.0, "kernels": 0, "top": {}})

    for chain, name, sec in launches(events, span_names):
        owner = row(chain[0] if chain else HARNESS)
        owner["self_s"] += sec
        owner["top"][name] = owner["top"].get(name, 0.0) + sec
        copy = name.startswith(COPIES)
        if not copy:
            owner["kernel_s"] += sec
            owner["kernels"] += 1
        for n in set(chain) or {HARNESS}:
            r = row(n)
            r["incl_s"] += sec
            if not copy:
                r["kernel_incl_s"] += sec
    for r in out.values():
        r["top"] = sorted(([n, s] for n, s in r["top"].items()), key=lambda x: -x[1])[:3]
    return out


def span_share(table: dict, names=None):
    """The share of the kernel time (copies and memsets left out) launched
    inside any of `names`, or inside any program span when `names` is
    None."""
    total = sum(r["kernel_s"] for r in table.values())
    if total <= 0:
        return None
    if names is None:
        inside = sum(r["kernel_s"] for n, r in table.items() if n not in (HARNESS, UNLINKED))
    else:
        inside = sum(r["kernel_incl_s"] for n, r in table.items() if n in names)
    return inside / total


# ---- what the detection and model-step metrics read --------------------------

def _host(run, names):
    spans = run.get("spans")
    if not spans or not spans.get("host"):
        return None
    return sum(spans["host"][n]["incl_s"] for n in names if n in spans["host"])


def model_host_ms_per_frame(run: dict):
    """Host ms inside the model step's spans (``model.forward_key`` and
    ``model.forward_cur``, or ``model.forward``) in the span window, over
    the frames of those calls."""
    t = _host(run, MODEL_SPANS)
    frames = sum(run["spans"]["counters"].get(n, 0) for n in MODEL_FRAMES) if t else 0
    return t / frames * 1e3 if frames else None


def detect_host_ms_per_frame(run: dict):
    """Host ms inside ``detect`` spans in the span window, over the frames
    through detection."""
    t = _host(run, ("detect",))
    frames = run["spans"]["counters"].get("detect.frames", 0) if t else 0
    return t / frames * 1e3 if frames else None


def _device(run, names):
    tr = run.get("span_trace")
    if not tr or not tr.get("device") or not run.get("trace_frames"):
        return None
    got = sum(tr["device"][n]["incl_s"] for n in names if n in tr["device"])
    return got / run["trace_frames"] * 1e3 if got > 0 else None


def model_device_ms_per_frame(run: dict):
    """Device ms of the kernels launched inside the model step's spans in
    the profiled window, over its frames."""
    return _device(run, MODEL_SPANS)


def detect_device_ms_per_frame(run: dict):
    """Device ms of the kernels launched inside ``detect`` spans in the
    profiled window, over its frames."""
    return _device(run, ("detect",))


METRICS = {f.__name__: f for f in (model_host_ms_per_frame, detect_host_ms_per_frame,
                                   model_device_ms_per_frame, detect_device_ms_per_frame)}


# ---- one run -------------------------------------------------------------------

def span_trace(events, span_names) -> dict:
    """The profiled window's reduction by span: `device_table`,
    `idle_by_span`, and the shares of kernel time inside program spans,
    inside the model step's and inside detection's."""
    table = device_table(events, span_names)
    return {"device": table, "idle": idle_by_span(events, span_names),
            "share_in_spans": span_share(table), "share_model": span_share(table, MODEL_SPANS),
            "share_detect": span_share(table, ("detect",))}


def print_table(run: dict, out=sys.stderr):
    """The per-span table, per frame."""
    sp, tr = run["spans"], run.get("span_trace") or {}
    frames, tframes = sp["frames"], run.get("trace_frames") or 1
    dev, idle = tr.get("device", {}), tr.get("idle", {})
    idle_s = sum(idle.values()) or 1.0
    names = sorted(set(sp["host"]) | set(dev) | set(idle),
                   key=lambda n: (-sp["host"].get(n, {}).get("incl_s", 0.0), n))
    print(f"{'span':22} {'host':>8} {'self':>8} {'dev':>8} {'dev.self':>8} {'kern':>7} "
          f"{'idle%':>8}  top kernels by self device ms (ms a frame; idle: % of idle)",
          file=out)
    for n in names:
        h = sp["host"].get(n, {"incl_s": 0.0, "self_s": 0.0})
        d = dev.get(n, {"incl_s": 0.0, "self_s": 0.0, "kernels": 0, "top": []})
        top = "; ".join(f"{k[:48]} {s / tframes * 1e3:.3f}" for k, s in d["top"])
        print(f"{n:22} {h['incl_s'] / frames * 1e3:8.3f} {h['self_s'] / frames * 1e3:8.3f} "
              f"{d['incl_s'] / tframes * 1e3:8.3f} {d['self_s'] / tframes * 1e3:8.3f} "
              f"{d['kernels'] / tframes:7.2f} {100 * idle.get(n, 0.0) / idle_s:8.2f}  {top}",
              file=out)
    for k, owners in run.get("owners", {}).items():
        print(f"owners of {k[:64]}: " + ", ".join(f"{n} {v / tframes * 1e3:.4f}"
                                                  for n, v in owners), file=out)
    print("counters per frame: " + ", ".join(f"{k} {v / frames:.4g}"
                                             for k, v in sorted(sp["counters"].items())),
          file=out)
    print(f"on-cost: enqueue {run['span_enqueue_ms']:.4f} ms a frame traced against "
          f"{run['enqueue_ms']:.4f} untraced ({run['on_cost_pct']:+.2f}%), "
          f"{run['on_cost_alternating_pct']:+.2f}% in alternating calls; kernel time in "
          f"spans {tr.get('share_in_spans')}, model {tr.get('share_model')}, detect "
          f"{tr.get('share_detect')}", file=out)


class _Alternating:
    """A driver whose odd-numbered calls run under ``tracing()``; keeps each
    call's enqueue seconds by whether it was traced, so that call 2i and
    call 2i + 1 are a pair."""

    def __init__(self, drv, tracing):
        self._drv, self._tracing = drv, tracing
        self.enqueue_s = {True: [], False: []}

    def __getattr__(self, name):
        return getattr(self._drv, name)

    def call(self, staged, w: int):
        traced = w % 2 == 1
        t0 = time.perf_counter()
        if traced:
            with self._tracing():
                out = self._drv.call(staged, w)
        else:
            out = self._drv.call(staged, w)
        self.enqueue_s[traced].append(time.perf_counter() - t0)
        return out


def span_windows(drv, readback, w: int, calls: int, device) -> tuple:
    """The span window and the profiled window, `calls` calls each from
    window `w`, both under the program's ``tracing()``, the second also
    under ``torch.profiler``. Returns the run's ``spans`` (host table,
    counters, the window's enqueue seconds and frames) and ``span_trace``
    (`span_trace`) records, the profiled window's events and the names of
    the spans recorded in it."""
    from torch.profiler import profile

    from benchmark import harness
    from lsfa_tpu_torch.utils.profiler import tracing

    harness._sync(device)
    with tracing() as r:
        spanned = harness.window_loop(drv, readback, w, count=calls, keep=False)
        harness._sync(device)
    out = {"spans": {"host": host_table(r.spans), "counters": dict(r.counters),
                     "enqueue_s": spanned["enqueue_s"], "frames": calls * drv.frames_per_window}}
    harness._sync(device)
    with tracing() as r2, profile(activities=harness.profiler_activities(device)) as prof:
        harness.window_loop(drv, readback, spanned["w_next"], count=calls, keep=False, mark=True)
        harness._sync(device)
    events = prof.events()
    names = {sp.name for sp in r2.spans}
    out["span_trace"] = span_trace(events, names)
    return out, events, names


def run_spans(cfg, mix, seed, seconds, device) -> dict:
    """One run of a cell through the measured window, `span_windows` and
    the on-cost loop; returns its record."""
    from benchmark import harness

    device = torch.device(device)
    _, drv, readback, w, _ = harness.set_up(cfg, mix, harness.seeds(seed), device,
                                            time.perf_counter())
    rec = harness.window_loop(drv, readback, w, until=time.perf_counter() + seconds, keep=False)
    frames = rec["calls"] * drv.frames_per_window
    calls = LEAD_IN + mix["trace_calls"]
    got, events, names = span_windows(drv, readback, rec["w_next"], calls, device)
    run = {"cfg": cfg, "mix": mix, "frames": frames, "window_s": rec["t_end"] - rec["t_start"],
           "enqueue_s": rec["enqueue_s"], "trace_frames": calls * drv.frames_per_window, **got}
    run["trace"] = trace_mod.reduce(events)
    run["owners"] = owners_of(events, names, [n for n, _ in run["trace"]["device_ops"]])
    del events
    # the on-cost again, within one window: traced and untraced calls in turn
    from lsfa_tpu_torch.utils.profiler import tracing

    alt = _Alternating(drv, tracing)
    harness.window_loop(alt, readback, 0, count=10 * mix["trace_calls"], keep=False)
    pairs = [on / off for off, on in zip(alt.enqueue_s[False], alt.enqueue_s[True])]
    run["on_cost_alternating_pct"] = 100.0 * (statistics.median(pairs) - 1.0)
    t = run["trace"]
    run["idle_s"] = t["window_s"] - t["busy_s"]
    run["enqueue_ms"] = rec["enqueue_s"] / frames * 1e3
    run["span_enqueue_ms"] = run["spans"]["enqueue_s"] / run["spans"]["frames"] * 1e3
    run["on_cost_pct"] = 100.0 * (run["span_enqueue_ms"] / run["enqueue_ms"] - 1.0)
    return run


def span_costs(n: int = 200000) -> dict:
    """Host nanoseconds of one ``with span(...)`` with tracing off and on
    (no profiler), on this machine's CPU."""
    from lsfa_tpu_torch.utils.profiler import span, tracing

    def loop():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("benchmark.cost"):
                pass
        return (time.perf_counter_ns() - t0) / n

    off = min(loop() for _ in range(3))
    with tracing():
        on = min(loop() for _ in range(3))
    return {"off_ns": off, "on_ns": on}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from benchmark.harness import ROOT, load_json
    from benchmark.run import cell_spec

    try:
        from lsfa_tpu_torch.utils.profiler import tracing  # noqa: F401
    except ImportError:
        print("the program has no utils.profiler.tracing: no spans to read", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    _, cfg, mix, _, _ = cell_spec(load_json("BENCHMARK.json"), args.workload, True)
    run = run_spans(cfg, mix, args.seed, args.seconds, args.device)
    print_table(run)
    t = run["trace"]
    line = {"workload": args.workload, "seed": args.seed,
            "metrics": {k: f(run) for k, f in METRICS.items()},
            "enqueue_ms": run["enqueue_ms"], "span_enqueue_ms": run["span_enqueue_ms"],
            "on_cost_pct": run["on_cost_pct"],
            "on_cost_alternating_pct": run["on_cost_alternating_pct"], "costs": span_costs(),
            "idle_s": run["idle_s"], "idle_by_span_s": run["span_trace"]["idle"],
            "busy_s": t["busy_s"], "window_s": t["window_s"],
            "trace_frames": run["trace_frames"],
            "share_in_spans": run["span_trace"]["share_in_spans"],
            "share_model": run["span_trace"]["share_model"],
            "share_detect": run["span_trace"]["share_detect"],
            "device": run["span_trace"]["device"], "host": run["spans"]["host"],
            "counters": run["spans"]["counters"], "device_ops": t["device_ops"],
            "owners": run["owners"]}
    if torch.cuda.is_available():
        line["card"] = trace_mod.device_info()
    text = json.dumps(line)
    out = ROOT / "chiprun_out" / "spans"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.workload}.{args.seed}.json").write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
