"""``benchmark/spans.py``: the reductions on hand-made profiler events (a
kernel goes to the innermost span open at its launch, by link and not by
time; idle time to the innermost span open on the host, `harness`
outside any, summing to the steady window's idle time), the four metrics
on hand-made run dicts (nothing from a program without spans), and one
run of each tiny cell on the CPU."""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import spans
from benchmark.harness import ROOT, run_cell
from benchmark.trace import MARK, reduce

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
DATA = ROOT / "benchmark" / "tests" / "data"


def ev(name, start, end, device=CPU, id=0, thread=1):
    """A profiler event with what the reductions read (times in us; `id`
    the correlation of a launch call with what it launched)."""
    return SimpleNamespace(name=name, device_type=device, thread=thread, id=id,
                           is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end,
                                                      elapsed_us=lambda s=start, t=end: t - s))


def window():
    """Three calls (MARK ranges) of one span tree. Each call's kernels run
    after its enqueue, while the next call is enqueued, so the kernels'
    own times would put them to the wrong spans; their launch calls (the
    ``cu*`` events of the same correlation id) lie in the right ones."""
    out = []
    for i, t0 in enumerate((0.0, 100.0, 200.0)):
        c = 10 * i
        out += [ev(MARK, t0, t0 + 60.0),
                ev("stream.process_gops", t0 + 1, t0 + 59),
                ev("model.forward_key", t0 + 2, t0 + 30),
                ev("aten::conv", t0 + 3, t0 + 10), ev("cudaLaunchKernel", t0 + 5, t0 + 6, id=c + 1),
                ev("detect", t0 + 31, t0 + 58),
                ev("nms", t0 + 40, t0 + 50), ev("cuLaunchKernelEx", t0 + 45, t0 + 46, id=c + 2),
                ev("aten::stack", t0 + 58.5, t0 + 58.9),
                ev("cudaLaunchKernel", t0 + 58.6, t0 + 58.7, id=c + 3),
                ev("aten::copy_", t0 + 59.5, t0 + 59.8),
                ev("cudaMemcpyAsync", t0 + 59.6, t0 + 59.7, id=c + 4)]
        # the device: conv 20 us, 50 us after the call began, then nms, cat, the copy
        d0 = t0 + 50.0
        out += [ev("conv_k", d0, d0 + 20, CUDA, c + 1),
                ev("nms_sweep_kernel", d0 + 25, d0 + 30, CUDA, c + 2),
                ev("cat_k", d0 + 30, d0 + 31, CUDA, c + 3),
                ev("Memcpy DtoH", d0 + 31, d0 + 33, CUDA, c + 4)]
    return out


NAMES = {"stream.process_gops", "model.forward_key", "detect", "nms"}


def test_kernels_go_to_the_span_that_launched_them():
    owned = spans.kernels_by_owner(window(), NAMES)
    assert owned == {"model.forward_key": {"conv_k": pytest.approx(60e-6)},
                     "nms": {"nms_sweep_kernel": pytest.approx(15e-6)},
                     "stream.process_gops": {"cat_k": pytest.approx(3e-6)},
                     spans.HARNESS: {"Memcpy DtoH": pytest.approx(6e-6)}}
    table = spans.device_table(window(), NAMES)
    assert table["detect"]["self_s"] == 0 and table["detect"]["incl_s"] == pytest.approx(15e-6)
    assert table["stream.process_gops"]["incl_s"] == pytest.approx(78e-6)
    assert table["model.forward_key"]["kernels"] == 3
    assert table[spans.HARNESS]["kernel_s"] == 0 and table[spans.HARNESS]["kernels"] == 0
    assert spans.span_share(table) == pytest.approx(1.0)
    assert spans.span_share(table, ("detect",)) == pytest.approx(15 / 78)


def test_owners_of_named_kernels():
    assert spans.owners_of(window(), NAMES, ["conv_k", "Memcpy DtoH", "absent"]) == {
        "conv_k": [["model.forward_key", pytest.approx(60e-6)]],
        "Memcpy DtoH": [[spans.HARNESS, pytest.approx(6e-6)]], "absent": []}


def test_unlinked_device_time_is_its_own_owner():
    events = window() + [ev("orphan_k", 400.0, 410.0, CUDA, 999)]
    table = spans.device_table(events, NAMES)
    assert table[spans.UNLINKED]["self_s"] == pytest.approx(10e-6)
    assert table[spans.UNLINKED]["top"] == [["orphan_k", pytest.approx(10e-6)]]
    assert spans.span_share(table) == pytest.approx(78 / 88)


def test_idle_goes_to_the_innermost_open_span_and_sums_to_the_window():
    events = window()
    idle = spans.idle_by_span(events, NAMES)
    t = reduce(events)
    assert sum(idle.values()) == pytest.approx(t["window_s"] - t["busy_s"])
    # after the lead-in, from the third MARK (200 us) to the last event
    # (283): the gaps 200-250, under the third call's tree, and 270-275,
    # after its enqueue
    assert idle == pytest.approx({spans.HARNESS: 6e-6, "stream.process_gops": 2e-6,
                                  "model.forward_key": 28e-6, "detect": 9e-6, "nms": 10e-6})


def test_metrics_read_the_span_and_profiled_windows():
    run = {"trace_frames": 20,
           "spans": {"host": {"model.forward_key": {"calls": 2, "incl_s": 0.2, "self_s": 0.01},
                              "model.forward_cur": {"calls": 2, "incl_s": 0.6, "self_s": 0.02},
                              "detect": {"calls": 4, "incl_s": 0.04, "self_s": 0.001}},
                     "counters": {"model.frames.key": 4, "model.frames.cur": 16,
                                  "detect.frames": 20},
                     "enqueue_s": 1.0, "frames": 20},
           "span_trace": {"device": {"model.forward_key": {"incl_s": 0.1},
                                     "model.forward_cur": {"incl_s": 0.3},
                                     "detect": {"incl_s": 0.02}}}}
    got = {k: f(run) for k, f in spans.METRICS.items()}
    assert got == pytest.approx({"model_host_ms_per_frame": 40.0, "detect_host_ms_per_frame": 2.0,
                                 "model_device_ms_per_frame": 20.0,
                                 "detect_device_ms_per_frame": 1.0})
    single = {"trace_frames": 4,
              "spans": {"host": {"model.forward": {"calls": 4, "incl_s": 0.08, "self_s": 0}},
                        "counters": {"model.frames.rfcn": 4}},
              "span_trace": {"device": {"model.forward": {"incl_s": 0.04}}}}
    assert spans.model_host_ms_per_frame(single) == pytest.approx(20.0)
    assert spans.model_device_ms_per_frame(single) == pytest.approx(10.0)
    assert spans.detect_host_ms_per_frame(single) is None


def test_metrics_of_a_program_without_spans_are_none():
    parent = {"frames": 10, "trace_frames": 10, "trace": {"by_name": {}}}
    assert all(f(parent) is None for f in spans.METRICS.values())
    empty = {"trace_frames": 10, "spans": {"host": {}, "counters": {}},
             "span_trace": {"device": {}, "idle": {}}}
    assert all(f(empty) is None for f in spans.METRICS.values())


@pytest.mark.parametrize("config,mix,root", [("tiny_lsfa", "tiny_lanes", "stream.process_gops"),
                                             ("tiny_rfcn", "tiny_frames", "rfcn.detect")])
def test_tiny_cell_on_the_cpu(config, mix, root):
    torch.set_num_threads(4)
    cfg = json.loads((DATA / f"{config}.json").read_text())
    m = json.loads((DATA / f"{mix}.json").read_text())
    run = spans.run_spans(cfg, m, 2**33 + 5, 0.5, "cpu")
    host, counters = run["spans"]["host"], run["spans"]["counters"]
    calls = 2 + m["trace_calls"]
    assert host[root]["calls"] == calls and host["detect"]["calls"] > 0
    assert counters["detect.frames"] == run["trace_frames"]
    assert spans.model_host_ms_per_frame(run) > 0 and spans.detect_host_ms_per_frame(run) > 0
    # no device on the CPU: no device time, every traced second idle
    assert spans.model_device_ms_per_frame(run) is None
    idle = run["span_trace"]["idle"]
    assert sum(idle.values()) == pytest.approx(run["idle_s"], rel=1e-9)
    assert idle and set(idle) <= set(host) | {spans.HARNESS}


@pytest.mark.parametrize("config,mix", [("tiny_lsfa", "tiny_lanes"), ("tiny_rfcn", "tiny_frames")])
def test_traced_run_reads_the_span_metrics(config, mix):
    """A traced run keeps its profiled window, then runs the span windows,
    whose readers read the host spans (no device time on the CPU)."""
    torch.set_num_threads(4)
    cfg = json.loads((DATA / f"{config}.json").read_text())
    m = json.loads((DATA / f"{mix}.json").read_text())
    checks = json.loads((DATA / "tiny_checks.json").read_text())
    names = [(n, "ms") for n in spans.METRICS] + [("kernels_per_frame", "kernels")]
    r = run_cell(cfg, m, checks, names, 2**33 + 7, 1.5, True, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(got) == {"model_host_ms_per_frame", "detect_host_ms_per_frame"}
    assert all(v > 0 for v in got.values())
    assert r["device"]["window_s"] > 0 and list(r)[-1] == "checks"
