"""The port's spans and counters (``utils/profiler.py``: `span`, `count`,
`tracing`) on the tiny configs, on the CPU: the span tree of
`StreamingDetector.process_gops` and `RFCNDetector.detect` with parents
and one request id per call, the counters against the counts the shapes
give (``bn.plain`` for each BatchNorm call on the CPU), nothing recorded
and bit-equal outputs with tracing off, and every span a
``torch.profiler`` range nested as its parents say.

JAX-free, so that its card tests run on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_tracing.py

On the card they hold `process_gops` and `detect` to no host sync with
tracing on, and every NMS kernel of the profiled calls to an ``nms``
span (``benchmark/spans.py``'s attribution by launch)."""

import json
import os

import numpy as np
import pytest
import torch

from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.eval.rfcn_tester import RFCNDetector, rfcn_from_config
from lsfa_tpu_torch.eval.tester import StreamingDetector
from lsfa_tpu_torch.models.layers import FrozenBN
from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config
from lsfa_tpu_torch.utils import profiler
from lsfa_tpu_torch.utils.profiler import PhaseTimer, count, span, trace, tracing

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "lsfa_tpu_torch", "configs")
H, W = 64, 112                  # the tiny configs' bucket
FH, FW = H // 16, W // 16
B, G, N = 2, 2, 3               # lanes, GOPs a call, non-key frames a GOP
INFO2 = np.asarray([[60.0, 104.0, 0.5], [56.0, 96.0, 0.45]], np.float32)
INFO1 = np.asarray([[60.0, 104.0, 0.5]], np.float32)

GOP_TREE = [
    ("model.forward_key", ["model.trunk", "model.long_term", "model.heads"]),
    ("detect", ["detect.proposals", "detect.psroi", "detect.classes"]),
    ("model.forward_cur", ["model.mv_warp", "model.rnet", "model.small_net", "model.heads"]),
    ("detect", ["detect.proposals", "detect.psroi", "detect.classes"]),
]
DETECT_TREE = [
    ("model.forward", ["model.trunk", "model.heads"]),
    ("detect", ["detect.proposals", "detect.psroi", "detect.classes"]),
]


@pytest.fixture(scope="module")
def lsfa():
    cfg = load_config(os.path.join(CONFIGS, "lsfa_tiny_smoke.json"))
    model = lsfa_from_config(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    return cfg, model.eval()


@pytest.fixture(scope="module")
def rfcn():
    cfg = load_config(os.path.join(CONFIGS, "rfcn_tiny_smoke.json"))
    model = rfcn_from_config(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(1))
    return cfg, model.eval()


def gop_inputs(seed, device="cpu"):
    rng = np.random.default_rng(seed)
    ins = (rng.integers(0, 256, (G, B, H, W, 3), dtype=np.uint8),
           rng.integers(0, 256, (G, N, B, H // 4, W // 4, 3), dtype=np.uint8),
           rng.normal(0, 0.5, (G, N, B, FH, FW, 2)).astype(np.float32),
           rng.normal(0, 5, (G, N, B, FH, FW, 3)).astype(np.float32))
    return tuple(torch.from_numpy(x).to(device) for x in ins)


def frame(seed, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8)).to(device)


def children(rec, parent):
    return [s for s in rec.spans if s.parent is parent]


def names(spans):
    return [s.name for s in spans]


def assert_detect_subtree(rec, det_span):
    parts = children(rec, det_span)
    assert names(parts) == ["detect.proposals", "detect.psroi", "detect.classes"]
    for part in parts:
        want = ["nms"] if part.name != "detect.psroi" else []
        assert names(children(rec, part)) == want
        for leaf in children(rec, part):
            assert children(rec, leaf) == []


def test_process_gops_span_tree_and_requests(lsfa):
    cfg, model = lsfa
    det = StreamingDetector(model, cfg, (H, W), batch=B)
    ins = gop_inputs(0)
    with tracing() as rec:
        det.process_gops(*ins, INFO2, first=True)
        det.process_gops(*ins, INFO2)
    roots = children(rec, None)
    assert names(roots) == ["stream.process_gops"] * 2
    assert [r.request for r in roots] == [0, 1]
    for root in roots:
        gops = children(rec, root)
        assert names(gops) == ["stream.gop"] * G
        for gop in gops:
            steps = children(rec, gop)
            assert names(steps) == [name for name, _ in GOP_TREE]
            for step, (name, kids) in zip(steps, GOP_TREE):
                if name == "detect":
                    assert_detect_subtree(rec, step)
                else:
                    assert names(children(rec, step)) == kids
    for s in rec.spans:
        top = s
        while top.parent is not None:
            assert top.parent.start_ns <= top.start_ns <= top.end_ns <= top.parent.end_ns
            top = top.parent
        assert s.request == top.request
    assert len(rec.spans) == 2 * (1 + G * (1 + 4 + 5 + 2 * 6))


def test_detect_span_tree_and_requests(rfcn):
    cfg, model = rfcn
    det = RFCNDetector(model, cfg, (H, W))
    with tracing() as rec:
        for i in range(3):
            det.detect(frame(i), INFO1)
    roots = children(rec, None)
    assert names(roots) == ["rfcn.detect"] * 3
    assert [r.request for r in roots] == [0, 1, 2]
    for root in roots:
        steps = children(rec, root)
        assert names(steps) == [t[0] for t in DETECT_TREE]
        assert names(children(rec, steps[0])) == DETECT_TREE[0][1]
        assert_detect_subtree(rec, steps[1])
        assert {s.request for s in rec.spans if s.request == root.request} == {root.request}


def nms_shapes(cfg, rows):
    """The (B, N) of detection's two NMS calls over `rows` frames: the RPN
    over the top min(pre_nms, anchors) boxes of each frame, the classes
    over each frame's post-NMS rois per foreground class."""
    anchors = FH * FW * cfg.network.NUM_ANCHORS
    rpn = (rows, min(cfg.TEST.RPN_PRE_NMS_TOP_N, anchors))
    classes = (rows * (cfg.dataset.NUM_CLASSES - 1), cfg.TEST.RPN_POST_NMS_TOP_N)
    return [rpn, classes]


def frozen_bns(module):
    """The FrozenBNs of `module`: 19 in the tiny configs' ResNet-18 trunk
    (16 in its units, bn_data, bn0, bn1), 6 in its one-stage small net."""
    return sum(isinstance(m, FrozenBN) for m in module.modules())


def test_counters_equal_the_known_counts(lsfa, rfcn):
    cfg, model = lsfa
    det = StreamingDetector(model, cfg, (H, W), batch=B)
    with tracing() as rec:
        det.process_gops(*gop_inputs(1), INFO2, first=True)
    shapes = G * (nms_shapes(cfg, B) + nms_shapes(cfg, N * B))
    # one call of each BatchNorm of the trunk (key frames) and of the small
    # net (non-key frames) a GOP; on the CPU each takes the plain chain
    bns = frozen_bns(model.backbone) + frozen_bns(model.small_net_backbone)
    assert rec.counters == {
        "stream.restarts": B, "model.frames.key": G * B, "model.frames.cur": G * N * B,
        "detect.frames": G * (B + N * B), "nms.calls": 4 * G, "bn.plain": G * bns,
        "nms.boxes": sum(b * n for b, n in shapes),
        "nms.pairs": sum(b * n * (n - 1) // 2 for b, n in shapes)}

    rcfg, rmodel = rfcn
    rdet = RFCNDetector(rmodel, rcfg, (H, W))
    frames = 3
    with tracing() as rec:
        for i in range(frames):
            rdet.detect(frame(i), INFO1)
    shapes = frames * nms_shapes(rcfg, 1)
    assert rec.counters == {
        "model.frames.rfcn": frames, "detect.frames": frames, "nms.calls": 2 * frames,
        "bn.plain": frames * frozen_bns(rmodel.backbone),
        "nms.boxes": sum(b * n for b, n in shapes),
        "nms.pairs": sum(b * n * (n - 1) // 2 for b, n in shapes)}
    # the kernel's launches count on a card only
    assert "nms.launches" not in rec.counters


def test_off_records_nothing_and_outputs_are_bit_equal(lsfa, rfcn):
    cfg, model = lsfa
    ins = gop_inputs(2)
    off = StreamingDetector(model, cfg, (H, W), batch=B).process_gops(*ins, INFO2, first=True)
    assert profiler._RECORDER is None
    assert span("stream.gop") is span("nms")
    with tracing() as rec:
        on = StreamingDetector(model, cfg, (H, W), batch=B).process_gops(*ins, INFO2, first=True)
    recorded = (len(rec.spans), dict(rec.counters))
    assert profiler._RECORDER is None
    again = StreamingDetector(model, cfg, (H, W), batch=B).process_gops(*ins, INFO2, first=True)
    count("nms.calls", 5)
    assert (len(rec.spans), rec.counters) == recorded
    for a, b, c in zip(off, on, again):
        assert torch.equal(a, b) and torch.equal(a, c)

    rcfg, rmodel = rfcn
    rdet = RFCNDetector(rmodel, rcfg, (H, W))
    off = rdet.detect(frame(5), INFO1)
    with tracing():
        on = rdet.detect(frame(5), INFO1)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_spans_are_profiler_ranges_nested_as_recorded(lsfa, rfcn):
    """Under a CPU torch.profiler every span is a host range; its nearest
    enclosing program range is its recorded parent."""
    from torch.profiler import ProfilerActivity, profile

    cfg, model = lsfa
    det = StreamingDetector(model, cfg, (H, W), batch=B)
    rcfg, rmodel = rfcn
    rdet = RFCNDetector(rmodel, rcfg, (H, W))
    with tracing() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        det.process_gops(*gop_inputs(3), INFO2, first=True)
        rdet.detect(frame(3), INFO1)
    span_names = {s.name for s in rec.spans}
    ranges = sorted((e for e in prof.events() if e.name in span_names),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    spans = sorted(rec.spans, key=lambda s: (s.start_ns, -s.end_ns))
    assert names(spans) == [e.name for e in ranges]
    event_of = {id(s): e for s, e in zip(spans, ranges)}
    for s in spans:
        e = event_of[id(s)]
        enclosing = [o for o in ranges if o is not e and o.time_range.start <= e.time_range.start
                     and e.time_range.end <= o.time_range.end]
        nearest = max(enclosing, key=lambda o: o.time_range.start, default=None)
        assert nearest is (event_of[id(s.parent)] if s.parent is not None else None), s


def test_nested_tracing_shares_the_recorder_and_trace_exports_spans(rfcn, tmp_path):
    cfg, model = rfcn
    det = RFCNDetector(model, cfg, (H, W))
    with tracing() as outer:
        with tracing() as inner:
            assert inner is outer
        assert profiler._RECORDER is outer
        with trace(str(tmp_path)):
            det.detect(frame(6), INFO1)
    assert profiler._RECORDER is None
    assert outer.counters["detect.frames"] == 1
    with open(tmp_path / "trace.json") as f:
        exported = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {s.name for s in outer.spans} <= exported
    with trace(str(tmp_path)):
        det.detect(frame(6), INFO1)
    assert profiler._RECORDER is None


def test_phase_timer_phases_are_eval_spans():
    timer = PhaseTimer()
    with timer.phase("data"):
        pass
    with tracing() as rec:
        with timer.phase("net"):
            with span("stream.gop", request=True):
                pass
        with timer.phase("post"):
            pass
    assert sorted(timer.totals) == ["data", "net", "post"]
    assert [(s.name, s.parent.name if s.parent else None) for s in rec.spans] == [
        ("eval.net", None), ("stream.gop", "eval.net"), ("eval.post", None)]
    assert [s.request for s in rec.spans] == [None, 0, None]


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def card_models(dev):
    lcfg = load_config(os.path.join(CONFIGS, "lsfa_tiny_smoke.json"))
    lsfa_m = lsfa_from_config(lcfg, device=dev)
    init_params(lsfa_m, torch.Generator(device=dev).manual_seed(0))
    rcfg = load_config(os.path.join(CONFIGS, "rfcn_tiny_smoke.json"))
    rfcn_m = rfcn_from_config(rcfg, device=dev)
    init_params(rfcn_m, torch.Generator(device=dev).manual_seed(1))
    return (StreamingDetector(lsfa_m.eval(), lcfg, (H, W), batch=B),
            RFCNDetector(rfcn_m.eval(), rcfg, (H, W)))


@pytest.mark.cuda
def test_no_host_sync_with_tracing_on(cuda_device):
    det, rdet = card_models(cuda_device)
    ins = gop_inputs(7, cuda_device)
    info2 = torch.from_numpy(INFO2).to(cuda_device)
    info1 = torch.from_numpy(INFO1).to(cuda_device)
    img = frame(7, cuda_device)
    det.process_gops(*ins, info2, first=True)        # cuDNN and cuBLAS set up
    rdet.detect(img, info1)
    torch.cuda.synchronize()
    with tracing() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            det.process_gops(*ins, info2)
            rdet.detect(img, info1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert rec.counters["nms.launches"] == rec.counters["nms.calls"] == 4 * G + 2


@pytest.mark.cuda
def test_nms_spans_own_every_nms_kernel(cuda_device):
    """Every kernel that ``nms_roofline_pct`` times by name is launched
    under an ``nms`` span: their device time under the spans equals the
    by-name time within 1%."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import spans as span_mod
    from benchmark.trace import reduce

    det, rdet = card_models(cuda_device)
    ins = gop_inputs(8, cuda_device)
    info2 = torch.from_numpy(INFO2).to(cuda_device)
    info1 = torch.from_numpy(INFO1).to(cuda_device)
    img = frame(8, cuda_device)
    det.process_gops(*ins, info2, first=True)
    rdet.detect(img, info1)
    torch.cuda.synchronize()
    with tracing() as rec, profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            det.process_gops(*ins, info2)
            rdet.detect(img, info1)
        torch.cuda.synchronize()
    events = prof.events()
    by_name = reduce(events)["by_name"]
    nms_names = ("nms", "build_sup", "sweep_fixpoint")
    want = sum(s for n, s in by_name.items() if any(k in n for k in nms_names))
    owned = span_mod.kernels_by_owner(events, {s.name for s in rec.spans})
    got = sum(s for n, s in owned.get("nms", {}).items() if any(k in n for k in nms_names))
    assert want > 0 and abs(got - want) <= 0.01 * want, (got, want)
