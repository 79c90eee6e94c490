"""FGFA in the port (``models/fgfa.py``, ``eval/fgfa_tester.py``) against
the benchmark's plain float32 reference (``benchmark/reference/fgfa.py``)
at a tiny size on the CPU: the tiny FGFA cell's configuration (ResNet-50,
feature 64, a 64x128 bucket, K = 2; FlowNet-S and the tower at full
width), with float32 convolutions so that both sides compute the same
equations in the same precision, on the benchmark's seeded weights.

- `FGFA.forward_aggregate` over a batch of centres with 2K = 20
  neighbour slots (the published K = 10) against the reference's window;
- `FGFADetector` over two short videos and a restart, then `flush`: T
  rows a lane each call, the first call's K rows invalid and without
  work, and every emitted frame's detection maps against the reference
  on its own padded window (the slots clamped into its video);
- the windows over many short videos, calls shorter than K among them,
  with the detector's state bounded by its ring;
- the N = 2 `FgfaEmbed.forward` bit-equal to the two-way weighting as
  LSFA's key step had it;
- the counters of one call.

Tolerance: the maps within 1e-4 of max(1, max |reference|). Both sides
are float32 through the same layers; they differ in the order of the
sums inside each convolution (the program runs NCHW views of NHWC
tensors, in bigger batches) and in where the FlowNet input is divided,
about 1e-6 relative a layer over some 70 layers of trunk, FlowNet and
tower; a wrong window slot, a wrong pair order or a missing warp moves
the maps by 1e-2 or more of their scale here."""

import json
import os

import pytest
import torch

from benchmark.kinds import program_config
from benchmark.reference import fgfa as ref_fgfa
from benchmark.reference import model as ref
from benchmark.weights import make_state_dict
from lsfa_tpu_torch.eval.detector import detect_batch
from lsfa_tpu_torch.eval.fgfa_tester import MAPS, FGFADetector
from lsfa_tpu_torch.models.aggregation import FgfaEmbed
from lsfa_tpu_torch.models.fgfa import fgfa_from_config
from lsfa_tpu_torch.models.lsfa import init_params
from lsfa_tpu_torch.utils.profiler import tracing

DATA = os.path.join(os.path.dirname(__file__), "..", "benchmark", "tests", "data")
SEED = 2**31 + 41
TOL = 1e-4


def tiny_cfg():
    with open(os.path.join(DATA, "tiny_fgfa.json")) as f:
        cfg = json.load(f)
    cfg["tpu"]["compute_dtype"] = "float32"
    return cfg


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads (``tests/test_torch_convert.two_torch_threads``'s
    reason: the parallel run's workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    cfg = tiny_cfg()
    pcfg = program_config(cfg)
    state = make_state_dict(cfg, SEED, "cpu")
    prog = fgfa_from_config(pcfg, device="cpu")
    prog.load_state_dict(state)
    net = ref_fgfa.FGFA(**ref.net_args(cfg, {"nettype": "resnet", "add_dcn": False}))
    net.load_state_dict(state)
    return cfg, pcfg, prog.eval(), net.eval()


def frames(gen, n, b, cfg):
    """(n, b, H, W, 3) uint8 BGR: smooth scenes, so that flows are smooth."""
    h, w = cfg["tpu"]["default_bucket"]
    coarse = torch.rand(n * b, 3, 4, 8, generator=gen) * 255
    x = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    x = x + 12 * torch.randn(n * b, 3, h, w, generator=gen)
    return x.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).reshape(n, b, h, w, 3)


def close(got, want, what):
    for key in MAPS:
        a, r = got[key].float(), want[key].float()
        tol = TOL * max(1.0, float(r.abs().max()))
        assert float((a - r).abs().max()) <= tol, (what, key, float((a - r).abs().max()), tol)


def reference_maps(net, video, k):
    """{(frame, lane): the reference's maps of that frame of `video` (n, B,
    H, W, 3)}, each on its window clamped into the video: the trunk once
    a frame, then the reference's aggregation (its `forward` is held to
    the program in `test_forward_aggregate_at_k10`)."""
    n, b = video.shape[:2]
    out = {}
    with torch.no_grad():
        for lane in range(b):
            x, f = net.forward_feat(video[:, lane])
            for c in range(n):
                nb = [min(max(c + d, 0), n - 1) for d in range(-k, k + 1) if d]
                out[c, lane] = net.detection_maps(net.aggregate(x[c:c + 1], f[c:c + 1], x[nb],
                                                                f[nb]))
    return out


def test_forward_aggregate_at_k10(nets):
    """Two centres, each with the published 2K = 20 neighbour slots (some
    repeated, as a padded window has them)."""
    cfg, _, prog, net = nets
    gen = torch.Generator().manual_seed(3)
    video = frames(gen, 12, 2, cfg)
    slots = [0] * 4 + list(range(0, 12)) + [11] * 5         # 21 slots, centre slot 10 = frame 6
    with torch.no_grad():
        prep, feat = prog.forward_feat(video.flatten(0, 1))
        prep, feat = prep.unflatten(0, (12, 2)), feat.unflatten(0, (12, 2))
        nb = torch.tensor(slots[:10] + slots[11:])
        got = prog.forward_aggregate(prep[6], feat[6], prep[nb], feat[nb])
    for lane in range(2):
        with torch.no_grad():
            want = net(video[:, lane], slots)
        close({k: v[lane:lane + 1] for k, v in got.items()}, want, f"lane {lane}")


def test_detector_windows_restart_and_flush(nets):
    """K = 2, T = 3, 2 lanes: video A (6 frames) in two calls, video B (3)
    with first=True (its first rows are A's last K), then `flush`. Each
    forward_aggregate call is caught and held against the reference on
    the frame's own window; the detections are detection of those maps."""
    cfg, pcfg, prog, net = nets
    k, t, b = prog.window_k, 3, 2
    assert k == 2
    gen = torch.Generator().manual_seed(5)
    vids = [frames(gen, 6, b, cfg), frames(gen, 3, b, cfg)]
    info = torch.tensor([[60.0, 120.0, 1.0], [56.0, 100.0, 0.9]])
    det = FGFADetector(prog, pcfg, tuple(cfg["tpu"]["default_bucket"]), batch=b)
    caught = []
    orig = prog.forward_aggregate

    def catch(*a):
        caught.append(orig(*a))
        return caught[-1]

    prog.forward_aggregate = catch
    try:
        calls = [(vids[0][:3], True), (vids[0][3:], False), (vids[1], True)]
        outs = [det.process_frames(x, info, first=first) for x, first in calls]
        outs.append(det.flush())
    finally:
        del prog.forward_aggregate
    # which (video, frame) each row holds; None: before the reset
    expect = [[None, None, (0, 0)], [(0, 1), (0, 2), (0, 3)], [(0, 4), (0, 5), (1, 0)],
              [(1, 1), (1, 2)]]
    assert [o[0].shape[0] for o in outs] == [t, t, t, k]
    emitted = [e for rows in expect for e in rows if e is not None]
    assert len(caught) == len(emitted) == 9
    want = [reference_maps(net, v, k) for v in vids]
    flat = iter(caught)
    for (dets, valid), rows in zip(outs, expect):
        assert dets.shape[1:] == (b, cfg["TEST"]["max_per_image"], 6)
        for r, e in enumerate(rows):
            if e is None:
                assert not valid[r].any() and not dets[r].any()
                continue
            maps = next(flat)
            d, v = detect_batch(maps, det.anchors, info, **det.det_kw)
            assert torch.equal(d, dets[r]) and torch.equal(v, valid[r])
            assert valid[r].any(1).all()
            for lane in range(b):
                close({key: maps[key][lane:lane + 1] for key in MAPS}, want[e[0]][e[1], lane],
                      (e, lane))


def test_windows_and_state_over_many_restarts(nets):
    """Ten videos of 1-5 frames, each cut into calls of at most K frames as
    `eval_videos_fgfa` cuts them (so some calls hold fewer than K): every
    frame is emitted once, K frames late, with its window clamped into its
    own video, and the detector keeps no video start older than its ring
    (its state does not grow with the number of videos)."""
    cfg, pcfg, prog, _ = nets
    k = prog.window_k
    det = FGFADetector(prog, pcfg, tuple(cfg["tpu"]["default_bucket"]))
    emitted = []
    det._emit = lambda centres: emitted.extend((g, det.window(g)) for g in centres if g >= 0)
    lengths = [3, 1, 5, 2, 1, 4, 2, 1, 3, 5]
    video = frames(torch.Generator().manual_seed(13), max(lengths), 1, cfg)
    info = torch.tensor([[60.0, 120.0, 1.0]])
    starts = [sum(lengths[:i]) for i in range(len(lengths))]
    for n in lengths:
        for c in range(0, n, k):
            det.process_frames(video[c:min(n, c + k)], info, first=c == 0)
            assert all(s > det.lo for s in det.starts[1:]), (det.starts, det.lo)
            assert len(det.starts) <= det.feat.shape[0] + 1
    total = sum(lengths)
    assert [g for g, _ in emitted] == list(range(total - k))
    for g, win in emitted:
        s = max(x for x in starts if x <= g)
        e = s + lengths[starts.index(s)]
        assert win == [min(max(g + d, s), e - 1) for d in range(-k, k + 1)], g


def test_two_way_embed_bit_equal():
    """`FgfaEmbed.forward` (the N = 2 `aggregate`) returns, bit for bit,
    the two-way weighting LSFA's key step had: both inputs through the
    tower in one batch [fresh, warped], cosine to the fresh embedding,
    softmax over (warped, fresh), weighted sum."""

    def two_way(m, warp_feat, conv_feat):
        b = warp_feat.shape[0]
        both = torch.cat([conv_feat.to(m.dtype), warp_feat.to(m.dtype)], dim=0)
        e = torch.relu(m.em_conv1(both))
        e = torch.relu(m.em_conv2(e))
        e = m.em_conv3(e).float()
        e_cur, e_warp = e[:b], e[b:]

        def l2n(v):
            return v / torch.sqrt((v * v).sum(dim=1, keepdim=True) + 1e-10)

        n_cur = l2n(e_cur)
        w_warp = (l2n(e_warp) * n_cur).sum(dim=1, keepdim=True)
        w_cur = (n_cur * n_cur).sum(dim=1, keepdim=True)
        wgt = torch.softmax(torch.stack([w_warp, w_cur], dim=0), dim=0)
        return wgt[0] * warp_feat + wgt[1] * conv_feat

    gen = torch.Generator().manual_seed(7)
    for dtype in (torch.bfloat16, torch.float32):
        m = FgfaEmbed(64, dtype=dtype)
        init_params(m, gen)
        warp = torch.randn(2, 4, 8, 64, generator=gen).permute(0, 3, 1, 2) * 3
        conv = torch.relu(torch.randn(2, 4, 8, 64, generator=gen)).to(dtype).permute(0, 3, 1, 2)
        with torch.no_grad():
            assert torch.equal(m(warp, conv), two_way(m, warp, conv))
            assert torch.equal(m.aggregate(torch.cat([conv, warp]), 2), two_way(m, warp, conv))


def test_counters_of_one_call(nets):
    """A video's first two calls, T = 3 frames of 2 lanes at K = 2: every
    new frame through the trunk once; the first call restarts both lanes
    and aggregates frame 0 alone (slots -2 and -1 padded), the second
    frames 1-3 (slot -1 of frame 1 padded; frame 5 exists by then), each
    over 2K pairs a lane, in one detection batch."""
    cfg, pcfg, prog, _ = nets
    gen = torch.Generator().manual_seed(9)
    video = frames(gen, 6, 2, cfg)
    info = torch.tensor([[60.0, 120.0, 1.0]] * 2)
    det = FGFADetector(prog, pcfg, tuple(cfg["tpu"]["default_bucket"]), batch=2)
    got = []
    for x, first in ((video[:3], True), (video[3:], False)):
        with tracing() as rec:
            det.process_frames(x, info, first=first)
        got.append(rec)
    c = got[0].counters
    assert c["stream.restarts"] == 2 and c["fgfa.trunk_frames"] == 6
    assert c["model.frames.fgfa"] == 2 and c["fgfa.pairs"] == 8 and c["fgfa.padded"] == 4
    c = got[1].counters
    assert c["fgfa.trunk_frames"] == 6 and c["model.frames.fgfa"] == 6
    assert c["fgfa.pairs"] == 2 * 2 * 3 * 2 and c["detect.frames"] == 6
    assert c["fgfa.padded"] == 2 * 1 and "stream.restarts" not in c
    rec = got[1]
    assert [s.name for s in rec.spans if s.parent is None] == ["stream.fgfa.process_frames"]
    assert {"model.fgfa.feat", "model.trunk", "model.fgfa.flow", "model.fgfa.warp",
            "model.fgfa.embed", "model.fgfa.weigh", "model.heads", "detect"} <= {
        s.name for s in rec.spans}


def test_eval_videos_fgfa(nets):
    """`eval_videos_fgfa` over two videos of 5 and 3 frames (K at a time,
    a restart, the flush) files every frame once, each as a detector run
    over its whole video in one call gives it: the windows do not depend
    on how the frames are cut into calls."""
    from functools import partial

    from lsfa_tpu_torch.data.loader import SyntheticPreparedVideo
    from lsfa_tpu_torch.eval.driver import eval_videos_fgfa
    from lsfa_tpu_torch.eval.tester import collect_detections

    cfg, pcfg, prog, _ = nets
    h, w = cfg["tpu"]["default_bucket"]
    recs = [{"video_path": f"v{i}", "frame_seg_len": n, "height": 60, "width": 120,
             "vid_path": f"v{i}"} for i, n in enumerate((5, 3))]
    opener = partial(SyntheticPreparedVideo, num_frames=8, seed=4, content_hw=(60, 120))
    got = eval_videos_fgfa(prog, pcfg, recs, logger=None, open_video=opener)
    assert sorted(got) == list(range(8))
    det = FGFADetector(prog, pcfg, (h, w))
    base = 0
    for rec in recs:
        video = opener(rec["video_path"], pcfg, (h, w), frames_mode=0)
        items = [video.frame(f) for f in range(rec["frame_seg_len"])]
        frames = torch.stack([torch.as_tensor(d).reshape(1, h, w, 3) for d, *_ in items])
        info = torch.as_tensor(items[0][4]).reshape(1, 3)
        dets, valid = det.process_frames(frames, info, first=True)
        late = det.flush()
        rows = [(d, v) for d, v in zip(dets, valid)][det.k:] + list(zip(*late))
        for f, (d, v) in enumerate(rows):
            want, have = collect_detections(d, v), got[base + f]
            assert (want["labels"] == have["labels"]).all()
            torch.testing.assert_close(torch.as_tensor(have["scores"]),
                                       torch.as_tensor(want["scores"]), rtol=1e-4, atol=1e-6)
        base += rec["frame_seg_len"]


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_no_host_sync_on_the_card(cuda_device):
    """The tiny cell's configuration (bf16) on the card: after one warm-up
    call, a call, a restart (new window patterns) and a flush enqueue
    without a host sync."""
    with open(os.path.join(DATA, "tiny_fgfa.json")) as f:
        cfg = json.load(f)
    pcfg = program_config(cfg)
    model = fgfa_from_config(pcfg, device=cuda_device)
    model.load_state_dict(make_state_dict(cfg, SEED, cuda_device))
    det = FGFADetector(model, pcfg, tuple(cfg["tpu"]["default_bucket"]), batch=2)
    video = frames(torch.Generator().manual_seed(11), 9, 2, cfg).to(cuda_device)
    info = torch.tensor([[60.0, 120.0, 1.0]] * 2, device=cuda_device)
    det.process_frames(video[:3], info, first=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [det.process_frames(video[3:6], info),
                det.process_frames(video[6:], info, first=True), det.flush()]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(v.any(-1).all()) for _, v in outs)
