"""The port's evaluation loops against the JAX package's, on decoded clips.

A synthetic VID dataset (``lsfa_tpu.data.synth.make_synth_vid_dataset``:
two videos of 36 frames and one of 30, 128x96, MPEG-4 in GOPs of 12, so
one video ends in a partial GOP) is decoded by each package's own data
plane and run through its loops on the tiny float32 models
(configs/lsfa_tiny_smoke.yaml, configs/rfcn_tiny_smoke.yaml) with flax
weights carried across by convert.flax_to_torch; the class kernels are
redrawn at std 0.05 so that scores have no ties.

Tolerances, float32 on both sides with sums reassociated: the same frame
keys; per frame the same labels row by row; scores within 1e-4; boxes
within 1e-2 pixels. The North-star test (the streaming detector on one
clip's decoded GOPs) holds valid masks equal and scores within 1e-4.

The JAX side ships float32 MV/residual grids (``tpu.mv_res_dtype``) and
runs its jitted steps compiled with XLA's algsimp pass off: under plain
jit psroi_pool's division by the bin count becomes a multiply by the
reciprocal, which moves knife-edge bins (tests/test_torch_train_step.py).
Its detectors are subclassed here for that; no file of the package
changes. JAX pads a video's last window by repeating its last GOP and
drops those outputs; the port runs the real GOPs only.

The file skips where the native library does not load.
"""

import logging
import os
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.data import loader as jax_loader
from lsfa_tpu.data.synth import make_synth_vid_dataset
from lsfa_tpu.eval import driver as jax_driver
from lsfa_tpu.eval import rfcn_tester as jax_rfcn_tester
from lsfa_tpu.eval.tester import StreamingDetector as JaxStreamingDetector
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.data import coviar
from lsfa_tpu_torch.data import loader
from lsfa_tpu_torch.eval import driver
from lsfa_tpu_torch.eval.rfcn_tester import rfcn_from_config
from lsfa_tpu_torch.eval.tester import StreamingDetector
from lsfa_tpu_torch.models.lsfa import lsfa_from_config
from tests.test_torch_convert import perturb, to_numpy
from tests.test_torch_train_step import NO_ALGSIMP
from tests.test_torch_convert import two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

ROOT = os.path.join(os.path.dirname(__file__), "..")
LSFA_CONFIG = os.path.join(ROOT, "configs", "lsfa_tiny_smoke.yaml")
RFCN_CONFIG = os.path.join(ROOT, "configs", "rfcn_tiny_smoke.yaml")
BUCKET = (64, 112)
H, W = BUCKET
FH, FW = H // 16, W // 16
LOG = logging.getLogger("torch_eval_loops")
LOG.addHandler(logging.NullHandler())
COMPILED = {}


def no_algsimp(name, step):
    """The jitted step compiled without algsimp, once per step name and
    argument signature for the whole file: every detector of a model is
    built from the same model, config and bucket."""
    def call(*args):
        key = (name,) + tuple((x.shape, str(x.dtype)) for x in jax.tree.leaves(args))
        if key not in COMPILED:
            COMPILED[key] = step.lower(*args).compile(compiler_options=NO_ALGSIMP)
        return COMPILED[key](*args)
    return call


class ExactJaxStreamingDetector(JaxStreamingDetector):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        for name in ("_scan_gops_step", "_key_step", "_cur_step"):
            setattr(self, name, no_algsimp(name, getattr(self, name)))


class ExactJaxRFCNDetector(jax_rfcn_tester.RFCNDetector):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._step = no_algsimp("rfcn_step", self._step)


@pytest.fixture(scope="module")
def roidb(tmp_path_factory):
    if not coviar.available():
        pytest.skip("native coviar plane not built (needs FFmpeg's libraries)")
    d = str(tmp_path_factory.mktemp("eval_loops"))
    kw = dict(sizes=((128, 96),), gop_size=12, split="val", profile="easy")
    _, vids, annos = make_synth_vid_dataset(d, n_videos=2, n_frames=36, seed=11, **kw)
    _, tail, tail_annos = make_synth_vid_dataset(d, n_videos=1, n_frames=30, seed=12, **kw)
    annotations = dict(annos)
    annotations.update({len(annos) + i: a for i, a in tail_annos.items()})
    return vids + tail, annotations


@pytest.fixture(scope="module")
def lsfa():
    jcfg = jax_load_config(LSFA_CONFIG)
    jcfg.tpu.mv_res_dtype = "float32"
    jm = jax_lsfa_from_config(jcfg)
    d = jnp.zeros((1, H, W, 3))
    v = jm.init(jax.random.PRNGKey(3), d, d, d, jnp.ones((1,)), jnp.ones((1,)),
                jnp.zeros((1, FH, FW, 2)), jnp.zeros((1, FH, FW, 3)))
    v = perturb(to_numpy(v), 1)
    k = v["params"]["rfcn_cls"]["kernel"]
    v["params"]["rfcn_cls"]["kernel"] = (
        np.random.default_rng(2).normal(0, 0.05, k.shape).astype(np.float32))
    cfg = load_config(LSFA_CONFIG)
    tm = lsfa_from_config(cfg, device="cpu")
    tm.load_state_dict(flax_to_torch(v), strict=True)
    return jcfg, jm, v, cfg, tm.eval()


@pytest.fixture(scope="module")
def rfcn():
    jcfg = jax_load_config(RFCN_CONFIG)
    jm = jax_rfcn_tester.rfcn_from_config(jcfg)
    v = perturb(to_numpy(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, H, W, 3)), False)), 1)
    hr = np.random.default_rng(2)
    for name in ("rpn_cls_score", "rfcn_cls", "rfcn_bbox"):
        k = v["params"][name]["kernel"]
        v["params"][name]["kernel"] = hr.normal(0, 0.05, k.shape).astype(np.float32)
    cfg = load_config(RFCN_CONFIG)
    tm = rfcn_from_config(cfg, device="cpu")
    tm.load_state_dict(flax_to_torch(v), strict=True)
    return jcfg, jm, v, cfg, tm.eval()


@pytest.fixture(scope="module")
def jax_lsfa_dets(roidb, lsfa):
    """JAX's eval_videos over the three videos, steps compiled exactly."""
    jcfg, jm, v, _, _ = lsfa
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_driver, "StreamingDetector", ExactJaxStreamingDetector)
        return jax_driver.eval_videos(jm, v, jcfg, roidb[0], logger=LOG)


@pytest.fixture(scope="module")
def port_lsfa_dets(roidb, lsfa):
    _, _, _, cfg, tm = lsfa
    return driver.eval_videos(tm, cfg, roidb[0], logger=LOG)


def assert_detections_close(got, want, scores=1e-4, boxes=1e-2):
    """The same keys; per frame the same labels row by row, scores within
    `scores`, boxes within `boxes` pixels."""
    assert sorted(got) == sorted(want)
    rows = 0
    for k in want:
        np.testing.assert_array_equal(got[k]["labels"], want[k]["labels"], err_msg=f"frame {k}")
        np.testing.assert_allclose(got[k]["scores"], want[k]["scores"], rtol=0, atol=scores,
                                   err_msg=f"frame {k}")
        np.testing.assert_allclose(got[k]["boxes"], want[k]["boxes"], rtol=0, atol=boxes,
                                   err_msg=f"frame {k}")
        rows += len(want[k]["labels"])
    assert rows > 0


def assert_detections_same(got, want):
    """tests/test_timeplex.py's tolerances: labels equal, scores within
    1e-6 relative, boxes within 1e-5 relative and 1e-3."""
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k]["labels"], want[k]["labels"])
        np.testing.assert_allclose(got[k]["scores"], want[k]["scores"], rtol=1e-6)
        np.testing.assert_allclose(got[k]["boxes"], want[k]["boxes"], rtol=1e-5, atol=1e-3)


def test_streaming_detector_matches_jax_on_a_decoded_clip(roidb, lsfa):
    """The North-star test: each package decodes the 36-frame clip with its
    own PreparedVideo and runs its StreamingDetector over the three GOPs
    (a window of two, then one carrying the key feature): valid masks
    equal, scores within 1e-4 row by row, labels equal, boxes within 1e-2."""
    jcfg, jm, v, cfg, tm = lsfa
    path = roidb[0][0]["video_path"]
    jpv = jax_loader.PreparedVideo(path, jcfg, BUCKET)
    pv = loader.PreparedVideo(path, cfg, BUCKET)
    jdet = ExactJaxStreamingDetector(jm, v, jcfg, BUCKET)
    tdet = StreamingDetector(tm, cfg, BUCKET)
    for win, first in (([0, 1], True), ([2], False)):
        want = [np.asarray(o) for o in jdet.process_prepared_window(
            [jpv.gop(g) for g in win], first=first)]
        got = [o.numpy() for o in tdet.process_prepared_window(
            [pv.gop(g) for g in win], first=first)]
        for dets, valid, jd, jv in ((got[0], got[1], want[0], want[1]),
                                    (got[2], got[3], want[2], want[3])):
            assert dets.shape == jd.shape
            np.testing.assert_array_equal(valid, jv)
            assert valid.sum() > 0
            np.testing.assert_array_equal(dets[valid][:, 0], jd[jv][:, 0])
            np.testing.assert_allclose(dets[valid][:, 1], jd[jv][:, 1], rtol=0, atol=1e-4)
            np.testing.assert_allclose(dets[valid][:, 2:], jd[jv][:, 2:], rtol=0, atol=1e-2)
    np.testing.assert_allclose(tdet.feat_key.numpy(), np.asarray(jdet.feat_key),
                               rtol=1e-3, atol=1e-3)
    assert tdet.frame_id == jdet.frame_id == 36


def test_eval_videos_matches_jax(roidb, jax_lsfa_dets, port_lsfa_dets):
    """Whole GOP windows, then the 30-frame video's last 6 frames through
    the per-frame path, restarted with flag 0."""
    assert sorted(port_lsfa_dets) == list(range(36 + 36 + 30))
    assert_detections_close(port_lsfa_dets, jax_lsfa_dets)


def test_eval_videos_timeplex_matches_jax_and_sequential(roidb, lsfa, jax_lsfa_dets,
                                                         port_lsfa_dets):
    _, _, _, cfg, tm = lsfa
    before = threading.active_count()
    got = driver.eval_videos_timeplex(tm, cfg, roidb[0], streams=2, logger=LOG)
    assert threading.active_count() == before
    assert_detections_same(got, port_lsfa_dets)
    assert_detections_close(got, jax_lsfa_dets)


def test_eval_videos_timeplex_more_streams_than_videos(roidb, lsfa, port_lsfa_dets):
    _, _, _, cfg, tm = lsfa
    got = driver.eval_videos_timeplex(tm, cfg, roidb[0][:1], streams=8, logger=LOG)
    assert_detections_same(got, {k: port_lsfa_dets[k] for k in range(36)})


def test_eval_videos_rfcn_matches_jax(roidb, rfcn):
    """Every frame of the 30-frame video at full resolution through the
    single-frame R-FCN."""
    jcfg, jm, v, cfg, tm = rfcn
    recs = roidb[0][2:]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rfcn_tester, "RFCNDetector", ExactJaxRFCNDetector)
        want = jax_driver.eval_videos_rfcn(jm, v, jcfg, recs, logger=LOG)
    got = driver.eval_videos_rfcn(tm, cfg, recs, logger=LOG)
    assert sorted(got) == list(range(30))
    assert_detections_close(got, want)


def test_evaluate_map_equal_on_equal_detections(roidb, jax_lsfa_dets, port_lsfa_dets):
    """mAP over the port's detections equals mAP over JAX's, by either
    package's evaluate_map (the synth annotations behind a dataset's
    _load_annotation)."""
    recs, annotations = roidb
    base = {r["vid_path"]: b for r, b in zip(recs, (0, 36, 72))}

    class Annotated:
        num_classes = 9
        classes = ["__background__"] + [f"class{i}" for i in range(1, 9)]

        def _load_annotation(self, entry):
            a = annotations[base[entry["path"]] + entry["frame_seg_id"]]
            return {"gt_classes": a["labels"], "boxes": a["boxes"]}

    got_mean, got_ap = driver.evaluate_map(port_lsfa_dets, Annotated(), recs, logger=LOG)
    same_mean, same_ap = jax_driver.evaluate_map(port_lsfa_dets, Annotated(), recs, logger=LOG)
    want_mean, want_ap = jax_driver.evaluate_map(jax_lsfa_dets, Annotated(), recs, logger=LOG)
    assert got_mean == same_mean
    np.testing.assert_array_equal(got_ap, same_ap)
    np.testing.assert_allclose(got_ap, want_ap, rtol=0, atol=1e-6)
    assert np.isfinite(got_ap).sum() >= 2 and 0.0 <= got_mean <= 1.0
    assert abs(got_mean - want_mean) <= 1e-6


def failing_video(fail_from):
    class Failing(loader.PreparedVideo):
        def gop(self, gop_idx):
            if gop_idx >= fail_from:
                raise RuntimeError("planted decode failure")
            return super().gop(gop_idx)
    return Failing


def test_timeplex_raises_a_producers_exception(roidb, lsfa):
    """The error of a stream's second window reaches the caller, and no
    producer thread outlives the call."""
    _, _, _, cfg, tm = lsfa
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="planted decode failure"):
        driver.eval_videos_timeplex(tm, cfg, roidb[0], streams=3, logger=LOG,
                                    open_video=failing_video(2))
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]
    with pytest.raises(RuntimeError, match="planted decode failure"):
        driver.eval_videos(tm, cfg, roidb[0][:1], logger=LOG, open_video=failing_video(0))


def test_max_frames_stops_the_loops(roidb, lsfa, rfcn, port_lsfa_dets):
    """The budget counts frames as they are filed, one window behind the
    enqueue, and is checked after each video's windows and each per-frame
    step (timeplex: after each window filed; R-FCN: after each frame). The
    frames run are JAX's, and what was filed equals the full run's."""
    jcfg, jm, v, cfg, tm = lsfa
    recs = roidb[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_driver, "StreamingDetector", ExactJaxStreamingDetector)
        want_whole = jax_driver.eval_videos(jm, v, jcfg, recs, logger=LOG, max_frames=30)
        want_tail = jax_driver.eval_videos(jm, v, jcfg, recs[2:], logger=LOG, max_frames=27)
    before = threading.active_count()       # JAX's prefetcher may leave its thread waiting
    got = driver.eval_videos(tm, cfg, recs, logger=LOG, max_frames=30)
    assert sorted(got) == sorted(want_whole) == list(range(72))   # stops before the third video
    assert_detections_same(got, {k: port_lsfa_dets[k] for k in got})
    got = driver.eval_videos(tm, cfg, recs[2:], logger=LOG, max_frames=27)
    assert sorted(got) == sorted(want_tail) == list(range(27))    # two GOPs and 3 tail frames
    assert_detections_same(got, {k: port_lsfa_dets[72 + k] for k in got})
    got = driver.eval_videos_timeplex(tm, cfg, recs, streams=2, logger=LOG, max_frames=40)
    assert 40 <= len(got) < 102 and len(got) % 12 == 0
    assert_detections_same(got, {k: port_lsfa_dets[k] for k in got})
    _, _, _, rcfg, rm = rfcn
    got = driver.eval_videos_rfcn(rm, rcfg, recs, logger=LOG, max_frames=5)
    assert sorted(got) == list(range(5))
    assert threading.active_count() == before


def test_detection_cache_is_read_back_without_the_net(roidb, lsfa, rfcn, tmp_path,
                                                      port_lsfa_dets):
    """A cached run returns the pickle: no model is needed."""
    _, _, _, cfg, tm = lsfa
    cache = str(tmp_path / "cache" / "dets.pkl")
    first = driver.eval_videos(tm, cfg, roidb[0][:1], det_cache=cache, logger=LOG)
    assert os.path.exists(cache)
    assert_detections_same(first, {k: port_lsfa_dets[k] for k in range(36)})
    for loop in (driver.eval_videos, driver.eval_videos_timeplex, driver.eval_videos_rfcn):
        back = loop(None, cfg, roidb[0][:1], det_cache=cache, logger=LOG)
        assert back.keys() == first.keys()
        for k in first:
            for f in first[k]:
                np.testing.assert_array_equal(back[k][f], first[k][f])


def test_gop_eval_reason_and_buckets(roidb, lsfa, monkeypatch):
    """Each of the four reasons, as JAX gives them; an opened stream skips
    the gates on the file and the library; buckets by orientation."""
    jcfg, _, _, cfg, _ = lsfa
    rec = roidb[0][0]
    off_schedule = load_config(LSFA_CONFIG, overrides={"TEST": {"KEY_FRAME_INTERVAL": 24}})
    j_off = jax_load_config(LSFA_CONFIG, overrides={"TEST": {"KEY_FRAME_INTERVAL": 24}})
    cases = [(rec, cfg, jcfg, None),
             ({**rec, "video_path": None}, cfg, jcfg, "no compressed stream on disk"),
             ({**rec, "video_path": rec["video_path"] + ".absent"}, cfg, jcfg,
              "no compressed stream on disk"),
             (rec, off_schedule, j_off, "KEY_FRAME_INTERVAL=24 != GOP_SIZE=12"),
             ({**rec, "frame_seg_len": 11}, cfg, jcfg, "video shorter than one GOP (11 frames)")]
    for r, c, jc, reason in cases:
        got = driver._gop_eval_reason(r, c)
        assert got == jax_driver._gop_eval_reason(r, jc)
        assert got is None if reason is None else got.startswith(reason)
    opened = {"frame_seg_len": 36, "video_path": "any"}
    assert driver._gop_eval_reason(opened, cfg, opened=True) is None
    assert driver._gop_eval_reason(opened, off_schedule, opened=True).startswith(
        "KEY_FRAME_INTERVAL")
    assert driver._gop_eval_reason({**opened, "frame_seg_len": 3}, cfg,
                                   opened=True).startswith("video shorter")
    # a record of JPEG frames takes the per-frame path, whatever opens streams
    jpeg = {"frame_seg_len": 36, "pattern": "%06d.JPEG"}
    assert driver._gop_eval_reason(jpeg, cfg, opened=True) == jax_driver._gop_eval_reason(
        jpeg, jcfg) == "no compressed stream on disk"
    monkeypatch.setattr(driver, "prepared_available", lambda: False)
    assert driver._gop_eval_reason(rec, cfg) == "native prepared-decode plane not built"
    assert driver._gop_eval_reason(rec, cfg, opened=True) is None
    monkeypatch.undo()

    portrait = {**rec, "height": 128, "width": 96}
    unsized = {k: v for k, v in rec.items() if k not in ("height", "width")}
    recs = [rec, portrait, unsized]
    got = driver.group_videos_by_bucket(recs, cfg)
    assert got == jax_driver.group_videos_by_bucket(recs, jcfg)
    assert got == {(64, 112): [rec, unsized], (112, 64): [portrait]}
    with pytest.raises(ValueError, match="no height and width"):
        driver.group_videos_by_bucket([{"vid_path": "x"}], cfg)
    with pytest.raises(FileNotFoundError):
        driver.group_videos_by_bucket([{"vid_path": "x", "pattern": "/nonexistent/%06d.JPEG"}], cfg)
    # a record of JPEG frames without a size is sized from its first image
    tall = {"vid_path": "t", "pattern": "tall_%06d.JPEG"}
    got = driver.group_videos_by_bucket([tall], cfg, read_image=lambda p: np.zeros((128, 96, 3)))
    assert got == {(112, 64): [tall]}


def test_a_fallen_back_video_runs_frame_by_frame(roidb, lsfa, port_lsfa_dets):
    """A video shorter than one GOP takes the per-frame path from its
    first frame (flag 0, then 2), as the first frames of a GOP do."""
    _, _, _, cfg, tm = lsfa
    short = {**roidb[0][0], "frame_seg_len": 5}
    got = driver.eval_videos(tm, cfg, [short], logger=LOG)
    assert sorted(got) == list(range(5))
    for k in got:
        np.testing.assert_array_equal(got[k]["labels"], port_lsfa_dets[k]["labels"])
        np.testing.assert_allclose(got[k]["scores"], port_lsfa_dets[k]["scores"], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def jpeg_record(tmp_path_factory):
    """A video of 14 JPEG frames (128x96, written by PIL from a clip that
    ``data.synth.render_video`` draws) and no compressed stream."""
    from PIL import Image

    from lsfa_tpu_torch.data.synth import render_video

    d = tmp_path_factory.mktemp("jpeg_video")
    frames, _ = render_video(128, 96, 14, np.random.default_rng(5))
    for fid, f in enumerate(frames):
        Image.fromarray(f[:, :, ::-1]).save(d / f"{fid:06d}.JPEG", quality=90)
    return {"vid_path": "jpeg", "frame_seg_len": 14, "pattern": str(d / "%06d.JPEG"),
            "height": 96, "width": 128}


def test_eval_videos_over_jpeg_frames_matches_jax(roidb, lsfa, jpeg_record):
    """A roidb that mixes a decoded clip (GOP windows, then its tail frame
    by frame) and a record of JPEG frames (every frame through the host
    chain, zero MV and residual, flag 0 then 2, 1 at frame 12): JAX's
    detections."""
    jcfg, jm, v, cfg, tm = lsfa
    recs = [roidb[0][2], jpeg_record]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_driver, "StreamingDetector", ExactJaxStreamingDetector)
        want = jax_driver.eval_videos(jm, v, jcfg, recs, logger=LOG)
    got = driver.eval_videos(tm, cfg, recs, logger=LOG)
    assert sorted(got) == list(range(30 + 14))
    assert_detections_close(got, want)
