"""Lockstep lane batching of the port against the JAX package's.

The tiny float32 LSFA of tests/test_torch_eval_loops.py (flax weights
carried across by convert.flax_to_torch, rfcn_cls redrawn so scores have
no ties; JAX's steps compiled with XLA's algsimp pass off) runs B lanes:

  * `StreamingDetector(batch=2).process_frame` over key, non-key, a key
    step at which one lane restarts (is_first) and another non-key step,
    against JAX's: valid masks equal, the valid rows within rtol 1e-4 and
    atol 1e-4 (tests/test_streaming.py:199-202);
  * the lane-batched GOP step (B=2, G=2, n=3, each lane its own inputs and
    im_info) against per-frame streaming at batch B and against JAX's lane
    scan; each lane of a B=3 run against its own single-lane run (scores
    within 1e-5, boxes within 1e-5 of the frame's largest coordinate);
  * `build_lane_playlists` equal to JAX's, `MultiStreamEvalLoader`'s
    batches bit-equal to JAX's on decoded clips (one wire format; pooled
    decode equal to serial) and over `SyntheticPreparedVideo` streams;
  * `eval_videos_lanes` against JAX's on decoded clips (labels equal,
    scores 1e-4, boxes 1e-2, tests/test_torch_eval_loops.py's) and
    against the port's `eval_videos` on every frame but a partial GOP's
    tail, which `eval_videos` restarts and the lanes carry on, as in JAX;
  * `lsfa_test --lanes 2 --mesh 2` as two processes of a gloo group
    against the unsharded run; `bench --multistream` on the CPU;
  * `eval_videos_lanes(over_ranks=True)` over two spawned gloo ranks
    (``tools.dryrun_multihost.run_lanes``): 4 lanes over
    SyntheticPreparedVideo streams, each rank's frames its block of
    `build_lane_playlists` and its lanes (the detector's carry) 2; 2 lanes
    on decoded clips against JAX's `eval_videos_lanes` over a mesh of two
    of the virtual CPU devices (labels equal, scores 1e-4, boxes 1e-2).

Lanes against a run of the same frames at another batch size (a lane
against its single-lane run, `eval_videos_lanes` against `eval_videos`,
a lane per rank against two lanes in one process) are held at the
lanes' tolerance: labels and valid rows equal, scores within 1e-5, boxes within
1e-5 of the frame's largest coordinate. tests/test_timeplex.py's (scores
1e-6 relative) does not hold: torch's CPU convolutions round a frame
differently at another batch size, key frames included (batch 2 against
1). Measured for `eval_videos_lanes` against `eval_videos` over the
decoded clips: scores within 1.2e-6, boxes within 1.8e-6 of the largest
coordinate.

The tests that decode skip where the native library does not load.
"""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

from chip_smoke import write_vid_tree
import jax
import jax.numpy as jnp

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.eval import driver as jax_driver
from lsfa_tpu.eval import multistream as jax_multistream
from lsfa_tpu.eval.tester import StreamingDetector as JaxStreamingDetector
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu.parallel.mesh import make_mesh
from lsfa_tpu_torch import bench
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.data import coviar
from lsfa_tpu_torch.data.loader import SyntheticPreparedVideo
from lsfa_tpu_torch.eval import driver, multistream
from lsfa_tpu_torch.eval.tester import StreamingDetector
from lsfa_tpu_torch.experiments import lsfa_test
from lsfa_tpu_torch.models.lsfa import lsfa_from_config
from lsfa_tpu_torch.tools.dryrun_multihost import run_lanes
from tests.test_torch_convert import perturb, to_numpy
from tests.test_torch_convert import two_torch_threads  # noqa: F401  (a fixture)
from tests.test_torch_eval_loops import (  # noqa: F401  (roidb: a fixture)
    BUCKET, LOG, LSFA_CONFIG, ExactJaxStreamingDetector, assert_detections_close, no_algsimp,
    roidb)
from tests.test_torch_slice import assert_boxes_close

pytestmark = pytest.mark.usefixtures("two_torch_threads")

H, W = BUCKET
FH, FW = H // 16, W // 16
TINY = os.path.join(os.path.dirname(__file__), "..", "lsfa_tpu_torch", "configs",
                    "lsfa_tiny_smoke.json")
INFO2 = np.asarray([[60.0, 104.0, 0.5], [56.0, 96.0, 0.45]], np.float32)


@pytest.fixture(scope="module")
def lsfa():
    """tests/test_torch_eval_loops.py's tiny LSFA, its flax init jitted
    (one program to compile, not one per op)."""
    jcfg = jax_load_config(LSFA_CONFIG)
    jcfg.tpu.mv_res_dtype = "float32"          # the port's payloads are float32
    jm = jax_lsfa_from_config(jcfg)
    d = jnp.zeros((1, H, W, 3))
    v = jax.jit(jm.init)(jax.random.PRNGKey(3), d, d, d, jnp.ones((1,)), jnp.ones((1,)),
                         jnp.zeros((1, FH, FW, 2)), jnp.zeros((1, FH, FW, 3)))
    v = perturb(to_numpy(v), 1)
    k = v["params"]["rfcn_cls"]["kernel"]
    v["params"]["rfcn_cls"]["kernel"] = (
        np.random.default_rng(2).normal(0, 0.05, k.shape).astype(np.float32))
    cfg = load_config(LSFA_CONFIG)
    tm = lsfa_from_config(cfg, device="cpu")
    tm.load_state_dict(flax_to_torch(v), strict=True)
    return jcfg, jm, v, cfg, tm.eval()


def frames(rng, b):
    """b raw BGR u8 frames with seeded content inside the bucket."""
    out = np.zeros((b, H, W, 3), np.uint8)
    out[:, :60, :104] = rng.integers(0, 256, (b, 60, 104, 3), dtype=np.uint8)
    return out


def assert_close_valid(got, want, rtol=1e-4, atol=1e-4):
    """(dets, valid) pairs: valid masks equal, valid rows close."""
    d, v = (np.asarray(x) for x in got)
    jd, jv = (np.asarray(x) for x in want)
    assert d.shape == jd.shape
    np.testing.assert_array_equal(v, jv)
    assert v.sum() > 0
    np.testing.assert_allclose(d[v], jd[jv], rtol=rtol, atol=atol)


def assert_detections_lanes(got, want):
    """Detection mappings at the lanes' tolerance (module docstring)."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        np.testing.assert_array_equal(g["labels"], w["labels"], err_msg=f"frame {k}")
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5,
                                   err_msg=f"frame {k}")
        if len(w["boxes"]):
            np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0,
                                       atol=1e-5 * np.abs(w["boxes"]).max(), err_msg=f"frame {k}")


def assert_lane_close(got, want):
    """(dets, valid) of a lane and of its single-lane run: valid masks and
    labels equal, scores within 1e-5, boxes within 1e-5 of the frame's
    largest coordinate."""
    d, v = (np.asarray(x) for x in got)
    jd, jv = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(v, jv)
    assert v.sum() > 0
    np.testing.assert_array_equal(d[v][:, 0], jd[jv][:, 0])
    np.testing.assert_allclose(d[v][:, 1], jd[jv][:, 1], rtol=0, atol=1e-5)
    assert_boxes_close(d, v, jd, jv)


@pytest.mark.parametrize("lengths,lanes,interval", [
    ((36, 36, 30), 2, 12), ((36,), 4, 12), ((5, 40, 13, 24, 7), 3, 12), ((10, 3, 9), 2, 4),
    ((12, 12), 5, 6)])
def test_build_lane_playlists_matches_jax(lengths, lanes, interval):
    roidb = [{"frame_seg_len": n} for n in lengths]
    got = multistream.build_lane_playlists(roidb, lanes, interval)
    assert got == jax_multistream.build_lane_playlists(roidb, lanes, interval)
    assert len(got) == lanes and all(len(p) % interval == 0 for p in got)
    real = sorted((vi, fid) for p in got for vi, fid, r in p if r)
    assert real == [(vi, f) for vi, n in enumerate(lengths) for f in range(n)]


def test_process_frame_lanes_match_jax(lsfa):
    """Flags 0, 2, 1 with lane 0 restarting (is_first [1, 0]), 2; each lane
    its own frames, MVs and im_info. The restarted lane equals a fresh
    single-lane stream's first frame."""
    jcfg, jm, v, cfg, tm = lsfa
    jdet = ExactJaxStreamingDetector(jm, v, jcfg, BUCKET, batch=2)
    tdet = StreamingDetector(tm, cfg, BUCKET, batch=2)
    rng = np.random.default_rng(7)
    for flag, is_first in ((0, None), (2, None), (1, np.asarray([1.0, 0.0], np.float32)),
                           (2, None)):
        data = frames(rng, 2)
        kw = {}
        if flag == 2:
            kw = {"small": rng.integers(0, 256, (2, H // 4, W // 4, 3), dtype=np.uint8),
                  "motion_vector": rng.normal(0, 1.0, (2, FH, FW, 2)).astype(np.float32),
                  "res_diff": rng.normal(0, 10, (2, FH, FW, 3)).astype(np.float32)}
        want = jdet.process_frame(data, INFO2, flag=flag, is_first=is_first, **kw)
        got = tdet.process_frame(data, INFO2, flag=flag, is_first=is_first, **kw)
        assert got[0].shape == (2, 20, 6)
        assert_close_valid(got, want)
        np.testing.assert_allclose(tdet.feat_key.numpy(), np.asarray(jdet.feat_key),
                                   rtol=1e-3, atol=1e-3)
        if is_first is not None:
            fresh = StreamingDetector(tm, cfg, BUCKET).process_frame(data[:1], INFO2[:1], flag=0)
            assert_lane_close((got[0][:1], got[1][:1]), fresh)
    assert tdet.frame_id == jdet.frame_id == 4


def test_lane_gop_step_equals_streaming_and_jax(lsfa):
    """The lane-batched GOP step folds (n, B) n-major: a fold by lane, or
    lane 0's im_info for every lane, would pair frames with the wrong key
    feature or scale. Held against per-frame streaming at batch B (the
    counterpart of tests/test_streaming.py:205, at its tolerance) and
    against JAX's lane scan."""
    jcfg, jm, v, cfg, tm = lsfa
    b, g, n = 2, 2, 3
    rng = np.random.default_rng(21)
    keys = np.stack([frames(rng, b) for _ in range(g)])
    smalls = rng.integers(0, 256, (g, n, b, H // 4, W // 4, 3), dtype=np.uint8)
    mvs = rng.normal(0, 0.5, (g, n, b, FH, FW, 2)).astype(np.float32)
    ress = rng.normal(0, 5, (g, n, b, FH, FW, 3)).astype(np.float32)
    det = StreamingDetector(tm, cfg, BUCKET, batch=b)
    stream = []
    for gi in range(g):
        stream.append(det.process_frame(keys[gi], INFO2, flag=0 if gi == 0 else 1))
        for i in range(n):
            stream.append(det.process_frame(None, INFO2, mvs[gi, i], ress[gi, i], flag=2,
                                            small=smalls[gi, i]))
    det.reset()
    kd, kv, cd, cv = det.process_gops(keys, smalls, mvs, ress, INFO2, first=True)
    assert tuple(kd.shape) == (g, b, 20, 6) and tuple(cd.shape) == (g, n, b, 20, 6)
    assert det.frame_id == g * (1 + n)
    jdet = ExactJaxStreamingDetector(jm, v, jcfg, BUCKET, batch=b)
    jkd, jkv, jcd, jcv = jdet.process_gops(keys, smalls, mvs, ress, INFO2, first=True)
    for gi in range(g):
        assert_close_valid((kd[gi], kv[gi]), stream[gi * (n + 1)], rtol=1e-3, atol=1e-2)
        assert_close_valid((kd[gi], kv[gi]), (jkd[gi], jkv[gi]))
        for i in range(n):
            assert_close_valid((cd[gi, i], cv[gi, i]), stream[gi * (n + 1) + 1 + i],
                               rtol=1e-3, atol=1e-2)
            assert_close_valid((cd[gi, i], cv[gi, i]), (jcd[gi, i], jcv[gi, i]))


def test_each_lane_equals_its_single_lane_run(lsfa):
    """Three streams of other seeds (I420 SyntheticPreparedVideo payloads)
    as the lanes of one detector, two GOPs: each lane's key and non-key
    detections equal its own stream's single-lane run."""
    _, _, _, cfg, tm = lsfa
    pvs = [SyntheticPreparedVideo(f"lane{s}", cfg, BUCKET, num_frames=24, seed=30 + s,
                                  content_hw=(60, 104), im_scale=0.5 + 0.1 * s)
           for s in range(3)]
    lane_gops = [[pv.gop(g) for g in range(2)] for pv in pvs]
    keys, smalls, mvs, ress, info = multistream.stack_lane_gops(lane_gops)
    assert keys.shape == (2, 3, H * 3 // 2, W, 1) and mvs.shape == (2, 11, 3, FH, FW, 2)
    det = StreamingDetector(tm, cfg, BUCKET, batch=3)
    kd, kv, cd, cv = det.process_gops(keys, smalls, mvs, ress, info, first=True)
    single = StreamingDetector(tm, cfg, BUCKET)
    for lane, gops in enumerate(lane_gops):
        single.reset()
        skd, skv, scd, scv = single.process_prepared_window(gops, first=True)
        assert_lane_close((kd[:, lane], kv[:, lane]), (skd[:, 0], skv[:, 0]))
        assert_lane_close((cd[:, :, lane], cv[:, :, lane]), (scd, scv))
    with pytest.raises(ValueError, match="one lane"):
        det.process_prepared_window(lane_gops[0])


def test_lt_off_restarts_every_lane(lsfa):
    """Under lt_off a key step restarts every lane, whatever is_first says."""
    _, _, _, cfg, tm = lsfa
    rng = np.random.default_rng(8)
    a, b = frames(rng, 2), frames(rng, 2)
    off = StreamingDetector(tm, cfg, BUCKET, batch=2, lt_off=True)
    off.process_frame(a, INFO2, flag=0)
    got = off.process_frame(b, INFO2, flag=1, is_first=np.zeros(2, np.float32))
    want = StreamingDetector(tm, cfg, BUCKET, batch=2).process_frame(b, INFO2, flag=0)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def synthetic_roidb(lengths, stream_lengths=None):
    """Records of SyntheticPreparedVideo streams (`stream_lengths` frames,
    default the records') and their open_video."""
    stream_lengths = stream_lengths or lengths
    roidb = [{"vid_path": f"v{i}", "video_path": f"v{i}.mp4", "frame_seg_len": n,
              "pattern": f"v{i}/%06d.JPEG", "height": 60, "width": 104}
             for i, n in enumerate(lengths)]
    opener = functools.partial(SyntheticPreparedVideo, content_hw=(60, 104))

    def open_video(path, *args, **kw):
        return opener(path, *args, num_frames=stream_lengths[int(path[1:-4])], **kw)

    return roidb, open_video


def test_loader_over_open_video_serves_every_lane_one_format():
    """open_video over SyntheticPreparedVideo streams: every lane takes the
    stream's own payloads in I420; a frame past a stream's end comes from
    read_image through the host chain, packed to I420; a record of JPEG
    frames makes the whole run BGR."""
    cfg = load_config(TINY)
    roidb, open_video = synthetic_roidb([24, 13, 12], stream_lengths=[24, 12, 12])
    read = []

    def read_image(path):
        read.append(path)
        return np.full((60, 104, 3), 90.0, np.float32)

    loader = multistream.MultiStreamEvalLoader(roidb, cfg, lanes=2, open_video=open_video,
                                               read_image=read_image)
    assert loader._wire == "i420" and loader.n_steps == 36
    items = list(loader)
    # lane 0 plays v0 then v2; lane 1 plays v1 (13 frames, padded to 24),
    # then idles on its last frame, the 13th, which its stream lacks
    assert len(items) == 36 and set(read) == {"v1/000012.JPEG"} and len(read) == 24
    assert items[12]["lane_meta"] == [(0, 12, True), (1, 12, True)]
    assert items[24]["lane_meta"] == [(2, 0, True), (1, 12, False)]
    assert items[35]["lane_meta"] == [(2, 11, True), (1, 12, False)]
    for t, first in ((0, [1, 1]), (12, [0, 0]), (24, [1, 0])):
        np.testing.assert_array_equal(items[t]["is_first"], first)
    streams = [open_video(r["video_path"], cfg, BUCKET, wire_fmt="i420") for r in roidb]
    for t, item in enumerate(items):
        assert item["flag"] == (0 if t == 0 else 1 if t % 12 == 0 else 2)
        assert (item["data"] is None) == (item["flag"] == 2)
        assert item["small"].shape == (2, H // 4 * 3 // 2, W // 4, 1)
        for lane, (vi, fid, real) in enumerate(item["lane_meta"]):
            if vi == 1 and fid == 12:
                continue                                # read_image's frame
            want = streams[vi].frame(fid)
            np.testing.assert_array_equal(item["small"][lane], want[1][0])
            np.testing.assert_array_equal(item["motion_vector"][lane], want[2][0])
            np.testing.assert_array_equal(item["im_info"][lane], want[4][0])
            if item["data"] is not None:
                np.testing.assert_array_equal(item["data"][lane], want[0][0])

    mixed = roidb[:1] + [{"vid_path": "jpeg", "frame_seg_len": 4, "pattern": "j/%06d.JPEG"}]
    loader = multistream.MultiStreamEvalLoader(mixed, cfg, lanes=2, open_video=open_video,
                                               read_image=read_image)
    assert loader._wire == "bgr8"
    assert next(iter(loader))["data"].shape == (2, H, W, 3)
    with pytest.raises(ValueError, match="divide"):
        multistream.MultiStreamEvalLoader(roidb, cfg, lanes=3, world=2)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Decoded-clip records for the loaders: 3 MPEG-4 videos of 24 frames
    at 96x56, the second with frame_seg_len 25 (its last frame a JPEG)."""
    if not coviar.available():
        pytest.skip("native coviar plane not built (needs FFmpeg's libraries)")
    from PIL import Image

    d = tmp_path_factory.mktemp("lane_clips")
    roidb = []
    for i, extra in enumerate((0, 1, 0)):
        vp = str(d / f"v{i}.mp4")
        coviar.encode_test_video(vp, n_frames=24, w=96, h=56, gop_size=12, seed=10 + i)
        jdir = d / f"jpg{i}"
        jdir.mkdir()
        for fid in range(24 + extra):
            Image.fromarray(np.full((56, 96, 3), 50 + 7 * fid, np.uint8)).save(
                jdir / f"{fid:06d}.JPEG")
        roidb.append({"frame_seg_len": 24 + extra, "video_path": vp,
                      "pattern": str(jdir / "%06d.JPEG")})
    return roidb


def test_loader_matches_jax_and_pooled_decode_equals_serial(clips, lsfa):
    """The counterparts of tests/test_payload_fmt.py:303 and :384: I420 for
    every lane, a tail frame past the stream packed to it; each batch
    bit-equal to JAX's loader's (the full-size frame on key steps only),
    and decode over 3 worker threads equal to the serial path."""
    jcfg, _, _, cfg, _ = lsfa

    def port_items(workers):
        cfg.tpu.decode_workers = workers
        try:
            return list(multistream.MultiStreamEvalLoader(clips, cfg, lanes=2, bucket_hw=BUCKET))
        finally:
            cfg.tpu.decode_workers = 0

    serial = port_items(0)
    want = list(jax_multistream.MultiStreamEvalLoader(clips, jcfg, lanes=2, bucket_hw=BUCKET))
    assert len(serial) == len(want) == 48
    for a, b in zip(serial, want):
        assert a["flag"] == b["flag"] and a["lane_meta"] == b["lane_meta"]
        np.testing.assert_array_equal(a["is_first"], b["is_first"])
        for k in ("small", "motion_vector", "res_diff", "im_info"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if a["flag"] in (0, 1):
            assert a["data"].shape == (2, H * 3 // 2, W, 1)
            np.testing.assert_array_equal(a["data"], b["data"])
    for a, b in zip(serial, port_items(3)):
        assert a["flag"] == b["flag"] and a["lane_meta"] == b["lane_meta"]
        for k in ("is_first", "data", "small", "motion_vector", "res_diff", "im_info"):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def jax_lanes(roidb, lsfa):
    """JAX's eval_videos_lanes (2 lanes) over the three decoded videos,
    over the first alone (an idle lane) and under max_frames=30."""
    jcfg, jm, v, _, _ = lsfa
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_multistream, "StreamingDetector", ExactJaxStreamingDetector)
        run = functools.partial(jax_driver.eval_videos_lanes, jm, v, jcfg, lanes=2, logger=LOG)
        return {"all": run(roidb[0]), "one": run(roidb[0][:1]),
                "cap": run(roidb[0], max_frames=30)}


@pytest.fixture(scope="module")
def port_whole(roidb, lsfa):
    _, _, _, cfg, tm = lsfa
    return driver.eval_videos(tm, cfg, roidb[0], logger=LOG)


def test_eval_videos_lanes_matches_jax_and_eval_videos(roidb, lsfa, jax_lanes, port_whole):
    _, _, _, cfg, tm = lsfa
    got = driver.eval_videos_lanes(tm, cfg, roidb[0], lanes=2, logger=LOG)
    assert sorted(got) == list(range(102))
    assert_detections_close(got, jax_lanes["all"])
    # the 30-frame video's partial-GOP tail (frames 96-101): eval_videos
    # restarts the stream there, the lanes carry the key feature on
    assert_detections_lanes({k: d for k, d in got.items() if k < 96},
                            {k: d for k, d in port_whole.items() if k < 96})


def test_eval_videos_lanes_idle_lanes_and_max_frames(roidb, lsfa, jax_lanes, port_whole,
                                                     tmp_path):
    """One video over 2 lanes (the idle lane replays it as padding); a
    frame cap of 30 charged as steps x lanes; the detection cache."""
    _, _, _, cfg, tm = lsfa
    got = driver.eval_videos_lanes(tm, cfg, roidb[0][:1], lanes=2, logger=LOG)
    assert sorted(got) == list(range(36))
    assert_detections_close(got, jax_lanes["one"])
    assert_detections_lanes(got, {k: port_whole[k] for k in range(36)})
    cache = str(tmp_path / "dets.pkl")
    got = driver.eval_videos_lanes(tm, cfg, roidb[0], lanes=2, logger=LOG, max_frames=30,
                                   det_cache=cache)
    assert sorted(got) == sorted(jax_lanes["cap"])
    assert len(got) == 30                          # 15 steps of lane 0's video and lane 1's
    assert_detections_close(got, jax_lanes["cap"])
    back = driver.eval_videos_lanes(None, cfg, roidb[0], lanes=2, det_cache=cache, logger=LOG)
    assert back.keys() == got.keys()
    for k in got:
        np.testing.assert_array_equal(back[k]["scores"], got[k]["scores"])


MESH_LENGTHS = {"a": 26, "b": 14, "c": 12}


def test_mesh_over_two_ranks_equals_the_unsharded_run(tmp_path):
    """`lsfa_test --lanes 2 --mesh 2` as two processes of a gloo group
    (torchrun's environment) over a VID tree of three encoded videos: rank
    0 prints the mAP and caches the detections of both ranks' lanes, which
    equal the unsharded lane run's; rank 1 prints none. A mesh without its
    process group is refused."""
    import json
    import subprocess
    import sys

    from lsfa_tpu_torch.tools.dryrun_multihost import free_port, tiny_model
    from lsfa_tpu_torch.train.checkpoint import save_checkpoint

    if not coviar.available():
        pytest.skip("native coviar plane not built (needs FFmpeg's libraries)")
    root = str(tmp_path)
    dataset_path = os.path.join(root, "ILSVRC2015")
    image_set = write_vid_tree(dataset_path, MESH_LENGTHS, 56, 96, seed=4)
    streams = os.path.join(dataset_path, "Data", "VID", "mpeg4_snippets", "val")
    os.makedirs(streams)
    for i, (name, n) in enumerate(MESH_LENGTHS.items()):
        coviar.encode_test_video(os.path.join(streams, f"{name}.mp4"), n_frames=n, w=96, h=56,
                                 gop_size=12, seed=20 + i)
    with open(TINY) as f:
        tree = json.load(f)
    paths = {}
    for tag in ("mesh", "whole"):
        tree.update(output_path=os.path.join(root, f"out_{tag}"))
        tree["dataset"].update(root_path=root, dataset_path=dataset_path,
                               test_image_set=image_set)
        tree["TEST"]["test_epoch"] = 0
        paths[tag] = os.path.join(root, f"{tag}.json")
        with open(paths[tag], "w") as f:
            json.dump(tree, f)
    cfg = load_config(paths["whole"])
    ckpt = os.path.join(root, "ckpt")
    save_checkpoint(ckpt, 0, tiny_model(cfg), None, None, 0, None)

    with pytest.raises(ValueError, match="process group of 2 ranks"):
        lsfa_test.run_test(cfg, ckpt_dir=ckpt, lanes=2, mesh_shape=2, device="cpu")
    want_map, _ = lsfa_test.run_test(cfg, ckpt_dir=ckpt, lanes=2, device="cpu")

    port = str(free_port())
    argv = [sys.executable, "-m", "lsfa_tpu_torch.experiments.lsfa_test", "--cfg",
            paths["mesh"], "--ckpt", ckpt, "--lanes", "2", "--mesh", "2", "--device", "cpu"]
    procs = [subprocess.Popen(argv, cwd=os.path.join(os.path.dirname(__file__), ".."),
                              env={**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                                   "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
                                   "OMP_NUM_THREADS": "1"},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert f"mAP@0.5 = {want_map:.4f}" in outs[0] and "mAP@0.5" not in outs[1]
    assert "1 on rank 1 of 2" in outs[1]

    def cached(tag):
        c = load_config(paths[tag])
        with open(os.path.join(c.output_path, c.symbol, image_set, "detections.pkl"), "rb") as f:
            return pickle.load(f)

    want = cached("whole")
    assert sorted(want) == list(range(sum(MESH_LENGTHS.values())))
    assert_detections_lanes(cached("mesh"), want)


def test_bench_multistream_on_the_cpu(capsys):
    """`--multistream 2` at bench.tiny_config() sizes under --device cpu:
    the cpu_smoke_ metric; each lane of its windows equals the single-lane
    run of that lane's inputs."""
    r = bench.main(["--multistream", "2", "--device", "cpu", "--cfg", TINY, "--trials", "1",
                    "--windows", "1"])
    assert r["metric"] == "cpu_smoke_lsfa_multistream_device_fps" and r["value"] > 0
    assert r["vs_baseline"] is None and "2 lockstep streams" in r["unit"]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        '{"metric": "cpu_smoke_lsfa_multistream_device_fps"')
    assert "--multistream" not in bench.NOT_CARRIED

    cfg, det = bench._build_detector(bench.tiny_config(), "cpu", lanes=2)
    windows = []
    bench.run_multistream(cfg, det, trials=1, windows=1, collect=windows)
    assert len(windows) == 1
    keys, smalls, mvs, ress, info = bench.multistream_inputs(cfg, 2)
    single = StreamingDetector(det.model, cfg, tuple(cfg.tpu.default_bucket))
    for lane in range(2):
        single.reset()
        want = single.process_gops(keys[:, lane:lane + 1], smalls[:, :, lane], mvs[:, :, lane],
                                   ress[:, :, lane], info[lane:lane + 1], first=True)
        kd, kv, cd, cv = windows[0]
        assert_lane_close((kd[:, lane], kv[:, lane]), (want[0][:, 0], want[1][:, 0]))
        assert_lane_close((cd[:, :, lane], cv[:, :, lane]), (want[2], want[3]))


def test_lanes_over_two_ranks_are_their_playlist_blocks(lsfa):
    """4 lanes over 2 spawned gloo ranks, SyntheticPreparedVideo streams of
    30, 24, 18 and 13 frames: each rank's stats name 2 lanes and its
    frames, the real frames of its block [2r, 2r + 2) of the global
    playlists; rank 1 returns exactly those frames, rank 0 every frame,
    each once. The same blocks in this process
    (`eval_videos_multistream(rank=r, world=2)`) report 2 lanes."""
    _, _, _, cfg, tm = lsfa
    lengths = (30, 24, 18, 13)
    roidb, _ = synthetic_roidb(list(lengths))
    opener = functools.partial(SyntheticPreparedVideo, content_hw=(60, 104))
    ranks = run_lanes({"cfg": cfg, "state": tm.state_dict(), "device": "cpu", "records": roidb,
                       "lanes": 4, "open_video": opener, "threads": 2}, 2, timeout=300)
    playlists = multistream.build_lane_playlists(roidb, 4, cfg.TEST.KEY_FRAME_INTERVAL)
    base, total = driver.frame_bases(roidb)
    for rank, out in enumerate(ranks):
        block = sorted(base[id(roidb[vi])] + fid for pl in playlists[2 * rank:2 * rank + 2]
                       for vi, fid, real in pl if real)
        (group,) = out["stats"]
        assert group["lanes"] == 2 and group["frames"] == block
        assert group["steps"] == max(len(p) for p in playlists)
        assert out["passes"] == 1 and out["launches"] == 0          # the plain NMS on the CPU
        stats = {}
        local = multistream.eval_videos_multistream(tm, cfg, roidb, lanes=4, logger=LOG,
                                                    bucket_hw=group["bucket"],
                                                    open_video=opener, rank=rank, world=2,
                                                    stats=stats)
        assert stats == {"steps": group["steps"], "lanes": 2}
        assert sorted(base[id(roidb[vi])] + fid for vi, fid in local) == block
    assert sorted(ranks[1]["dets"]) == ranks[1]["stats"][0]["frames"]
    assert sorted(ranks[0]["dets"]) == list(range(total)) == list(range(sum(lengths)))


class ExactJaxMeshDetector(JaxStreamingDetector):
    """ExactJaxStreamingDetector over a mesh: its steps compiled apart from
    the unsharded ones, since a step compiled for one device refuses
    lane-sharded arguments."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        for name in ("_scan_gops_step", "_key_step", "_cur_step"):
            setattr(self, name, no_algsimp(f"{name}@mesh{self.mesh.size}",
                                           getattr(self, name)))


def test_lanes_over_two_ranks_match_jax_mesh(roidb, lsfa):
    """The port's 2 lanes over two spawned gloo ranks, one lane each,
    against JAX's 2 lanes sharded over a mesh of two devices, on the
    three decoded videos: rank 0's merged mapping within
    tests/test_torch_eval_loops.py's tolerance of JAX's."""
    jcfg, jm, v, cfg, tm = lsfa
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_multistream, "StreamingDetector", ExactJaxMeshDetector)
        want = jax_driver.eval_videos_lanes(jm, v, jcfg, roidb[0], lanes=2, logger=LOG,
                                            mesh=make_mesh(2))
    ranks = run_lanes({"cfg": cfg, "state": tm.state_dict(), "device": "cpu",
                       "records": roidb[0], "lanes": 2, "open_video": None, "threads": 2},
                      2, timeout=300)
    assert [out["stats"][0]["lanes"] for out in ranks] == [1, 1]
    got = ranks[0]["dets"]
    assert sorted(got) == sorted(want) == list(range(102))
    assert_detections_close(got, want)

