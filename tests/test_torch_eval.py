"""Per-frame streaming and scoring of the port against the JAX package.

StreamingDetector.process_frame on the tiny LSFA (configs/lsfa_tiny_smoke
.yaml, float32; flax init, perturbed, rfcn_cls redrawn at std 0.05 so that
scores have no ties, carried across by convert.flax_to_torch) over the
flags 0, 2, 2, 1, 2: valid masks equal, sorted scores within 1e-4, and the
key-feature carry within 1e-3. JAX's key and non-key steps are compiled
with XLA's algsimp pass off, for the psroi_pool reason test_torch_slice
and test_torch_train_step give.

The numpy modules (eval/vid_eval.py, data/dataset.py, the helpers of
eval/driver.py) are copies, so they are held exactly equal to JAX's on
seeded detections and annotations and on a temporary ImageNet VID tree of
XML annotations.
"""

import importlib
import logging
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.data import dataset as jax_dataset
from lsfa_tpu.eval import driver as jax_driver
from lsfa_tpu.eval.tester import StreamingDetector as JaxStreamingDetector
from lsfa_tpu.eval.tester import collect_detections as jax_collect_detections
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.data import dataset
from lsfa_tpu_torch.eval import driver, vid_eval
from lsfa_tpu_torch.eval.tester import StreamingDetector, collect_detections
from lsfa_tpu_torch.models.lsfa import lsfa_from_config
from tests.test_data_pipeline import write_xml
from tests.test_torch_convert import perturb, to_numpy
from tests.test_torch_train_step import NO_ALGSIMP

# lsfa_tpu.eval re-exports the function vid_eval under the module's name
jax_vid_eval = importlib.import_module("lsfa_tpu.eval.vid_eval")
CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "lsfa_tiny_smoke.yaml")
H, W = 64, 112
FH, FW = H // 16, W // 16
SEG_LEN = 6


@pytest.fixture(scope="module")
def models():
    jcfg = jax_load_config(CONFIG)
    jcfg.tpu.mv_res_dtype = "float32"          # the port's payloads are float32
    jm = jax_lsfa_from_config(jcfg)
    d = jnp.zeros((1, H, W, 3))
    v = jm.init(jax.random.PRNGKey(3), d, d, d, jnp.ones((1,)), jnp.ones((1,)),
                jnp.zeros((1, FH, FW, 2)), jnp.zeros((1, FH, FW, 3)))
    v = perturb(to_numpy(v), 1)
    k = v["params"]["rfcn_cls"]["kernel"]
    v["params"]["rfcn_cls"]["kernel"] = (
        np.random.default_rng(2).normal(0, 0.05, k.shape).astype(np.float32))
    cfg = load_config(CONFIG)
    tm = lsfa_from_config(cfg, device="cpu")
    tm.load_state_dict(flax_to_torch(v), strict=True)
    return jcfg, jm, v, cfg, tm.eval()


def no_algsimp(step):
    """A jitted step compiled without algsimp, once per argument signature."""
    compiled = {}

    def call(*args):
        key = tuple((x.shape, x.dtype) for x in jax.tree.leaves(args))
        if key not in compiled:
            compiled[key] = step.lower(*args).compile(compiler_options=NO_ALGSIMP)
        return compiled[key](*args)

    return call


def test_process_frame_matches_jax(models):
    """Flags 0, 2, 2, 1, 2 of BGR u8 frames; the non-key frames give the
    small frame, leave it to the host block mean, and leave out the motion
    vectors and residuals (zeros) in turn."""
    jcfg, jm, v, cfg, tm = models
    jdet = JaxStreamingDetector(jm, v, jcfg, (H, W))
    jdet._key_step, jdet._cur_step = no_algsimp(jdet._key_step), no_algsimp(jdet._cur_step)
    tdet = StreamingDetector(tm, cfg, (H, W))
    rng = np.random.default_rng(7)
    info = np.asarray([[60.0, 104.0, 0.5]], np.float32)
    for flag, small_given, mv_given in ((0, None, None), (2, True, True), (2, False, True),
                                        (1, None, None), (2, True, False)):
        data = np.zeros((1, H, W, 3), np.uint8)
        data[:, :60, :104] = rng.integers(0, 256, (1, 60, 104, 3), dtype=np.uint8)
        kw = {}
        if flag == 2:
            if small_given:
                kw["small"] = rng.integers(0, 256, (1, H // 4, W // 4, 3), dtype=np.uint8)
            if mv_given:
                kw["motion_vector"] = rng.normal(0, 1.0, (1, FH, FW, 2)).astype(np.float32)
                kw["res_diff"] = rng.normal(0, 10, (1, FH, FW, 3)).astype(np.float32)
        want_d, want_v = (np.asarray(x) for x in jdet.process_frame(
            jnp.asarray(data), info, flag=flag, **{k: jnp.asarray(x) for k, x in kw.items()}))
        got_d, got_v = tdet.process_frame(data, info, flag=flag, **kw)
        assert got_d.shape == want_d.shape == (1, 20, 6)
        np.testing.assert_array_equal(got_v.numpy(), want_v, err_msg=f"flag {flag}")
        assert int(got_v.sum()) > 0
        np.testing.assert_allclose(np.sort(got_d[..., 1].numpy(), -1), np.sort(want_d[..., 1], -1),
                                   rtol=0, atol=1e-4, err_msg=f"flag {flag}")
        np.testing.assert_allclose(tdet.feat_key.numpy(), np.asarray(jdet.feat_key),
                                   rtol=1e-3, atol=1e-3)
    assert tdet.frame_id == jdet.frame_id == 5


def test_process_frame_default_flags_and_lt_off(models):
    """Without a flag the key-frame schedule picks 0, 2, ..., 1; under
    lt_off a flag-1 key frame restarts the recurrence, so it equals a
    flag-0 frame of a fresh stream."""
    _, _, _, cfg, tm = models
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (3, 1, H, W, 3), dtype=np.uint8)
    info = np.asarray([60.0, 104.0, 0.5], np.float32)
    det = StreamingDetector(tm, cfg, (H, W))
    flags = []
    for i in range(cfg.TEST.KEY_FRAME_INTERVAL + 1):
        flags.append(det.key_frame_flag(det.frame_id))
        det.process_frame(frames[i % 3], info)
    assert flags == [0] + [2] * (cfg.TEST.KEY_FRAME_INTERVAL - 1) + [1]
    off = StreamingDetector(tm, cfg, (H, W), lt_off=True)
    off.process_frame(frames[0], info, flag=0)
    a = off.process_frame(frames[1], info, flag=1)
    b = StreamingDetector(tm, cfg, (H, W)).process_frame(frames[1], info, flag=0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def seeded_detections(seed, n_frames=8, n_classes=6):
    """Detections and annotations with overlapping boxes, so that true and
    false positives, duplicates and misses all occur."""
    rng = np.random.default_rng(seed)
    dets, annos = {}, {}
    for i in range(n_frames):
        n = int(rng.integers(0, 5))
        x1, y1 = rng.uniform(0, 300, n), rng.uniform(0, 200, n)
        gt = np.stack([x1, y1, x1 + rng.uniform(4, 120, n), y1 + rng.uniform(4, 90, n)], 1)
        annos[i] = {"labels": rng.integers(1, n_classes, n), "boxes": gt.astype(np.float32)}
        m = int(rng.integers(0, 8))
        pick = rng.integers(0, max(n, 1), m)
        boxes = (gt[pick] if n else np.zeros((m, 4))) + rng.normal(0, 6, (m, 4))
        labels = (annos[i]["labels"][pick] if n else rng.integers(1, n_classes, m))
        labels = np.where(rng.uniform(size=m) < 0.2, rng.integers(1, n_classes, m), labels)
        dets[i] = {"labels": labels, "scores": rng.uniform(size=m),
                   "boxes": boxes.astype(np.float32)}
    return dets, annos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vid_eval_matches_jax(seed, tmp_path):
    """Per-class AP exactly equal, also through the text-file interface;
    adaptive thresholds and the AP integration exactly equal."""
    dets, annos = seeded_detections(seed)
    got = vid_eval.vid_eval(dets, annos, 6)
    want = jax_vid_eval.vid_eval(dets, annos, 6)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).sum() >= 2 and 0 < np.nanmax(got) <= 1
    path = tmp_path / "dets.txt"
    with open(path, "w") as f:
        for i, d in dets.items():
            for lbl, sc, b in zip(d["labels"], d["scores"], d["boxes"]):
                f.write(f"{i} {lbl} {sc:.6f} {b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f}\n")
    np.testing.assert_array_equal(vid_eval.vid_eval_files(str(path), annos, 6),
                                  jax_vid_eval.vid_eval_files(str(path), annos, 6))
    gt = np.concatenate([a["boxes"] for a in annos.values()])
    np.testing.assert_array_equal(vid_eval.adaptive_iou_threshold(gt),
                                  jax_vid_eval.adaptive_iou_threshold(gt))
    rec, prec = np.sort(np.random.default_rng(seed).uniform(size=(2, 9)), axis=1)
    assert vid_eval.vid_ap(rec, prec[::-1]) == jax_vid_eval.vid_ap(rec, prec[::-1])


def test_collect_detections_matches_jax():
    rng = np.random.default_rng(3)
    dets = rng.normal(0, 50, (1, 20, 6)).astype(np.float32)
    dets[..., 0] = rng.integers(1, 31, (1, 20))
    valid = rng.uniform(size=(1, 20)) < 0.6
    for d, v in ((dets, valid), (dets[0], valid[0])):
        got = collect_detections(torch.from_numpy(d), torch.from_numpy(v))
        want = jax_collect_detections(d, v)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k


@pytest.fixture()
def vid_tree(tmp_path):
    """Two VID videos and a DET image set: per-frame XML annotations (a
    class outside the 30 is skipped, one frame has no file, one box runs
    past the image), VID and DET image sets."""
    root = tmp_path / "data"
    dpath = root / "ILSVRC2015"
    rng = np.random.default_rng(5)
    wnids = [w for w, _ in dataset.VID_CLASSES]
    videos = ["val/vid_a", "val/vid_b"]
    for vid in videos:
        for fid in range(SEG_LEN):
            if vid == "val/vid_b" and fid == 3:
                continue                                    # no annotation file
            boxes = []
            for _ in range(int(rng.integers(1, 4))):
                x1, y1 = int(rng.integers(0, 100)), int(rng.integers(0, 60))
                boxes.append((wnids[int(rng.integers(0, 4))], x1, y1,
                              x1 + int(rng.integers(5, 80)), y1 + int(rng.integers(5, 60))))
            boxes.append(("n00000000", 1, 1, 20, 20))         # not a VID class
            boxes.append((wnids[0], 100, 70, 200, 150))       # clipped to the image
            write_xml(str(dpath / "Annotations" / "VID" / vid / f"{fid:06d}.xml"), 128, 96, boxes)
    write_xml(str(dpath / "Annotations" / "DET" / "train" / "det_0.xml"), 64, 48,
              [(wnids[1], 2, 3, 40, 30)])
    write_xml(str(dpath / "Annotations" / "DET" / "train" / "det_1.xml"), 64, 48, [])
    iset = dpath / "ImageSets"
    os.makedirs(iset)
    with open(iset / "VID_val_videos.txt", "w") as f:
        for i, vid in enumerate(videos):
            f.write(f"{vid} {i + 1} 0 {SEG_LEN}\n")
    with open(iset / "VID_val_frames.txt", "w") as f:
        for i, vid in enumerate(videos):
            for fid in range(SEG_LEN):
                f.write(f"{vid}/{fid:06d} {i * SEG_LEN + fid + 1}\n")
    with open(iset / "DET_train_30classes.txt", "w") as f:
        f.write("train/det_0 1\ntrain/det_1 2\n")
    return str(root), str(dpath), videos


def assert_roidb_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k


def test_imagenet_vid_roidb_matches_jax(vid_tree):
    """Index, paths and gt_roidb (with its cache) of VID and DET image
    sets, and append_flipped / merge_roidb / filter_roidb, equal JAX's."""
    root, dpath, _ = vid_tree
    roidbs = {}
    for image_set in ("VID_val_videos", "VID_val_frames", "DET_train_30classes"):
        ours = dataset.ImageNetVID(image_set, root, dpath)
        theirs = jax_dataset.ImageNetVID(image_set, root, dpath)
        assert ours._index == theirs._index and ours.num_images == theirs.num_images
        assert ours.classes == theirs.classes and ours.num_classes == theirs.num_classes == 31
        for e in ours._index:
            for f in ("image_path", "anno_path", "video_path"):
                assert getattr(ours, f)(e) == getattr(theirs, f)(e), f
        got = ours.gt_roidb()                  # writes the cache
        assert_roidb_equal(got, theirs.gt_roidb(use_cache=False))
        assert_roidb_equal(dataset.ImageNetVID(image_set, root, dpath).gt_roidb(), got)
        roidbs[image_set] = got
    assert any(len(r["boxes"]) == 0 for r in roidbs["DET_train_30classes"])
    merged = dataset.merge_roidb([roidbs["VID_val_videos"], roidbs["DET_train_30classes"]])
    assert_roidb_equal(merged, jax_dataset.merge_roidb(
        [roidbs["VID_val_videos"], roidbs["DET_train_30classes"]]))
    assert_roidb_equal(dataset.append_flipped(merged), jax_dataset.append_flipped(merged))
    assert_roidb_equal(dataset.filter_roidb(merged), jax_dataset.filter_roidb(merged))
    assert len(dataset.filter_roidb(merged)) == len(merged) - 1
    ours = dataset.ImageNetVID("VID_val_frames", root, dpath)
    assert ours.annotations_for_eval(roidbs["VID_val_frames"]).keys() == set(range(2 * SEG_LEN))


def test_evaluate_map_and_driver_helpers_match_jax(vid_tree, tmp_path):
    """evaluate_map over two videos' annotations equals JAX's (mean and
    per-class AP); shard_videos, frame_bases and the detection cache too."""
    root, dpath, videos = vid_tree
    video_roidb = [{"vid_path": v, "frame_seg_len": SEG_LEN} for v in videos]
    ours = dataset.ImageNetVID("VID_val_videos", root, dpath)
    theirs = jax_dataset.ImageNetVID("VID_val_videos", root, dpath)
    rng = np.random.default_rng(9)
    detections = {}
    idx = 0
    for rec in video_roidb:
        for fid in range(SEG_LEN):
            anno = ours._load_annotation({"path": rec["vid_path"], "frame_seg_id": fid})
            n = len(anno["boxes"])
            keep = rng.uniform(size=n) < 0.7
            boxes = anno["boxes"][keep] + rng.normal(0, 4, (int(keep.sum()), 4))
            extra = rng.uniform(0, 90, (2, 4)) + [0, 0, 20, 20]
            detections[idx] = {
                "labels": np.concatenate([anno["gt_classes"][keep], rng.integers(1, 5, 2)]),
                "scores": rng.uniform(size=int(keep.sum()) + 2),
                "boxes": np.concatenate([boxes, extra]).astype(np.float32)}
            idx += 1
    logger = logging.getLogger("torch_eval_test")
    logger.addHandler(logging.NullHandler())
    got_mean, got_ap = driver.evaluate_map(detections, ours, video_roidb, logger=logger)
    want_mean, want_ap = jax_driver.evaluate_map(detections, theirs, video_roidb, logger=logger)
    assert got_mean == want_mean and 0 < got_mean < 1
    np.testing.assert_array_equal(got_ap, want_ap)

    roidb = [{"frame_seg_len": n, "vid_path": f"v{i}"}
             for i, n in enumerate((100, 50, 50, 10, 73, 1))]
    for n in (1, 2, 3):
        assert driver.shard_videos(roidb, n) == jax_driver.shard_videos(roidb, n)
    assert driver.frame_bases(roidb) == jax_driver._frame_bases(roidb)
    cache = str(tmp_path / "cache" / "dets.pkl")
    assert driver.load_det_cache(cache, logger.info) is None
    driver.save_det_cache(cache, detections)
    for load in (driver.load_det_cache, jax_driver._load_det_cache):
        back = load(cache, logger.info)
        assert back.keys() == detections.keys()
        for i, d in detections.items():
            for k in d:
                np.testing.assert_array_equal(back[i][k], d[k])
