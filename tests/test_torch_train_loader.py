"""The port's training feed (``lsfa_tpu_torch/data/loader.py``:
`load_pair_sample`, `zero_residual_grid`, `TrainLoader`) against
``lsfa_tpu.data.loader`` on a tiny synthetic VID dataset
(``make_synth_vid_dataset``, landscape and portrait clips) and two DET
JPEGs.

The JAX side ships float32 MV/residual grids (``tpu.mv_res_dtype``), as
the port always does, and the loaders run one worker (with more, which
worker draws for which batch is a race in both packages). The native fast
path is held bit for bit; the host chain resizes without PIL in the port,
within 2 float32 ulps of the largest magnitude (equal on this host).
Decoding cases skip where the native library does not load.
"""

import os
import threading
import time

import numpy as np
import pytest
from PIL import Image

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.data import loader as jax_loader
from lsfa_tpu.data.dataset import append_flipped as jax_append_flipped
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.data import coviar, loader, synth
from lsfa_tpu_torch.data.dataset import append_flipped

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONFIG = os.path.join(ROOT, "configs", "lsfa_tiny_smoke.yaml")
BUCKETS = {False: (64, 112), True: (112, 64)}       # by portrait


def configs(**over):
    """(port config, JAX config) of the tiny model with overrides."""
    jcfg = jax_load_config(CONFIG, overrides=over or None)
    jcfg.tpu.mv_res_dtype = "float32"
    return load_config(CONFIG, overrides=over or None), jcfg


def assert_samples_close(got, want, exact):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if exact or not np.issubdtype(w.dtype, np.floating) or not w.size:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            tol = 2 * np.spacing(np.float32(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(frame roidb of two 14-frame clips with oracle states, DET records
    of two JPEGs written with PIL)."""
    if not coviar.available():
        pytest.skip("native coviar plane not built (needs FFmpeg's libraries)")
    root = tmp_path_factory.mktemp("trainfeed")
    frames, _, _ = synth.make_synth_vid_dataset(str(root), n_videos=2, n_frames=14, seed=5,
                                                sizes=((128, 96), (96, 128)), oracle=True)
    rng = np.random.default_rng(6)
    det = []
    for i, (h, w) in enumerate(((75, 100), (100, 75))):
        path = str(root / f"det{i}.JPEG")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
        det.append({"image": path, "height": h, "width": w, "flipped": False,
                    "boxes": np.asarray([[4.0, 5.0, 40.0, 50.0]], np.float32),
                    "gt_classes": np.asarray([3], np.int32)})
    return frames, det


def portrait(rec):
    return rec["height"] > rec["width"]


@pytest.mark.parametrize("oracle", [False, True])
def test_fast_path_matches_jax(data, oracle):
    """The native one-call sample, same seed: a key frame, mid-GOP frames,
    the last GOP, flipped copies; with network.oracle_mv the generator's
    flow replaces the decoded MV grid."""
    frames, _ = data
    cfg, jcfg = configs()
    cfg.network.oracle_mv = jcfg.network.oracle_mv = oracle       # read with getattr
    recs = append_flipped([frames[i] for i in (0, 5, 12, 13, 16, 27)])
    jrecs = jax_append_flipped([frames[i] for i in (0, 5, 12, 13, 16, 27)])
    for i, (rec, jrec) in enumerate(zip(recs, jrecs)):
        bucket = BUCKETS[portrait(rec)]
        got = loader.load_pair_sample(rec, cfg, np.random.default_rng(i), bucket_hw=bucket)
        want = jax_loader.load_pair_sample(jrec, jcfg, np.random.default_rng(i), bucket_hw=bucket)
        assert_samples_close(got, want, exact=True)


def test_host_chain_matches_jax(data):
    """No bucket: the host chain, same seed. A JPEG record, a frame past
    the stream's end (read through its JPEG), flipped records (the MV's x
    sign), and the eq flags at GOP starts and mid-GOP with the reference
    offset forced to 0 and to -9."""
    frames, det = data
    past_end = dict(frames[3], frame_seg_id=14, frame_seg_len=15, image=det[0]["image"],
                    height=75, width=100)
    recs = [det[0], det[1], past_end] + [frames[i] for i in (0, 5, 12, 13, 20)]
    recs += append_flipped([frames[5], frames[20]])[2:]
    seen = set()
    for offset in (0, -9):
        cfg, jcfg = configs(TRAIN={"MIN_OFFSET": offset, "MAX_OFFSET": offset})
        for i, rec in enumerate(recs):
            got = loader.load_pair_sample(rec, cfg, np.random.default_rng(i))
            want = jax_loader.load_pair_sample(rec, jcfg, np.random.default_rng(i))
            assert_samples_close(got, want, exact=False)
            seen.add((got["eq_flag"], got["eq_flag_old"]))
    assert seen == {(1.0, 0.0), (0.0, 1.0), (0.0, 0.0)}


@pytest.mark.parametrize("legacy_swap", [False, True])
def test_zero_residual_grid_matches_jax(legacy_swap):
    for shape, info in (((4, 7, 3), (60, 80, 0.6)), ((7, 4, 3), (104, 58, 1.0))):
        np.testing.assert_array_equal(
            loader.zero_residual_grid(shape, info, (103.06, 115.9, 123.15), 1.0, 16, legacy_swap),
            jax_loader.zero_residual_grid(shape, info, (103.06, 115.9, 123.15), 1.0, 16,
                                          legacy_swap))


@pytest.mark.parametrize("grouping", [True, False])
def test_train_loader_matches_jax(data, grouping):
    """Batches of 2 over two buckets (landscape and portrait, video and
    DET records): the same keys, shapes, order and values."""
    frames, det = data
    cfg, jcfg = configs(TRAIN={"ASPECT_GROUPING": grouping})
    roidb = frames + det
    got = list(loader.TrainLoader(roidb, cfg, 2, seed=3, num_workers=1))
    want = list(jax_loader.TrainLoader(roidb, jcfg, 2, seed=3, num_workers=1))
    assert len(got) == len(want) == len(loader.TrainLoader(roidb, cfg, 2)) == 14
    assert {b["data"].shape for b in got} == {(2, 64, 112, 3), (2, 112, 64, 3)}
    for g, w in zip(got, want):
        assert_samples_close(g, w, exact=False)


def test_ranks_split_the_global_batch(data):
    """world_size 2: every rank plans the same epoch; rank r's batch is rows
    [r, r + 1) of the world-1 batch (with no random draw left to differ:
    one scale, a fixed reference offset)."""
    frames, det = data
    cfg, _ = configs(TRAIN={"MIN_OFFSET": -3, "MAX_OFFSET": -3})
    roidb = frames + det
    whole = list(loader.TrainLoader(roidb, cfg, 2, seed=3, num_workers=1))
    parts = [loader.TrainLoader(roidb, cfg, 2, seed=3, num_workers=2, rank=r, world_size=2)
             for r in range(2)]
    assert len(parts[0]) == len(parts[1]) == len(whole)
    ranks = [list(p) for p in parts]
    for b, r0, r1 in zip(whole, *ranks):
        for k in b:
            np.testing.assert_array_equal(np.concatenate([r0[k], r1[k]]), b[k], err_msg=k)
        assert not np.array_equal(r0["gt_boxes"], r1["gt_boxes"])
    with pytest.raises(ValueError):
        loader.TrainLoader(roidb, cfg, 3, world_size=2)


def synthetic_roidb(n, h=96, w=128):
    return [{"image": f"v/{i:06d}.JPEG", "pattern": "v/%06d.JPEG", "video_path": f"v{i % 2}.mp4",
             "frame_seg_id": i % 12, "frame_seg_len": 12, "height": h, "width": w,
             "flipped": False, "boxes": np.asarray([[2.0, 3.0, 50.0, 60.0]], np.float32),
             "gt_classes": np.asarray([1], np.int32)} for i in range(n)]


def opener(h=96, w=128, fail_on=None):
    def open_video(path):
        if path == fail_on:
            raise ValueError(f"cannot open {path}")
        return loader.SyntheticVideoReader(path, h, w, num_frames=12)
    return open_video


def wait_for_threads(before, timeout=10.0):
    end = time.monotonic() + timeout
    while threading.active_count() > before and time.monotonic() < end:
        time.sleep(0.02)
    return threading.active_count()


def test_worker_errors_reach_the_consumer_and_threads_end():
    """A reader's exception is raised by the iterator; the workers end when
    it is raised, and when an iterator is closed after one batch."""
    cfg, _ = configs()
    before = threading.active_count()
    bad = loader.TrainLoader(synthetic_roidb(8), cfg, 2, num_workers=2,
                             open_video=opener(fail_on="v1.mp4"))
    with pytest.raises(ValueError, match="cannot open v1.mp4"):
        list(bad)
    assert wait_for_threads(before) == before
    it = iter(loader.TrainLoader(synthetic_roidb(16), cfg, 2, num_workers=2,
                                 open_video=opener()))
    first = next(it)
    assert first["data"].shape == (2, 64, 112, 3) and np.isfinite(first["res_diff"]).all()
    it.close()
    assert wait_for_threads(before) == before


def test_many_workers_give_the_one_worker_batches():
    """16 workers (more than the cores) under a short switch interval take
    batches from one queue and hand them back through another: every
    batch comes once, in plan order, equal to the one-worker loader's
    (a fixed reference offset leaves no draw to differ)."""
    import sys

    cfg, _ = configs(TRAIN={"MIN_OFFSET": -2, "MAX_OFFSET": -2})
    roidb = synthetic_roidb(48, h=48, w=64)
    want = list(loader.TrainLoader(roidb, cfg, 2, seed=4, num_workers=1, open_video=opener(48, 64)))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        got = list(loader.TrainLoader(roidb, cfg, 2, seed=4, num_workers=16, prefetch=2,
                                      open_video=opener(48, 64)))
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_synthetic_video_reader_is_seeded():
    r = loader.SyntheticVideoReader("a.mp4", 20, 36, num_frames=14)
    assert r.get_num_frames() == 14
    frame, mv, res = (r.load(1, 1, k) for k in range(3))
    assert frame.dtype == np.uint8 and frame.shape == (20, 36, 3)
    assert mv.shape == (20, 36, 2) and res.shape == (20, 36, 3) and mv.any() and res.any()
    assert not r.load(1, 0, 1).any() and not r.load(1, 0, 2).any()     # the GOP's I-frame
    np.testing.assert_array_equal(loader.SyntheticVideoReader("a.mp4", 20, 36).load(1, 1, 1), mv)
    with pytest.raises(IndexError):
        r.load(1, 2, 0)                                                # frame 14 of 14


def test_video_record_without_a_reader_raises(monkeypatch):
    """No stream: FileNotFoundError as JAX's; no native library and no
    open_video: the port raises where JAX would read the JPEG."""
    cfg, _ = configs()
    rec = dict(synthetic_roidb(1)[0], video_path=None)
    with pytest.raises(FileNotFoundError, match="compressed stream"):
        loader.load_pair_sample(rec, cfg, np.random.default_rng(0))
    monkeypatch.setattr(coviar, "available", lambda: False)
    with pytest.raises(RuntimeError, match="pass open_video"):
        loader.load_pair_sample(synthetic_roidb(1)[0], cfg, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="pass open_video"):
        next(iter(loader.TrainLoader(synthetic_roidb(2), cfg, 1, num_workers=1)))
