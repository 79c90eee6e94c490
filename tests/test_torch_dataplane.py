"""The port's data plane against the JAX package's, on decoded clips.

``lsfa_tpu_torch/data/{coviar,image,oracle_flow,synth}.py`` are copies of
numpy-only modules, and ``data/loader.py``'s PreparedVideo and EvalLoader
re-state JAX's over them, so everything is held bit for bit: the same
MPEG-4 clip (``encode_test_video``, 30 frames of 128x96 in GOPs of 12, the
tiny 64x112 bucket) goes through both packages' readers and loaders. The
JAX side ships float32 MV/residual grids (``tpu.mv_res_dtype``), as the
port always does. The decoding cases skip where the native library does
not load (it needs FFmpeg's libraries).

The port's own parts are checked here too: SyntheticPreparedVideo (the
seeded stand-in for a decoded video, same shapes and dtypes as a real
one), the error without the library, EvalLoader's host chain for frames
past the stream's end (against JAX's) and its refusal of a record without
a stream, DevicePrefetcher and PhaseTimer.
"""

import os
import threading

import numpy as np
import pytest
import torch

from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.data import coviar as jax_coviar
from lsfa_tpu.data import image as jax_image
from lsfa_tpu.data import loader as jax_loader
from lsfa_tpu.data import oracle_flow as jax_oracle_flow
from lsfa_tpu.data import synth as jax_synth
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.data import coviar, image, loader, oracle_flow, synth
from lsfa_tpu_torch.data.prefetch import DevicePrefetcher
from lsfa_tpu_torch.utils.profiler import PhaseTimer

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONFIG = os.path.join(ROOT, "configs", "lsfa_tiny_smoke.yaml")
BUCKET = (64, 112)
N_FRAMES = 30


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 30-frame 128x96 MPEG-4 clip: two whole GOPs and a tail of 6."""
    if not coviar.available():
        pytest.skip("native coviar plane not built (needs FFmpeg's libraries)")
    path = str(tmp_path_factory.mktemp("dataplane") / "clip.mp4")
    coviar.encode_test_video(path, n_frames=N_FRAMES, w=128, h=96, gop_size=12, seed=3)
    return path


def configs(**tpu):
    """(port config, JAX config) of the tiny model with `tpu` overrides."""
    over = {"tpu": tpu} if tpu else None
    jcfg = jax_load_config(CONFIG, overrides=over)
    jcfg.tpu.mv_res_dtype = "float32"
    return load_config(CONFIG, overrides=over), jcfg


def assert_tuples_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}[{i}]: {g.dtype} {g.shape}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")


def test_library_path_resolves():
    """The copy sits as deep as the original, so its relative path still
    ends at the committed library."""
    assert os.path.abspath(coviar._LIB_PATHS[0]) == os.path.join(
        ROOT, "native", "coviar", "libcoviar_tpu.so")
    assert coviar.available() == jax_coviar.available()
    assert loader.prepared_available() == jax_loader.prepared_available()
    assert loader.GOP_SIZE == jax_loader.GOP_SIZE == 12


def test_video_reader_matches_jax(clip):
    ours, theirs = coviar.VideoReader(clip), jax_coviar.VideoReader(clip)
    for f in ("num_frames", "num_gops", "width", "height"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert (ours.num_frames, ours.num_gops, ours.height, ours.width) == (N_FRAMES, 3, 96, 128)
    assert coviar.get_num_frames(clip) == N_FRAMES and coviar.get_num_gops(clip) == 3
    for g in range(3):
        assert ours.gop_frames(g) == theirs.gop_frames(g)
        assert_tuples_equal(ours.decode_gop(g), theirs.decode_gop(g), f"decode_gop({g})")
        for kw in (dict(), dict(frames_mode=1, payload_fmt="i420", small_src="yuv", res_src="yuv"),
                   dict(frames_mode=1, legacy_swap=True, stride=16, small_factor=2)):
            args = (g, BUCKET, 60, 104, [103.06, 115.9, 123.15], 0.5)
            assert_tuples_equal(ours.decode_gop_prepared(*args, **kw),
                                theirs.decode_gop_prepared(*args, **kw),
                                f"decode_gop_prepared({g}, {kw})")
    for rep in (0, 1, 2):
        np.testing.assert_array_equal(coviar.load(clip, 1, 5, rep), jax_coviar.load(clip, 1, 5, rep))
    for cur, flip in ((0, False), (7, False), (17, True), (29, False)):
        args = (cur, BUCKET, 60, 104, [0.0, 0.0, 0.0])
        got, want = (r.decode_train_sample(*args, flip=flip) for r in (ours, theirs))
        assert got[-1] == want[-1] == cur % 12
        assert_tuples_equal(got[:-1], want[:-1], f"decode_train_sample({cur})")
    assert sorted(ours.prof_read()) == sorted(theirs.prof_read())
    with pytest.raises(IndexError):
        ours.decode_gop(3)
    with pytest.raises(ValueError, match="require payload_fmt='i420'"):
        ours.decode_gop_prepared(0, BUCKET, 60, 104, [0.0, 0.0, 0.0], small_src="yuv")
    with pytest.raises(IOError, match="cannot open video"):
        coviar.VideoReader(clip + ".absent")


def test_encoders_match_jax(clip, tmp_path):
    """Both bindings drive the same encoder: equal bytes."""
    theirs = str(tmp_path / "theirs.mp4")
    jax_coviar.encode_test_video(theirs, n_frames=N_FRAMES, w=128, h=96, gop_size=12, seed=3)
    with open(clip, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    frames = np.random.default_rng(0).integers(0, 256, (12, 32, 48, 3), dtype=np.uint8)
    paths = [str(tmp_path / f"{n}.mp4") for n in ("a", "b")]
    coviar.encode_frames(paths[0], frames, gop_size=6, bit_rate=200_000)
    jax_coviar.encode_frames(paths[1], frames, gop_size=6, bit_rate=200_000)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert coviar.get_num_frames(paths[0]) == 12


@pytest.mark.parametrize("frames_mode", [0, 1, None])
@pytest.mark.parametrize("src", ["bgr", "yuv"])
@pytest.mark.parametrize("payload", ["bgr8", "i420"])
def test_prepared_video_matches_jax(clip, payload, src, frames_mode):
    """gop and frame tuples bit for bit, whatever the wire format, the
    sources of the smalls and residuals, and the frames mode."""
    cfg, jcfg = configs(frame_payload=payload, small_src=src, res_src=src)
    ours = loader.PreparedVideo(clip, cfg, BUCKET, frames_mode=frames_mode)
    theirs = jax_loader.PreparedVideo(clip, jcfg, BUCKET, frames_mode=frames_mode)
    assert ours.num_frames == theirs.num_frames == N_FRAMES
    assert ours.wire_format == theirs.wire_format
    assert ours.wire_format == ("i420" if payload == "i420" and frames_mode != 0 else "bgr8")
    for g in (0, 2, 1):
        got = ours.gop(g)
        assert_tuples_equal(got, theirs.gop(g), f"gop({g})")
        assert got[2].dtype == got[3].dtype == np.float32
        assert ours.gop(g) is got                      # served from the one-GOP cache
    for fid in (0, 5, 12, 29):
        got = ours.frame(fid)
        assert_tuples_equal(got, theirs.frame(fid), f"frame({fid})")
        assert got[0].shape[0] == 1 and got[4].shape == (1, 3)


@pytest.mark.parametrize("wire_fmt", ["bgr8", "i420"])
def test_prepared_video_wire_override_and_legacy_swap(clip, wire_fmt):
    over = {"network": {"res_diff_legacy_swap": True}, "tpu": {"small_src": "bgr"}}
    cfg = load_config(CONFIG, overrides=over)
    jcfg = jax_load_config(CONFIG, overrides=over)
    jcfg.tpu.mv_res_dtype = "float32"
    ours = loader.PreparedVideo(clip, cfg, BUCKET, wire_fmt=wire_fmt)
    theirs = jax_loader.PreparedVideo(clip, jcfg, BUCKET, wire_fmt=wire_fmt)
    assert ours.wire_format == theirs.wire_format == wire_fmt
    assert_tuples_equal(ours.gop(1), theirs.gop(1), "gop(1)")
    plain = loader.PreparedVideo(clip, load_config(CONFIG), BUCKET, wire_fmt=wire_fmt).gop(1)
    assert not np.array_equal(plain[3], ours.gop(1)[3])          # the swap reaches the residual


def test_image_helpers_match_jax():
    rng = np.random.default_rng(0)
    buckets = [(608, 1024), (1024, 608), (608, 960), (64, 112)]
    for h, w in [(96, 128), (128, 96), (576, 960), (720, 1280), (1080, 1920), (480, 640), (1, 3)]:
        for target, cap in ((600, 1000), (60, 104)):
            assert image.resized_dims(h, w, target, cap) == jax_image.resized_dims(h, w, target, cap)
            try:
                want = jax_image.pick_bucket(h, w, buckets, target, cap)
            except ValueError:
                with pytest.raises(ValueError, match="no bucket"):
                    image.pick_bucket(h, w, buckets, target, cap)
            else:
                assert image.pick_bucket(h, w, buckets, target, cap) == want
    assert image.pick_bucket(576, 960, buckets, 600, 1000) == (608, 1024)
    frames = rng.integers(0, 256, (3, 16, 24, 3), dtype=np.uint8)
    frames[0] = 0
    got = image.bgr_to_i420(frames)
    np.testing.assert_array_equal(got, jax_image.bgr_to_i420(frames))
    assert got.shape == (3, 24, 24, 1) and got.dtype == np.uint8
    assert np.all(got[0, :16] == 16) and np.all(got[0, 16:] == 128)


def test_oracle_flow_matches_jax():
    """The analytic motion grids on a rendered clip's recorded state."""
    state: dict = {}
    jax_synth.render_video(128, 96, 24, np.random.default_rng(4), zoom=0.15, pan_speed=3.0,
                           record_state=state)
    for flip in (False, True):
        got = oracle_flow.oracle_mv_grid(state, 17, 12, 4, 7, 0.625, 16, (96, 128), flip=flip)
        want = jax_oracle_flow.oracle_mv_grid(state, 17, 12, 4, 7, 0.625, 16, (96, 128), flip=flip)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32 and np.abs(got).max() > 0
    mv = np.random.default_rng(5).normal(0, 1, (12, 4, 7, 2)).astype(np.float32)
    got = oracle_flow.substitute_gop_mv(mv, state, 12, 0.625, 16, (96, 128))
    np.testing.assert_array_equal(
        got, jax_oracle_flow.substitute_gop_mv(mv, state, 12, 0.625, 16, (96, 128)))
    assert not got[0].any() and got[1:].any()


def test_synth_dataset_matches_jax(tmp_path):
    """render_video draws the same clip; make_synth_vid_dataset writes the
    same streams, records and annotations, oracle states included, and a
    PreparedVideo given a record's oracle state serves JAX's MV grids."""
    a = synth.render_video(64, 48, 6, np.random.default_rng(9), n_distractors=2, occluders=1,
                           motion_blur=True, flicker=0.05)
    b = jax_synth.render_video(64, 48, 6, np.random.default_rng(9), n_distractors=2, occluders=1,
                               motion_blur=True, flicker=0.05)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]
    assert synth.NUM_SYNTH_CLASSES == jax_synth.NUM_SYNTH_CLASSES
    if not coviar.available():
        pytest.skip("native coviar plane not built (needs FFmpeg's libraries)")
    kw = dict(n_videos=2, n_frames=14, seed=5, sizes=((128, 96),), gop_size=12, split="val",
              oracle=True)
    ours = synth.make_synth_vid_dataset(str(tmp_path / "ours"), **kw)
    theirs = jax_synth.make_synth_vid_dataset(str(tmp_path / "theirs"), **kw)
    again = synth.make_synth_vid_dataset(str(tmp_path / "ours"), **kw)       # from the cache
    for got in (ours, again):
        for g_recs, w_recs in zip(got[:2], theirs[:2]):
            assert len(g_recs) == len(w_recs)
            for g, w in zip(g_recs, w_recs):
                assert sorted(g) == sorted(w)
                for k in w:
                    if k in ("video_path", "pattern", "image"):
                        assert os.path.basename(g[k]) == os.path.basename(w[k])
                    elif k == "oracle":
                        for s in w[k]:
                            np.testing.assert_array_equal(g[k][s], w[k][s])
                    else:
                        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert got[2].keys() == theirs[2].keys()
        for i, anno in theirs[2].items():
            for k in anno:
                np.testing.assert_array_equal(got[2][i][k], anno[k])
    for g, w in zip(ours[1], theirs[1]):
        with open(g["video_path"], "rb") as fa, open(w["video_path"], "rb") as fb:
            assert fa.read() == fb.read()
    cfg, jcfg = configs()
    rec = ours[1][0]
    got = loader.PreparedVideo(rec["video_path"], cfg, BUCKET, oracle=rec["oracle"]).gop(0)
    want = jax_loader.PreparedVideo(rec["video_path"], jcfg, BUCKET, oracle=rec["oracle"]).gop(0)
    assert_tuples_equal(got, want, "oracle gop(0)")
    assert not np.array_equal(got[2], loader.PreparedVideo(rec["video_path"], cfg, BUCKET).gop(0)[2])


def items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("full_frames", [False, True])
def test_eval_loader_matches_jax(clip, full_frames):
    """Flags 0/1/2 by the key schedule, a partial-GOP tail record starting
    at _tail_start, and full-res frames for single-frame detectors."""
    cfg, jcfg = configs()
    roidb = [{"vid_path": "a", "video_path": clip, "frame_seg_len": N_FRAMES},
             {"vid_path": "b", "video_path": clip, "frame_seg_len": N_FRAMES, "_tail_start": 24}]
    got = list(loader.EvalLoader(roidb, cfg, bucket_hw=BUCKET, full_frames=full_frames))
    want = list(jax_loader.EvalLoader(roidb, jcfg, bucket_hw=BUCKET, full_frames=full_frames))
    assert len(got) == len(want) == N_FRAMES + 6
    for g, w in zip(got, want):
        items_equal(g, w)
    assert [i["flag"] for i in got[:14]] == [0] + [2] * 11 + [1, 2]
    assert [(i["video_index"], i["frame_id"], i["flag"]) for i in got[N_FRAMES:]] == [
        (1, 24, 1)] + [(1, f, 2) for f in range(25, 30)]
    assert got[1]["data"].shape == ((1, 64, 112, 3) if full_frames else (1, 96, 112, 1))
    assert got[1]["data"].any() == full_frames         # key-only mode leaves non-key slots zero
    default = loader.EvalLoader(roidb, cfg)
    assert default.bucket_hw == BUCKET and default.key_interval == 12


def test_eval_loader_refuses_the_host_chain(clip, tmp_path):
    """Frames past the stream's end go through read_image (the JPEG
    reader by default) and the host image chain, in the stream's wire
    format, as JAX's do; so does every frame of a record without a stream
    (JPEG frames), in BGR, bit for bit JAX's payloads; a missing JPEG
    raises."""
    from PIL import Image

    cfg, jcfg = configs()
    pattern = str(tmp_path / "%06d.JPEG")
    rng = np.random.default_rng(8)
    for fid in (N_FRAMES, N_FRAMES + 1):
        Image.fromarray(rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)).save(pattern % fid)
    long = [{"vid_path": "a", "video_path": clip, "frame_seg_len": N_FRAMES + 2,
             "_tail_start": 28, "pattern": pattern}]
    for full_frames, fmt in ((False, (1, 96, 112, 1)), (True, (1, 64, 112, 3))):
        got = list(loader.EvalLoader(long, cfg, bucket_hw=BUCKET, full_frames=full_frames))
        want = list(jax_loader.EvalLoader(long, jcfg, bucket_hw=BUCKET, full_frames=full_frames))
        assert [i["frame_id"] for i in got] == [28, 29, 30, 31]
        for g, w in zip(got, want):
            items_equal(g, w)
        assert got[-1]["data"].shape == fmt and not got[-1]["motion_vector"].any()
    jpegs = str(tmp_path / "jpeg_%06d.JPEG")
    for fid in range(14):
        Image.fromarray(rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)).save(jpegs % fid)
    bare = [{"vid_path": "b", "frame_seg_len": 14, "pattern": jpegs}]
    got = list(loader.EvalLoader(bare, cfg, bucket_hw=BUCKET))
    want = list(jax_loader.EvalLoader(bare, jcfg, bucket_hw=BUCKET))
    assert [i["flag"] for i in got] == [0] + [2] * 11 + [1, 2]
    for g, w in zip(got, want):
        items_equal(g, w)
    assert got[0]["data"].shape == (1, 64, 112, 3) and not got[5]["motion_vector"].any()
    missing = [{"vid_path": "c", "frame_seg_len": 3, "pattern": "/nonexistent/%06d.JPEG"}]
    with pytest.raises(FileNotFoundError):
        next(iter(loader.EvalLoader(missing, cfg, bucket_hw=BUCKET)))


def synthetic(cfg, **kw):
    return loader.SyntheticPreparedVideo("synthetic", cfg, BUCKET, num_frames=N_FRAMES,
                                         content_hw=(60, 80), im_scale=0.625, **kw)


@pytest.mark.parametrize("frames_mode,wire_fmt,fmt", [(None, None, "i420"), (0, None, "bgr8"),
                                                      (1, "bgr8", "bgr8")])
def test_synthetic_prepared_video_has_a_real_ones_shapes(clip, frames_mode, wire_fmt, fmt):
    cfg, _ = configs()
    real = loader.PreparedVideo(clip, cfg, BUCKET, frames_mode=frames_mode, wire_fmt=wire_fmt)
    fake = synthetic(cfg, frames_mode=frames_mode, wire_fmt=wire_fmt)
    assert fake.wire_format == real.wire_format == fmt
    assert fake.num_frames == real.num_frames
    for g in (0, 2):                                    # GOP 2 is the short tail
        got, want = fake.gop(g), real.gop(g)
        assert [(x.shape, x.dtype) for x in got] == [(x.shape, x.dtype) for x in want]
        assert got[0].shape[0] == (12 if g == 0 else 6)
        np.testing.assert_array_equal(got[4], want[4])   # im_info of the same content and scale
        if frames_mode != 0:                            # key-only: non-key slots stay zero
            assert not got[0][1:].any() and not want[0][1:].any()
        assert got[0][0].any() and not got[2][0].any() and not got[3][0].any()
    for fid in (0, 7, 29):
        assert [(x.shape, x.dtype) for x in fake.frame(fid)] == [
            (x.shape, x.dtype) for x in real.frame(fid)]
    with pytest.raises(IndexError):
        fake.gop(3)


def test_synthetic_prepared_video_is_seeded():
    """A GOP depends on (seed, index) only; the default seed on the path;
    the pad past the content is the decoder's."""
    cfg, _ = configs()
    a, b = synthetic(cfg, seed=1), synthetic(cfg, seed=1)
    first = [x.copy() for x in a.gop(1)]
    a.gop(0)
    assert_tuples_equal(a.gop(1), first, "gop(1) again")
    assert_tuples_equal(b.gop(1), first, "gop(1) of a second handle")
    assert not np.array_equal(synthetic(cfg, seed=2).gop(1)[1], first[1])
    p, q, r = (loader.SyntheticPreparedVideo(n, cfg, BUCKET) for n in ("x", "x", "y"))
    assert_tuples_equal(p.gop(0), q.gop(0), "same path")
    assert not np.array_equal(p.gop(0)[1], r.gop(0)[1])
    assert p.num_frames > 10 ** 6 and p.gop(1000)[0].shape[0] == 12
    frames, smalls = first[0], first[1]                  # i420 at 64x112, content 60x80
    assert frames.shape == (12, 96, 112, 1) and smalls.shape == (12, 24, 28, 1)
    assert np.all(frames[0, 60:64] == 16) and np.all(frames[0, :64, 80:] == 16)
    assert np.all(smalls[:, 15:16] == 16) and np.all(smalls[:, 16:, 10:14] == 128)
    bgr = synthetic(cfg, seed=1, frames_mode=0).gop(0)[0]
    assert bgr.shape == (12, 64, 112, 3) and not bgr[:, 60:].any() and bgr[:, :60, :80].any()
    with pytest.raises(ValueError, match="oracle"):
        loader.SyntheticPreparedVideo("x", cfg, BUCKET, oracle={})
    items = list(loader.EvalLoader(
        [{"video_path": "x", "frame_seg_len": 14}], cfg, bucket_hw=BUCKET,
        open_video=loader.SyntheticPreparedVideo))
    assert [i["flag"] for i in items] == [0] + [2] * 11 + [1, 2]


def test_without_the_library_the_data_plane_raises(monkeypatch, tmp_path):
    """No synthetic fallback: the error names the library and the FFmpeg
    libraries it needs."""
    monkeypatch.setattr(coviar, "_lib", lambda: None)
    cfg, _ = configs()
    assert not coviar.available() and not loader.prepared_available()
    for call in (lambda: loader.PreparedVideo("clip.mp4", cfg, BUCKET),
                 lambda: coviar.VideoReader("clip.mp4"),
                 lambda: coviar.encode_test_video(str(tmp_path / "x.mp4")),
                 lambda: coviar.encode_frames(str(tmp_path / "x.mp4"),
                                              np.zeros((1, 2, 2, 3), np.uint8)),
                 lambda: next(iter(loader.EvalLoader(
                     [{"video_path": "clip.mp4", "frame_seg_len": 1}], cfg, BUCKET)))):
        with pytest.raises(RuntimeError, match=r"libcoviar_tpu\.so.*libavcodec\.so\.59"):
            call()


def test_device_prefetcher_moves_items_and_surfaces_errors():
    def items(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise KeyError("planted")
            yield {"frame_id": i, "data": np.full((1, 2, 2, 3), i, np.uint8),
                   "mv": torch.full((1, 2), float(i))}

    before = threading.active_count()
    with DevicePrefetcher(items(5), "cpu", depth=2) as pf:
        got = list(pf)
        with pytest.raises(StopIteration):
            next(pf)
    assert [g["frame_id"] for g in got] == list(range(5))
    for i, g in enumerate(got):
        assert isinstance(g["data"], torch.Tensor) and g["data"].dtype == torch.uint8
        assert int(g["data"].max()) == i and float(g["mv"][0, 0]) == i
    with DevicePrefetcher(items(5, fail_at=2), "cpu") as pf:
        assert [next(pf)["frame_id"] for _ in range(2)] == [0, 1]
        with pytest.raises(KeyError, match="planted"):
            next(pf)
        with pytest.raises(StopIteration):
            next(pf)
    pf = DevicePrefetcher(items(1000), "cpu", depth=2)   # a consumer that stops early
    assert next(pf)["frame_id"] == 0
    pf.close()
    assert not pf._thread.is_alive()
    assert threading.active_count() == before


def test_phase_timer():
    timer = PhaseTimer()
    assert timer.summary() == "no frames"
    for _ in range(2):
        with timer.phase("data"):
            pass
        with timer.phase("net"):
            pass
        timer.tick()
    with pytest.raises(ZeroDivisionError), timer.phase("post"):
        1 / 0
    assert list(timer.totals) == ["data", "net", "post"] and timer.count == 2
    assert all(v >= 0 for v in timer.totals.values())
    assert timer.summary().startswith("per-tick: data ") and "over 2 ticks" in timer.summary()
