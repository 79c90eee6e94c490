"""The batched-GOP graph of the port against the JAX package: one key frame
and N-1 frames in one forward (LSFA.forward_batch_gop), detection over
unbatched maps (eval.detector.detect_single), and the port's demo
(experiments/demo_batch.py) over a SyntheticVideoReader GOP and over a
clip the native encoder writes.

The tiny LSFA and its weights are test_torch_slice's (DCN on, float32,
the rfcn_cls kernel spread so that float noise reorders no class score).
Both packages take the same raw resized BGR uint8 frames: the JAX demo
normalizes its frames before forward_batch_gop normalizes them again,
which the port's demo does not copy, so the JAX side here is
forward_batch_gop itself. Tolerances: each map within 2e-5 of its
largest |value| (float32, sums reassociated: uint8 noise frames drive the
tiny trunk's feature to ~290, where the port is 3.7e-6 of it from JAX and
the fg probabilities 9.1e-6 of 1); on valid detection rows labels equal,
scores 1e-4, boxes
within test_torch_slice.BOX_REL of the frame's largest coordinate (see the
float64 evidence there). JAX's detection runs op by op (see
test_torch_slice).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsfa_tpu.data.image import pad_to_bucket as jax_pad_to_bucket
from lsfa_tpu.data.image import resize as jax_resize
from lsfa_tpu.eval.detector import detect_batch as jax_detect_batch
from lsfa_tpu.eval.detector import detect_single as jax_detect_single
from lsfa_tpu.ops.anchors import anchor_grid
from lsfa_tpu_torch.data import coviar
from lsfa_tpu_torch.data.loader import SyntheticVideoReader
from lsfa_tpu_torch.eval.detector import anchors_for, detect_single, detection_kwargs
from lsfa_tpu_torch.experiments import demo_batch
from tests.test_torch_slice import BOX_REL, FH, FW, H, W, models  # noqa: F401

MAP_REL = 2e-5
JSON_CONFIG = os.path.join(os.path.dirname(__file__), "..", "lsfa_tpu_torch", "configs",
                           "lsfa_tiny_smoke.json")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def jax_anchors(cfg):
    n = cfg.network
    return jnp.asarray(anchor_grid(FH, FW, n.RPN_FEAT_STRIDE, tuple(n.ANCHOR_RATIOS),
                                   tuple(n.ANCHOR_SCALES)))


def assert_detections_match(dets, valid, want, want_valid):
    """(N, M, 6) detections and (N, M) validity against JAX's."""
    dets, valid = np.asarray(dets), np.asarray(valid)
    want, want_valid = np.asarray(want), np.asarray(want_valid)
    np.testing.assert_array_equal(valid, want_valid)
    assert valid.any(axis=-1).all()
    for d, v, w in zip(dets, valid, want):
        np.testing.assert_array_equal(d[v][:, 0], w[v][:, 0])
        np.testing.assert_allclose(d[v][:, 1], w[v][:, 1], rtol=0, atol=1e-4)
        mag = float(np.abs(w[v][:, 2:]).max())
        np.testing.assert_allclose(d[v][:, 2:], w[v][:, 2:], rtol=0, atol=BOX_REL * mag)


def test_forward_batch_gop_and_detect_single_match_jax(models):  # noqa: F811
    jcfg, jm, v, cfg, tm = models
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (4, H, W, 3), dtype=np.uint8)
    want = jm.apply(v, jnp.asarray(frames[:1]), jnp.asarray(frames[1:]),
                    method=jm.forward_batch_gop)
    with torch.no_grad():
        got = tm.forward_batch_gop(t(frames[:1]), t(frames[1:]))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape[0] == 4, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=MAP_REL * np.abs(w).max(),
                                   err_msg=k)

    kw = detection_kwargs(cfg)
    info = np.asarray([60.0, 104.0, 0.5], np.float32)
    anchors = anchors_for(cfg, (H, W), "cpu")
    keys = ("rpn_fg", "rpn_deltas", "rfcn_cls_map", "rfcn_bbox_map")
    dets, valid, jdets, jvalid = [], [], [], []
    for i in range(4):
        d, ok = detect_single(*(got[k][i] for k in keys), anchors, t(info), **kw)
        with jax.disable_jit():
            jd, jok = jax_detect_single(*(want[k][i] for k in keys), jax_anchors(jcfg),
                                        jnp.asarray(info), **kw)
        assert d.shape == (kw["max_per_image"], 6) and ok.shape == (kw["max_per_image"],)
        dets.append(d.numpy()), valid.append(ok.numpy())
        jdets.append(np.asarray(jd)), jvalid.append(np.asarray(jok))
    assert_detections_match(np.stack(dets), np.stack(valid), np.stack(jdets), np.stack(jvalid))


def test_demo_batch_over_synthetic_reader(models, capsys):  # noqa: F811
    """main over the third GOP of a 30-frame SyntheticVideoReader stream
    at 120x208 (a partial GOP of 6 frames: load() per position): the raw
    frames it ships equal JAX's resize, rounding and bucket padding, and
    its detections equal JAX's forward_batch_gop with JAX's detection on
    them; one line per frame."""
    jcfg, jm, v, cfg, tm = models
    reader = SyntheticVideoReader("clip.mp4", 120, 208, num_frames=30)
    dets, valid = demo_batch.main(["--cfg", JSON_CONFIG, "--video", "clip.mp4", "--gop", "2",
                                   "--device", "cpu"],
                                  open_video=lambda path: reader, model=tm)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"frame {i}: {int(n)} detections" for i, n in enumerate(valid.sum(1))]
    assert len(lines) == 6 and tuple(dets.shape) == (6, cfg.TEST.max_per_image, 6)

    raw = np.stack([reader.load(2, pos, 0) for pos in range(6)])
    frames = []
    for f in raw:
        im_r, scale = jax_resize(f.astype(np.float32), *jcfg.SCALES[0])
        frames.append(jax_pad_to_bucket(np.clip(np.round(im_r), 0, 255).astype(np.uint8)[None],
                                        (H, W)))
    frames = np.concatenate(frames)
    batch, info = demo_batch.prepare_gop(raw, cfg, (H, W))
    np.testing.assert_array_equal(batch, frames)
    np.testing.assert_array_equal(info, np.asarray([60.0, 104.0, 0.5], np.float32))
    out = jm.apply(v, jnp.asarray(frames[:1]), jnp.asarray(frames[1:]),
                   method=jm.forward_batch_gop)
    with jax.disable_jit():
        jd, jok = jax_detect_batch(out, jax_anchors(jcfg), jnp.asarray(info),
                                   **detection_kwargs(cfg))
    assert_detections_match(dets, valid, jd, jok)


def test_demo_batch_synthesized_clip(models, tmp_path, capsys, monkeypatch):  # noqa: F811
    """--synthesize writes a 24-frame 320x240 clip with the native encoder
    and main reads its first GOP through the native decoder (decode_gop):
    12 frames of detections equal to detect_gop on the decoded frames.
    Where the library does not load, --synthesize raises, naming
    open_video."""
    _, _, _, cfg, tm = models
    path = str(tmp_path / "clip.mp4")
    args = ["--cfg", JSON_CONFIG, "--video", path, "--synthesize", "--device", "cpu"]
    with monkeypatch.context() as m:
        m.setattr(coviar, "available", lambda: False)
        with pytest.raises(RuntimeError, match="open_video"):
            demo_batch.main(args, model=tm)
    if not coviar.available():
        pytest.skip("native coviar plane not built (needs FFmpeg's libraries)")
    dets, valid = demo_batch.main(args, model=tm)
    assert len(capsys.readouterr().out.strip().splitlines()) == 12
    frames = coviar.VideoReader(path).decode_gop(0)[0]
    assert frames.shape == (12, 240, 320, 3)
    want = demo_batch.detect_gop(tm, cfg, *demo_batch.prepare_gop(frames, cfg, (H, W)))
    for a, b in zip((dets, valid), want):
        assert torch.equal(a, b)
