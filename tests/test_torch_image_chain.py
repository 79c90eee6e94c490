"""The port's host image chain (``lsfa_tpu_torch/data/image.py``) against
``lsfa_tpu.data.image``, which resizes with PIL.

The port computes Pillow's float bilinear filter in numpy. The outputs are
held within 2 float32 ulps of the output's largest magnitude (they are
equal bit for bit on this host's Pillow); `transform`,
`check_reconstruction` and `load_frame_triplet` (on a decoded clip) are
equal. The chain imports and runs with PIL blocked, as on a machine
without it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from lsfa_tpu.data import coviar as jax_coviar
from lsfa_tpu.data import image as jax_image
from lsfa_tpu_torch.data import coviar, image

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MEANS = (103.06, 115.9, 123.15)


def assert_close(got, want):
    """Equal shapes and dtypes, values within 2 float32 ulps of the
    output's largest magnitude."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    tol = 2 * np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# (image height, width, channels, target, max_size, stride)
RESIZES = [
    (96, 128, 3, 60, 104, 0),      # downscale, the long side capped
    (37, 61, 3, 600, 1000, 0),     # upscale from odd sizes
    (45, 71, 2, 40, 1000, 16),     # odd sizes, 2 channels, stride padding
    (128, 96, 3, 60, 104, 32),     # portrait, padded to 32
    (16, 128, 3, 60, 100, 0),      # 12.5 rows round half to even: 12
    (600, 1000, 3, 38, 63, 0),     # the feed's grid-sized downscale
]


@pytest.mark.parametrize("h,w,c,target,max_size,stride", RESIZES)
def test_resize_matches_pil(h, w, c, target, max_size, stride):
    rng = np.random.default_rng(h * w + c)
    im = rng.uniform(0, 255, (h, w, c)).astype(np.float32)
    got, scale = image.resize(im, target, max_size, stride)
    want, want_scale = jax_image.resize(im, target, max_size, stride)
    assert scale == want_scale
    assert_close(got, want)
    if (h, w) == (16, 128):
        assert got.shape[:2] == (12, 100)


def test_resize_of_a_uint8_frame_and_a_2d_array():
    rng = np.random.default_rng(1)
    frame = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    assert_close(image.resize(frame, 30, 1000)[0], jax_image.resize(frame, 30, 1000)[0])
    flat = rng.normal(0, 3, (33, 20)).astype(np.float32)
    assert_close(image._resize_np(flat, 13, 51), jax_image._resize_np(flat, 13, 51))


def test_transform_matches_jax():
    im = np.random.default_rng(2).uniform(0, 255, (20, 30, 3)).astype(np.float32)
    got = image.transform(im, MEANS, 0.5)
    np.testing.assert_array_equal(got, jax_image.transform(im, MEANS, 0.5))
    assert got.shape == (1, 20, 30, 3)


@pytest.mark.parametrize("legacy_swap", [False, True])
@pytest.mark.parametrize("h,w,scale", [(96, 128, 0.625), (75, 100, 1.6), (41, 67, 0.9)])
def test_transform_mv_res_matches_jax(h, w, scale, legacy_swap):
    rng = np.random.default_rng(h + w)
    mv = rng.integers(-9, 10, (h, w, 2)).astype(np.float32)
    res = rng.integers(-40, 41, (h, w, 3)).astype(np.float32)
    got = image.transform_mv_res(mv, res, scale, MEANS, 1.0, 16, legacy_swap=legacy_swap)
    want = jax_image.transform_mv_res(mv, res, scale, MEANS, 1.0, 16, legacy_swap=legacy_swap)
    for g, x in zip(got, want):
        assert_close(g, x)
    fh = int(np.ceil(round(h * scale) / 16))
    assert got[0].shape == (1, fh, got[0].shape[2], 2) and got[1].shape[-1] == 3


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 30-frame 128x96 MPEG-4 clip in GOPs of 12."""
    if not coviar.available():
        pytest.skip("native coviar plane not built (needs FFmpeg's libraries)")
    path = str(tmp_path_factory.mktemp("chain") / "clip.mp4")
    coviar.encode_test_video(path, n_frames=30, w=128, h=96, gop_size=12, seed=4)
    return path


def test_load_frame_triplet_and_reconstruction_match_jax(clip):
    for fid in (0, 5, 13, 29):
        got = image.load_frame_triplet(clip, fid)
        want = jax_image.load_frame_triplet(clip, fid)
        for g, x in zip(got, want):
            assert g.dtype == x.dtype == np.float32
            np.testing.assert_array_equal(g, x)
    key = jax_coviar.load(clip, 1, 0, 0)
    im, mv, res = (jax_coviar.load(clip, 1, 7, r) for r in range(3))
    for m in (mv, mv + 1):                  # a consistent triplet and a broken one
        assert image.check_reconstruction(key, im, m, res) == \
            jax_image.check_reconstruction(key, im, m, res)
    assert image.check_reconstruction(key, im, mv, res) != \
        image.check_reconstruction(key, im, mv + 1, res)


def test_chain_runs_without_pil():
    """The card's machine has no PIL: the chain and the loader import and
    resize with it blocked."""
    code = ("import sys; sys.modules['PIL'] = None; "
            "import numpy as np; "
            "from lsfa_tpu_torch.data import image, loader; "
            "out, s = image.resize(np.ones((30, 40, 3), np.float32), 15, 100); "
            "print(out.shape, s)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "(15, 20, 3) 0.5"
