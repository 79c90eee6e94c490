"""Host-side image, motion-vector and residual preprocessing, the
counterpart of ``lsfa_tpu.data.image`` without PIL.

The JAX package resizes each channel with PIL's float ("F" mode) bilinear
filter. `_resize_np` computes that filter itself: Pillow's separable
triangle filter, its support widened by the scale on a downscale, weights
normalized per output pixel and summed in float64 in tap order, the
horizontal pass first and float32 after each pass. It gives PIL's values
bit for bit (``tests/test_torch_image_chain.py``).

  * resize: scale the short side to `target_size` with the long side
    capped at `max_size` (Python's round, half to even, as JAX's);
  * transform: BGR to RGB, mean subtraction, pixel scale;
  * transform_mv_res: MV and residual to the image scale, padded to the
    stride, the residual's channel transform, then down to the feature
    grid, the MV in feature cells;
  * check_reconstruction, load_frame_triplet: the compressed stream's
    invariant and the (image, -MV, residual) triplet of one frame, read
    through a reader given as a parameter.
"""

from __future__ import annotations

import numpy as np


def _taps(in_size: int, out_size: int):
    """Pillow's bilinear coefficients along one axis: (indices, weights),
    each (out_size, taps), the weights of a row summing to 1 in float64
    and zero past the row's support."""
    scale = in_size / out_size
    filter_scale = max(scale, 1.0)
    support = filter_scale                       # the triangle's support is 1
    taps = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    first = np.maximum((center - support + 0.5).astype(np.int64), 0)
    count = np.minimum((center + support + 0.5).astype(np.int64), in_size) - first
    k = np.arange(taps)
    x = np.abs(((k[None, :] + first[:, None]) - center[:, None] + 0.5) * (1.0 / filter_scale))
    w = np.where((x < 1.0) & (k[None, :] < count[:, None]), 1.0 - x, 0.0)
    total = np.zeros(out_size)
    for j in range(taps):                        # Pillow's order of summation
        total = total + w[:, j]
    w = w / np.where(total == 0.0, 1.0, total)[:, None]
    return np.minimum(first[:, None] + k[None, :], in_size - 1), w


def _resample(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's float resample along `axis` of a float32
    array: float64 sums in tap order, stored as float32."""
    if a.shape[axis] == out_size:
        return a
    idx, w = _taps(a.shape[axis], out_size)
    a64 = a.astype(np.float64)
    wshape = [1] * a.ndim
    wshape[axis] = out_size
    acc = np.zeros(a.shape[:axis] + (out_size,) + a.shape[axis + 1:])
    for j in range(idx.shape[1]):
        acc += np.take(a64, idx[:, j], axis=axis) * w[:, j].reshape(wshape)
    return acc.astype(np.float32)


def _resize_np(arr: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Bilinear resize of an HxW or HxWxC array to (out_h, out_w, C)
    float32, as PIL's "F" mode BILINEAR per channel."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    out = _resample(np.asarray(arr, np.float32), out_w, 1)
    return _resample(out, out_h, 0)


def resize(im: np.ndarray, target_size: int, max_size: int, stride: int = 0):
    """Short-side resize with long-side cap; returns (image, im_scale)."""
    h, w = im.shape[:2]
    smin, smax = min(h, w), max(h, w)
    im_scale = float(target_size) / smin
    if round(im_scale * smax) > max_size:
        im_scale = float(max_size) / smax
    out_w, out_h = int(round(w * im_scale)), int(round(h * im_scale))
    out = _resize_np(im, out_w, out_h)
    if stride > 0:
        ph = int(np.ceil(out_h / stride) * stride)
        pw = int(np.ceil(out_w / stride) * stride)
        padded = np.zeros((ph, pw, out.shape[2]), np.float32)
        padded[:out_h, :out_w] = out
        out = padded
    return out, im_scale


def transform(im: np.ndarray, pixel_means, pixel_scale: float = 1.0):
    """BGR HxWx3 -> mean-subtracted RGB NHWC (1, H, W, 3)."""
    means = np.asarray(pixel_means, np.float32)  # [B, G, R]
    out = (im[:, :, ::-1].astype(np.float32) - means[::-1][None, None, :]) * pixel_scale
    return out[None]


def transform_mv_res(motion_vector: np.ndarray, res_diff: np.ndarray,
                     im_scale: float, pixel_means, pixel_scale: float = 1.0,
                     rcnn_stride: int = 16, legacy_swap: bool = False):
    """MV (H, W, 2) + residual (H, W, 3 BGR) -> feature-grid tensors
    (1, H', W', 2) and (1, H', W', 3 RGB), MV in feature-cell units.

    Both are resized twice: to the image scale, then (padded to the
    stride) down to the feature grid; the MV is scaled by
    im_scale / stride after the second resize. legacy_swap reproduces the
    reference's in-place channel-transform bug (lib/utils/image.py:217-218):
    output channel 2 reads the already-transformed channel 0 instead of
    the raw blue residual, which weights trained by the reference expect."""
    h, w = res_diff.shape[:2]
    sw, sh = int(round(w * im_scale)), int(round(h * im_scale))
    mv = _resize_np(motion_vector, sw, sh)
    res = _resize_np(res_diff, sw, sh)

    ph = int(np.ceil(sh / rcnn_stride) * rcnn_stride)
    pw = int(np.ceil(sw / rcnn_stride) * rcnn_stride)
    mv_p = np.zeros((ph, pw, 2), np.float32)
    res_p = np.zeros((ph, pw, 3), np.float32)
    mv_p[:sh, :sw] = mv
    res_p[:sh, :sw] = res

    # residual channel transform: out_i = (in_{2-i} - mean_{2-i}) * scale
    means = np.asarray(pixel_means, np.float32)
    res_t = (res_p[:, :, ::-1] - means[::-1][None, None, :]) * pixel_scale
    if legacy_swap:
        res_t = res_t.copy()
        res_t[:, :, 2] = (res_t[:, :, 0] - means[0]) * pixel_scale
    fh, fw = ph // rcnn_stride, pw // rcnn_stride
    mv_f = _resize_np(mv_p, fw, fh)
    res_f = _resize_np(res_t, fw, fh)
    mv_f *= im_scale / rcnn_stride       # feature-cell units
    return mv_f[None], res_f[None]


def pad_to_bucket(tensor: np.ndarray, bucket_hw, axis_h: int = 1,
                  axis_w: int = 2) -> np.ndarray:
    """Zero-pad an NHWC array to a fixed (H, W) bucket."""
    bh, bw = bucket_hw
    h, w = tensor.shape[axis_h], tensor.shape[axis_w]
    if h > bh or w > bw:
        raise ValueError(f"({h}, {w}) does not fit the bucket {tuple(bucket_hw)}")
    pads = [(0, 0)] * tensor.ndim
    pads[axis_h] = (0, bh - h)
    pads[axis_w] = (0, bw - w)
    return np.pad(tensor, pads)


def check_reconstruction(key_im: np.ndarray, im: np.ndarray, motion_vector: np.ndarray,
                         res_diff: np.ndarray) -> bool:
    """The compressed stream's pixel-exact invariant (lib/utils/image.py:79-89):
    key[p - mv(p)] + residual(p) == im(p) for every pixel, on the raw
    (not negated, not scaled) MV and residual a reader's `load` returns."""
    h, w = im.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    sx = np.clip(xs - motion_vector[:, :, 0], 0, w - 1)
    sy = np.clip(ys - motion_vector[:, :, 1], 0, h - 1)
    recon = key_im[sy, sx].astype(np.int64) + res_diff
    return bool((recon == im.astype(np.int64)).all())


def load_frame_triplet(video_path: str, frame_id: int, gop_size: int = 12, open_video=None):
    """(image, -MV, residual) of one frame as float32, the get_image
    contract (lib/utils/image.py:45-55) with its MV negation at :54.
    open_video(path) gives the reader (``data.loader.open_native_video``,
    the native decoder, when None)."""
    from lsfa_tpu_torch.data.loader import open_native_video

    reader = (open_video or open_native_video)(video_path)
    gop_id, pos_id = frame_id // gop_size, frame_id % gop_size
    im = reader.load(gop_id, pos_id, 0).astype(np.float32)
    mv = -reader.load(gop_id, pos_id, 1).astype(np.float32)
    res = reader.load(gop_id, pos_id, 2).astype(np.float32)
    return im, mv, res


def small_pool_factor(small_net_stride: int) -> int:
    """Host-side downscale factor feeding the small net: the model pools
    4x for stride 4 (backbone stage 1 adds /4) and 2x for stride 8 (stage 2
    adds /4)."""
    return 4 if small_net_stride == 4 else 2


def resized_dims(h: int, w: int, target_size: int, max_size: int):
    """Post-resize dims under the short-side/long-side rule."""
    smin, smax = min(h, w), max(h, w)
    im_scale = float(target_size) / smin
    if round(im_scale * smax) > max_size:
        im_scale = float(max_size) / smax
    return int(round(h * im_scale)), int(round(w * im_scale))


def pick_bucket(h: int, w: int, buckets, target_size: int, max_size: int):
    """Smallest configured (H, W) bucket that fits the resized image, so
    that portrait and landscape streams each run at their own shape and
    not at one worst-case square."""
    rh, rw = resized_dims(h, w, target_size, max_size)
    best = None
    for bh, bw in buckets:
        if rh <= bh and rw <= bw:
            if best is None or bh * bw < best[0] * best[1]:
                best = (bh, bw)
    if best is None:
        raise ValueError(
            f"no bucket in {list(buckets)} fits resized {rh}x{rw}; add one "
            f"to cfg.tpu.image_buckets")
    return best


def bgr_to_i420(frames: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 BGR -> (B, H*3/2, W, 1) planar I420 uint8.

    BT.601 limited range with a 2x2 chroma mean: the inverse of the
    model's converter (``models/lsfa.py::LSFA._preprocess_i420``) up to
    rounding, and the packing the native data plane emits. BGR (0, 0, 0)
    padding maps to Y=16, U=V=128, which the model converts back to exact
    zeros. H and W must be multiples of 4."""
    b, g, r = (frames[..., i].astype(np.float32) for i in range(3))
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    cb = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    cr = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0
    n, h, w = y.shape
    yp = np.clip(np.round(y), 0, 255).astype(np.uint8)

    def sub(c):
        c = c.reshape(n, h // 2, 2, w // 2, 2).mean((2, 4))
        return np.clip(np.round(c), 0, 255).astype(np.uint8)

    packed = np.concatenate([yp,
                             sub(cb).reshape(n, h // 4, w),
                             sub(cr).reshape(n, h // 4, w)], axis=1)
    return packed[..., None]
