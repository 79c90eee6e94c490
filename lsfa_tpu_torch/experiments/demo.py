"""Streaming demo (the dff_rfcn/demo.py role); the counterpart of
``experiments/demo.py``: LSFA over a compressed clip, or a directory of
images, one frame at a time through ``StreamingDetector.process_frame``,
each frame written with its detections drawn as ``<out>/<frame>.png``.

Usage:
  python -m lsfa_tpu_torch.experiments.demo \
      --cfg lsfa_tpu_torch/configs/lsfa_resnet101_vid.json --video clip.mp4 \
      --out out_frames/ [--ckpt <dir>] [--max-frames 48] [--synthesize] [--device cpu]
  python -m lsfa_tpu_torch.experiments.demo --cfg ... --frames <image dir> --out out/

In video mode each frame's BGR image, motion vectors (negated, as the
native loader's) and residual come from the stream; in the image-directory
mode (the reference's JPEG input) MV and residual are zero, so a non-key
frame rests on the cached key feature alone. The model is
``train.driver.init_model``'s, with ``--ckpt`` a checkpoint directory of
this package. Against the JAX demo: frames are written as PNG by
``utils.vis.write_png`` with the labels in its bitmap font; the readers
are parameters of `main` (``open_video``: a callable that opens a reader
with ``get_num_frames`` and ``load``, such as
``data.loader.SyntheticVideoReader``; ``read_image``: path -> BGR float32
image); --synthesize writes a 320x240 test clip with the native encoder,
so it needs the native library.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from lsfa_tpu_torch.data.loader import GOP_SIZE

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png")


def main(argv=None, open_video=None, read_image=None, model=None):
    """Run the demo; prints ``frame <fid> flag=<flag> dets=<n>`` per frame.
    model: run this LSFA (on its device) in place of `init_model`'s.
    Returns [(flag, detections)] per frame."""
    ap = argparse.ArgumentParser(description="LSFA streaming demo")
    ap.add_argument("--cfg", required=True, help=".json or .yaml config")
    ap.add_argument("--video", default=None)
    ap.add_argument("--frames", default=None, help="a directory of images (JPEG mode)")
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--ckpt", default=None, help="checkpoint directory of this package")
    ap.add_argument("--max-frames", type=int, default=48)
    ap.add_argument("--synthesize", action="store_true",
                    help="first write a synthetic test clip to --video")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.data import coviar
    from lsfa_tpu_torch.data.image import pad_to_bucket, resize, transform_mv_res
    from lsfa_tpu_torch.data.loader import open_native_video, read_jpeg_bgr
    from lsfa_tpu_torch.eval.tester import StreamingDetector, collect_detections
    from lsfa_tpu_torch.train.checkpoint import load_checkpoint
    from lsfa_tpu_torch.train.driver import init_model
    from lsfa_tpu_torch.utils.vis import draw_detections, write_png

    cfg = load_config(args.cfg)
    if not args.video and not args.frames:
        ap.error("one of --video / --frames is required")
    if args.synthesize and args.video:
        if not coviar.available():
            raise RuntimeError(f"--synthesize needs the native encoder: {coviar.MISSING}; "
                               f"call main with open_video to read a stream another way")
        coviar.encode_test_video(args.video, n_frames=args.max_frames, w=320, h=240,
                                 gop_size=GOP_SIZE, seed=0)
    if model is None:
        model = init_model(cfg, device=args.device)
    if args.ckpt:
        state, _ = load_checkpoint(args.ckpt)
        model.load_state_dict(state["model"])

    bucket = tuple(cfg.tpu.default_bucket)
    det = StreamingDetector(model, cfg, bucket)
    os.makedirs(args.out, exist_ok=True)
    images = reader = None
    if args.frames:
        images = sorted(os.path.join(args.frames, f) for f in os.listdir(args.frames)
                        if f.lower().endswith(IMAGE_EXTENSIONS))
        if not images:
            ap.error(f"no image files under {args.frames}")
        read_image = read_image or read_jpeg_bgr
        n = min(len(images), args.max_frames)
    else:
        reader = (open_video or open_native_video)(args.video)
        n = min(reader.get_num_frames(), args.max_frames)
    target, max_size = cfg.SCALES[0]
    fb = (bucket[0] // 16, bucket[1] // 16)
    out = []
    for fid in range(n):
        flag = det.key_frame_flag(fid)
        if images is not None:
            im = np.asarray(read_image(images[fid]), np.float32)
            mv = np.zeros(im.shape[:2] + (2,), np.float32)
            res = np.zeros(im.shape[:2] + (3,), np.float32)
        else:
            gop, pos = fid // GOP_SIZE, fid % GOP_SIZE
            im = reader.load(gop, pos, 0).astype(np.float32)
            mv = -reader.load(gop, pos, 1).astype(np.float32)
            res = reader.load(gop, pos, 2).astype(np.float32)
        im_r, im_scale = resize(im, target, max_size)
        # raw resized BGR uint8; normalized on the device
        data = pad_to_bucket(np.clip(np.round(im_r), 0, 255).astype(np.uint8)[None], bucket)
        mv_t, res_t = transform_mv_res(mv, res, im_scale, cfg.network.PIXEL_MEANS,
                                       cfg.network.PIXEL_SCALE)
        im_info = np.asarray([[im_r.shape[0], im_r.shape[1], im_scale]], np.float32)
        d, v = det.process_frame(data, im_info, pad_to_bucket(mv_t, fb),
                                 pad_to_bucket(res_t, fb), flag=flag)
        dets = collect_detections(d, v)
        frame_rgb = np.clip(im[:, :, ::-1], 0, 255)
        write_png(os.path.join(args.out, f"{fid:06d}.png"), draw_detections(frame_rgb, dets))
        n_dets = int(v.sum())
        print(f"frame {fid} flag={flag} dets={n_dets}")
        out.append((flag, dets))
    return out


if __name__ == "__main__":
    main()
