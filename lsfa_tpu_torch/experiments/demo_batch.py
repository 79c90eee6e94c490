"""Batched-GOP demo (the dff_rfcn/demo_batch.py role); the counterpart of
``experiments/demo_batch.py``: one GOP's key frame and its other frames
through ``LSFA.forward_batch_gop`` in one forward (the key frame's
feature FlowNet-warped to each other frame, DFF-style), then detection
over all the frames' maps as one batch.

Usage:
  python -m lsfa_tpu_torch.experiments.demo_batch \
      --cfg lsfa_tpu_torch/configs/lsfa_resnet101_vid.json --video clip.mp4 \
      [--gop 0] [--synthesize] [--device cpu]

It prints one line per frame with its detection count. The model is
``train.driver.init_model``'s (a random init with the config's warm
starts). Against the JAX demo: each frame is shipped as the raw resized
BGR uint8 frame that `forward_batch_gop` normalizes on the device (the
JAX demo passes it frames it has normalized already, so they are
normalized twice), and detection takes the config's TEST settings and RPN
tier (``eval.detector.detection_kwargs``). --synthesize writes a test clip
with the native encoder, so it needs the native library; where that does
not load, call `main` with `open_video`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lsfa_tpu_torch.data.loader import GOP_SIZE


def gop_frames(reader, gop: int) -> np.ndarray:
    """The BGR uint8 frames (N, H, W, 3) of GOP `gop`: the reader's
    `decode_gop` where it has one, else `load(gop, pos, 0)` for each
    position that the stream holds."""
    if hasattr(reader, "decode_gop"):
        return reader.decode_gop(gop)[0]
    n = min(GOP_SIZE, reader.get_num_frames() - gop * GOP_SIZE)
    if n <= 0:
        raise IndexError(f"gop {gop} of a {reader.get_num_frames()}-frame stream")
    return np.stack([reader.load(gop, pos, 0) for pos in range(n)])


def prepare_gop(frames: np.ndarray, cfg, bucket):
    """Each frame resized by cfg.SCALES[0], rounded to uint8 and zero-padded
    to the bucket: raw BGR (N, bh, bw, 3) uint8, and im_info (3,) float32
    [height, width, scale] of the resized frames."""
    from lsfa_tpu_torch.data.image import pad_to_bucket, resize

    target, max_size = cfg.SCALES[0]
    out = []
    for f in frames:
        im_r, im_scale = resize(f.astype(np.float32), target, max_size)
        out.append(pad_to_bucket(np.clip(np.round(im_r), 0, 255).astype(np.uint8)[None], bucket))
    info = np.asarray([im_r.shape[0], im_r.shape[1], im_scale], np.float32)
    return np.concatenate(out), info


@torch.no_grad()
def detect_gop(model, cfg, batch: np.ndarray, im_info: np.ndarray):
    """One forward_batch_gop over the raw frames `batch` (the key frame
    first) on the model's device, and detection over the N frames' maps.
    Returns (dets (N, M, 6), valid (N, M)), device tensors."""
    from lsfa_tpu_torch.eval.detector import anchors_for, detect_batch, detection_kwargs

    dev = next(model.parameters()).device
    x = torch.from_numpy(batch).to(dev)
    out = model.eval().forward_batch_gop(x[:1], x[1:])
    anchors = anchors_for(cfg, batch.shape[1:3], dev)
    return detect_batch(out, anchors, torch.from_numpy(im_info).to(dev),
                        **detection_kwargs(cfg))


def main(argv=None, open_video=None, model=None):
    """Run the demo. open_video: a callable that opens a reader of the
    stream (``get_num_frames`` and ``load``, or ``decode_gop``), such as
    ``data.loader.SyntheticVideoReader``; None opens it with the native
    decoder. model: run this LSFA (on its device) in place of
    `init_model`'s. Returns (dets, valid) of `detect_gop`."""
    ap = argparse.ArgumentParser(description="LSFA batched-GOP demo")
    ap.add_argument("--cfg", required=True, help=".json or .yaml config")
    ap.add_argument("--video", required=True)
    ap.add_argument("--gop", type=int, default=0)
    ap.add_argument("--synthesize", action="store_true",
                    help="first write a 24-frame 320x240 test clip to --video")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.data import coviar
    from lsfa_tpu_torch.data.loader import open_native_video
    from lsfa_tpu_torch.train.driver import init_model

    cfg = load_config(args.cfg)
    if args.synthesize:
        if not coviar.available():
            raise RuntimeError(f"--synthesize needs the native encoder: {coviar.MISSING}; "
                               f"call main with open_video to read a stream another way")
        coviar.encode_test_video(args.video, n_frames=24, w=320, h=240, gop_size=GOP_SIZE,
                                 seed=0)
    if model is None:
        model = init_model(cfg, device=args.device)
    reader = (open_video or open_native_video)(args.video)
    batch, im_info = prepare_gop(gop_frames(reader, args.gop), cfg,
                                 tuple(cfg.tpu.default_bucket))
    dets, valid = detect_gop(model, cfg, batch, im_info)
    for i, n in enumerate(valid.sum(dim=1).tolist()):
        print(f"frame {i}: {n} detections")
    return dets, valid


if __name__ == "__main__":
    main()
