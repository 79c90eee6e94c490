"""Train and then evaluate (the experiments/dff_rfcn/*_train_test.py
role); the counterpart of ``experiments/lsfa_end2end_train_test.py``.

Usage, on one card:
  python -m lsfa_tpu_torch.experiments.lsfa_end2end_train_test \
      --cfg lsfa_tpu_torch/configs/lsfa_resnet101_vid.json \
      [--frequent N] [--max-steps N] [--skip-test] [--device cpu]
and data parallel over the cards of one host:
  torchrun --nproc-per-node 4 -m lsfa_tpu_torch.experiments.lsfa_end2end_train_test --cfg ...

Under torchrun (WORLD_SIZE set) it joins the process group
(``parallel.mesh.initialize_distributed``: NCCL on the cards, gloo with
``--device cpu``) unless the caller already has, trains with
``train.driver.train_net`` over the DET+VID roidb of the config, writing
checkpoints under ``<output_path>/<symbol>/<image_set>/checkpoints/
<model_prefix>``, and then rank 0 evaluates the model just trained with
``experiments.lsfa_test.run_test``. The readers are the native decoder
and a JPEG reader; a machine without FFmpeg or PIL calls `main` with its
own (see ``data.loader``).
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None, open_video=None, read_image=None, open_eval_video=None):
    """Run the launcher. open_video, read_image: the training feed's
    readers (``data.loader.load_pair_sample``); open_eval_video: the
    evaluation loops' `open_video` (``PreparedVideo``'s signature);
    read_image also reads the frames past a stream's end in evaluation.
    Returns run_test's (mAP, per-class AP) on rank 0, None with
    --skip-test and on the other ranks."""
    ap = argparse.ArgumentParser(description="LSFA end-to-end train + test")
    ap.add_argument("--cfg", required=True, help=".json or .yaml config")
    ap.add_argument("--frequent", type=int, default=None, help="log interval (steps)")
    ap.add_argument("--max-steps", type=int, default=None, help="stop training early")
    ap.add_argument("--skip-test", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.experiments.lsfa_test import run_test
    from lsfa_tpu_torch.parallel import mesh
    from lsfa_tpu_torch.train.driver import train_net
    from lsfa_tpu_torch.utils.logger import create_logger

    cfg = load_config(args.cfg)
    if args.frequent is not None:
        cfg.default.frequent = args.frequent
    device = args.device
    joined = "WORLD_SIZE" in os.environ and not mesh.active()
    if joined:
        device = mesh.initialize_distributed(device=device)
    try:
        logger, out_dir = create_logger(cfg.output_path, cfg.symbol, cfg.dataset.image_set)
        ckpt_dir = os.path.join(out_dir, "checkpoints", cfg.TRAIN.model_prefix)
        model = train_net(cfg, ckpt_dir=ckpt_dir, logger=logger, max_steps=args.max_steps,
                          device=device, open_video=open_video, read_image=read_image)
        if args.skip_test or mesh.rank() != 0:
            return None
        return run_test(cfg, open_video=open_eval_video, read_image=read_image, model=model)
    finally:
        if joined:                           # rank 0 runs no collective after training
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
