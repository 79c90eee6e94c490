"""Experiment logging; a copy of ``lsfa_tpu.utils.logger`` (reference:
lib/utils/create_logger.py:13-35 — per-(config, imageset) output
directory + timestamped file log)."""

from __future__ import annotations

import logging
import os
import time


def create_logger(output_path: str, cfg_name: str, image_set: str):
    """Returns (logger, final_output_path)."""
    out_dir = os.path.join(output_path, cfg_name, image_set)
    os.makedirs(out_dir, exist_ok=True)
    log_file = os.path.join(
        out_dir, f"{cfg_name}_{time.strftime('%Y-%m-%d-%H-%M')}.log")
    logger = logging.getLogger(f"lsfa_tpu_torch.{cfg_name}.{image_set}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter("%(asctime)-15s %(message)s"))
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(asctime)-15s %(message)s"))
        logger.addHandler(sh)
    return logger, out_dir
