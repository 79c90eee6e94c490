"""Train batch assembly, copied from ``lsfa_tpu.data.loader`` without PIL,
and seeded synthetic train batches shaped like its output.

A batch is a dict of host arrays: data, data_ref, data_ref_old (B, H, W, 3)
raw BGR frames padded to the bucket; motion_vector (B, fh, fw, 2) and
res_diff (B, fh, fw, 3) float32 grids at stride 16; eq_flag, eq_flag_old
(B,); im_info (B, 3) [h, w, scale] of the real image; gt_boxes
(B, max_gt, 5) [x1, y1, x2, y2, cls] zero-padded with gt_valid (B, max_gt).
"""

from __future__ import annotations

import numpy as np
import torch

from lsfa_tpu_torch.data.image import pad_to_bucket


def collate_train_batch(samples, bucket_hw, max_gt: int = 100,
                        mv_res_dtype=np.float32):
    """Stack samples (dicts as ``lsfa_tpu.data.loader.load_pair_sample``
    returns them) into one fixed-shape batch."""
    bh, bw = bucket_hw
    fb = (bh // 16, bw // 16)
    b = len(samples)

    def stack(key, hw):
        return np.concatenate([pad_to_bucket(s[key], hw) for s in samples])

    out = {
        "data": stack("data", bucket_hw),
        "data_ref": stack("data_ref", bucket_hw),
        "data_ref_old": stack("data_ref_old", bucket_hw),
        "motion_vector": stack("motion_vector", fb).astype(mv_res_dtype),
        "res_diff": stack("res_diff", fb).astype(mv_res_dtype),
        "eq_flag": np.asarray([s["eq_flag"] for s in samples], np.float32),
        "eq_flag_old": np.asarray([s["eq_flag_old"] for s in samples], np.float32),
        "im_info": np.stack([s["im_info"] for s in samples]),
    }
    gt = np.zeros((b, max_gt, 5), np.float32)
    gtv = np.zeros((b, max_gt), bool)
    for i, s in enumerate(samples):
        g = min(len(s["gt_boxes"]), max_gt)
        gt[i, :g] = s["gt_boxes"][:g]
        gtv[i, :g] = True
    out["gt_boxes"] = gt
    out["gt_valid"] = gtv
    return out


def synthetic_sample(rng: np.random.Generator, content_hw, num_classes: int,
                     n_gt: int, eq_flag: float, eq_flag_old: float):
    """One seeded stand-in for a loaded training pair at the real extent
    content_hw: uint8 BGR frames, MV (dx, dy) and residual grids over the
    content's cells, and n_gt boxes of classes 1..num_classes-1. A key
    pair (eq_flag 1) repeats the frame as both references with zero
    motion, as the loader does."""
    h, w = content_hw
    fh, fw = -(-h // 16), -(-w // 16)
    data = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
    if eq_flag:
        ref = old = data
        mv = np.zeros((1, fh, fw, 2), np.float32)
    else:
        ref = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
        old = ref if eq_flag_old else rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
        mv = rng.normal(0, 1.5, (1, fh, fw, 2)).astype(np.float32)
    res = rng.normal(0, 10, (1, fh, fw, 3)).astype(np.float32)
    x1 = rng.uniform(0, w * 0.7, n_gt)
    y1 = rng.uniform(0, h * 0.7, n_gt)
    x2 = np.minimum(x1 + rng.uniform(w * 0.1, w * 0.5, n_gt), w - 1)
    y2 = np.minimum(y1 + rng.uniform(h * 0.1, h * 0.5, n_gt), h - 1)
    cls = rng.integers(1, num_classes, n_gt).astype(np.float32)
    return {"data": data, "data_ref": ref, "data_ref_old": old,
            "eq_flag": float(eq_flag), "eq_flag_old": float(eq_flag_old),
            "motion_vector": mv, "res_diff": res,
            "im_info": np.asarray([h, w, 1.0], np.float32),
            "gt_boxes": np.stack([x1, y1, x2, y2, cls], axis=1).astype(np.float32)}


def synthetic_train_batches(n: int, bucket_hw, seed: int = 0, batch_images: int = 1,
                            num_classes: int = 31, max_gt: int = 100, content_hw=None,
                            max_boxes: int = 10):
    """n seeded collated batches at the bucket: frames fill content_hw
    (default: the bucket less 8 rows and 24 columns), every fourth image
    starting with the first is a key pair (eq_flag 1), eq_flag_old is
    drawn, and each image holds 1..max_boxes gt boxes."""
    rng = np.random.default_rng(seed)
    bh, bw = bucket_hw
    content_hw = content_hw or (bh - 8, bw - 24)
    batches, i = [], 0
    for _ in range(n):
        samples = []
        for _ in range(batch_images):
            samples.append(synthetic_sample(
                rng, content_hw, num_classes, int(rng.integers(1, max_boxes + 1)),
                eq_flag=float(i % 4 == 0), eq_flag_old=float(rng.uniform() < 0.3)))
            i += 1
        batches.append(collate_train_batch(samples, bucket_hw, max_gt))
    return batches


def batch_to_device(batch: dict, device) -> dict:
    """Host batch -> tensors on `device`; to a card through pinned memory
    without blocking the host."""
    if torch.device(device).type != "cuda":
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    return {k: torch.as_tensor(v).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}
