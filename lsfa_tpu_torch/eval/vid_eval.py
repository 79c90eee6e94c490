"""ImageNet VID mAP evaluation — the metric of record. A copy of
``lsfa_tpu.eval.vid_eval`` (numpy only), which the port cannot import.

Behavioral target: lib/dataset/imagenet_vid_eval.py:17-218:
  * per-gt adaptive IoU threshold min(0.5, area / (area grown by 10px))
    (parse_vid_rec :34-37),
  * greedy confidence-ordered TP matching against unclaimed gts of the
    same class, requiring IoU >= the gt's own threshold (:165-193),
  * AP by precision-envelope integration over recall change points
    (vid_ap :45-67), averaged over the 30 foreground classes.

Pure NumPy, host-side (evaluation is not a device workload). The
structured API below replaces the reference's detection-txt-file
round-trip; `vid_eval_files` keeps the file-based interface for drop-in
compatibility with reference-format result files.
"""

from __future__ import annotations

import numpy as np


def adaptive_iou_threshold(gt_boxes: np.ndarray, default_thr: float = 0.5,
                           pixel_tolerance: int = 10) -> np.ndarray:
    """Per-gt IoU threshold (small objects get a laxer threshold)."""
    w = gt_boxes[:, 2] - gt_boxes[:, 0] + 1
    h = gt_boxes[:, 3] - gt_boxes[:, 1] + 1
    thr = (w * h) / ((w + pixel_tolerance) * (h + pixel_tolerance))
    return np.minimum(thr, default_thr)


def vid_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """Precision-envelope AP integration."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou_single(box: np.ndarray, gts: np.ndarray) -> np.ndarray:
    iw = np.minimum(box[2], gts[:, 2]) - np.maximum(box[0], gts[:, 0]) + 1
    ih = np.minimum(box[3], gts[:, 3]) - np.maximum(box[1], gts[:, 1]) + 1
    inter = np.maximum(iw, 0) * np.maximum(ih, 0)
    ua = ((box[2] - box[0] + 1) * (box[3] - box[1] + 1)
          + (gts[:, 2] - gts[:, 0] + 1) * (gts[:, 3] - gts[:, 1] + 1) - inter)
    return inter / ua


def vid_eval(detections, annotations, num_classes: int):
    """Compute per-class AP.

    Args:
      detections: dict img_id -> dict(labels (N,), scores (N,), boxes (N,4)).
      annotations: dict img_id -> dict(labels (G,), boxes (G,4)) — every
        evaluated image must appear (possibly with empty arrays).
      num_classes: total classes including background (class 0).

    Returns:
      ap: (num_classes - 1,) per-foreground-class AP (nan where no gt).
    """
    npos = np.zeros(num_classes)
    for rec in annotations.values():
        for lbl in rec["labels"]:
            npos[int(lbl)] += 1

    all_tp, all_fp, all_labels, all_scores = [], [], [], []
    for img_id, ann in annotations.items():
        det = detections.get(img_id)
        if det is None or len(det["labels"]) == 0:
            continue
        order = np.argsort(-np.asarray(det["scores"]), kind="stable")
        labels = np.asarray(det["labels"])[order]
        scores = np.asarray(det["scores"])[order]
        boxes = np.asarray(det["boxes"])[order]

        gt_labels = np.asarray(ann["labels"])
        gt_boxes = np.asarray(ann["boxes"], dtype=np.float64)
        gt_thr = (adaptive_iou_threshold(gt_boxes)
                  if len(gt_boxes) else np.zeros(0))
        claimed = np.zeros(len(gt_labels), dtype=bool)

        tp = np.zeros(len(labels))
        fp = np.zeros(len(labels))
        for j in range(len(labels)):
            ovmax, kmax = -1.0, -1
            if len(gt_labels):
                cand = np.where((gt_labels == labels[j]) & ~claimed)[0]
                if len(cand):
                    ious = _iou_single(boxes[j].astype(np.float64),
                                       gt_boxes[cand])
                    ok = (ious >= gt_thr[cand]) & (ious > ovmax)
                    if ok.any():
                        best = cand[np.argmax(np.where(ok, ious, -1))]
                        ovmax, kmax = ious.max(), best
            if kmax >= 0:
                tp[j] = 1
                claimed[kmax] = True
            else:
                fp[j] = 1
        all_tp.append(tp)
        all_fp.append(fp)
        all_labels.append(labels)
        all_scores.append(scores)

    ap = np.full(num_classes, np.nan)
    if not all_tp:
        return ap[1:]
    tp_all = np.concatenate(all_tp)
    fp_all = np.concatenate(all_fp)
    lbl_all = np.concatenate(all_labels)
    scr_all = np.concatenate(all_scores)
    order = np.argsort(-scr_all, kind="stable")
    tp_all, fp_all, lbl_all = tp_all[order], fp_all[order], lbl_all[order]

    for c in range(1, num_classes):
        if npos[c] == 0:
            continue
        sel = lbl_all == c
        fp_c = np.cumsum(fp_all[sel])
        tp_c = np.cumsum(tp_all[sel])
        rec = tp_c / npos[c]
        prec = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
        ap[c] = vid_ap(rec, prec)
    return ap[1:]


def vid_eval_files(det_path: str, annotations, num_classes: int):
    """Reference-format interface: detections in a text file of lines
    ``img_id label score x1 y1 x2 y2`` (imagenet_vid.py result writer)."""
    dets: dict = {}
    with open(det_path) as f:
        for line in f:
            p = line.split()
            img_id, lbl, sc = int(p[0]), int(p[1]), float(p[2])
            box = [float(v) for v in p[3:7]]
            d = dets.setdefault(img_id, {"labels": [], "scores": [], "boxes": []})
            d["labels"].append(lbl)
            d["scores"].append(sc)
            d["boxes"].append(box)
    for d in dets.values():
        for k in d:
            d[k] = np.asarray(d[k])
    return vid_eval(dets, annotations, num_classes)
