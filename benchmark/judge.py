"""The comparison that decides `correct`: the program's final detections,
frame by frame, judged by the plain reference (``reference/detect.py::
frames``) from both sides.

`det_gap`: every detection the program gives is one the network offers.
The reference offers, for each frame, every detection before any NMS: the
RPN's NMS input (the top min(pre_nms, tier) proposals, and the next ranks
that a rounding can swap into it), each scored for every class and
regressed. A program detection (label c, score s, box b) is judged by the
closest of them:

    gap = min over candidates j of max(|s - s_jc| / max(s, s_jc), 1 - IoU(b, b_j))

Matching against the candidates before NMS keeps this continuous: a
rounding that moves one greedy NMS decision among near-tied boxes changes
which of them survive, but every survivor is still a candidate. A frame
reads the median gap of its TOP best detections (1 where the program has
none and the reference some): a single gap follows rounding's tail, since
PSROI pooling's integer bins turn a small change of a box into a large one
of its score.

`recall_miss`: every detection the reference keeps is kept by the program
or lost to an NMS decision that rounding could have turned. Each program
detection is traced to the proposal it came from (the candidate whose box
overlaps its box most). Each of the reference's best final detections of
a frame, as many as a third of max_per_image (clear of that cut), r (label
c, score s, from proposal P) is kept when a program detection of class c
comes from P; otherwise it is explained by

- the class NMS: a program detection of class c from a proposal Q whose
  reference score in c is at least (1 - SCORE_MARGIN) s and whose
  reference box overlaps r's by more than TEST.NMS - MARGIN;
- the RPN's NMS, when no program detection comes from P: a proposal Q that
  one does come from, with fg score at least (1 - SCORE_MARGIN) fg_P and
  IoU(P, Q) above RPN_NMS_THRESH - MARGIN;
- the cut before the class stage, when no program detection comes from P:
  fg_P at most (1 + SCORE_MARGIN) times the fg score of the last proposal
  the reference let through.

Each explanation is an NMS decision near its threshold or a near tie, in
the reference's own numbers: what rounding can turn. `recall_miss` is the
share of the judged detections over the sample that are neither kept nor
explained. An NMS that suppresses too much, keeps too little or stops
before its fixpoint leaves such detections; a sound program leaves about
none (see PERF.md for both readings).

`det_gap` is the largest over the frames compared, so one wrong frame,
lane or GOP fails the run. `nms_overlap` is the largest IoU between two
kept detections of one class beyond TEST.NMS (greedy NMS keeps none above
it).
"""

from __future__ import annotations

import numpy as np

TOP = 20
MARGIN = 0.05
SCORE_MARGIN = 0.1


def iou(a, b):
    """IoU (+1 convention) of boxes a (N, 4) against b (M, 4)."""
    iw = np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0]) + 1
    ih = np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1]) + 1
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


def precision_gaps(dets, f) -> np.ndarray:
    """The gap of each of the program's TOP best detections of a frame to
    its closest candidate."""
    if not len(dets):
        return np.ones(1) if len(f["dets"]) else np.zeros(1)
    dets = dets[np.argsort(-dets[:, 1], kind="stable")[:TOP]]
    cand = f["scores"][:, dets[:, 0].astype(int) - 1].T                # (N, K)
    rel = np.abs(dets[:, 1:2] - cand) / np.maximum(np.maximum(dets[:, 1:2], cand), 1e-12)
    return np.maximum(rel, 1.0 - iou(dets[:, 2:6], f["boxes"])).min(axis=1)


def recall_misses(dets, f, test: dict) -> np.ndarray:
    """Which of the reference's judged detections of a frame the program
    neither keeps nor loses to an NMS decision (see the module's text)."""
    n = test["max_per_image"] // 3
    ref, p = f["dets"][:n], f["cand"][:n]
    if not len(ref) or not len(dets):
        return np.ones(len(ref), bool)
    j = iou(dets[:, 2:6], f["boxes"]).argmax(axis=1)
    same = ref[:, None, 0] == dets[None, :, 0]
    kept = (same & (p[:, None] == j[None, :])).any(axis=1)
    s_q = f["scores"][j[None, :], ref[:, 0, None].astype(int) - 1]
    cls = (same & (s_q >= (1.0 - SCORE_MARGIN) * ref[:, 1:2])
           & (iou(ref[:, 2:6], f["boxes"][j]) > test["NMS"] - MARGIN)).any(axis=1)
    fg_p, fg_q = f["fg"][p], f["fg"][j]
    rpn = ((p[:, None] != j[None, :]) & (fg_q[None, :] >= (1.0 - SCORE_MARGIN) * fg_p[:, None])
           & (iou(f["props"][p], f["props"][j]) > test["RPN_NMS_THRESH"] - MARGIN)).any(axis=1)
    cut = (fg_p <= (1.0 + SCORE_MARGIN) * f["fg_cut"] if f["fg_cut"] is not None
           else np.zeros(len(ref), bool))
    lost = ~np.isin(p, j)
    return ~(kept | cls | (lost & (rpn | cut)))


def nms_overlap(dets, thresh: float) -> float:
    """How far the largest IoU of two kept detections of one class lies
    above the NMS threshold (0 when none does)."""
    worst = 0.0
    for c in np.unique(dets[:, 0]):
        b = dets[dets[:, 0] == c, 2:6]
        if len(b) > 1:
            m = iou(b, b)
            np.fill_diagonal(m, 0.0)
            worst = max(worst, float(m.max()) - thresh)
    return worst


def readings(prog_items, ref_items, test: dict) -> dict:
    """prog_items: per sampled request, its frames' (N, 6) detections;
    ref_items: the same frames' `reference.detect.frames` records; test:
    the configuration's TEST section. Returns the numbers compared, and
    beside them `det_gap_max`, the largest single gap, which is not."""
    pairs = [(np.asarray(p, np.float64).reshape(-1, 6), r)
             for pi, ri in zip(prog_items, ref_items, strict=True)
             for p, r in zip(pi, ri, strict=True)]
    prec = [precision_gaps(p, r) for p, r in pairs]
    miss = [recall_misses(p, r, test) for p, r in pairs]
    return {"det_gap": max(float(np.median(x)) for x in prec),
            "recall_miss": sum(int(x.sum()) for x in miss) / max(sum(len(x) for x in miss), 1),
            "nms_overlap": max(nms_overlap(p, test["NMS"]) for p, _ in pairs),
            "det_gap_max": max(float(x.max()) for x in prec),
            "frames_compared": len(pairs)}
