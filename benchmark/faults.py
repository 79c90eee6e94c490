"""Faults planted underneath the timed path, which the check has to fail:
for the tests at a tiny size on the CPU, and for `benchmark/control.py` at
a cell's own size on the card. Each takes an object with pytest's
``MonkeyPatch.setattr(target, name, value)`` and breaks one thing:

- ``carry_unchanged``: each GOP step hands back the key-feature carry it
  was given;
- ``half_lanes_left_out``: the second half of the lanes returns the first
  half's detections;
- ``answer_altered``: the detections' scores scaled by 0.8 where detection
  produces them;
- ``nms_keep_first``: every NMS keeps only its best valid box;
- ``nms_threshold_lowered``: every NMS suppresses from 0.1 below its IoU
  threshold;
- ``nms_one_sweep``: the NMS fixpoint stops after one sweep, so a box
  suppressed only by boxes that are themselves suppressed is lost.

The NMS faults sit in ``ops/nms.py::_alive``, the fixpoint that the
kernel computes on the card and the plain version on the CPU.
"""

from __future__ import annotations

import importlib

import torch


def carry_unchanged(mp):
    from lsfa_tpu_torch.eval.tester import StreamingDetector

    orig = StreamingDetector.process_gop

    def process_gop(self, *a, **k):
        state = self.feat_key, self.data_key
        out = orig(self, *a, **k)
        self.feat_key, self.data_key = state
        return out

    mp.setattr(StreamingDetector, "process_gop", process_gop)


def half_lanes_left_out(mp):
    from lsfa_tpu_torch.eval.tester import StreamingDetector

    orig = StreamingDetector.process_gops

    def process_gops(self, *a, **k):
        kd, kv, cd, cv = (t.clone() for t in orig(self, *a, **k))
        h = self.batch // 2
        kd[:, h:], kv[:, h:] = kd[:, :h], kv[:, :h]
        cd[:, :, h:], cv[:, :, h:] = cd[:, :, :h], cv[:, :, :h]
        return kd, kv, cd, cv

    mp.setattr(StreamingDetector, "process_gops", process_gops)


def _answer_altered(module, name):
    def plant(mp):
        mod = importlib.import_module(module)
        orig = getattr(mod, name)

        def altered(*a, **k):
            dets, valid = orig(*a, **k)
            dets = dets.clone()
            first = dets[0] if dets.dim() == 3 else dets
            first[:, 1] *= 0.8
            return dets, valid

        mp.setattr(mod, name, altered)

    return plant


def _nms(change):
    def plant(mp):
        from lsfa_tpu_torch.ops import nms

        orig = nms._alive

        def _alive(boxes, valid, iou_thresh, num_sweeps, with_converged):
            return change(orig, boxes, valid, iou_thresh, num_sweeps, with_converged)

        mp.setattr(nms, "_alive", _alive)

    return plant


def _keep_first(orig, boxes, valid, t, sweeps, with_converged):
    alive = valid & (torch.cumsum(valid.long(), -1) == 1)
    return (alive, torch.ones_like(alive[:, 0])) if with_converged else alive


def _lowered(orig, boxes, valid, t, sweeps, with_converged):
    return orig(boxes, valid, t - 0.1, sweeps, with_converged)


def _one_sweep(orig, boxes, valid, t, sweeps, with_converged):
    return orig(boxes, valid, t, 1, with_converged)


LANES, FRAME = "lsfa_r101.lanes8", "rfcn_r101.frame1"
FAULTS = {
    (LANES, "carry_unchanged"): carry_unchanged,
    (LANES, "half_lanes_left_out"): half_lanes_left_out,
    (LANES, "answer_altered"): _answer_altered("lsfa_tpu_torch.eval.tester", "detect_batch"),
    (FRAME, "answer_altered"): _answer_altered("lsfa_tpu_torch.eval.rfcn_tester",
                                               "detect_from_maps"),
}
for _cell in (LANES, FRAME):
    FAULTS[(_cell, "nms_keep_first")] = _nms(_keep_first)
    FAULTS[(_cell, "nms_threshold_lowered")] = _nms(_lowered)
    FAULTS[(_cell, "nms_one_sweep")] = _nms(_one_sweep)
