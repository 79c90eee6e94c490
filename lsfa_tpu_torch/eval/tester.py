"""Streaming LSFA inference: the key/non-key state machine.

The counterpart of ``lsfa_tpu.eval.tester.StreamingDetector``. The cached
key feature (float32) and preprocessed key frame stay on the device; each
GOP is one key step (forward_key + detection) and one batched step over its
non-key frames (forward_cur + detection), all enqueued without waiting for
the device; `process_frame` runs one frame at a time by the key-frame
schedule. Detections come back as one fixed-size (M, 6) tensor per frame;
reading them (`collect_detections`) is the only host sync.
"""

from __future__ import annotations

import numpy as np
import torch

from lsfa_tpu_torch.data.image import small_pool_factor
from lsfa_tpu_torch.data.loader import to_device
from lsfa_tpu_torch.eval.detector import anchors_for, detect_batch, detection_kwargs


class StreamingDetector:
    """One stream's LSFA inference with device-resident recurrent state.

    model: an LSFA module with its weights; it runs on its own device.
    lt_off: every key frame takes the stream-start select, so the fresh
    backbone feature is used verbatim (an A/B of long-term aggregation)."""

    def __init__(self, model, cfg, image_hw, lt_off: bool = False):
        self.model = model.eval()
        self.cfg = cfg
        self.lt_off = lt_off
        self.device = next(model.parameters()).device
        h, w = image_hw
        self.image_hw = (h, w)
        stride = cfg.network.RPN_FEAT_STRIDE
        self.feat_hw = (h // stride, w // stride)
        self.key_interval = cfg.TEST.KEY_FRAME_INTERVAL
        self.anchors = anchors_for(cfg, image_hw, self.device)
        self.det_kw = detection_kwargs(cfg)
        self.reset()

    def _put(self, x, dtype=None):
        return to_device(x, self.device, dtype)

    def reset(self):
        """Start a new video stream."""
        fh, fw = self.feat_hw
        h, w = self.image_hw
        self.feat_key = torch.zeros((1, fh, fw, self.cfg.network.DFF_FEAT_DIM),
                                    device=self.device)
        self.data_key = torch.zeros((1, h, w, 3), device=self.device)
        self.frame_id = 0

    def get_state(self):
        """The current stream's recurrent state (feat_key, data_key,
        frame_id): device tensors, no copy."""
        return (self.feat_key, self.data_key, self.frame_id)

    def set_state(self, state):
        self.feat_key, self.data_key, self.frame_id = state

    def key_frame_flag(self, frame_id: int) -> int:
        """0: stream start; 1: key frame; 2: non-key frame."""
        if frame_id == 0:
            return 0
        if frame_id % self.key_interval == 0:
            return 1
        return 2

    @torch.no_grad()
    def process_gop(self, key_frame, smalls, motion_vectors, res_diffs,
                    im_info, first: bool = False):
        """One key frame (1, H, W, 3) or I420 (1, H*3/2, W, 1), and its n
        non-key frames: smalls (n, ...), motion_vectors (n, fh, fw, 2),
        res_diffs (n, fh, fw, 3); im_info (3,) or (1, 3).

        Returns (key_dets (1, M, 6), key_valid (1, M), cur_dets (n, M, 6),
        cur_valid (n, M)), device tensors."""
        m = self.model
        im_info = self._put(im_info, torch.float32).reshape(-1, 3)
        boot = first or self.lt_off
        is_first = torch.full((1,), 1.0 if boot else 0.0, device=self.device)
        kout = m.forward_key(self._put(key_frame), self.data_key, self.feat_key, is_first)
        kd, kv = detect_batch(kout, self.anchors, im_info, **self.det_kw)
        smalls = self._put(smalls)
        n = smalls.shape[0]
        fk = kout["feat"].expand((n,) + tuple(kout["feat"].shape[1:]))
        cout = m.forward_cur(smalls, fk, self._put(motion_vectors, torch.float32),
                             self._put(res_diffs, torch.float32))
        cd, cv = detect_batch(cout, self.anchors, im_info[0], **self.det_kw)
        self.feat_key = kout["feat"]
        self.data_key = kout["prep"]
        self.frame_id += 1 + n
        return kd, kv, cd, cv

    def process_gops(self, key_frames, smalls, motion_vectors, res_diffs,
                     im_info, first: bool = False):
        """G whole GOPs in order: key_frames (G, 1, ...); smalls, motion
        vectors and residuals (G, n, ...). Returns (key_dets (G, 1, M, 6),
        key_valids, cur_dets (G, n, M, 6), cur_valids) — the same as G
        sequential process_gop calls, which is what it runs."""
        outs = [self.process_gop(key_frames[i], smalls[i], motion_vectors[i],
                                 res_diffs[i], im_info, first=first and i == 0)
                for i in range(len(key_frames))]
        return tuple(torch.stack(o) for o in zip(*outs))

    def process_prepared_window(self, payloads, first: bool = False):
        """A window of prepared GOP payloads, each the tuple
        (frames, smalls, mv, res, im_info) that ``PreparedVideo.gop``
        returns: only the key frame of each GOP is read at full size;
        MV/residual run in float32."""
        key_frames = np.stack([p[0][0:1] for p in payloads])
        smalls = np.stack([p[1][1:] for p in payloads])
        mvs = np.stack([p[2][1:] for p in payloads]).astype(np.float32)
        ress = np.stack([p[3][1:] for p in payloads]).astype(np.float32)
        info = np.asarray(payloads[0][4], np.float32)[None]
        return self.process_gops(key_frames, smalls, mvs, ress, info, first=first)

    @torch.no_grad()
    def process_frame(self, data, im_info, motion_vector=None, res_diff=None,
                      flag: int | None = None, small=None):
        """One frame of the stream. flag (default: `key_frame_flag` of the
        frame count): 0 or 1 runs the key graph on data, a raw (1, H, W, 3)
        BGR or (1, H*3/2, W, 1) I420 frame (flag 0, or any key frame under
        lt_off, restarts the feature recurrence); 2 runs the non-key graph
        on small, the raw 1/small_net_stride frame, made on the host as a
        block mean of the BGR data when omitted, and on motion_vector
        (1, fh, fw, 2) and res_diff (1, fh, fw, 3), zeros when omitted.
        im_info: (3,) or (1, 3).

        Returns (dets (1, M, 6), valid (1, M)), device tensors."""
        if flag is None:
            flag = self.key_frame_flag(self.frame_id)
        m = self.model
        im_info = self._put(im_info, torch.float32).reshape(-1, 3)
        if flag in (0, 1):
            boot = flag == 0 or self.lt_off
            is_first = torch.full((1,), 1.0 if boot else 0.0, device=self.device)
            out = m.forward_key(self._put(data), self.data_key, self.feat_key, is_first)
            self.feat_key = out["feat"]
            self.data_key = out["prep"]
        else:
            if small is None:
                s = small_pool_factor(self.cfg.network.small_net_stride)
                x = torch.as_tensor(data).float()
                b, h, w = x.shape[0], x.shape[1] // s, x.shape[2] // s
                small = x[:, :h * s, :w * s].reshape(b, h, s, w, s, 3).mean(dim=(2, 4))
            fh, fw = self.feat_hw
            mv = (torch.zeros((1, fh, fw, 2), device=self.device) if motion_vector is None
                  else self._put(motion_vector, torch.float32))
            rd = (torch.zeros((1, fh, fw, 3), device=self.device) if res_diff is None
                  else self._put(res_diff, torch.float32))
            out = m.forward_cur(self._put(small), self.feat_key, mv, rd)
        self.frame_id += 1
        return detect_batch(out, self.anchors, im_info, **self.det_kw)


def collect_detections(dets, valid) -> dict:
    """A frame's fixed-size detections ((M, 6) or (1, M, 6), with their
    validity) -> the dict of numpy arrays `vid_eval` reads: labels,
    scores and boxes of the valid rows. Reading a device tensor waits for
    the device."""
    d = torch.as_tensor(dets).cpu().numpy()
    v = torch.as_tensor(valid).cpu().numpy()
    if d.ndim == 3:
        d, v = d[0], v[0]
    d = d[v]
    return {"labels": d[:, 0].astype(int), "scores": d[:, 1], "boxes": d[:, 2:6]}
