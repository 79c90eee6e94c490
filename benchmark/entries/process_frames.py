"""Lockstep lanes of FGFA: `lanes` streams as the lanes of one
``FGFADetector`` through ``process_frames``, `frames_per_call` new frames
of every lane a call; each lane plays its video of `video_frames` frames,
then all lanes restart together (first=True). A call's detections are
those of the frames K behind its newest (K = TEST.KEY_FRAME_INTERVAL),
so each frame is one request, finished when its call's detections are
read back.

The pool (`ring_pool`): frames (C, T, L, H, W, 3) uint8 BGR of C calls of
T frames for L lanes, drawn on the device by ``benchmark/gen.py``'s
`bgr_frames` a call at a time, then held in pinned host memory; im_info
(L, 3)."""

from __future__ import annotations

import torch

from benchmark import gen
from benchmark.entries import anchor_grid, valid_rows
from benchmark.reference import detect as ref_detect


def ring_pool(cfg: dict, mix: dict, seed: int, device) -> dict:
    gen_ = torch.Generator(device=device).manual_seed(seed)
    lanes, t = mix["lanes"], mix["frames_per_call"]
    bh, bw = cfg["tpu"]["default_bucket"]
    pin = torch.device(device).type == "cuda"
    frames = torch.empty((mix["video_frames"] // t, t, lanes, bh, bw, 3), dtype=torch.uint8,
                         pin_memory=pin)
    for call in frames:
        call.copy_(gen.bgr_frames(gen_, t * lanes, cfg, device).reshape(t, lanes, bh, bw, 3))
    return {"frames": frames, "im_info": gen.im_info(cfg, lanes)}


class RingDriver:
    """`lanes` streams in lockstep through ``FGFADetector.process_frames``."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        self.lanes, self.t = mix["lanes"], mix["frames_per_call"]
        self.k = cfg["TEST"]["KEY_FRAME_INTERVAL"]
        self.length = mix["video_frames"]
        if self.length % self.t or self.t < self.k:
            raise ValueError("video_frames must be a whole number of calls of at least K frames")
        self.cycle = self.length // self.t
        self.frames_per_window = self.requests_per_window = self.t * self.lanes
        self.pool = ring_pool(cfg, mix, seed, self.device)
        self.im_info = self.pool["im_info"].to(self.device)
        self.kept = {}

    def build(self, model, program_cfg):
        from lsfa_tpu_torch.eval.fgfa_tester import FGFADetector

        self.det = FGFADetector(model, program_cfg, tuple(self.cfg["tpu"]["default_bucket"]),
                                batch=self.lanes)

    def stage(self, w: int):
        return self.pool["frames"][w % self.cycle].to(self.device, non_blocking=True)

    def call(self, staged, w: int):
        return self.det.process_frames(staged, self.im_info, first=w % self.cycle == 0)

    def keep(self, w: int, host):
        self.kept[w % self.cycle] = host

    def _call_row(self, f: int):
        """(call of the video, row) whose detections are video frame f: row
        r of call i is frame i*T - K + r, the previous video's where that
        is negative (every video is the pool's)."""
        q = (f + self.k) % self.length
        return q // self.t, q % self.t

    def release(self):
        self.det = None

    def sample(self, rng):
        """`check_frames_per_lane` finished frames of each lane, drawn from
        `rng`, at least one of them within `check_edge_frames` of a video's
        start or end where one is finished: [(lane, frame)]."""
        done = sorted(f for f in range(self.length) if self._call_row(f)[0] in self.kept)
        edge_n = self.mix["check_edge_frames"]
        edge = [f for f in done if f < edge_n or f >= self.length - edge_n]
        out = []
        for lane in range(self.lanes):
            picked = [edge[int(rng.integers(len(edge)))]] if edge else []
            rest = [f for f in done if f not in picked]
            n = min(self.mix["check_frames_per_lane"] - len(picked), len(rest))
            picked += [rest[int(j)] for j in rng.choice(len(rest), size=n, replace=False)]
            out += [(lane, f) for f in sorted(picked)]
        return out

    def program_frames(self, sample):
        out = []
        for lane, f in sample:
            i, r = self._call_row(f)
            dets, valid = self.kept[i]
            out.append(valid_rows(dets[r, lane], valid[r, lane]))
        return out

    @torch.no_grad()
    def reference_frames(self, net, sample):
        """Each sampled frame by the reference `net` from its window: the
        frames f - K .. f + K of its lane, clamped into the video."""
        anchors = anchor_grid(self.cfg, self.device)
        frames, t = self.pool["frames"], self.t
        out = []
        for lane, f in sample:
            slots = [min(max(f + d, 0), self.length - 1) for d in range(-self.k, self.k + 1)]
            distinct = sorted(set(slots))
            imgs = torch.stack([frames[j // t, j % t, lane] for j in distinct]).to(self.device)
            maps = net(imgs, [distinct.index(j) for j in slots])
            out.append(ref_detect.frames(maps, anchors, self.im_info[lane:lane + 1], self.cfg))
        return out


Driver = RingDriver
