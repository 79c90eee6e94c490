"""The entries the window drives, one class per kind of traffic mix.

A driver owns the program's entry for its mix (``StreamingDetector.
process_gops`` over lockstep lanes, or ``RFCNDetector.detect`` per frame),
stages one window of inputs from the pinned pool, calls the entry, keeps
the host copy of every window's detections by its place in the pool, and
works out the same windows again with the plain reference for the check.
What it imports of the program is the system under test; the reference
side imports nothing of it.
"""

from __future__ import annotations

import torch

from benchmark import gen
from benchmark.reference import detect as ref_detect


def _anchors(cfg, device):
    bh, bw = cfg["tpu"]["default_bucket"]
    s = cfg["network"]["RPN_FEAT_STRIDE"]
    n = cfg["network"]
    return torch.from_numpy(ref_detect.anchor_grid(bh // s, bw // s, s, tuple(n["ANCHOR_RATIOS"]),
                                                   tuple(n["ANCHOR_SCALES"]))).to(device)


def _frames(dets, valid):
    """Host (..., M, 6) detections -> list of (M', 6) valid rows."""
    d = dets.reshape(-1, dets.shape[-2], 6)
    v = valid.reshape(-1, valid.shape[-1])
    return [d[i][v[i]] for i in range(d.shape[0])]


class LaneDriver:
    """`lanes` streams in lockstep through ``StreamingDetector.process_gops``:
    windows of `gops_per_window` GOPs; each lane plays its video of
    `video_gops` GOPs, then all lanes restart together (first=True)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        self.lanes, self.gpw = mix["lanes"], mix["gops_per_window"]
        if mix["video_gops"] % self.gpw:
            raise ValueError("video_gops must be a whole number of windows")
        self.cycle = mix["video_gops"] // self.gpw
        self.gop_frames = cfg["TEST"]["KEY_FRAME_INTERVAL"]
        self.frames_per_window = self.gpw * self.gop_frames * self.lanes
        self.requests_per_window = self.gpw * self.lanes
        self.pool = gen.lane_pool(cfg, mix, seed, self.device)
        self.im_info = self.pool["im_info"].to(self.device)
        self.kept = {}

    def build(self, model, program_cfg):
        from lsfa_tpu_torch.eval.tester import StreamingDetector

        self.det = StreamingDetector(model, program_cfg, tuple(self.cfg["tpu"]["default_bucket"]),
                                     batch=self.lanes)

    def stage(self, w: int):
        i = w % self.cycle
        sl = slice(i * self.gpw, (i + 1) * self.gpw)
        p = self.pool
        return tuple(p[k][sl].to(self.device, non_blocking=True)
                     for k in ("key_frames", "smalls", "mvs", "ress"))

    def call(self, staged, w: int):
        return self.det.process_gops(*staged, self.im_info, first=w % self.cycle == 0)

    def keep(self, w: int, host):
        self.kept[w % self.cycle] = host

    def release(self):
        self.det = None

    def sample(self, rng):
        """One finished GOP of each lane, drawn from `rng`: [(lane, gop)]."""
        done = sorted(self.kept)
        out = []
        for lane in range(self.lanes):
            i = done[int(rng.integers(len(done)))]
            out.append((lane, i * self.gpw + int(rng.integers(self.gpw))))
        return out

    def program_frames(self, sample):
        """The program's detections of each sampled GOP: key frame first,
        then its non-key frames."""
        out = []
        for lane, g in sample:
            kd, kv, cd, cv = self.kept[g // self.gpw]
            gi = g % self.gpw
            out.append(_frames(kd[gi, lane], kv[gi, lane]) + _frames(cd[gi, :, lane],
                                                                     cv[gi, :, lane]))
        return out

    @torch.no_grad()
    def reference_frames(self, net, sample):
        """The same GOPs by the reference `net`, one lane at a time: the
        lane's key frames replayed from the start of its video for the
        carry, then the GOP's key and non-key frames, through detection
        (`reference.detect.frames`)."""
        dev, cfg, p = self.device, self.cfg, self.pool
        anchors = _anchors(cfg, dev)
        bh, bw = cfg["tpu"]["default_bucket"]
        s = cfg["network"]["RPN_FEAT_STRIDE"]
        c = cfg["network"]["DFF_FEAT_DIM"]
        out = []
        for lane, g in sample:
            info = self.im_info[lane:lane + 1]
            feat = torch.zeros(1, bh // s, bw // s, c, device=dev)
            prep = torch.zeros(1, bh, bw, 3, device=dev)
            for j in range(g + 1):
                first = torch.full((1,), 1.0 if j == 0 else 0.0, device=dev)
                maps = net.forward_key(p["key_frames"][j, lane:lane + 1].to(dev), prep, feat,
                                       first)
                feat, prep = maps["feat"], maps["prep"]
            key = ref_detect.frames(maps, anchors, info, cfg)
            n = p["mvs"].shape[1]
            cur = net.forward_cur(p["smalls"][g, :, lane].to(dev), feat.expand(n, -1, -1, -1),
                                  p["mvs"][g, :, lane].to(dev), p["ress"][g, :, lane].to(dev))
            out.append(key + ref_detect.frames(cur, anchors, info, cfg))
        return out


class FrameDriver:
    """One stream of frames through ``RFCNDetector.detect``, one frame a
    call, cycling through a pool of `pool_frames` frames."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        self.pool = gen.frame_pool(cfg, mix, seed, self.device)
        self.cycle = mix["pool_frames"]
        self.frames_per_window = 1
        self.requests_per_window = 1
        self.im_info = self.pool["im_info"].to(self.device)
        self.kept = {}

    def build(self, model, program_cfg):
        from lsfa_tpu_torch.eval.rfcn_tester import RFCNDetector

        self.det = RFCNDetector(model, program_cfg, tuple(self.cfg["tpu"]["default_bucket"]))

    def stage(self, w: int):
        return self.pool["frames"][w % self.cycle].to(self.device, non_blocking=True)

    def call(self, staged, w: int):
        return self.det.detect(staged, self.im_info)

    def keep(self, w: int, host):
        self.kept[w % self.cycle] = host

    def release(self):
        self.det = None

    def sample(self, rng):
        done = sorted(self.kept)
        k = min(self.mix["check_frames"], len(done))
        return sorted(int(done[i]) for i in rng.choice(len(done), size=k, replace=False))

    def program_frames(self, sample):
        return [_frames(*self.kept[i]) for i in sample]

    @torch.no_grad()
    def reference_frames(self, net, sample):
        anchors = _anchors(self.cfg, self.device)
        return [ref_detect.frames(net(self.pool["frames"][i].to(self.device)), anchors,
                                  self.im_info, self.cfg) for i in sample]


DRIVERS = {"process_gops": LaneDriver, "detect": FrameDriver}
