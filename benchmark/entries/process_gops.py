"""Lockstep lanes: `lanes` streams as the lanes of one
``StreamingDetector`` through ``process_gops``, each window `gops_per_window`
GOPs (``benchmark/gen.py::lane_pool``)."""

from __future__ import annotations

import torch

from benchmark import gen
from benchmark.entries import anchor_grid, valid_rows
from benchmark.reference import detect as ref_detect


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
            out.append(valid_rows(kd[gi, lane], kv[gi, lane]) + valid_rows(cd[gi, :, lane],
                                                                     cv[gi, :, lane]))
        return out

    @torch.no_grad()
    def reference_frames(self, net, sample):
        """The same GOPs by the reference `net`, one lane at a time: the
        lane's key frames replayed from the start of its video for the
        carry, then the GOP's key and non-key frames, through detection
        (`reference.detect.frames`)."""
        dev, cfg, p = self.device, self.cfg, self.pool
        anchors = anchor_grid(cfg, dev)
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


Driver = LaneDriver
