"""One stream of frames through ``RFCNDetector.detect``, a frame a call
(``benchmark/gen.py::frame_pool``)."""

from __future__ import annotations

import torch

from benchmark import gen
from benchmark.entries import anchor_grid, valid_rows
from benchmark.reference import detect as ref_detect


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
        return [valid_rows(*self.kept[i]) for i in sample]

    @torch.no_grad()
    def reference_frames(self, net, sample):
        anchors = anchor_grid(self.cfg, self.device)
        return [ref_detect.frames(net(self.pool["frames"][i].to(self.device)), anchors,
                                  self.im_info, self.cfg) for i in sample]


Driver = FrameDriver
