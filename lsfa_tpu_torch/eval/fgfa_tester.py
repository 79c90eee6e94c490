"""Streaming FGFA inference: a window of 2K + 1 frames around each frame,
detections K frames late.

`FGFADetector` keeps, on the device, each lane's last frames: their
preprocessed images, float32 features and image info, enough for every
window it still has to work out. A call takes T new frames of every
lane, runs the trunk over them once (``FGFA.forward_feat``), and emits T
frames a lane: the T frames K behind the newest, whose windows the new
frames complete. Lanes run in lockstep, so a window step aggregates one
centre of every lane in one batch (FlowNet over 2K * B pairs, the tower
over (2K + 1) * B features), and detection runs once over every centre
of the call.

A window slot before a video's first frame or after its last takes that
end frame, as the source's tester pads; the padded slot is still warped
by FlowNet against its end frame, so every frame costs the same. A call
with `first` starts a new video in every lane: the frames it emits first
are the previous video's last K, whose windows end at that video's last
frame. `flush` emits the current video's last K frames. Everything is
enqueued without a host sync: which slots fill a window is worked out on
the host from the frame counts alone.
"""

from __future__ import annotations

import torch

from lsfa_tpu_torch.data.loader import to_device
from lsfa_tpu_torch.eval.detector import anchors_for, detect_batch, detection_kwargs
from lsfa_tpu_torch.utils.profiler import count, span

MAPS = ("rpn_fg", "rpn_deltas", "rfcn_cls_map", "rfcn_bbox_map")


class FGFADetector:
    """FGFA over `batch` streams in lockstep, with the frames of their
    windows resident on the device.

    model: an ``models.fgfa.FGFA`` with its weights; it runs on its own
    device, with window half-width K = ``model.window_k``."""

    def __init__(self, model, cfg, image_hw, batch: int = 1):
        self.model = model.eval()
        self.batch = batch
        self.k = model.window_k
        self.device = next(model.parameters()).device
        self.anchors = anchors_for(cfg, image_hw, self.device)
        self.det_kw = detection_kwargs(cfg)
        self.max_per_image = cfg.TEST.max_per_image
        self._index = {}
        self.reset()

    def reset(self):
        """Forget every video: the next call starts a new one in every lane
        and emits nothing from before it."""
        self.pushed = 0              # frames a lane has been given since the reset
        self.starts = []             # where the videos with frames in the ring began
        self.lo = 0                  # the frame the ring's first row holds
        self.prep = self.feat = self.info = None    # the ring: (rows, B, ...)

    def _rows(self, idx):
        """A cached device tensor of ring rows."""
        key = tuple(idx)
        t = self._index.get(key)
        if t is None:
            t = self._index[key] = to_device(torch.tensor(key, dtype=torch.long), self.device)
        return t

    def _gather(self, rows):
        """The ring's preprocessed frames and features at `rows`."""
        with span("stream.fgfa.ring"):
            idx = self._rows(rows)
            return self.prep.index_select(0, idx), self.feat.index_select(0, idx)

    def window(self, g: int) -> list:
        """The 2K + 1 frames (since the reset) that fill frame g's window,
        g at its middle: each slot clamped into g's video."""
        s = max(x for x in self.starts if x <= g)
        e = min([x for x in self.starts if x > g] + [self.pushed])
        return [min(max(g + d, s), e - 1) for d in range(-self.k, self.k + 1)]

    @torch.no_grad()
    def process_frames(self, frames, im_info, first: bool = False):
        """frames (T, B, H, W, 3) raw BGR, u8 or float, host or device;
        im_info (B, 3) of these frames; first: every lane starts a new
        video with them.

        Returns (dets (T, B, M, 6), valid (T, B, M)), device tensors, for
        the T frames a lane K behind the newest: with `first`, the previous
        video's last K frames, then the new video's first T - K. Rows of
        frames before the reset are all invalid, and cost nothing."""
        with span("stream.fgfa.process_frames", request=True):
            frames = to_device(frames, self.device)
            t, b = frames.shape[:2]
            if first or not self.starts:
                count("stream.restarts", b)
                self.starts.append(self.pushed)
            prep, feat = self.model.forward_feat(frames.flatten(0, 1))
            info = to_device(im_info, self.device, torch.float32).reshape(1, b, 3).expand(t, b, 3)
            self._push(prep.unflatten(0, (t, b)), feat.unflatten(0, (t, b)), info)
            return self._emit(range(self.pushed - t - self.k, self.pushed - self.k))

    @torch.no_grad()
    def flush(self):
        """The current video's last K frames of every lane, as
        `process_frames` returns them ((K, B, M, 6), (K, B, M)); then the
        detector is as after `reset`."""
        with span("stream.fgfa.flush", request=True):
            self.starts.append(self.pushed)
            out = self._emit(range(self.pushed - self.k, self.pushed))
            self.reset()
            return out

    def _push(self, prep, feat, info):
        """Append T frames to the ring, keeping the 2K before them: every
        window still to be emitted lies inside."""
        if self.feat is None:
            self.prep, self.feat, self.info, self.lo = prep, feat, info, self.pushed
        else:
            cut = max(0, self.feat.shape[0] - 2 * self.k)
            with span("stream.fgfa.ring"):
                self.prep = torch.cat([self.prep[cut:], prep])
                self.feat = torch.cat([self.feat[cut:], feat])
                self.info = torch.cat([self.info[cut:], info])
            self.lo += cut
        self.pushed += prep.shape[0]
        # a video none of whose frames is left in the ring bounds no window
        while len(self.starts) > 1 and self.starts[1] <= self.lo:
            del self.starts[0]

    def _emit(self, centres):
        """Detections of the frames `centres` (since the reset), each
        aggregated over its window; a centre before frame 0 is an invalid
        row."""
        k, b, m = self.k, self.batch, self.max_per_image
        maps, infos, skipped = [], [], 0
        for g in centres:
            if g < 0:
                skipped += 1
                continue
            win = self.window(g)
            count("fgfa.padded", b * sum(w != g + d for w, d in zip(win, range(-k, k + 1))))
            c = g - self.lo
            # gathered as arguments, freed when the call returns, not at the next gather
            maps.append(self.model.forward_aggregate(
                self.prep[c], self.feat[c],
                *self._gather([w - self.lo for j, w in enumerate(win) if j != k])))
            infos.append(self.info[c])
        parts = []
        if skipped:
            parts.append((torch.zeros((skipped, b, m, 6), device=self.device),
                          torch.zeros((skipped, b, m), dtype=torch.bool, device=self.device)))
        if maps:
            out = {key: torch.cat([mp[key] for mp in maps]) for key in MAPS}
            d, v = detect_batch(out, self.anchors, torch.cat(infos), **self.det_kw)
            parts.append((d.unflatten(0, (len(maps), b)), v.unflatten(0, (len(maps), b))))
        if len(parts) == 1:
            return parts[0]
        return tuple(torch.cat(x) for x in zip(*parts))
