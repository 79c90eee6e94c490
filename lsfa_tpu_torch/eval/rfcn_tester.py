"""Single-frame R-FCN inference, the baseline's test path; the counterpart
of ``lsfa_tpu.eval.rfcn_tester``.

Every frame runs the whole network: forward, proposals (the RPN NMS in
the ``nms_sweep`` kernel on a card), PSROI scoring and per-class NMS (the
same kernel), with no key-frame state. The frame is enqueued without
waiting for the device.
"""

from __future__ import annotations

import torch

from lsfa_tpu_torch.config import compute_dtype
from lsfa_tpu_torch.data.loader import to_device
from lsfa_tpu_torch.eval.detector import anchors_for, detect_from_maps, detection_kwargs
from lsfa_tpu_torch.models.lsfa import resolve_device
from lsfa_tpu_torch.models.rfcn import RFCN


def rfcn_from_config(cfg, device=None) -> RFCN:
    """Build the R-FCN of a config tree on `device` (the card when None;
    raises without one unless device="cpu"). Weights are uninitialized:
    call ``models.lsfa.init_params`` or load a converted state dict."""
    n = cfg.network
    return RFCN(
        num_classes=cfg.dataset.NUM_CLASSES,
        num_reg_classes=2 if cfg.CLASS_AGNOSTIC else cfg.dataset.NUM_CLASSES,
        feat_dim=n.DFF_FEAT_DIM,
        num_layer=n.num_layer,
        num_anchors=n.NUM_ANCHORS,
        add_dcn=n.add_dcn,
        anchor_means=tuple(n.ANCHOR_MEANS),
        anchor_stds=tuple(n.ANCHOR_STDS),
        normalize_rpn=n.NORMALIZE_RPN,
        pixel_means=tuple(float(m) for m in n.PIXEL_MEANS),
        pixel_scale=float(n.PIXEL_SCALE),
        dtype=compute_dtype(cfg),
        device=resolve_device(device),
    )


class RFCNDetector:
    """Stateless per-frame detector over an R-FCN module with its weights,
    on the module's device, for frames of one image_hw bucket."""

    def __init__(self, model, cfg, image_hw):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.anchors = anchors_for(cfg, image_hw, self.device)
        self.det_kw = detection_kwargs(cfg)

    @torch.no_grad()
    def detect(self, data, im_info):
        """data: a raw resized BGR frame (1, H, W, 3), u8 or float, host or
        device; im_info (1, 3) [h, w, scale]. Returns (dets (M, 6)
        [label, score, x1, y1, x2, y2] in original-image coordinates,
        valid (M,)), device tensors."""
        out = self.model(to_device(data, self.device))
        im_info = to_device(im_info, self.device, torch.float32).reshape(-1, 3)
        return detect_from_maps(out, self.anchors, im_info[0], **self.det_kw)
