"""Configuration tree for lsfa_tpu_torch.

The same knobs and defaults as ``lsfa_tpu.config`` (a nested attribute
dict with hard defaults, a strict YAML overlay where unknown keys raise,
and derived network fields), carried here because importing any module of
``lsfa_tpu`` imports JAX. ``yaml`` is imported only inside ``load_config``.

The ``tpu`` section keeps its name so that YAML files written for the JAX
package load unchanged. Of it the port reads ``compute_dtype``,
``default_bucket`` and ``nms_tier``; the knobs that worked around a TPU
runtime (``mv_res_dtype``, ``sync_per_window``, ``scan_only``) are parsed
and ignored: payloads are float32 and every GOP is one eager step.
"""

from __future__ import annotations

import copy

import torch


class AttrDict(dict):
    """dict with attribute access; nested dicts are converted on insert."""

    def __init__(self, d=None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, AttrDict):
            v = AttrDict(v)
        super().__setitem__(k, v)

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def copy(self):
        return copy.deepcopy(self)


def get_default_config() -> AttrDict:
    """Defaults, field for field those of ``lsfa_tpu.config``."""
    c = AttrDict()
    c.output_path = "./output"
    c.symbol = "lsfa"
    c.CLASS_AGNOSTIC = True
    c.SCALES = [(600, 1000)]        # (short side target, long side cap)

    c.default = AttrDict()
    c.default.frequent = 20

    n = c.network = AttrDict()
    n.pretrained = ""
    n.pretrained_flow = ""
    n.pretrained_detector = ""
    n.nettype = "resnet"
    n.num_layer = 101
    n.pretrained_epoch = 0
    n.PIXEL_MEANS = [0.0, 0.0, 0.0]
    n.PIXEL_SCALE = 1.0
    n.IMAGE_STRIDE = 0
    n.RPN_FEAT_STRIDE = 16
    n.RCNN_FEAT_STRIDE = 16
    n.FIXED_PARAMS = ["gamma", "beta"]
    n.ANCHOR_SCALES = (8, 16, 32)
    n.ANCHOR_RATIOS = (0.5, 1, 2)
    n.NORMALIZE_RPN = True
    n.ANCHOR_MEANS = (0.0, 0.0, 0.0, 0.0)
    n.ANCHOR_STDS = (0.1, 0.1, 0.4, 0.4)
    n.NUM_ANCHORS = 9
    n.DFF_FEAT_DIM = 1024
    n.rnet_num_conv = 0
    n.fnet_type = "None"
    n.fuse_type = "add"
    n.res_diff_bn = False
    n.res_diff_legacy_swap = False
    n.add_dcn = True
    n.add_small_net = True
    n.small_net_bn_before_fuse = False
    n.small_net_scale_before_fuse = False
    n.small_net_stride = 4
    n.small_net_fuse_type = "add"
    n.add_Nq_net = True
    n.add_Fgfa_net = False
    n.add_rnet = True
    n.add_lt_aggregation = True

    d = c.dataset = AttrDict()
    d.dataset = "ImageNetVID"
    d.image_set = "DET_train_30classes+VID_train_15frames"
    d.test_image_set = "VID_val_videos"
    d.root_path = "./data"
    d.dataset_path = "./data/ILSVRC2015"
    d.NUM_CLASSES = 31

    t = c.TRAIN = AttrDict()
    t.lr = 2.5e-4
    t.lr_step = "1.333"
    t.lr_factor = 0.1
    t.warmup = False
    t.warmup_lr = 0.0
    t.warmup_step = 0
    t.momentum = 0.9
    t.wd = 0.0005
    t.begin_epoch = 0
    t.end_epoch = 2
    t.model_prefix = "lsfa"
    t.RESUME = False
    t.FLIP = True
    t.SHUFFLE = True
    t.ENABLE_OHEM = True
    t.BATCH_IMAGES = 1
    t.END2END = True
    t.ASPECT_GROUPING = True
    t.BATCH_ROIS = -1
    t.BATCH_ROIS_OHEM = 128
    t.FG_FRACTION = 0.25
    t.FG_THRESH = 0.5
    t.BG_THRESH_HI = 0.5
    t.BG_THRESH_LO = 0.0
    t.BBOX_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    t.RPN_BATCH_SIZE = 256
    t.RPN_FG_FRACTION = 0.5
    t.RPN_POSITIVE_OVERLAP = 0.7
    t.RPN_NEGATIVE_OVERLAP = 0.3
    t.RPN_CLOBBER_POSITIVES = False
    t.RPN_BBOX_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    t.RPN_POSITIVE_WEIGHT = -1.0
    t.RPN_NMS_THRESH = 0.7
    t.RPN_PRE_NMS_TOP_N = 6000
    t.RPN_POST_NMS_TOP_N = 300
    t.RPN_MIN_SIZE = 0
    t.BBOX_NORMALIZATION_PRECOMPUTED = True
    t.BBOX_MEANS = (0.0, 0.0, 0.0, 0.0)
    t.BBOX_STDS = (0.1, 0.1, 0.2, 0.2)
    t.MIN_OFFSET = -9
    t.MAX_OFFSET = 0

    e = c.TEST = AttrDict()
    e.HAS_RPN = True
    e.BATCH_IMAGES = 1
    e.RPN_NMS_THRESH = 0.7
    e.RPN_PRE_NMS_TOP_N = 6000
    e.RPN_POST_NMS_TOP_N = 300
    e.RPN_MIN_SIZE = 0
    e.NMS = 0.3
    e.KEY_FRAME_INTERVAL = 12
    e.max_per_image = 300
    e.test_epoch = 0
    e.SCORE_THRESH = 1e-3

    p = c.tpu = AttrDict()
    p.compute_dtype = "bfloat16"    # backbone/flownet/heads compute dtype
    p.param_dtype = "float32"
    p.image_buckets = [(608, 1024), (1024, 608), (608, 960)]
    p.eval_gop_window = 2
    p.default_bucket = (608, 1024)
    p.mesh_axes = AttrDict({"data": -1})
    p.max_gt_boxes = 100
    # RPN NMS runs on the top `nms_tier` pre-NMS boxes (0 = all of them)
    p.nms_tier = 2048
    p.decode_workers = 0
    p.nms_pallas = True
    p.mv_res_dtype = "float16"
    p.sync_per_window = False
    p.scan_only = True
    p.frame_payload = "i420"
    p.small_src = "yuv"
    p.res_src = "yuv"

    _finalize(c)
    return c


def _finalize(c: AttrDict) -> None:
    c.network.NUM_ANCHORS = len(c.network.ANCHOR_SCALES) * len(c.network.ANCHOR_RATIOS)
    if c.network.IMAGE_STRIDE != 0:
        raise NotImplementedError(
            "network.IMAGE_STRIDE != 0 is unsupported: bucket padding "
            "replaces stride padding (tpu.image_buckets)")
    if c.TRAIN.RPN_POSITIVE_WEIGHT != -1.0:
        raise NotImplementedError(
            "TRAIN.RPN_POSITIVE_WEIGHT is not implemented; only the -1.0 "
            "default is valid")
    if not c.TRAIN.END2END:
        raise NotImplementedError(
            "TRAIN.END2END=false (alternate-phase training) is not supported")
    if not c.TEST.HAS_RPN:
        raise NotImplementedError(
            "TEST.HAS_RPN=false (pre-computed proposals) is not supported")


def _merge(dst: AttrDict, src: dict, path: str = "") -> None:
    """Strict merge: every key in src must already exist in dst."""
    for k, v in src.items():
        if k not in dst:
            raise KeyError(f"unknown config key: {path}{k}")
        if isinstance(v, dict) and isinstance(dst[k], AttrDict):
            _merge(dst[k], v, path=f"{path}{k}.")
        else:
            if k == "SCALES":
                v = [tuple(s) for s in v] if isinstance(v[0], (list, tuple)) else [tuple(v)]
            dst[k] = v


def load_config(path: str | None = None, overrides: dict | None = None) -> AttrDict:
    """Build a config: defaults, then strict YAML overlay, then overrides."""
    c = get_default_config()
    if path is not None:
        import yaml

        with open(path) as f:
            _merge(c, yaml.safe_load(f))
    if overrides:
        _merge(c, overrides)
    _finalize(c)
    return c


def compute_dtype(cfg: AttrDict) -> torch.dtype:
    """The torch dtype named by ``cfg.tpu.compute_dtype``."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.tpu.compute_dtype]
