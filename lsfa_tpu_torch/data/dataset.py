"""ImageNet VID / DET dataset (roidb) layer. A copy of
``lsfa_tpu.data.dataset`` (numpy, pickle and xml only), which the port
cannot import.

Behavioral targets:
  * lib/dataset/imdb.py — the roidb abstraction: cached gt loading,
    flipped-copy augmentation, filtering;
  * lib/dataset/imagenet_vid.py — the 30 VID classes + WordNet-id mapping
    (:38-55), imageset parsing (DET lines "path id", VID lines
    "path frame_id seg_id seg_len" -> %06d frame patterns, :62-80), XML
    annotation loading (:115-181), pickled roidb cache (:96-113), result
    writing + per-frame eval-list synthesis for video sets (:291-315).

Each roidb entry:
  image, (pattern, frame_id, frame_seg_id, frame_seg_len for VID),
  height, width, boxes (G, 4), gt_classes (G,), flipped.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np

# 30 VID classes: (wordnet id, name); class index = position + 1 (0 = bg)
VID_CLASSES = [
    ("n02691156", "airplane"), ("n02419796", "antelope"),
    ("n02131653", "bear"), ("n02834778", "bicycle"), ("n01503061", "bird"),
    ("n02924116", "bus"), ("n02958343", "car"), ("n02402425", "cattle"),
    ("n02084071", "dog"), ("n02121808", "domestic_cat"),
    ("n02503517", "elephant"), ("n02118333", "fox"),
    ("n02510455", "giant_panda"), ("n02342885", "hamster"),
    ("n02374451", "horse"), ("n02129165", "lion"), ("n01674464", "lizard"),
    ("n02484322", "monkey"), ("n03790512", "motorcycle"),
    ("n02324045", "rabbit"), ("n02509815", "red_panda"),
    ("n02411705", "sheep"), ("n01726692", "snake"), ("n02355227", "squirrel"),
    ("n02129604", "tiger"), ("n04468005", "train"), ("n01662784", "turtle"),
    ("n04530566", "watercraft"), ("n02062744", "whale"), ("n02391049", "zebra"),
]
WNID_TO_CLASS = {w: i + 1 for i, (w, _) in enumerate(VID_CLASSES)}
CLASS_NAMES = ["__background__"] + [n for _, n in VID_CLASSES]
NUM_CLASSES = len(CLASS_NAMES)


class ImageNetVID:
    """roidb provider for an imageset like 'VID_train_15frames',
    'DET_train_30classes', 'VID_val_videos', 'VID_val_frames'."""

    def __init__(self, image_set: str, root_path: str, dataset_path: str,
                 result_path: str | None = None):
        self.image_set = image_set
        self.root_path = root_path
        self.dataset_path = dataset_path
        self.result_path = result_path or root_path
        self.is_vid = image_set.startswith("VID")
        self.classes = CLASS_NAMES
        self.num_classes = NUM_CLASSES
        self._index = self._load_image_set_index()
        self.num_images = len(self._index)

    # ---- imageset parsing (imagenet_vid.py:62-80) ----
    def _imageset_file(self) -> str:
        return os.path.join(self.dataset_path, "ImageSets", self.image_set + ".txt")

    def _load_image_set_index(self):
        path = self._imageset_file()
        entries = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:            # DET-style or val_frames
                    entries.append({"path": parts[0], "frame_id": int(parts[1])})
                elif len(parts) == 4:          # VID: path frame_id seg_id seg_len
                    entries.append({
                        "path": parts[0], "frame_id": int(parts[1]),
                        "frame_seg_id": int(parts[2]),
                        "frame_seg_len": int(parts[3]),
                    })
                else:
                    raise ValueError(f"bad imageset line: {line!r}")
        return entries

    def image_path(self, entry, frame_seg_id: int | None = None) -> str:
        sub = "VID" if self.is_vid else "DET"
        if "frame_seg_id" in entry:
            fid = entry["frame_seg_id"] if frame_seg_id is None else frame_seg_id
            return os.path.join(self.dataset_path, "Data", sub,
                                entry["path"], f"{fid:06d}.JPEG")
        return os.path.join(self.dataset_path, "Data", sub,
                            entry["path"] + ".JPEG")

    def anno_path(self, entry, frame_seg_id: int | None = None) -> str:
        sub = "VID" if self.is_vid else "DET"
        if "frame_seg_id" in entry:
            fid = entry["frame_seg_id"] if frame_seg_id is None else frame_seg_id
            return os.path.join(self.dataset_path, "Annotations", sub,
                                entry["path"], f"{fid:06d}.xml")
        return os.path.join(self.dataset_path, "Annotations", sub,
                            entry["path"] + ".xml")

    def video_path(self, entry) -> str:
        """The mpeg4 snippet the compressed-domain loader decodes
        (mirrors the path surgery in lib/utils/image.py:48-51)."""
        parts = entry["path"].split("/")
        return os.path.join(self.dataset_path, "Data", "VID",
                            "mpeg4_snippets", *parts[:-1], parts[-1] + ".mp4") \
            if len(parts) > 1 else os.path.join(
                self.dataset_path, "Data", "VID", "mpeg4_snippets",
                entry["path"] + ".mp4")

    # ---- annotations (imagenet_vid.py:115-181) ----
    def _load_annotation(self, entry):
        path = self.anno_path(entry)
        rec = {
            "image": self.image_path(entry),
            "flipped": False,
        }
        for k in ("frame_id", "frame_seg_id", "frame_seg_len"):
            if k in entry:
                rec[k] = entry[k]
        if "frame_seg_id" in entry:
            rec["pattern"] = os.path.join(
                self.dataset_path, "Data", "VID", entry["path"], "%06d.JPEG")
        if not os.path.exists(path):
            rec.update(height=0, width=0,
                       boxes=np.zeros((0, 4), np.float32),
                       gt_classes=np.zeros((0,), np.int32))
            return rec
        tree = ET.parse(path)
        size = tree.find("size")
        h = int(size.find("height").text)
        w = int(size.find("width").text)
        boxes, classes = [], []
        for obj in tree.findall("object"):
            wnid = obj.find("name").text
            if wnid not in WNID_TO_CLASS:
                continue
            bb = obj.find("bndbox")
            x1 = np.clip(float(bb.find("xmin").text), 0, w - 1)
            y1 = np.clip(float(bb.find("ymin").text), 0, h - 1)
            x2 = np.clip(float(bb.find("xmax").text), 0, w - 1)
            y2 = np.clip(float(bb.find("ymax").text), 0, h - 1)
            boxes.append([x1, y1, x2, y2])
            classes.append(WNID_TO_CLASS[wnid])
        rec.update(
            height=h, width=w,
            boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            gt_classes=np.asarray(classes, np.int32),
        )
        return rec

    def gt_roidb(self, use_cache: bool = True):
        cache = os.path.join(self.root_path, "cache",
                             f"ImageNetVID_{self.image_set}_gt_roidb.pkl")
        if use_cache and os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)
        roidb = [self._load_annotation(e) for e in self._index]
        if use_cache:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            with open(cache, "wb") as f:
                pickle.dump(roidb, f, protocol=pickle.HIGHEST_PROTOCOL)
        return roidb

    # ---- evaluation glue ----
    def annotations_for_eval(self, roidb):
        """Structured annotations keyed by frame index for eval.vid_eval."""
        out = {}
        for i, rec in enumerate(roidb):
            out[i] = {"labels": rec["gt_classes"], "boxes": rec["boxes"]}
        return out


def append_flipped(roidb):
    """x-flip augmentation (imdb.py:202-231): mirrored copies with flipped
    boxes; the image/MV/residual flip happens at load time."""
    flipped = []
    for rec in roidb:
        r = dict(rec)
        boxes = rec["boxes"].copy()
        if len(boxes):
            w = rec["width"]
            x1 = boxes[:, 0].copy()
            boxes[:, 0] = w - boxes[:, 2] - 1
            boxes[:, 2] = w - x1 - 1
        r["boxes"] = boxes
        r["flipped"] = True
        flipped.append(r)
    return list(roidb) + flipped


def merge_roidb(roidbs):
    """DET + VID concat (lib/utils/load_data.py:38-44)."""
    out = []
    for r in roidbs:
        out.extend(r)
    return out


def filter_roidb(roidb):
    """Drop entries with no gt boxes (lib/utils/load_data.py:47-59)."""
    return [r for r in roidb if len(r["boxes"]) > 0]
