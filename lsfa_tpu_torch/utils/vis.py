"""Detection visualization (the reference's lib/utils/show_boxes.py role);
the counterpart of ``lsfa_tpu.utils.vis``, without PIL.

`draw_detections` draws each detection's box as a 2-pixel outline (the
pixels of PIL's ``ImageDraw.rectangle(box, width=2)``) and its label
"name score" above it, on an RGB uint8 array; `write_png` writes the
array as an 8-bit RGB PNG with the standard library's zlib. Deviations
from the JAX module: the result is an array, not a PIL image; the labels
are drawn in a 3x5 bitmap font kept in this module, at twice its size
(PIL's default font is another); and the launchers write PNG files, where
JAX's evaluation launcher writes JPEG.
"""

from __future__ import annotations

import colorsys
import struct
import zlib

import numpy as np

from lsfa_tpu_torch.data.dataset import CLASS_NAMES

# 3x5 glyphs, five rows of three columns ('#' on); letters print as capitals
_GLYPHS = {
    "a": (".#.", "#.#", "###", "#.#", "#.#"), "b": ("##.", "#.#", "##.", "#.#", "##."),
    "c": (".##", "#..", "#..", "#..", ".##"), "d": ("##.", "#.#", "#.#", "#.#", "##."),
    "e": ("###", "#..", "##.", "#..", "###"), "f": ("###", "#..", "##.", "#..", "#.."),
    "g": (".##", "#..", "#.#", "#.#", ".##"), "h": ("#.#", "#.#", "###", "#.#", "#.#"),
    "i": ("###", ".#.", ".#.", ".#.", "###"), "j": ("..#", "..#", "..#", "#.#", ".#."),
    "k": ("#.#", "#.#", "##.", "#.#", "#.#"), "l": ("#..", "#..", "#..", "#..", "###"),
    "m": ("#.#", "###", "###", "#.#", "#.#"), "n": ("##.", "#.#", "#.#", "#.#", "#.#"),
    "o": (".#.", "#.#", "#.#", "#.#", ".#."), "p": ("##.", "#.#", "##.", "#..", "#.."),
    "q": (".#.", "#.#", "#.#", "##.", ".##"), "r": ("##.", "#.#", "##.", "#.#", "#.#"),
    "s": (".##", "#..", ".#.", "..#", "##."), "t": ("###", ".#.", ".#.", ".#.", ".#."),
    "u": ("#.#", "#.#", "#.#", "#.#", ".##"), "v": ("#.#", "#.#", "#.#", ".#.", ".#."),
    "w": ("#.#", "#.#", "###", "###", "#.#"), "x": ("#.#", "#.#", ".#.", "#.#", "#.#"),
    "y": ("#.#", "#.#", ".#.", ".#.", ".#."), "z": ("###", "..#", ".#.", "#..", "###"),
    "0": ("###", "#.#", "#.#", "#.#", "###"), "1": (".#.", "##.", ".#.", ".#.", "###"),
    "2": ("##.", "..#", ".#.", "#..", "###"), "3": ("##.", "..#", ".#.", "..#", "##."),
    "4": ("#.#", "#.#", "###", "..#", "..#"), "5": ("###", "#..", "##.", "..#", "##."),
    "6": (".##", "#..", "###", "#.#", "###"), "7": ("###", "..#", ".#.", ".#.", ".#."),
    "8": ("###", "#.#", "###", "#.#", "###"), "9": ("###", "#.#", "###", "..#", "##."),
    ".": ("...", "...", "...", "...", ".#."), "_": ("...", "...", "...", "...", "###"),
    "-": ("...", "...", "###", "...", "..."), " ": ("...", "...", "...", "...", "..."),
    "?": ("##.", "..#", ".#.", "...", ".#."),
}
GLYPH_W, GLYPH_H = 3, 5
TEXT_SCALE = 2                # each glyph drawn at 6x10 pixels, 8 pixels apart


def _glyph(ch: str) -> np.ndarray:
    """The (GLYPH_H, GLYPH_W) bool bitmap of a character ('?' where the
    font has none)."""
    rows = _GLYPHS.get(ch.lower(), _GLYPHS["?"])
    return np.asarray([[c == "#" for c in r] for r in rows])


def text_mask(text: str) -> np.ndarray:
    """The bool pixels of `text` in the bitmap font: (10, 8 * len - 2)."""
    s = TEXT_SCALE
    if not text:
        return np.zeros((GLYPH_H * s, 0), bool)
    cells = [np.pad(_glyph(c), ((0, 0), (0, 1))) for c in text]
    mask = np.concatenate(cells, axis=1)[:, :-1]
    return mask.repeat(s, axis=0).repeat(s, axis=1)


def class_color(idx: int, n: int = 31):
    r, g, b = colorsys.hsv_to_rgb((idx * 0.41) % 1.0, 0.9, 1.0)
    return int(r * 255), int(g * 255), int(b * 255)


def _hline(img, x0: int, y: int, x1: int, color):
    h, w = img.shape[:2]
    x0, x1 = min(x0, x1), max(x0, x1)
    if 0 <= y < h and x1 >= 0 and x0 < w:
        img[y, max(x0, 0):min(x1, w - 1) + 1] = color


def _vline(img, x: int, start: int, stop: int, color):
    """Rows from `start` toward `stop`, `stop` excluded (none when they
    are equal), of column x, clipped to the image."""
    h, w = img.shape[:2]
    if start == stop or not 0 <= x < w:
        return
    lo, hi = (start, stop - 1) if start < stop else (stop + 1, start)
    if hi >= 0 and lo < h:
        img[max(lo, 0):min(hi, h - 1) + 1, x] = color


def draw_rectangle(img: np.ndarray, box, color, width: int = 2):
    """A `width`-pixel outline of box (x1, y1, x2, y2) on img (H, W, 3)
    uint8 in place: the pixels of PIL's ``ImageDraw.rectangle`` (Pillow
    12), degenerate boxes included. The corners are the box's truncated
    toward zero; the top and bottom edges are `width` full rows, inner
    rows toward the box's middle, and each side column runs from `width`
    rows below the top toward the row after the bottom edge's inner row,
    that row excluded."""
    x0, y0, x1, y1 = (int(v) for v in box)
    y0, y1 = min(y0, y1), max(y0, y1)
    for i in range(width):
        _hline(img, x0, y0 + i, x1, color)
        _hline(img, x0, y1 - i, x1, color)
        _vline(img, x1 - i, y0 + width, y1 - width + 1, color)
        _vline(img, x0 + i, y0 + width, y1 - width + 1, color)


def label_origin(box) -> tuple[int, int]:
    """The top-left pixel (x, y) of a box's label: 2 pixels right of its
    left edge and 12 above its top, clamped at the image's top, as JAX
    places its text."""
    return int(float(box[0]) + 2), int(max(float(box[1]) - 12, 0))


def draw_text(img: np.ndarray, origin, text: str, color):
    """`text` in the bitmap font with its top-left pixel at origin (x, y),
    clipped to img, in place."""
    mask = text_mask(text)
    x, y = origin
    h, w = img.shape[:2]
    mh, mw = mask.shape
    y0, y1, x0, x1 = max(y, 0), min(y + mh, h), max(x, 0), min(x + mw, w)
    if y0 < y1 and x0 < x1:
        img[y0:y1, x0:x1][mask[y0 - y:y1 - y, x0 - x:x1 - x]] = color


def label_text(label: int, score: float) -> str:
    lbl = int(label)
    name = CLASS_NAMES[lbl] if lbl < len(CLASS_NAMES) else str(label)
    return f"{name} {score:.2f}"


def draw_detections(image_rgb: np.ndarray, dets: dict, score_thresh: float = 0.3) -> np.ndarray:
    """A copy of image_rgb (H, W, 3) as uint8 with every detection of at
    least score_thresh drawn in its class's color, in the order given.
    dets: {labels, scores, boxes} (``eval.tester.collect_detections``);
    decoded boxes can have their corners crossed, and are sorted first."""
    img = np.ascontiguousarray(image_rgb.astype(np.uint8))
    for lbl, sc, box in zip(dets["labels"], dets["scores"], dets["boxes"]):
        if sc < score_thresh:
            continue
        color = class_color(int(lbl))
        x1, y1, x2, y2 = (float(v) for v in box)
        box = (min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2))
        draw_rectangle(img, box, color, width=2)
        draw_text(img, label_origin(box), label_text(lbl, sc), color)
    return img


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray, level: int = 6):
    """Write rgb (H, W, 3) uint8 as an 8-bit RGB PNG (every row filter 0,
    zlib at `level`)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, not {rgb.shape}")
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(_png_chunk(b"IEND", b""))
