"""The entries the window drives, found by name: a traffic mix's ``entry``
value E is the file ``benchmark/entries/<E>.py``, whose ``Driver`` class
drives it.

A driver owns the program's entry for its mix, stages one window of inputs
from the pinned pool, calls the entry, keeps the host copy of every
window's detections by its place in the pool, and works out the same
windows again with the plain reference for the check. What it imports of
the program is the system under test, inside ``build``; the reference side
imports nothing of it. A driver gives:

- ``Driver(cfg, mix, seed, device)``: the pool of inputs from `seed`
  (``benchmark/gen.py``'s generators and helpers), and the attributes
  ``cycle`` (windows in the pool), ``frames_per_window`` and
  ``requests_per_window``;
- ``build(model, program_cfg)``, ``stage(w)``, ``call(staged, w)``,
  ``keep(w, host)``, ``release()``: the program's side;
- ``sample(rng)``, ``program_frames(sample)``,
  ``reference_frames(net, sample)``: the check's, each frame's detections
  as (M, 6) rows (``judge.readings``).

A new entry is a new file here; no other file of the benchmark names one.
"""

from __future__ import annotations

import importlib

import torch

from benchmark.reference import detect as ref_detect


def driver(name: str):
    """The ``Driver`` class of entry `name`, its file imported once a
    process."""
    return importlib.import_module(f"{__name__}.{name}").Driver


def anchor_grid(cfg: dict, device):
    """The anchor grid of the configuration's bucket, on `device`."""
    bh, bw = cfg["tpu"]["default_bucket"]
    s = cfg["network"]["RPN_FEAT_STRIDE"]
    n = cfg["network"]
    return torch.from_numpy(ref_detect.anchor_grid(bh // s, bw // s, s, tuple(n["ANCHOR_RATIOS"]),
                                                   tuple(n["ANCHOR_SCALES"]))).to(device)


def valid_rows(dets, valid):
    """Host (..., M, 6) detections -> list of (M', 6) valid rows."""
    d = dets.reshape(-1, dets.shape[-2], 6)
    v = valid.reshape(-1, valid.shape[-1])
    return [d[i][v[i]] for i in range(d.shape[0])]
