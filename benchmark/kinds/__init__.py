"""Model kinds, found by name: a configuration's ``model`` value X is the
file ``benchmark/kinds/<X>.py``. A kind file gives

- ``program(cfg, device) -> (model, program_cfg)``: the program's network
  for the configuration, on `device`, with its config tree; it imports the
  program inside the function, never at the top of the file;
- ``reference(cfg, prec, device) -> nn.Module``: the plain float32 network
  (``benchmark/reference/``) with every contraction's operands through
  `prec` (``reference.model.Precision``); it refuses a configuration that
  takes a path it does not implement. Its parameter names equal the
  program's, so ``benchmark/weights.py`` makes one state dict for both;
- ``flops_per_frame(net, cfg) -> float``: the model step's FLOPs a frame,
  counted over `net` (the reference on meta tensors) at the cell's shapes
  by ``benchmark/count_flops.py``.

A new kind is a new file here (with its reference network under
``benchmark/reference/``, built from ``reference/model.py``'s blocks); no
other file of the benchmark names a kind.
"""

from __future__ import annotations

import importlib

# the sections of a configuration file that are the program's config overlay
PROGRAM_KEYS = ("symbol", "SCALES", "CLASS_AGNOSTIC", "network", "dataset", "TRAIN", "TEST",
                "tpu")


def find(name: str):
    """The kind file of model `name`, imported once a process."""
    return importlib.import_module(f"{__name__}.{name}")


def program_config(cfg: dict):
    """The program's config tree: its defaults under the configuration's
    overlay."""
    from lsfa_tpu_torch.config import load_config

    return load_config(None, overrides={k: cfg[k] for k in PROGRAM_KEYS if k in cfg})
