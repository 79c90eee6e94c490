"""Carry flax weights of ``lsfa_tpu`` into a torch ``state_dict``.

Input: the flax variables {"params": ..., "batch_stats": ...} as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, variables)``); nothing
here imports JAX. Module paths map one to one, because the torch modules
carry the flax module names; the `BatchNorm_0` level that the JAX
package's BatchNorm wrapper adds is dropped. Leaves:

  conv kernel (kh, kw, in, out)   -> weight (out, in, kh, kw)
  ConvTranspose kernel            -> weight (in, out, kh, kw), spatially
                                     flipped: flax's transposed conv does
                                     not flip its kernel, torch's does
  dense kernel (in, out)          -> weight (out, in)
  BN scale / bias / mean / var    -> weight / bias / running_mean /
                                     running_var (bn_data has no scale)

Transposed convs are the FlowNet modules named deconv* and upflow*.
"""

from __future__ import annotations

import numpy as np
import torch

_TRANSPOSED = ("deconv", "upflow")
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_torch(variables) -> dict:
    """flax variable tree (numpy leaves) -> torch state_dict (float32 CPU
    tensors, keyed like ``LSFA.state_dict()``)."""
    out = {}
    for col in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(col, {})):
            mods = [p for p in path[:-1] if p != "BatchNorm_0"]
            leaf = path[-1]
            if leaf == "kernel":
                if arr.ndim == 4 and mods[-1].startswith(_TRANSPOSED):
                    arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
                elif arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:
                    arr = arr.T
                name = "weight"
            else:
                name = _LEAF[leaf]
            key = ".".join(mods + [name])
            out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out
