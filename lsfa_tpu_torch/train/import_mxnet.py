"""Exact import of the reference's MXNet ``.params`` checkpoints onto the
port's ``state_dict``; the counterpart of ``lsfa_tpu.train.import_mxnet``.

The reference saves flat ``arg:<name>`` / ``aux:<name>`` NDArray dicts
(lib/utils/save_model.py:11-25); names come from the symbol builders
(dff_rfcn/symbols/resnet.py, sym_common.py, resnet_v1_101_flownet_rfcn.py).
`torch_to_mx_name` maps every state-dict key of the LSFA/RFCN modules to
its MXNet name, with the JAX package's name rules:

  * module paths join with "_" (``backbone.stage3_unit2.conv2.offset``
    -> ``stage3_unit2_conv2_offset``), the small-net trunk takes
    ``small_net_``, FlowNet keeps its historical layer names, the Nq-net,
    R-net and F-net their prefixes;
  * BatchNorm weight/bias -> gamma/beta (args), running_mean/running_var
    -> moving_mean/moving_var (aux);
  * ``*_test`` de-normalized duplicates (core/callback.py:54-65): ignored
    when the live weights are present; un-baked (/std, -mean) when a
    test-only release ships only the baked pair.

MXNet's layouts are torch's, so tensors are copied as they are: both
store convolution weights OIHW, and MXNet's Deconvolution weight
(in, out, kh, kw) has the layout and the meaning of ``ConvTranspose2d``'s
(each is the gradient of the convolution), so it is not flipped.

``export_mxnet_lsfa`` writes a state dict back in the reference's format
(the inverse map).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from lsfa_tpu_torch.utils.mxnet_io import load_params, save_params, split_arg_aux

# module name -> MXNet layer name, for the flownet's historical names
# (get_flownet, resnet_v1_101_flownet_rfcn.py:150-207)
_FLOWNET_RENAME = {
    "conv1": "flow_conv1",
    "flow6": "Convolution1", "flow5": "Convolution2",
    "flow4": "Convolution3", "flow3": "Convolution4",
    "flow_final": "Convolution5", "scale_map": "Convolution5_scale",
    "upflow5": "upsample_flow6to5", "upflow4": "upsample_flow5to4",
    "upflow3": "upsample_flow4to3", "upflow2": "upsample_flow3to2",
}
_TRANSPOSED = ("deconv", "upflow")
# BatchNorm modules: bn_data, bn0-bn3, the R-net's bn, the fusion's *_bn
_BN_MODULE = re.compile(r"bn(_data|\d*)|\w+_bn")
_BN_SUFFIX = {"weight": "gamma", "bias": "beta", "running_mean": "moving_mean",
              "running_var": "moving_var"}
_STATS = ("running_mean", "running_var")


def _mx_layer_name(mods: tuple[str, ...]) -> str | None:
    """Module path -> MXNet layer name, or None if the module has no
    reference counterpart."""
    top, rest = mods[0], mods[1:]
    if top in ("backbone", "small_net_backbone"):
        prefix = "" if top == "backbone" else "small_net_"
        return prefix + "_".join(rest)
    if top == "flownet":
        assert len(rest) == 1, mods
        return _FLOWNET_RENAME.get(rest[0], rest[0])
    if top == "nq_net":
        m = re.fullmatch(r"conv(\d+)", rest[0])
        return f"Nq_conv{m.group(1)}"
    if top == "fgfa_net":
        return rest[0]                      # em_conv{1..3}
    if top == "rnet":
        if rest[0] == "bn":
            return "res_diff_bn"
        return "rnet_" + rest[0]            # rnet_conv{i}
    if top == "fnet":
        return "fnet_" + rest[0]            # fnet_conv{i}
    if top == "small_fuse":
        return "_".join(rest)               # fuse_reduce_add, cur_scale, ...
    if top == "fuse_downsample":
        return "fuse_downsample"            # fuse_type=concat 1x1
    if not rest:                            # heads at the root
        return top                          # feat_conv_3x3, rpn_*, rfcn_*
    return None


def torch_to_mx_name(key: str):
    """State-dict key -> (MXNet name, kind), kind one of 'conv', 'deconv'
    (a 4-D weight) or 'direct'; None for a module with no reference
    counterpart."""
    *mods, leaf = key.split(".")
    layer = _mx_layer_name(tuple(mods))
    if layer is None:
        return None
    if _BN_MODULE.fullmatch(mods[-1]):
        return f"{layer}_{_BN_SUFFIX[leaf]}", "direct"
    if leaf != "weight":
        return f"{layer}_{leaf}", "direct"
    return f"{layer}_weight", "deconv" if mods[-1].startswith(_TRANSPOSED) else "conv"


def _unbake_rfcn_bbox(arg: dict, bbox_means, bbox_stds):
    """Recover live rfcn_bbox weights from a test-only (baked) release:
    the inverse of do_checkpoint (core/callback.py:54-65)."""
    if "rfcn_bbox_weight" in arg or "rfcn_bbox_weight_test" not in arg:
        return arg
    w = np.asarray(arg["rfcn_bbox_weight_test"], np.float32)
    b = np.asarray(arg["rfcn_bbox_bias_test"], np.float32)
    means = np.asarray(bbox_means, np.float32)
    stds = np.asarray(bbox_stds, np.float32)
    rep = b.shape[0] // means.shape[0]
    stds_r = np.repeat(stds[None], rep, 0).reshape(-1)
    means_r = np.repeat(means[None], rep, 0).reshape(-1)
    arg = dict(arg)
    arg["rfcn_bbox_weight"] = w / stds_r[:, None, None, None]
    arg["rfcn_bbox_bias"] = (b - means_r) / stds_r
    return arg


def import_mxnet_lsfa(state: dict, source,
                      bbox_means=(0.0, 0.0, 0.0, 0.0),
                      bbox_stds=(0.1, 0.1, 0.2, 0.2),
                      strict_modules: tuple[str, ...] = ()):
    """Map an MXNet checkpoint onto a model's ``state_dict()``.

    source: a .params path, or an already-split (arg, aux) pair, or a raw
    ``arg:``/``aux:``-prefixed dict.
    strict_modules: top-level modules that must import completely (every
    key found) or ValueError — use for backbone/flownet parity runs.

    Returns (new state dict, report). The new state holds the imported
    tensors as float32 CPU tensors and the other entries of `state` as
    they were; load it with ``model.load_state_dict``. report: 'imported'
    (state keys), 'missing' (state keys with no checkpoint entry),
    'unused' (checkpoint names never consumed). A checkpoint tensor whose
    shape differs from its key's raises ValueError.
    """
    if isinstance(source, str):
        arg, aux = split_arg_aux(load_params(source))
    elif isinstance(source, tuple):
        arg, aux = dict(source[0]), dict(source[1])
    else:
        arg, aux = split_arg_aux(dict(source))
    arg = _unbake_rfcn_bbox(arg, bbox_means, bbox_stds)

    new = dict(state)
    used: set[str] = set()
    imported: list[str] = []
    missing: list[str] = []
    for key, cur in state.items():
        mapped = torch_to_mx_name(key)
        is_stats = key.endswith(_STATS)
        store = aux if is_stats else arg
        # bn_data has fix_gamma=True: the checkpoint's gamma stays unused,
        # as the module has no weight
        if mapped is None or mapped[0] not in store:
            missing.append(key)
            continue
        name, kind = mapped
        a = np.require(store[name], np.float32, ["C", "W"])
        if a.shape != tuple(cur.shape):
            raise ValueError(f"shape mismatch: mx {name} ({kind}) {a.shape} vs "
                             f"{key} {tuple(cur.shape)}")
        new[key] = torch.from_numpy(a)
        used.add(("aux:" if is_stats else "arg:") + name)
        imported.append(key)

    unused = sorted(
        ({("arg:" + k) for k in arg if not k.endswith("_test")}
         | {("aux:" + k) for k in aux})
        - used)
    report = {"imported": imported, "missing": missing, "unused": unused}

    for mod in strict_modules:
        bad = [m for m in missing if m.split(".", 1)[0] == mod]
        if bad:
            raise ValueError(f"strict import: {mod} missing {bad[:8]}"
                             f" (+{max(0, len(bad) - 8)} more)")
    return new, report


def export_mxnet_lsfa(state: dict, path: str | None = None):
    """Inverse map: a state dict -> the reference's arg:/aux: flat dict of
    float32 numpy arrays (copies), optionally written to ``path`` in
    .params format. Enables running the port's weights in the reference
    toolchain and round-trip tests."""
    flat: dict[str, np.ndarray] = {}
    for key, t in state.items():
        mapped = torch_to_mx_name(key)
        if mapped is None:
            continue
        prefix = "aux:" if key.endswith(_STATS) else "arg:"
        flat[prefix + mapped[0]] = t.detach().to("cpu", torch.float32, copy=True).numpy()
    if path is not None:
        save_params(path, flat)
    return flat
