"""Convert a reference MXNet checkpoint into a checkpoint of this package.

Usage:
  python -m lsfa_tpu_torch.tools.import_reference_checkpoint \
      --cfg lsfa_tpu_torch/configs/lsfa_resnet101_vid.json \
      --params /path/to/lsfa-0002.params [--flownet /path/to/flownet-0000.params] \
      --out /path/to/ckpt_dir [--strict backbone,flownet] [--device cpu]

The counterpart of ``tools/import_reference_checkpoint.py``. It builds the
config's model (LSFA, or the R-FCN for an ``rfcn*`` symbol) from seed 0,
maps the reference's flat arg:/aux: NDArray dict(s)
(lib/utils/save_model.py:11-25) onto its state dict
(``train/import_mxnet.py``), seeds the small net from the backbone
(init_weight, resnet_v1_101_flownet_rfcn.py:753-760), and writes
``<out>/0.pt`` in the format of ``train/checkpoint.py``: the model, the
optimizer and scheduler of ``make_optimizer``, step 0 and a seeded
generator state, so that ``load_checkpoint``, ``TRAIN.RESUME`` and
``experiments/lsfa_test.py`` read it. It builds on the card unless given
``--device cpu``. Reminder: weights trained by the reference expect
network.res_diff_legacy_swap=True at data-loading time (the reference's
residual channel-transform bug, lib/utils/image.py:217-218).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", required=True, help=".json or .yaml config")
    ap.add_argument("--params", required=True, help=".params checkpoint")
    ap.add_argument("--flownet", default=None,
                    help="optional separate FlowNet .params (combine_model)")
    ap.add_argument("--out", required=True, help="checkpoint directory")
    ap.add_argument("--strict", default="",
                    help="comma list of modules that must import fully")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from lsfa_tpu_torch.config import load_config
    from lsfa_tpu_torch.train.checkpoint import save_checkpoint, seed_small_net
    from lsfa_tpu_torch.train.driver import build_model
    from lsfa_tpu_torch.train.import_mxnet import import_mxnet_lsfa
    from lsfa_tpu_torch.train.schedule import make_optimizer
    from lsfa_tpu_torch.utils.mxnet_io import load_params

    cfg = load_config(args.cfg)
    model = build_model(cfg, 0, args.device)
    device = next(model.parameters()).device
    state = model.state_dict()
    strict = tuple(m for m in args.strict.split(",") if m)
    for path in [args.params] + ([args.flownet] if args.flownet else []):
        t0 = time.perf_counter()
        raw = load_params(path)
        t1 = time.perf_counter()
        state, report = import_mxnet_lsfa(
            state, raw, bbox_means=tuple(cfg.TRAIN.BBOX_MEANS),
            bbox_stds=tuple(cfg.TRAIN.BBOX_STDS), strict_modules=strict)
        t2 = time.perf_counter()
        print(f"{path}: read {len(raw)} tensors in {t1 - t0:.3f} s, mapped in {t2 - t1:.3f} s: "
              f"imported {len(report['imported'])} tensors, {len(report['missing'])} state "
              f"entries unmatched, {len(report['unused'])} checkpoint tensors unused")
        for m in report["missing"][:20]:
            print("  missing:", m)
        for u in report["unused"][:20]:
            print("  unused: ", u)

    model.load_state_dict(seed_small_net(state))
    optimizer, scheduler = make_optimizer(model, base_lr=cfg.TRAIN.lr, lr_steps=[1])
    save_checkpoint(args.out, 0, model, optimizer, scheduler, step=0,
                    rng_state=torch.Generator(device=device).manual_seed(0).get_state())
    print(f"wrote checkpoint {args.out}/0.pt (epoch 0)")
    if not bool(cfg.network.res_diff_legacy_swap):
        print("NOTE: set network.res_diff_legacy_swap: true in the config "
              "when evaluating reference-trained weights", file=sys.stderr)


if __name__ == "__main__":
    main()
