"""The model step's share of the H100's dense bf16 peak: the configuration's
frozen FLOPs per frame (``flops_per_frame``, counted by
``benchmark/count_flops.py`` over the plain reference at the cell's
shapes; detection is not counted) times the frames per second of the
measured window, over 989 TFLOP/s. The card's power limit is printed in
the result's ``device``."""

from benchmark.peaks import PEAK_BF16_FLOPS


def read(run: dict):
    flops = run["cfg"].get("flops_per_frame")
    if not flops or not run["frames"]:
        return None
    return 100.0 * flops * run["frames"] / run["window_s"] / PEAK_BF16_FLOPS
