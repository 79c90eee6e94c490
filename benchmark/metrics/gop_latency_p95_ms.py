"""95th percentile over every GOP of every lane finished in the window of
the time from the host clock when its window's inputs began staging to its
detections on the host."""

import numpy as np


def read(run: dict):
    if run["request"] != "gop" or not run["latencies_s"]:
        return None
    return float(np.percentile(run["latencies_s"], 95)) * 1e3
