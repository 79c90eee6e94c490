"""95th percentile over every frame finished in the window of the time from
its staging to its detections on the host."""

import numpy as np


def read(run: dict):
    if run["request"] != "frame" or not run["latencies_s"]:
        return None
    return float(np.percentile(run["latencies_s"], 95)) * 1e3
