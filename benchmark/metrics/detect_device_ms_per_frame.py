"""Device ms of the kernels launched inside the ``detect`` spans in a traced
run's profiled span window, over its frames
(``benchmark/spans.py::detect_device_ms_per_frame``)."""

from benchmark import spans


def read(run: dict):
    return spans.detect_device_ms_per_frame(run)
