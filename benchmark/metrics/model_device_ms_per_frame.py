"""Device ms of the kernels launched inside the model step's spans in a traced
run's profiled span window, over its frames
(``benchmark/spans.py::model_device_ms_per_frame``)."""

from benchmark import spans


def read(run: dict):
    return spans.model_device_ms_per_frame(run)
