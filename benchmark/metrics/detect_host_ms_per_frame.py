"""Host ms inside the ``detect`` spans in a traced run's span window, over the
frames through detection (``benchmark/spans.py::detect_host_ms_per_frame``)."""

from benchmark import spans


def read(run: dict):
    return spans.detect_host_ms_per_frame(run)
