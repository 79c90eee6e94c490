"""Host ms inside the model step's spans in a traced run's span window, over
the frames of those calls (``benchmark/spans.py::model_host_ms_per_frame``)."""

from benchmark import spans


def read(run: dict):
    return spans.model_host_ms_per_frame(run)
