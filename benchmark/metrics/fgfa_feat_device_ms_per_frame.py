"""Device ms of the kernels launched inside the ``model.fgfa.feat`` spans in a
traced run's profiled span window, over its frames (FGFA)."""

from benchmark import spans


def read(run: dict):
    return spans._device(run, ("model.fgfa.feat",))
