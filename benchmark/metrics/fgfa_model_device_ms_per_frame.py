"""Device ms of the kernels launched inside FGFA's model-step spans
(``model.fgfa.feat``, ``.flow``, ``.warp``, ``.embed``, ``.weigh`` and
``model.heads``, none inside another) in a traced run's profiled span
window, over its frames."""

from benchmark import spans

NAMES = ("model.fgfa.feat", "model.fgfa.flow", "model.fgfa.warp", "model.fgfa.embed",
         "model.fgfa.weigh", "model.heads")


def read(run: dict):
    return spans._device(run, NAMES)
