"""Host ms inside FGFA's model-step spans (``model.fgfa.feat``, ``.flow``,
``.warp``, ``.embed``, ``.weigh`` and ``model.heads``, none inside
another) in a traced run's span window, over the frames aggregated in it
(the ``model.frames.fgfa`` counter)."""

from benchmark import spans

NAMES = ("model.fgfa.feat", "model.fgfa.flow", "model.fgfa.warp", "model.fgfa.embed",
         "model.fgfa.weigh", "model.heads")


def read(run: dict):
    t = spans._host(run, NAMES)
    frames = run["spans"]["counters"].get("model.frames.fgfa", 0) if t else 0
    return t / frames * 1e3 if frames else None
