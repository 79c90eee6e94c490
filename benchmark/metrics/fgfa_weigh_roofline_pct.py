"""FGFA's weighting (cosine, softmax and weighted sum, the span
``model.fgfa.weigh``) against its roofline in a traced run's profiled
span window: the least time of the weighting of every traced frame at
the H100's HBM peak, over the device time of the kernels launched inside
that span. The least bytes (`weigh_bytes`) are counted from the shapes,
whatever implements the step: per pixel of the feature map, the 2K + 1
embeddings of 2048 channels read once in bf16, the 2K + 1 float32
features read once, the float32 aggregate written once."""

from benchmark.peaks import PEAK_HBM_BYTES

EMBED_DIM = 2048


def weigh_bytes(n: int, feat_dim: int, pixels: int, embed_dim: int = EMBED_DIM) -> int:
    """Least bytes of one frame's weighting over `n` features."""
    return pixels * (n * embed_dim * 2 + n * feat_dim * 4 + feat_dim * 4)


def frame_bytes(cfg: dict) -> int:
    bh, bw = cfg["tpu"]["default_bucket"]
    s = cfg["network"]["RPN_FEAT_STRIDE"]
    n = 2 * cfg["TEST"]["KEY_FRAME_INTERVAL"] + 1
    return weigh_bytes(n, cfg["network"]["DFF_FEAT_DIM"], (bh // s) * (bw // s))


def read(run: dict):
    tr = run.get("span_trace")
    if not tr or not tr.get("device") or not run.get("trace_frames"):
        return None
    spent = tr["device"].get("model.fgfa.weigh", {}).get("incl_s", 0.0)
    if spent <= 0:
        return None
    return 100.0 * run["trace_frames"] * frame_bytes(run["cfg"]) / PEAK_HBM_BYTES / spent
