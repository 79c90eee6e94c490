"""The frozen counts: the FLOPs per frame recounted over the reference, the
NMS bound against the port's arithmetic at the shapes PERF.md times."""

import pytest

from benchmark import peaks
from benchmark.count_flops import flops_per_frame
from benchmark.harness import load_json


@pytest.mark.parametrize("name", ["lsfa_r101", "rfcn_r101"])
def test_flops_recounted(name):
    cfg = load_json("benchmark", "configs", f"{name}.json")
    assert flops_per_frame(cfg) == cfg["flops_per_frame"]


SHAPES = [(1, 2048), (30, 300), (11, 2048), (330, 300), (12, 2048), (360, 300), (1, 6000),
          (8, 2048), (240, 300), (88, 2048), (2640, 300), (4, 2048), (120, 300)]


@pytest.mark.parametrize("b,n", SHAPES)
def test_nms_bound_matches_port(b, n):
    from lsfa_tpu_torch.ops import nms_cuda

    ms, _ = nms_cuda.nms_bound_ms(b, n)
    assert peaks.nms_bound_s(b, n) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_nms_bound_per_frame_is_the_batch_sum():
    cfg = load_json("benchmark", "configs", "lsfa_r101.json")
    per_frame = peaks.nms_bound_per_frame_s(cfg)
    lanes = 8
    window = peaks.nms_bound_s(lanes, 2048) + peaks.nms_bound_s(30 * lanes, 300)
    assert per_frame * lanes == pytest.approx(window, rel=1e-12)
    assert per_frame * 1e6 == pytest.approx(0.50 + 0.32, abs=0.01)
