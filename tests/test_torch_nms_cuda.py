"""The CUDA NMS kernel against its plain version, on the card.

JAX-free, so that it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_nms_cuda.py

Without a card every test skips. Masks must be equal bit for bit: the
kernel computes inter and union in the plain version's operation order
and decides fl(inter / union) > t exactly without dividing."""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import knife_edge_boxes
from lsfa_tpu_torch.ops import nms_cuda
from lsfa_tpu_torch.ops.nms import greedy_alive, nms_fixed
from lsfa_tpu_torch.utils.profiler import tracing


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def sorted_boxes(rng, b, n, hi=400.0):
    x1 = rng.uniform(0, hi, (b, n))
    y1 = rng.uniform(0, hi, (b, n))
    wh = rng.uniform(1, 80, (b, n, 2))
    return np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]], -1).astype(np.float32)


def chain(n):
    x1 = np.arange(n, dtype=np.float32) * 6.0
    return np.stack([x1, np.zeros(n, np.float32), x1 + 20.0,
                     np.full(n, 20.0, np.float32)], axis=1)[None]


@functools.lru_cache(maxsize=1)
def cases():
    rng = np.random.default_rng(0)
    cut = np.ones((3, 256), bool)
    cut[:, 100:] = False
    out = {
        "rpn": (sorted_boxes(rng, 12, 2048, 1000.0), rng.uniform(size=(12, 2048)) < 0.95, 0.7, 31),
        "per_class": (sorted_boxes(rng, 330, 300), rng.uniform(size=(330, 300)) < 0.8, 0.3, 31),
        "chain": (chain(128), np.ones((1, 128), bool), 0.5, 128),
        "chain_2048": (chain(2048), np.ones((1, 2048), bool), 0.5, 31),
        "odd_cap": (sorted_boxes(rng, 3, 256), np.ones((3, 256), bool), 0.6, 1),
        "valid_cut": (sorted_boxes(rng, 3, 256), cut, 0.5, 16),
        "ragged_77": (sorted_boxes(rng, 5, 77), np.ones((5, 77), bool), 0.5, 31),
        "no_sweeps": (sorted_boxes(rng, 2, 64), np.ones((2, 64), bool), 0.5, 0),
        "n_1": (sorted_boxes(rng, 3, 1), np.ones((3, 1), bool), 0.7, 31),
        "n_2049": (sorted_boxes(rng, 2, 2049, 1000.0), np.ones((2, 2049), bool), 0.7, 31),
        "n_8192": (sorted_boxes(rng, 1, 8192, 2000.0), rng.uniform(size=(1, 8192)) < 0.9, 0.7, 31),
    }
    # the streaming path's other shapes and thresholds: RPN key (1, 2048),
    # per-class key (30, 300), RPN non-key (11, 2048); per_class above is
    # the per-class non-key (330, 300)
    for b, n, t in ((1, 2048, 0.7), (30, 300, 0.3), (11, 2048, 0.7)):
        out[f"stream_{b}x{n}"] = (sorted_boxes(rng, b, n, 1000.0 if n > 300 else 400.0),
                                  rng.uniform(size=(b, n)) < 0.9, t, 31)
    for t, (b, n) in zip((0.7, 0.3, 0.5, 0.6), ((2, 2048), (11, 300), (1, 1000), (3, 2049))):
        out[f"knife_{t}_{b}x{n}"] = (knife_edge_boxes(rng, b, n, t),
                                     np.ones((b, n), bool), t, 31)
    assert sorted(out) == sorted(CASES)
    return out


CASES = ["rpn", "per_class", "chain", "chain_2048", "odd_cap", "valid_cut", "ragged_77",
         "no_sweeps", "n_1", "n_2049", "n_8192", "stream_1x2048", "stream_30x300",
         "stream_11x2048", "knife_0.7_2x2048", "knife_0.3_11x300", "knife_0.5_1x1000",
         "knife_0.6_3x2049"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_plain(cuda_device, case):
    boxes, valid, thresh, sweeps = cases()[case]
    b = torch.from_numpy(boxes).to(cuda_device)
    v = torch.from_numpy(valid).to(cuda_device)
    with tracing() as rec:
        got, conv = nms_cuda.greedy_alive_cuda(b, v, thresh, sweeps)
    want, want_conv = greedy_alive(b, v, thresh, sweeps, with_converged=True)
    assert rec.counters.get("nms.launches", 0) == 1
    assert torch.equal(got, want)
    assert torch.equal(conv, want_conv)


@pytest.mark.cuda
def test_fused_path_allocates_no_scratch(cuda_device):
    """Up to N = 2048 the wrapper allocates only alive and converged; above
    it, the two-phase path adds its (B, words, N) scratch."""
    rng = np.random.default_rng(3)
    for b, n in ((12, 2048), (1, 2049)):
        boxes = torch.from_numpy(sorted_boxes(rng, b, n, 1000.0)).to(cuda_device)
        valid = torch.ones(b, n, dtype=torch.bool, device=cuda_device)
        nms_cuda.greedy_alive_cuda(boxes, valid, 0.7, 31)       # build, warm the allocator
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda_device)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        got = nms_cuda.greedy_alive_cuda(boxes, valid, 0.7, 31)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(cuda_device) - before
        del got
        outputs = 2 * 512 + b * n            # alive and converged, in 512-byte blocks
        scratch = b * ((n + 63) // 64) * n * 8
        if n <= nms_cuda.FUSED_MAX_N:
            assert extra <= outputs, extra
        else:
            assert extra >= scratch


@pytest.mark.cuda
def test_nms_fixed_on_card_equals_cpu(cuda_device):
    """nms_fixed routes CUDA tensors through the kernel and CPU tensors
    through the plain version; both give the same keeps."""
    rng = np.random.default_rng(1)
    boxes = torch.from_numpy(sorted_boxes(rng, 30, 300))
    scores = torch.from_numpy(rng.uniform(size=(30, 300)).astype(np.float32))
    valid = scores > 0.1
    want = nms_fixed(boxes, scores, 0.3, 100, valid=valid, return_converged=True)
    with tracing() as rec:
        got = nms_fixed(boxes.to(cuda_device), scores.to(cuda_device), 0.3, 100,
                        valid=valid.to(cuda_device), return_converged=True)
    assert rec.counters.get("nms.launches", 0) == 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_wrapper_rejects_bad_input(cuda_device):
    b = torch.zeros(2, 8, 4, device=cuda_device)
    v = torch.ones(2, 8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        nms_cuda.greedy_alive_cuda(b.double(), v, 0.5, 3)
    with pytest.raises(ValueError):
        nms_cuda.greedy_alive_cuda(b[:, ::2], v[:, ::2], 0.5, 3)
    with pytest.raises(ValueError):
        nms_cuda.greedy_alive_cuda(b.cpu(), v.cpu(), 0.5, 3)
