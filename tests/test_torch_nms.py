"""NMS of the port (lsfa_tpu_torch.ops.nms) against the JAX package.

The plain fixpoint must EQUAL the Pallas kernel (interpret mode) and the
XLA sweeps on the cases of tests/test_pallas_nms.py, and nms_fixed's
compaction must equal the JAX one bit for bit: the IoU is computed in the
same order in float32, and the mask is 0/1."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsfa_tpu.ops.nms import _greedy_alive, nms_fixed as jax_nms_fixed
from lsfa_tpu.ops.pallas_nms import greedy_alive_pallas
from lsfa_tpu_torch.ops.boxes import pairwise_iou
from lsfa_tpu_torch.ops.nms import greedy_alive, nms_fixed, suppression_matrix
from lsfa_tpu_torch.ops.nms_cuda import division_free_threshold
from tests.ref_impl import ref_nms
from tests.test_pallas_nms import make_sorted


def chain_boxes(n):
    """Box i suppresses i+1 only (IoU 15/27 > 0.5, IoU(i, i+2) = 9/33)."""
    x1 = np.arange(n, dtype=np.float32) * 6.0
    return np.stack([x1, np.zeros(n, np.float32), x1 + 20.0,
                     np.full(n, 20.0, np.float32)], axis=1)


def nms_case(name):
    """(boxes, valid, thresh, sweeps) of the five Pallas-NMS test cases."""
    if name == "xla_sweeps":
        boxes, _ = make_sorted(0, 256)
        return boxes, np.ones(256, bool), 0.5, 16
    if name == "greedy_oracle":
        boxes, _ = make_sorted(1, 512)
        return boxes, np.ones(512, bool), 0.7, 24
    if name == "chain":
        return chain_boxes(128), np.ones(128, bool), 0.5, 128
    if name == "odd_cap":
        boxes, _ = make_sorted(3, 256)
        return boxes, np.ones(256, bool), 0.6, 1
    boxes, _ = make_sorted(2, 256)            # "valid_mask"
    valid = np.ones(256, bool)
    valid[100:] = False
    return boxes, valid, 0.5, 16


CASES = ["xla_sweeps", "greedy_oracle", "chain", "odd_cap", "valid_mask"]


@pytest.mark.parametrize("case", CASES)
def test_greedy_alive_equals_pallas_and_xla(case):
    boxes, valid, thresh, sweeps = nms_case(case)
    want_pallas = np.asarray(greedy_alive_pallas(jnp.asarray(boxes), jnp.asarray(valid),
                                                 thresh, sweeps, interpret=True))
    want_xla = np.asarray(_greedy_alive(jnp.asarray(boxes), jnp.asarray(valid),
                                        thresh, sweeps))
    got = greedy_alive(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None],
                       thresh, sweeps)[0].numpy()
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_xla)


def test_greedy_alive_fixpoint_is_greedy_oracle():
    boxes, valid, thresh, sweeps = nms_case("greedy_oracle")
    _, scores = make_sorted(1, 512)
    got, conv = greedy_alive(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None],
                             thresh, sweeps, with_converged=True)
    want = np.zeros(512, bool)
    want[ref_nms(np.concatenate([boxes, scores[:, None]], 1), thresh)] = True
    assert bool(conv[0])
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_greedy_alive_batch_equals_items():
    """Items of a batch exit at their own fixpoints: the chain needs ~64
    sweeps, the random boxes a few; batching changes neither."""
    a, va, _, _ = nms_case("chain")
    b, _ = make_sorted(4, 128)
    boxes = torch.from_numpy(np.stack([a, b]))
    valid = torch.ones(2, 128, dtype=torch.bool)
    both, conv = greedy_alive(boxes, valid, 0.5, 128, with_converged=True)
    for i in range(2):
        one = greedy_alive(boxes[i:i + 1], valid[i:i + 1], 0.5, 128)
        np.testing.assert_array_equal(both[i].numpy(), one[0].numpy())
    assert conv.all()
    np.testing.assert_array_equal(both[0].numpy(), np.arange(128) % 2 == 0)


def test_iou_forms_agree_with_plus_one_widths():
    """The kernel's inter / max(union, 1e-10) and pairwise_iou's
    where(union > 0, inter / union, 0) agree: with +1 widths the union of
    two clipped boxes is >= 1."""
    rng = np.random.default_rng(9)
    boxes = rng.uniform(0, 50, (1, 200, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(0, 30, (1, 200, 2)).astype(np.float32)
    boxes[0, :10, 2:] = boxes[0, :10, :2]                    # 1-pixel boxes
    t = torch.from_numpy(boxes)
    iou = pairwise_iou(t, t)
    n = 200
    upper = torch.arange(n)[:, None] < torch.arange(n)[None, :]
    for thresh in (0.0, 0.3, 0.7):
        want = upper & (iou > thresh)
        assert torch.equal(suppression_matrix(t, thresh), want)


def jax_nms(boxes, scores, valid, thresh, max_out, presorted):
    out = jax_nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out,
                        valid=jnp.asarray(valid), presorted=presorted,
                        return_converged=True)
    return [np.asarray(o) for o in out]


def torch_nms(boxes, scores, valid, thresh, max_out, presorted):
    out = nms_fixed(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                    thresh, max_out, valid=torch.from_numpy(valid)[None],
                    presorted=presorted, return_converged=True)
    return [o[0].numpy() for o in out]


@pytest.mark.parametrize("case", ["random", "ties", "all_invalid", "presorted", "few_keeps"])
def test_nms_fixed_equals_jax(case):
    rng = np.random.default_rng(11)
    n, max_out, thresh, presorted = 300, 100, 0.3, False
    boxes = make_sorted(12, n)[0]
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = scores > 0.2
    if case == "ties":
        scores = np.round(scores * 4).astype(np.float32) / 4      # 5 distinct values
    elif case == "all_invalid":
        valid = np.zeros(n, bool)
    elif case == "presorted":
        scores = np.sort(scores)[::-1].copy()
        valid = np.arange(n) < 250
        presorted, thresh = True, 0.7
    elif case == "few_keeps":
        boxes = np.tile(boxes[:1], (n, 1))                       # one box, repeated
        max_out = 20
    want = jax_nms(boxes, scores, valid, thresh, max_out, presorted)
    got = torch_nms(boxes, scores, valid, thresh, max_out, presorted)
    for name, g, w in zip(("keep_idx", "keep_valid", "converged"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


THRESHOLDS = [0.3, 0.5, 0.6, 0.7, 0.0, -0.25]


def _round32(v, up):
    """float64 values rounded to float32 upward (up) or downward."""
    r = v.astype(np.float32)
    off = r.astype(np.float64) < v if up else r.astype(np.float64) > v
    step = np.float32(np.inf) if up else np.float32(-np.inf)
    return np.where(off, np.nextafter(r, step), r)


def kernel_iou_over(inter, union, thresh, exact_only=False):
    """The kernel's division-free decision of fl(inter / max(union, 1e-10))
    > t, mirrored in numpy: the float32 filter with directed-rounding
    products, then the exact float64 test between them."""
    t, t_up, mid, tie_up = division_free_threshold(thresh)
    u = np.maximum(union, np.float32(1e-10)).astype(np.float64)
    x = inter.astype(np.float64)
    p = mid * u                                    # exact: 25 + 24 bits
    exact = (x > p) | ((x == p) & tie_up)
    if exact_only:
        return exact
    over = x > _round32(t_up * u, up=True)         # products exact: 24 + 24 bits
    amb = ~over & (x >= _round32(t * u, up=False))
    return np.where(amb, exact, over)


def boundary_pairs(thresh, rng):
    """float32 (inter, union) pairs on and around the rounding boundary
    m * u of the threshold, at the clamp, at zero, and at random."""
    _, _, mid, _ = division_free_threshold(thresh)
    u = np.concatenate([
        rng.uniform(1, 1e5, 4000), 2.0 ** np.arange(-20, 30),            # powers of two
        rng.uniform(1e-3, 10, 1000)]).astype(np.float32)
    near = np.abs((mid * u.astype(np.float64)).astype(np.float32))
    k = np.arange(-4, 5, dtype=np.int32)
    inter = (near[:, None].view(np.int32) + k).view(np.float32)          # +-4 ulps
    inter = np.where(inter < 0, np.float32(0), inter) if thresh <= 0 else inter
    unions = np.broadcast_to(u[:, None], inter.shape)
    n = 1_000_000
    rand_u = rng.uniform(0, 1e5, n).astype(np.float32)
    rand_i = (rand_u * rng.uniform(0, 1, n)).astype(np.float32)
    clamp_u = np.array([0.0, 1e-12, 1e-10, -5.0, 9.9e-11], np.float32)
    clamp_i = np.array([0.0, 1e-11, 1e-10, 0.0, 7e-11], np.float32)
    zero_u = rng.uniform(1, 1e4, 100).astype(np.float32)
    return (np.concatenate([inter.ravel(), rand_i, clamp_i, np.zeros(100, np.float32)]),
            np.concatenate([unions.ravel(), rand_u, clamp_u, zero_u]))


@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_division_free_iou_test_equals_division(thresh):
    """The kernel's test without division (filter and exact fallback, and
    the exact test alone) equals torch's float32 division and compare on
    pairs within 4 ulps of the boundary, clamped unions, zero
    intersections and 10^6 random pairs."""
    inter, union = boundary_pairs(thresh, np.random.default_rng(5))
    want = (torch.from_numpy(inter) / torch.from_numpy(union).clamp(min=1e-10)) > thresh
    np.testing.assert_array_equal(kernel_iou_over(inter, union, thresh), want.numpy())
    np.testing.assert_array_equal(kernel_iou_over(inter, union, thresh, exact_only=True),
                                  want.numpy())
    # the boundary cases sit on both sides of a non-negative threshold
    q = want.numpy()[:9 * 5050]
    assert q.any() and (thresh < 0 or not q.all())


@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_division_free_threshold_constants(thresh):
    """mid lies halfway between t and t_up, and tie_up is how float32
    rounding takes mid itself (half to even). No float32 quotient can hit
    mid exactly (it has 25 significant bits), so the kernel never takes
    the tie branch on real inputs; it keeps the test exact all the same."""
    t, t_up, mid, tie_up = division_free_threshold(thresh)
    assert np.float32(t) == np.float32(thresh) and t_up == np.nextafter(np.float32(t), np.inf)
    assert t < mid < t_up and mid - t == t_up - mid
    assert float(np.float32(mid)) == (t_up if tie_up else t)
