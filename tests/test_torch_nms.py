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
