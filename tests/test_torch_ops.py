"""Ops of the port (lsfa_tpu_torch.ops) against the JAX package on the
same numpy inputs: flow warp, deformable conv, PSROI pooling, boxes and
RPN proposals. Float32 on both sides; tolerances are stated per test."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsfa_tpu.ops import boxes as jboxes
from lsfa_tpu.ops.anchors import anchor_grid as jax_anchor_grid
from lsfa_tpu.ops.anchors import generate_anchors as jax_generate_anchors
from lsfa_tpu.ops.deform_conv import deform_conv as jax_deform_conv
from lsfa_tpu.ops.proposal import rpn_proposals as jax_rpn_proposals
from lsfa_tpu.ops.psroi_pool import psroi_pool as jax_psroi_pool
from lsfa_tpu.ops.warp import flow_warp as jax_flow_warp
from lsfa_tpu_torch.ops import boxes as tboxes
from lsfa_tpu_torch.ops.anchors import anchor_grid, generate_anchors
from lsfa_tpu_torch.ops.deform_conv import deform_conv
from lsfa_tpu_torch.ops.proposal import rpn_proposals
from lsfa_tpu_torch.ops.psroi_pool import psroi_pool
from lsfa_tpu_torch.ops.warp import flow_warp
from tests.ref_impl import ref_flow_warp, ref_psroi_pool
from tests.test_boxes import rand_boxes


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_flow_warp_off_every_edge():
    """Flows push samples past every edge; grid_sample's normalized
    coordinates move a sample by float rounding only (1e-5)."""
    rng = np.random.default_rng(0)
    b, h, w, c = 2, 7, 9, 5
    feat = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    flow = rng.normal(0, 4, (b, h, w, 2)).astype(np.float32)
    flow[:, 0, :, 1] = -3.5                      # above the top
    flow[:, -1, :, 1] = 2.25                     # below the bottom
    flow[:, :, 0, 0] = -1.75                     # left of the left edge
    flow[:, :, -1, 0] = 0.6                      # just past the right edge
    want = np.asarray(jax.vmap(jax_flow_warp)(jnp.asarray(feat), jnp.asarray(flow)))
    got = flow_warp(t(feat), t(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    oracle = ref_flow_warp(feat[0].transpose(2, 0, 1), flow[0].transpose(2, 0, 1))
    np.testing.assert_allclose(got[0], oracle.transpose(1, 2, 0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dilate", [1, 2])
def test_deform_conv_nonzero_offsets_4_groups(dilate):
    rng = np.random.default_rng(dilate)
    b, h, w, cin, cout, g = 2, 6, 8, 16, 12, 4
    x = rng.normal(0, 1, (b, h, w, cin)).astype(np.float32)
    off = rng.normal(0, 1.5, (b, h, w, g * 9 * 2)).astype(np.float32)
    wt = rng.normal(0, 0.2, (3, 3, cin, cout)).astype(np.float32)     # HWIO
    bias = rng.normal(0, 1, cout).astype(np.float32)
    want = np.stack([np.asarray(jax_deform_conv(
        jnp.asarray(x[i]), jnp.asarray(off[i]), jnp.asarray(wt), jnp.asarray(bias),
        kernel=3, dilate=dilate, groups=g)) for i in range(b)])
    got = deform_conv(t(x), t(off), t(wt.transpose(3, 2, 0, 1)), t(bias), kernel=3,
                      dilate=dilate, groups=g).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_deform_conv_zero_offsets_is_conv():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (1, 5, 7, 8)).astype(np.float32)
    wt = rng.normal(0, 0.3, (6, 8, 3, 3)).astype(np.float32)
    got = deform_conv(t(x), torch.zeros(1, 5, 7, 2 * 9 * 2), t(wt), groups=2, dilate=2)
    want = torch.nn.functional.conv2d(t(x).permute(0, 3, 1, 2), t(wt), padding=2,
                                      dilation=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def psroi_rois(rng, n, h, w):
    """Random rois at image scale, with .5 coordinates, 1-pixel rois and
    rois hanging off the map."""
    x1 = rng.uniform(-8, w * 16, n)
    y1 = rng.uniform(-8, h * 16, n)
    rois = np.stack([np.zeros(n), x1, y1, x1 + rng.uniform(0, 90, n),
                     y1 + rng.uniform(0, 90, n)], 1).astype(np.float32)
    rois[:6, 1:] = np.floor(rois[:6, 1:]) + 0.5          # halves: C round
    rois[6:10, 3] = rois[6:10, 1]                        # 1-pixel wide
    rois[6:10, 4] = rois[6:10, 2]                        # and tall
    return rois


def test_psroi_pool_matches_jax_and_oracle():
    """The loop oracle on every roi, and JAX on every roi whose end edge
    does not fall exactly on a feature-cell boundary. There the last bin
    ends at 7 * ((xe - xs) / 7) + xs, mathematically the integer xe:
    float32 puts it a rounding step either side, the port and the oracle
    below it, the jitted JAX op above it (one more column). The sums are
    reassociated, so 1e-5."""
    rng = np.random.default_rng(3)
    b, h, w, od, g = 2, 9, 11, 3, 7
    feat = rng.normal(0, 1, (b, h, w, od * g * g)).astype(np.float32)
    rois = np.stack([psroi_rois(rng, 40, h, w) for _ in range(b)])
    got = psroi_pool(t(feat), t(rois), od).numpy()
    ends = np.sign(rois[..., 3:5]) * np.floor(np.abs(rois[..., 3:5]) + 0.5) + 1.0
    off_edge = (ends % 16 != 0).all(axis=-1)
    assert off_edge.mean() > 0.8
    for i in range(b):
        oracle = ref_psroi_pool(feat[i].transpose(2, 0, 1), rois[i], od, g, g, 1 / 16)
        np.testing.assert_allclose(got[i], oracle.transpose(0, 2, 3, 1),
                                   rtol=1e-5, atol=1e-5)
        want = np.asarray(jax_psroi_pool(jnp.asarray(feat[i]), jnp.asarray(rois[i]), od))
        np.testing.assert_allclose(got[i][off_edge[i]], want[off_edge[i]],
                                   rtol=1e-5, atol=1e-5)


def test_psroi_pool_bf16_map_is_exact_upcast():
    """A bf16 map pools as its float32 upcast (bf16 x 0/1 products are
    exact in float32)."""
    rng = np.random.default_rng(4)
    feat = torch.randn(1, 6, 8, 2 * 49, generator=torch.Generator().manual_seed(0))
    rois = t(psroi_rois(rng, 20, 6, 8)[None])
    bf = feat.to(torch.bfloat16)
    assert torch.equal(psroi_pool(bf, rois, 2), psroi_pool(bf.float(), rois, 2))


def test_anchors_equal_jax():
    np.testing.assert_array_equal(generate_anchors(), jax_generate_anchors())
    np.testing.assert_array_equal(anchor_grid(5, 7, 16, (0.5, 1, 2), (1, 2, 4)),
                                  jax_anchor_grid(5, 7, 16, (0.5, 1, 2), (1, 2, 4)))


def test_boxes_equal_jax():
    rng = np.random.default_rng(5)
    boxes = rand_boxes(rng, 64)
    deltas = rng.normal(0, 0.3, (64, 8)).astype(np.float32)
    im_hw = np.asarray([150.0, 170.0], np.float32)
    tb, td = t(boxes), t(deltas)
    for name, got, want in [
        ("bbox_pred", tboxes.bbox_pred(tb, td), jboxes.bbox_pred(boxes, deltas)),
        ("iou_pred", tboxes.iou_pred(tb, td), jboxes.iou_pred(boxes, deltas)),
        ("clip", tboxes.clip_boxes(td * 300, t(im_hw)),
         jboxes.clip_boxes(jnp.asarray(deltas * 300), jnp.asarray(im_hw))),
        ("iou", tboxes.pairwise_iou(tb, tb), jboxes.pairwise_iou(boxes, boxes)),
        ("area", tboxes.box_area(tb), jboxes.box_area(boxes)),
    ]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4,
                                   err_msg=name)
    for got, want in zip(tboxes.box_wh_ctr(tb), jboxes.box_wh_ctr(boxes)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("tier,min_size,iou_loss", [(0, 0, False), (128, 16, False),
                                                    (0, 0, True)])
def test_rpn_proposals_equal_jax(tier, min_size, iou_loss):
    """Identical score/delta maps with no ties: the valid slots must be
    the same, and the rois within 1e-4."""
    rng = np.random.default_rng(6 + tier)
    b, h, w, a = 2, 6, 9, 9
    anchors = anchor_grid(h, w, 16, (0.5, 1, 2), (1, 2, 4))
    fg = rng.permutation(b * h * w * a).reshape(b, h, w, a).astype(np.float32) / (b * h * w * a)
    deltas = rng.normal(0, 4.0 if iou_loss else 0.2, (b, h, w, 4 * a)).astype(np.float32)
    im_info = np.asarray([[80.0, 130.0, 1.25], [96.0, 140.0, 1.0]], np.float32)
    kw = dict(pre_nms_top_n=400, post_nms_top_n=60, nms_thresh=0.7, min_size=min_size,
              feat_stride=16, nms_tier=tier, iou_loss=iou_loss)
    rois, scores, valid = rpn_proposals(t(fg), t(deltas), t(anchors), t(im_info), **kw)
    for i in range(b):
        jr, js, jv = jax_rpn_proposals(jnp.asarray(fg[i]), jnp.asarray(deltas[i]),
                                       jnp.asarray(anchors), jnp.asarray(im_info[i]), **kw)
        jv = np.asarray(jv)
        np.testing.assert_array_equal(valid[i].numpy(), jv)
        assert jv.sum() > 10
        np.testing.assert_allclose(rois[i].numpy()[jv], np.asarray(jr)[jv], atol=1e-4)
        np.testing.assert_allclose(scores[i].numpy(), np.asarray(js), atol=1e-6)
