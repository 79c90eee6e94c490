"""One whole train step of the model family's variants against the JAX
package: FGFA aggregation, the concat fuse of the R-net residual, the
concatv1 small-net fuse and the MobileNetV2 trunk, each on the tiny
config without DCN, through test_torch_train_step's `step_both` (JAX's
loss, gradients and optax update compiled without XLA's algebraic
simplifier; the port's make_train_step; the same weights, batch of two
and uniform draws). Tolerances as that file's: metrics 1e-4 relative,
gradients within 1e-3 of their tensor's largest JAX gradient plus 1e-6,
parameters after the update 1e-5, frozen parameters unchanged."""

import numpy as np
import pytest

from lsfa_tpu_torch.train.schedule import frozen_names
from tests import test_torch_train_step as flagship

NETWORK = {
    "fgfa": {"add_Nq_net": False, "add_Fgfa_net": True},
    "fuse_concat": {"fuse_type": "concat"},
    "small_concatv1": {"small_net_fuse_type": "concatv1"},
    "mobilenet": {"nettype": "mobilenet", "add_small_net": False,
                  "PIXEL_MEANS": [103.94, 116.78, 123.68]},
}


@pytest.fixture(scope="module", params=sorted(NETWORK))
def variant_stepped(request):
    network = {**flagship.OVERRIDES["network"], "add_dcn": False, **NETWORK[request.param]}
    return request.param, flagship.step_both({**flagship.OVERRIDES, "network": network})


def test_variant_step_metrics_match_jax(variant_stepped):
    flagship.test_step_metrics_match_jax(variant_stepped[1])


def test_variant_step_gradients_match_jax(variant_stepped):
    name, stepped = variant_stepped
    jg, tg = stepped["jgrads"], stepped["tgrads"]
    assert set(tg) == set(jg) - frozen_names(stepped["tm"])
    for key, g in tg.items():
        want = jg[key].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-3 * scale + 1e-6,
                                   err_msg=key)
    top = {"fgfa": "fgfa_net.em_conv3.weight", "fuse_concat": "fuse_downsample.weight",
           "small_concatv1": "small_fuse.s_feat_conv2.weight",
           "mobilenet": "backbone.block6_0.project.weight"}[name]
    assert float(tg[top].abs().max()) > 0, top


def test_variant_step_updated_params_match_jax(variant_stepped):
    flagship.assert_updated_params_match(variant_stepped[1])
    tm, before = variant_stepped[1]["tm"], variant_stepped[1]["before"]
    assert not (tm.rfcn_cls.weight.detach() == before["rfcn_cls.weight"]).all()
