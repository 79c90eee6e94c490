"""The LSFA switches the flagship leaves at their defaults, against the JAX
package: the ablation rungs (no R-net, no long-term aggregation, no small
net), plain averaging instead of the Nq-net, and the stride-8 small net
with its BN/scale options, an R-net conv, BN on the residual, un-normalized
RPN deltas and BGR pixel means. Tiny models, float32, 1e-4 (sums
reassociated)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsfa_tpu.models.lsfa import LSFA as JaxLSFA
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.models.lsfa import LSFA
from tests.test_torch_convert import perturb, to_numpy

H, W = 64, 96
BASE = dict(num_classes=5, feat_dim=64, num_layer=18)
VARIANTS = {
    "ablation": dict(add_rnet=False, add_lt_aggregation=False, add_small_net=False,
                     add_dcn=False),
    "average_no_nq": dict(add_Nq_net=False, add_dcn=False),
    "stride8_options": dict(small_net_stride=8, small_net_bn_before_fuse=True,
                            small_net_scale_before_fuse=True, res_diff_bn=True,
                            rnet_num_conv=1, normalize_rpn=False, add_dcn=False,
                            pixel_means=(103.94, 116.78, 123.68), pixel_scale=0.017),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_matches_jax(name):
    kw = dict(BASE, **VARIANTS[name])
    jm = JaxLSFA(dtype=jnp.float32, **kw)
    d = jnp.zeros((1, H, W, 3))
    v = jm.init(jax.random.PRNGKey(5), d, d, d, jnp.ones((1,)), jnp.ones((1,)),
                jnp.zeros((1, 4, 6, 2)), jnp.zeros((1, 4, 6, 3)))
    v = perturb(to_numpy(v), 2)
    tm = LSFA(**kw)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    tm.eval()

    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (1, H, W, 3)).astype(np.float32)
    prev = rng.normal(0, 60, (1, H, W, 3)).astype(np.float32)
    feat = rng.normal(0, 1, (1, 4, 6, 64)).astype(np.float32)
    small_hw = (H // 4, W // 4) if kw.get("small_net_stride", 4) == 4 else (H // 2, W // 2)
    small = rng.integers(0, 256, (2,) + small_hw + (3,)).astype(np.float32)
    mv = rng.normal(0, 1.5, (2, 4, 6, 2)).astype(np.float32)
    res = rng.normal(0, 20, (2, 4, 6, 3)).astype(np.float32)
    fk = np.repeat(feat, 2, axis=0)
    want_k = jm.apply(v, jnp.asarray(data), jnp.asarray(prev), jnp.asarray(feat),
                      jnp.zeros((1,)), method=jm.forward_key)
    want_c = jm.apply(v, jnp.asarray(small), jnp.asarray(fk), jnp.asarray(mv),
                      jnp.asarray(res), method=jm.forward_cur)
    t = torch.from_numpy
    with torch.no_grad():
        got_k = tm.forward_key(t(data), t(prev), t(feat), torch.zeros(1))
        got_c = tm.forward_cur(t(small), t(fk), t(mv), t(res))
    for want, got in ((want_k, got_k), (want_c, got_c)):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
