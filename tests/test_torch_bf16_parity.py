"""Full-width bf16 parity: the flagship forward_key of the port against
JAX's, both in bfloat16 compute.

The flagship (the defaults of config.py: ResNet-101 with DCN, FlowNet-S,
Nq-net, feat 1024, 31 classes, bf16) at a reduced spatial size (128x192:
the widths are full, the maps small enough for the CPU), on the port's
seeded weights carried into the flax tree (the inverse of
convert.flax_to_torch) with the degenerate leaves perturbed as in
test_torch_convert; a raw BGR frame, a previous key frame and key
feature, is_first 0 (the long-term aggregation runs). Besides the output
maps, the RPN's raw logits (`rpn_cls`, the output of the rpn_cls_score
conv, NHWC) are captured in both packages.

Each package's bf16 output is also measured against its own float32 run
(`tpu.compute_dtype="float32"`, same weights): that is the rounding bf16
costs it. Errors are over the reference map's largest |value|
(``python -m tests.test_torch_bf16_parity`` prints them). Measured: each
package's own error 2.3-2.9e-2 on the feature, RPN logit and delta and
R-FCN maps, the port's own error 0.81-1.01 times JAX's, and the two bf16
runs 2.7-3.2e-2 apart; the preprocessed frame (float32 in both) exact.

Two checks on every map: the port's own error lies within OWN_BAND times
JAX's own error (both exact where JAX's is: the float32 frame), so the
port does round to bf16 where JAX does and by as much; and the port's
bf16 run lies within CROSS_OVER_OWN times the larger own error of JAX's
bf16 run. The float32 control, the port's float32 run put in place of
its bf16 run, fails the first check on every bf16 map (own error 0): the
test asserts that too.

The RPN's fg probabilities (`rpn_fg`) are held through their logits, not
as probabilities: at seeded weights the logits are large, so bf16's
relative rounding of them moves probabilities across the whole [0, 1]
(0.76 for the port and 0.48 for JAX from their float32 runs), and a
limit from those errors would check nothing. `rpn_fg` itself is held to
the softmax of the captured logits at float32 rounding.

Marked slow: the flagship at full width on the CPU, in both packages and
both dtypes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsfa_tpu.config import get_default_config as jax_default_config
from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
from lsfa_tpu_torch.config import get_default_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config
from tests.test_torch_convert import perturb
from tests.test_torch_train import flax_shapes, torch_to_flax

H, W = 128, 192
CROSS_OVER_OWN = 1.5
OWN_BAND = (0.5, 2.0)


def forward_keys():
    """{(package, dtype): {map name: float32 numpy}} of the flagship's
    forward_key on one seeded input, for the port and JAX in bfloat16 and
    float32, from the same weights; each dict also holds the RPN's raw
    logits as "rpn_cls"."""
    cfg = get_default_config()
    ported = lsfa_from_config(cfg, device="cpu")
    init_params(ported, torch.Generator().manual_seed(0))
    jcfg = jax_default_config()
    v = perturb(torch_to_flax(ported.state_dict(), flax_shapes(
        jax_lsfa_from_config(jcfg), H, W)), 1)
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8)
    prev = rng.normal(0, 60, (1, H, W, 3)).astype(np.float32)
    feat = rng.normal(0, 1, (1, H // 16, W // 16, cfg.network.DFF_FEAT_DIM)).astype(np.float32)
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg.tpu.compute_dtype = jcfg.tpu.compute_dtype = dtype
        tm = lsfa_from_config(cfg, device="cpu").eval()
        tm.load_state_dict(flax_to_torch(v), strict=True)
        logits = []
        hook = tm.rpn_cls_score.register_forward_hook(
            lambda mod, args, o: logits.append(o.float().permute(0, 2, 3, 1)))
        with torch.no_grad():
            got = tm.forward_key(torch.from_numpy(frame), torch.from_numpy(prev),
                                 torch.from_numpy(feat), torch.zeros(1))
        hook.remove()
        assert len(logits) == 1
        out["port", dtype] = {k: x.float().numpy() for k, x in {**got, "rpn_cls": logits[0]}.items()}
        jm = jax_lsfa_from_config(jcfg)
        fn = jax.jit(lambda v_, a, b, c: jm.apply(
            v_, a, b, c, jnp.zeros((1,)), method=jm.forward_key, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name == "rpn_cls_score"))
        want, state = fn(v, jnp.asarray(frame), jnp.asarray(prev), jnp.asarray(feat))
        (captured,) = [x for path, x in jax.tree_util.tree_flatten_with_path(
            state["intermediates"])[0] if "rpn_cls_score" in jax.tree_util.keystr(path)]
        out["jax", dtype] = {k: np.asarray(x, np.float32)
                             for k, x in {**want, "rpn_cls": captured}.items()}
    return out


def relative_errors(out):
    """{map: (port bf16 vs f32, JAX bf16 vs f32, port bf16 vs JAX bf16)},
    each the largest |difference| over the reference map's largest
    |value| (the float32 run's; JAX's bf16 run for the last); rpn_fg is
    held through rpn_cls (module docstring)."""
    errs = {}
    for k in out["jax", "bfloat16"]:
        if k == "rpn_fg":
            continue

        def rel(a, b):
            return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        errs[k] = (rel(out["port", "bfloat16"][k], out["port", "float32"][k]),
                   rel(out["jax", "bfloat16"][k], out["jax", "float32"][k]),
                   rel(out["port", "bfloat16"][k], out["jax", "bfloat16"][k]))
    return errs


def failures(errs):
    """The maps on which the port's bf16 run fails either check (module
    docstring)."""
    bad = []
    for name, (port, jx, cross) in errs.items():
        if jx == 0:                                  # float32 in both packages
            ok = port == 0 and cross == 0
        else:
            ok = (OWN_BAND[0] * jx <= port <= OWN_BAND[1] * jx
                  and cross <= CROSS_OVER_OWN * max(port, jx))
        if not ok:
            bad.append(name)
    return bad


@pytest.mark.slow
def test_flagship_forward_key_bf16_matches_jax():
    out = forward_keys()
    assert sorted(out["port", "bfloat16"]) == sorted(out["jax", "bfloat16"])
    for name, x in out["port", "bfloat16"].items():
        assert np.isfinite(x).all(), name
    errs = relative_errors(out)
    assert failures(errs) == [], errs
    a = out["port", "bfloat16"]["rpn_cls"].shape[-1] // 2
    for pkg in ("port", "jax"):
        m = out[pkg, "bfloat16"]
        fg = 1.0 / (1.0 + np.exp(m["rpn_cls"][..., :a] - m["rpn_cls"][..., a:]))
        np.testing.assert_allclose(m["rpn_fg"], fg, rtol=0, atol=1e-6, err_msg=pkg)
    # the float32 control fails on every map that JAX rounds to bf16
    control = relative_errors({**out, ("port", "bfloat16"): out["port", "float32"]})
    assert sorted(failures(control)) == sorted(k for k, e in errs.items() if e[1] > 0)


if __name__ == "__main__":
    out = forward_keys()
    for name, (port, jx, cross) in relative_errors(out).items():
        print(f"{name:16s}: port bf16 vs f32 {port:.3e}, JAX bf16 vs f32 {jx:.3e} (port/JAX "
              f"{port / jx if jx else float('nan'):.3f}), port bf16 vs JAX bf16 {cross:.3e} "
              f"(of the map's largest |value|)")
    print("failures:", failures(relative_errors(out)), "float32 control fails on:",
          failures(relative_errors({**out, ("port", "bfloat16"): out["port", "float32"]})))
