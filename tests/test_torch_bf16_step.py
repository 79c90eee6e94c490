"""One train step of the tiny LSFA with ``tpu.param_dtype="bfloat16"``,
the port's SGD against JAX's optax chain.

Both packages start from the same float32 weights rounded to bfloat16 and
take one step on the same batch and draws (`test_torch_train_step.step_both`).
Neither keeps a float32 master copy, so each rounds the decayed gradient,
the momentum and the update into bfloat16 in its own places: optax rounds
the learning rate to the parameter dtype and each transform's result
(``optax.scale_by_schedule``, ``apply_updates``), torch's SGD adds
``-lr * buf`` to the parameter in one rounding. The tolerances, from the
float64 evidence of `test_bf16_step_rounds_no_worse_than_optax` (one step,
51.2M elements):

- every parameter within 2 bfloat16 ulps of the larger of its magnitudes
  before and after the step (the operands of the update's last addition),
  plus the learning rate times the gradient tolerance of
  `test_torch_train_step.test_step_gradients_match_jax` (1e-3 of the
  tensor's largest gradient plus 1e-6): the gradients themselves differ by
  float32 noise before they are rounded. Measured: 1.5 ulps at most;
- at most 0.05% of the elements differ at all. Measured: 0.018%. Against
  the float64 update of each package's own bfloat16 gradient, rounded once
  to bfloat16, JAX's step differs in 0.021% of the elements and the port's
  in 0.0076%: the packages disagree where optax's extra roundings land.

The step moves 0.69% of the elements in either package: at this learning
rate most updates are below half an ulp of their parameter, and bfloat16
storage without a master copy drops them (ROADMAP Queue 3, F4).
"""

import numpy as np
import pytest
import torch

from lsfa_tpu_torch.train.schedule import frozen_names
from tests.test_torch_convert import two_torch_threads  # noqa: F401  (a fixture)
from tests.test_torch_train_step import OVERRIDES, step_both

pytestmark = pytest.mark.usefixtures("two_torch_threads")

LR, WD = OVERRIDES["TRAIN"]["lr"], 5e-4
MAX_DIFFERING = 5e-4            # fraction of the elements
ULPS = 2


@pytest.fixture(scope="module")
def stepped():
    return step_both(OVERRIDES, param_dtype="bfloat16")


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    x = np.abs(x).astype(np.float64)
    return 2.0 ** (np.floor(np.log2(np.where(x > 0, x, 2.0 ** -133))) - 7)


def to_bf16(x: np.ndarray) -> np.ndarray:
    """float64 -> bfloat16 -> float64. The float32 step first can round a
    tie twice; the measured fractions above came through the same path."""
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).double().numpy()


def test_bf16_step_matches_jax(stepped):
    tm, before, want = stepped["tm"], stepped["before"], stepped["jparams"]
    frozen = frozen_names(tm)
    total = differing = moved = 0
    for name, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16, name
        got = p.detach().float().numpy()
        w, b = want[name].numpy(), before[name].float().numpy()
        assert np.array_equal(torch.from_numpy(w).to(torch.bfloat16).float().numpy(), w), name
        if name in frozen:
            assert np.array_equal(got, b) and np.array_equal(w, b), name
            continue
        grad_tol = LR * (1e-3 * float(np.abs(stepped["jgrads"][name].numpy()).max()) + 1e-6)
        scale = np.maximum(np.abs(b), np.maximum(np.abs(got), np.abs(w)))
        np.testing.assert_array_less(np.abs(got - w), ULPS * bf16_ulp(scale) + grad_tol,
                                     err_msg=name)
        total += got.size
        differing += int((got != w).sum())
        moved += int((got != b).sum())
    assert differing <= MAX_DIFFERING * total, f"{differing} of {total} elements differ"
    assert moved > 1e-3 * total        # the step moved 0.69% of the elements in bfloat16


def test_bf16_step_rounds_no_worse_than_optax(stepped):
    """Against the float64 SGD update of each package's own bfloat16
    gradient (first step: the momentum buffer is the decayed gradient),
    rounded once: the port's step misses it in no more elements than
    JAX's does."""
    tm, before, want = stepped["tm"], stepped["before"], stepped["jparams"]
    miss = {"port": 0, "jax": 0}
    for name, grad in stepped["tgrads"].items():
        b = before[name].double().numpy()
        decay = WD if b.ndim > 1 else 0.0
        for who, after, g in (("port", tm.get_parameter(name).detach().double().numpy(),
                               grad.double().numpy()),
                              ("jax", want[name].double().numpy(),
                               stepped["jgrads"][name].double().numpy())):
            exact = to_bf16(b - LR * (g + decay * b))
            miss[who] += int((after != exact).sum())
    assert miss["port"] <= miss["jax"], miss
