"""The package pins full float32 for its float32 convolutions.

torch's default lets cuDNN run float32 convolutions in TF32. The DCN
offset convs (float32 on purpose in every config) and every conv of a
float32 config must not: ``models/layers.py::full_float32`` clears
``torch.backends.cudnn.allow_tf32`` around them and restores the caller's
setting. Here, on the CPU, the flag is only observed: it is read at the
moment a convolution is called, and counted where the context is entered.
That real cuDNN then computes in full float32 is checked on the card by
chip_smoke.py (its float32 parity phases run under torch's default flag).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import lsfa_tpu_torch  # noqa: F401  (importing the package sets nothing)
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.data.loader import batch_to_device, synthetic_train_batches
from lsfa_tpu_torch.eval.tester import StreamingDetector
from lsfa_tpu_torch.models import layers
from lsfa_tpu_torch.models.lsfa import init_params, lsfa_from_config
from lsfa_tpu_torch.train.schedule import make_optimizer
from lsfa_tpu_torch.train.train_step import TrainSettings, draw_uniforms, make_train_step

TINY = {"network": {"num_layer": 18, "DFF_FEAT_DIM": 64, "ANCHOR_SCALES": [1, 2, 4]},
        "TEST": {"RPN_PRE_NMS_TOP_N": 256, "RPN_POST_NMS_TOP_N": 64, "max_per_image": 20},
        "TRAIN": {"RPN_POST_NMS_TOP_N": 64, "BATCH_ROIS_OHEM": 32, "RPN_BATCH_SIZE": 64},
        "tpu": {"nms_tier": 0, "max_gt_boxes": 8}}
HW = (64, 112)


@pytest.fixture()
def flag():
    """Restores the process-wide flag whatever a test sets."""
    before = torch.backends.cudnn.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32 = before


@pytest.fixture()
def seen(monkeypatch):
    """Records (compute dtype, flag) at every convolution call of the
    package's layers, and counts the entries of full_float32."""
    log = {"convs": [], "entered": 0}
    conv, deconv, pin = torch.nn.Conv2d._conv_forward, F.conv_transpose2d, layers.full_float32

    def conv_forward(self, x, w, b):
        log["convs"].append((x.dtype, torch.backends.cudnn.allow_tf32))
        return conv(self, x, w, b)

    def conv_transpose2d(x, *args, **kw):
        log["convs"].append((x.dtype, torch.backends.cudnn.allow_tf32))
        return deconv(x, *args, **kw)

    def counting():
        log["entered"] += 1
        return pin()

    monkeypatch.setattr(torch.nn.Conv2d, "_conv_forward", conv_forward)
    monkeypatch.setattr(layers.F, "conv_transpose2d", conv_transpose2d)
    monkeypatch.setattr(layers, "full_float32", counting)
    return log


def tiny_model(compute_dtype, add_dcn):
    cfg = load_config(None, overrides={**TINY, "network": {**TINY["network"], "add_dcn": add_dcn},
                                       "tpu": {**TINY["tpu"], "compute_dtype": compute_dtype}})
    model = lsfa_from_config(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    return cfg, model


def one_gop(cfg, model):
    from lsfa_tpu_torch.data.loader import SyntheticPreparedVideo

    pv = SyntheticPreparedVideo("precision", cfg, HW, num_frames=12, content_hw=(60, 104))
    return StreamingDetector(model, cfg, HW).process_prepared_window([pv.gop(0)], first=True)


@pytest.mark.parametrize("caller", [True, False])
def test_float32_forward_pins_and_restores(flag, seen, caller):
    """A float32 config: every convolution (FlowNet's transposed ones too)
    sees the flag cleared, and the caller's setting comes back."""
    torch.backends.cudnn.allow_tf32 = caller
    cfg, model = tiny_model("float32", add_dcn=False)
    outs = one_gop(cfg, model)
    assert torch.backends.cudnn.allow_tf32 is caller
    assert all(bool(torch.isfinite(o.float()).all()) for o in outs)
    assert len(seen["convs"]) > 50 and seen["entered"] == len(seen["convs"])
    assert all(dtype == torch.float32 and allowed is False for dtype, allowed in seen["convs"])


@pytest.mark.parametrize("caller", [True, False])
def test_bf16_forward_pins_only_the_offset_convs(flag, seen, caller):
    """A bf16 config with DCN: the bf16 convolutions run under the caller's
    setting, the float32 offset convs (one per deformable unit) pinned."""
    torch.backends.cudnn.allow_tf32 = caller
    cfg, model = tiny_model("bfloat16", add_dcn=True)
    model.eval()
    n_offset = sum(1 for name, _ in model.named_modules() if name.endswith(".offset"))
    data = torch.zeros((1,) + HW + (3,), dtype=torch.uint8)
    with torch.no_grad():
        model.forward_key(data, torch.zeros((1,) + HW + (3,)),
                          torch.zeros(1, HW[0] // 16, HW[1] // 16, 64), torch.ones(1))
    assert torch.backends.cudnn.allow_tf32 is caller
    f32 = [allowed for dtype, allowed in seen["convs"] if dtype == torch.float32]
    bf16 = [allowed for dtype, allowed in seen["convs"] if dtype == torch.bfloat16]
    assert n_offset > 0 and len(f32) == seen["entered"] == n_offset and len(bf16) > 20
    assert not any(f32) and all(a is caller for a in bf16)


def test_full_float32_restores_after_an_error(flag):
    for caller in (True, False):
        torch.backends.cudnn.allow_tf32 = caller
        with pytest.raises(ZeroDivisionError), layers.full_float32():
            assert torch.backends.cudnn.allow_tf32 is False
            1 / 0
        assert torch.backends.cudnn.allow_tf32 is caller
    with layers._precision(torch.bfloat16):
        assert torch.backends.cudnn.allow_tf32 is False    # the caller's, untouched


def test_train_step_pins_the_backward(flag, monkeypatch):
    """The backward of a float32 convolution reads the flag when it runs,
    after the forward's context has closed: the step holds the pin around
    backward() and restores the caller's setting."""
    torch.backends.cudnn.allow_tf32 = True
    cfg, model = tiny_model("float32", add_dcn=False)
    settings = TrainSettings.from_config(cfg)
    step = make_train_step(model, settings, *make_optimizer(model, cfg.TRAIN.lr, [1000]))
    batch = batch_to_device(synthetic_train_batches(1, HW, seed=5, max_gt=8,
                                                    content_hw=(60, 104))[0], "cpu")
    during = []
    backward = torch.Tensor.backward

    def recording(self, *args, **kw):
        during.append(torch.backends.cudnn.allow_tf32)
        return backward(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "backward", recording)
    metrics = step(batch, draw_uniforms(settings, batch, torch.Generator().manual_seed(1)))
    assert during == [False]
    assert torch.backends.cudnn.allow_tf32 is True
    assert np.isfinite(float(metrics["total_loss"]))
