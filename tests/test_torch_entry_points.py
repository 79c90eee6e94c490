"""The port's last user entry points against the JAX package: the image
writer and the detection drawing (``utils/vis.py``), the streaming demo
(``experiments/demo.py``), the parameter inspection (``utils/inspect.py``)
and ``utils/profiler.trace``, FlowNet-S pretraining
(``tools/pretrain_flow.py``) and the learn->detect smoke
(``tools/overfit_smoke.py``).

Tolerances: the drawn boxes equal PIL's pixels (the labels use the port's
bitmap font, so their band is left out); a PNG reads back bit for bit;
FlowNet-S pretraining from JAX's converted init, on the same pairs, gives
JAX's loss and photometric term within 1e-5 relative per step, and every
parameter within 2e-6 of JAX's (3 Adam steps of 1e-4: an element whose
gradient is float noise can move by up to 1e-4 a step in either package,
so the parameters that moved by more than 2e-6 apart are counted, not
held: at most 0.1%); the smoke's first 5 steps from JAX's init and draws
give JAX's metrics within 1e-4 relative (float32, sums reassociated,
compounded over the steps).
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import RenderedVideos
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.convert import flax_to_torch
from lsfa_tpu_torch.data import coviar
from lsfa_tpu_torch.utils import vis
from tests.test_torch_convert import to_numpy
from tests.test_torch_train_step import NO_ALGSIMP, jax_draws
from tests.test_torch_convert import two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = os.path.join(ROOT, "lsfa_tpu_torch", "configs", "lsfa_tiny_smoke.json")


def random_dets(rng, n, h, w):
    """n detections with boxes around and across the image, some with
    crossed corners and some under the 0.3 score threshold."""
    x = rng.uniform(-20, w + 20, (n, 2))
    y = rng.uniform(-20, h + 20, (n, 2))
    return {"labels": rng.integers(1, 34, n), "scores": rng.uniform(0.1, 1.0, n),
            "boxes": np.stack([x[:, 0], y[:, 0], x[:, 1], y[:, 1]], 1)}


def test_class_color_and_labels_equal_jax():
    from lsfa_tpu.data.dataset import CLASS_NAMES as JAX_CLASS_NAMES
    from lsfa_tpu.utils.vis import class_color as jax_class_color

    assert [vis.class_color(i) for i in range(40)] == [jax_class_color(i) for i in range(40)]
    assert vis.CLASS_NAMES == JAX_CLASS_NAMES
    assert vis.label_text(3, 0.987) == "bear 0.99" and vis.label_text(40, 0.5) == "40 0.50"


def test_boxes_equal_pil_outside_the_label_band():
    """draw_detections against JAX's drawing with the text left out (PIL's
    rectangle(width=2) over the sorted corners), on every pixel outside
    the bands the port's labels cover."""
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(4)
    h, w = 90, 120
    for _ in range(20):
        image = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
        dets = random_dets(rng, 12, h, w)
        got = vis.draw_detections(image, dets)
        want = Image.fromarray(image.astype(np.uint8))
        draw = ImageDraw.Draw(want)
        band = np.zeros((h, w), bool)
        for lbl, sc, box in zip(dets["labels"], dets["scores"], dets["boxes"]):
            if sc < 0.3:
                continue
            x1, y1, x2, y2 = box
            box = (min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2))
            draw.rectangle(box, outline=vis.class_color(int(lbl)), width=2)
            x, y = vis.label_origin(box)
            mh, mw = vis.text_mask(vis.label_text(lbl, sc)).shape
            band[max(y, 0):max(y + mh, 0), max(x, 0):max(x + mw, 0)] = True
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        want = np.asarray(want)
        np.testing.assert_array_equal(got[~band], want[~band])
        assert (got[band] != image.astype(np.uint8)[band]).any()      # the labels were drawn


def test_write_png_reads_back_with_pil(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(1).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    vis.write_png(path, rgb)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), rgb)
    with pytest.raises(ValueError):
        vis.write_png(path, rgb[..., 0])


def demo_lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("frame ")]


def test_demo_over_a_clip_and_an_image_directory(tmp_path, capsys):
    """As tests/test_demos.py checks JAX's demo: 15 annotated PNGs of the
    clip's 240x320 frames and 15 frame lines with the key schedule (flag
    0, 2 to frame 11, 1 at 12); then 8 JPEGs of a directory."""
    from PIL import Image

    from lsfa_tpu_torch.experiments import demo

    if not coviar.available():
        pytest.skip("native coviar plane not built (needs FFmpeg's libraries)")
    from lsfa_tpu_torch.train.driver import init_model

    model = init_model(load_config(TINY), device="cpu")
    out = str(tmp_path / "frames")
    got = demo.main(["--cfg", TINY, "--video", str(tmp_path / "clip.mp4"), "--out", out,
                     "--synthesize", "--max-frames", "15"], model=model)
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert pngs == [f"{i:06d}.png" for i in range(15)]
    with Image.open(os.path.join(out, pngs[0])) as im:
        assert np.asarray(im).shape == (240, 320, 3)
    lines = demo_lines(capsys)
    flags = [0] + [2] * 11 + [1, 2, 2]
    assert [ln.split()[2] for ln in lines] == [f"flag={f}" for f in flags]
    assert [f for f, _ in got] == flags
    assert [int(ln.split("dets=")[1]) for ln in lines] == [len(d["labels"]) for _, d in got]

    jpegs = tmp_path / "jpegs"
    jpegs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)).save(
            jpegs / f"{i:06d}.jpg")
    out2 = str(tmp_path / "frames2")
    got = demo.main(["--cfg", TINY, "--frames", str(jpegs), "--out", out2], model=model)
    assert len(demo_lines(capsys)) == 8 and len(got) == 8
    assert sorted(os.listdir(out2)) == [f"{i:06d}.png" for i in range(8)]
    with pytest.raises(SystemExit):
        demo.main(["--cfg", TINY, "--out", out2], model=model)


def test_inspect_counts_equal_jax():
    """count_params of the tiny LSFA's parameters equals JAX's count of its
    params tree; the summary's lines and the shape check."""
    from lsfa_tpu.config import load_config as jax_load_config
    from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
    from lsfa_tpu.utils.inspect import count_params as jax_count_params
    from lsfa_tpu_torch.models.lsfa import lsfa_from_config
    from lsfa_tpu_torch.utils.inspect import check_parameter_shapes, count_params, param_summary

    jcfg = jax_load_config(os.path.join(ROOT, "configs", "lsfa_tiny_smoke.yaml"))
    h, w = jcfg.tpu.default_bucket
    d = jnp.zeros((1, h, w, 3))
    shapes = jax.eval_shape(jax_lsfa_from_config(jcfg).init, jax.random.PRNGKey(0), d, d, d,
                            jnp.ones((1,)), jnp.ones((1,)), jnp.zeros((1, h // 16, w // 16, 2)),
                            jnp.zeros((1, h // 16, w // 16, 3)))
    model = lsfa_from_config(load_config(TINY), device="cpu")
    params = dict(model.named_parameters())
    assert count_params(params) == jax_count_params(shapes["params"])
    assert count_params(model) == sum(t.numel() for t in model.state_dict().values()) > \
        count_params(params)                           # with the BatchNorm statistics
    lines = param_summary(params).splitlines()
    assert lines[-1] == f"{'TOTAL':>24s}: {count_params(params) / 1e6:8.2f} M"
    assert any(ln.strip().startswith("backbone:") for ln in lines)
    w = model.backbone.conv0.weight
    assert check_parameter_shapes(model, {"backbone.conv0.weight": tuple(w.shape)}) == []
    assert check_parameter_shapes(model, {"backbone.conv0.weight": (1,), "nope": (2,)}) == [
        ("backbone.conv0.weight", tuple(w.shape), (1,)), ("nope", "missing", (2,))]


def test_trace_writes_a_chrome_trace(tmp_path):
    from lsfa_tpu_torch.utils.profiler import trace

    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).cumsum(0)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert len(prof.key_averages()) > 0


def test_pretrain_flow_steps_match_jax():
    """3 steps of the port's loss and Adam step from JAX's converted
    FlowNet-S (feat_dim 32) on the pairs the tool draws from 128x96
    clips, against the JAX tool's loss under optax.adam; the scale-map
    head stays at its init in both."""
    import optax

    from lsfa_tpu.models.flownet import FlowNetS as JaxFlowNetS
    from lsfa_tpu.ops.warp import flow_warp as jax_flow_warp
    from lsfa_tpu_torch.models.flownet import FlowNetS
    from lsfa_tpu_torch.tools import pretrain_flow

    jm = JaxFlowNetS(feat_dim=32)
    dummy = jnp.zeros((1, 96, 128, 3), jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), dummy, dummy)["params"]
    tm = FlowNetS(feat_dim=32)
    tm.load_state_dict({k[len("flownet."):]: v for k, v in flax_to_torch(
        {"params": {"flownet": to_numpy(params)}}).items()}, strict=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    step = pretrain_flow.make_step(tm, 1e-4, 0.01)

    tx = optax.adam(1e-4)

    def pool16(x):
        b, h, w, c = x.shape
        return x.reshape(b, h // 16, 16, w // 16, 16, c).mean(axis=(2, 4))

    def loss_fn(p, cur, old):
        flow, _ = jm.apply({"params": p}, cur, old)
        photo = jnp.abs(jax_flow_warp(pool16(old), flow) - pool16(cur)).mean()
        tv = jnp.abs(jnp.diff(flow, axis=1)).mean() + jnp.abs(jnp.diff(flow, axis=2)).mean()
        return photo + 0.01 * tv, photo

    @jax.jit
    def jax_step(p, o, cur, old):
        (loss, photo), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, cur, old)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, photo

    opener = RenderedVideos(((128, 96),), 24)
    readers = [opener(p) for p in pretrain_flow.video_paths("d", 2, 24, ((128, 96),), "hard")]
    rng = np.random.default_rng(0)
    opt_state = tx.init(params)
    for _ in range(3):
        cur, old = pretrain_flow.draw_batch(readers, rng, 2, (96, 128))
        params, opt_state, jloss, jphoto = jax_step(params, opt_state, jnp.asarray(cur),
                                                    jnp.asarray(old))
        loss, photo = step(torch.from_numpy(cur), torch.from_numpy(old))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(photo), float(jphoto), rtol=1e-5)
    want = flax_to_torch({"params": {"flownet": to_numpy(params)}})
    state = tm.state_dict()
    n = apart = 0
    for k, v in state.items():
        w = want["flownet." + k]
        assert float((v - w).abs().max()) <= 3e-4, k          # 3 steps of at most lr
        apart += int(((v - w).abs() > 2e-6).sum())
        n += v.numel()
    assert apart <= 1e-3 * n, (apart, n)
    for k in ("scale_map.weight", "scale_map.bias"):
        assert torch.equal(state[k], before[k]), k
        np.testing.assert_array_equal(want["flownet." + k].numpy(), before[k].numpy())


def test_pretrain_flow_checkpoint_warm_starts_init_model(tmp_path, capsys):
    """The tool in its CPU smoke mode over in-memory clips: finite losses,
    JAX's report keys, and a checkpoint whose FlowNet tensors init_model's
    pretrained_flow loads bit for bit (all but the scale map, whose width
    is the smoke's 32, not the tiny config's 64)."""
    from lsfa_tpu_torch.tools import pretrain_flow
    from lsfa_tpu_torch.train.driver import init_model

    out = str(tmp_path / "flow")
    report = {}
    assert pretrain_flow.main(["--cpu-smoke", "--steps", "2", "--log-every", "1", "--out", out,
                               "--data", str(tmp_path / "data")],
                              open_video=RenderedVideos(((128, 96),), 24), report=report) == 0
    assert [s for s, _, _ in report["logged"]] == [0, 1]
    assert all(np.isfinite(x) for _, a, b in report["logged"] for x in (a, b))
    with open(os.path.join(out, "flow_pretrain.json")) as f:
        assert sorted(json.load(f)) == ["out", "photo_final", "photo_first", "steps", "wall_s"]
    saved = torch.load(os.path.join(out, "2.pt"), weights_only=True)["model"]
    cfg = load_config(TINY, overrides={"network": {"pretrained_flow": out}})
    state = init_model(cfg, device="cpu").state_dict()
    loaded = [k for k in saved if not k.startswith("flownet.scale_map.")]
    assert len(loaded) == len(saved) - 2
    for k in loaded:
        assert torch.equal(state[k], saved[k]), k


def overfit_models():
    """(JAX config, flax module, JAX's init variables, the port's config,
    the port's model loaded with them): the JAX tool's init, jitted (op by
    op it takes half a minute on the CPU)."""
    from lsfa_tpu.config import load_config as jax_load_config
    from lsfa_tpu.models.lsfa import lsfa_from_config as jax_lsfa_from_config
    from lsfa_tpu_torch.models.lsfa import lsfa_from_config
    from lsfa_tpu_torch.tools import overfit_smoke

    jcfg = jax_load_config(os.path.join(ROOT, "configs", "lsfa_tiny_smoke.yaml"))
    jcfg.TRAIN.RPN_PRE_NMS_TOP_N = 128
    jcfg.TRAIN.RPN_POST_NMS_TOP_N = 32
    jcfg.TRAIN.BATCH_ROIS_OHEM = 16
    cfg = overfit_smoke.smoke_config()
    _, batch = overfit_smoke.scene(cfg)
    jm = jax_lsfa_from_config(jcfg)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in (
        "data", "data_ref", "data_ref_old", "eq_flag", "eq_flag_old", "motion_vector",
        "res_diff")))
    tm = lsfa_from_config(cfg, device="cpu")
    tm.load_state_dict(flax_to_torch(to_numpy(v)), strict=True)
    return jcfg, jm, v, cfg, tm, batch


def test_overfit_smoke_first_steps_match_jax():
    """The smoke's scene from JAX's init: 5 steps of JAX's make_train_step
    (compiled without algsimp, keys PRNGKey(i)) against the port's
    `overfit_smoke.train` with the same uniform draws."""
    from lsfa_tpu.train.schedule import make_optimizer as jax_make_optimizer
    from lsfa_tpu.train.train_step import TrainSettings as JaxTrainSettings
    from lsfa_tpu.train.train_step import make_train_step as jax_make_train_step
    from lsfa_tpu_torch.tools import overfit_smoke

    jcfg, jm, v, cfg, tm, batch = overfit_models()
    settings = JaxTrainSettings.from_config(jcfg)
    params, bs = v["params"], v.get("batch_stats", {})
    opt = jax_make_optimizer(params, base_lr=2e-3, lr_steps=[10000])
    opt_state = opt.init(params)
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    step = jax_make_train_step(jm, settings, None, opt)
    compiled = step.lower(params, bs, opt_state, jbatch, jax.random.PRNGKey(0)).compile(
        compiler_options=NO_ALGSIMP)
    want = []
    for i in range(5):
        params, bs, opt_state, m = compiled(params, bs, opt_state, jbatch, jax.random.PRNGKey(i))
        want.append({k: float(x) for k, x in m.items()})
    n_anchors = batch["motion_vector"].shape[1] * batch["motion_vector"].shape[2] * 9
    got = overfit_smoke.train(tm, cfg, batch, 5, log=lambda s: None,
                              draws=lambda i: jax_draws(jax.random.PRNGKey(i), 1, n_anchors))
    for g, w in zip(got, want):
        for k in ("total_loss", "rpn_acc", "rcnn_acc"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.slow
def test_overfit_smoke_passes_on_the_cpu(capsys):
    """The tool at its defaults (80 steps from the port's own seeded init)
    returns 0: AP[class 3] > 0.49, JAX's gate. Slow: its 80 steps take
    17 s alone on an 8-core CPU, 36 s at two threads, and 12 minutes among
    6 test workers on those cores; chip_smoke.py phase 29 runs it on the
    card every time."""
    from lsfa_tpu_torch.tools import overfit_smoke

    report = {}
    assert overfit_smoke.main(device="cpu", report=report) == 0
    assert report["ap"][2] > 0.49 and len(report["history"]) == 80
    out = capsys.readouterr().out
    assert "OVERFIT SMOKE: PASS" in out and out.count("step ") == 5
