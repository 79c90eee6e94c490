"""The port's entry points over JSON configs: the JSON twins of
``configs/*.yaml``, the checkpoint importer
(``lsfa_tpu_torch.tools.import_reference_checkpoint``) and the evaluation
launcher (``lsfa_tpu_torch.experiments.lsfa_test``).

The twins load to the tree the YAML files give in both packages, and a
JSON config loads where ``yaml`` cannot be imported (the card's machine).
The importer writes ``<out>/0.pt`` that ``load_checkpoint`` and
``TRAIN.RESUME`` read. `run_test` over a tiny ImageNet VID tree
(``chip_smoke.write_vid_tree``: two videos of 14 and 12 frames, the second
ending in a partial GOP) with ``SyntheticPreparedVideo`` streams gives
exactly what calling the loop it dispatches to and ``evaluate_map``
directly gives, for the LSFA (sequential and two streams) and the R-FCN.
"""

import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import write_vid_tree
from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.data.dataset import ImageNetVID
from lsfa_tpu_torch.data.loader import SyntheticPreparedVideo
from lsfa_tpu_torch.eval import driver
from lsfa_tpu_torch.eval.rfcn_tester import rfcn_from_config
from lsfa_tpu_torch.experiments import lsfa_test
from lsfa_tpu_torch.models.lsfa import lsfa_from_config
from lsfa_tpu_torch.tools import import_reference_checkpoint
from lsfa_tpu_torch.train.checkpoint import load_checkpoint
from lsfa_tpu_torch.train.driver import build_model, is_rfcn, train_net
from lsfa_tpu_torch.train.import_mxnet import export_mxnet_lsfa
from lsfa_tpu_torch.utils.mxnet_io import save_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
TWINS = ("lsfa_resnet101_vid", "rfcn_resnet101_vid", "lsfa_tiny_smoke", "rfcn_tiny_smoke")
LENGTHS = {"vid_a": 14, "vid_b": 12}
CONTENT = (60, 104)


def twin(name):
    return os.path.join(ROOT, "lsfa_tpu_torch", "configs", name + ".json")


@pytest.mark.parametrize("name", TWINS)
def test_json_twin_equals_yaml(name):
    yaml_path = os.path.join(ROOT, "configs", name + ".yaml")
    assert load_config(twin(name)) == load_config(yaml_path) == jax_load_config(yaml_path)


def test_json_config_loads_without_yaml():
    """The card's machine has no yaml: a JSON config must not need it."""
    code = ("import sys; sys.modules['yaml'] = None; "
            "from lsfa_tpu_torch.config import load_config; "
            f"print(load_config({twin('lsfa_resnet101_vid')!r}).network.num_layer)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "101"


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{model name: (config path, the importer's checkpoint dir, the
    source state)}: each tiny model from seed 7 with its BatchNorms
    perturbed, exported to .params and imported by the tool."""
    out = {}
    root = tmp_path_factory.mktemp("ckpt")
    for name in ("lsfa_tiny_smoke", "rfcn_tiny_smoke"):
        model = build_model(load_config(twin(name)), 7, "cpu")
        g = torch.Generator().manual_seed(8)
        with torch.no_grad():
            for key, t in model.state_dict().items():
                if key.endswith(("running_mean", "running_var", "bn_data.bias")):
                    t.add_(0.1 * torch.rand(t.shape, generator=g))
            model.rfcn_cls.weight.normal_(0.0, 0.05, generator=g)
        params = str(root / f"{name}-0000.params")
        export_mxnet_lsfa(model.state_dict(), params)
        ckpt = str(root / name)
        import_reference_checkpoint.main(["--cfg", twin(name), "--params", params, "--out", ckpt,
                                          "--strict", "backbone", "--device", "cpu"])
        out[name] = (twin(name), ckpt, model.state_dict())
    return out


def test_importer_writes_a_checkpoint_resume_reads(checkpoints):
    cfg_path, ckpt, source = checkpoints["lsfa_tiny_smoke"]
    state, epoch = load_checkpoint(ckpt)
    assert epoch == 0 and state["step"] == 0 and state["epoch"] == 0
    # seeded from the imported backbone, the small net equals the source's
    # where the source's was seeded too; the rest is the file's
    assert state["model"].keys() == source.keys()
    for k, v in source.items():
        if not k.startswith("small_net_backbone.") or k.endswith(("_mean", "_var")):
            assert torch.equal(state["model"][k], v), k
    cfg = load_config(cfg_path, overrides={"TRAIN": {"RESUME": True}})
    model = train_net(cfg, [], ckpt_dir=ckpt, device="cpu")
    assert latest_epochs(ckpt) == [0, 1]
    resumed = model.state_dict()
    assert all(torch.equal(resumed[k], state["model"][k]) for k in resumed)


def latest_epochs(path):
    return sorted(int(f[:-3]) for f in os.listdir(path) if f.endswith(".pt"))


def test_importer_prints_the_report_and_the_swap_note(checkpoints, capfd, tmp_path):
    cfg_path, _, source = checkpoints["rfcn_tiny_smoke"]
    flat = export_mxnet_lsfa(source)
    flat["arg:fc1_weight"] = np.zeros((2, 2), np.float32)
    del flat["arg:rpn_cls_score_bias"]
    save_params(str(tmp_path / "r.params"), flat)
    import_reference_checkpoint.main(["--cfg", cfg_path, "--params", str(tmp_path / "r.params"),
                                      "--out", str(tmp_path / "out"), "--device", "cpu"])
    out, err = capfd.readouterr()
    n = len(flat) - 1
    assert f"imported {n} tensors, 1 state entries unmatched, 1 checkpoint tensors unused" in out
    assert "  missing: rpn_cls_score.bias" in out and "  unused:  arg:fc1_weight" in out
    assert "res_diff_legacy_swap: true" in err


@pytest.fixture(scope="module")
def vid_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("vid")
    dataset_path = str(root / "ILSVRC2015")
    image_set = write_vid_tree(dataset_path, LENGTHS, *CONTENT, seed=3)
    return str(root), dataset_path, image_set


def opener(dataset_path):
    """open_video for the tree's videos: SyntheticPreparedVideo streams of
    their lengths, the content filling the resized frame."""
    lengths = {os.path.join(dataset_path, "Data", "VID", "mpeg4_snippets", "val", f"{n}.mp4"): k
               for n, k in LENGTHS.items()}

    def open_video(path, *args, **kw):
        return SyntheticPreparedVideo(path, *args, num_frames=lengths[path], content_hw=CONTENT,
                                      **kw)

    return open_video


def tree_config(cfg_path, vid_tree, out):
    root, dataset_path, image_set = vid_tree
    return load_config(cfg_path, overrides={
        "output_path": out,
        "dataset": {"root_path": root, "dataset_path": dataset_path,
                    "test_image_set": image_set},
        "TEST": {"test_epoch": 0}})


@pytest.mark.parametrize("name,streams", [("lsfa_tiny_smoke", 0), ("lsfa_tiny_smoke", 2),
                                          ("rfcn_tiny_smoke", 0)])
def test_run_test_equals_the_loop_and_evaluate_map(name, streams, checkpoints, vid_tree,
                                                   tmp_path):
    cfg_path, ckpt, _ = checkpoints[name]
    cfg = tree_config(cfg_path, vid_tree, str(tmp_path / "out"))
    open_video = opener(vid_tree[1])
    mean_ap, ap = lsfa_test.run_test(cfg, ckpt_dir=ckpt, streams=streams,
                                     open_video=open_video, device="cpu")

    state, _ = load_checkpoint(ckpt)
    model = (rfcn_from_config if is_rfcn(cfg) else lsfa_from_config)(cfg, device="cpu")
    model.load_state_dict(state["model"])
    ds = ImageNetVID(cfg.dataset.test_image_set, cfg.dataset.root_path,
                     cfg.dataset.dataset_path)
    roidb = [{"vid_path": f"val/{n}", "frame_seg_len": k, "height": CONTENT[0],
              "width": CONTENT[1],
              "video_path": os.path.join(vid_tree[1], "Data", "VID", "mpeg4_snippets", "val",
                                         f"{n}.mp4")}
             for n, k in LENGTHS.items()]
    if is_rfcn(cfg):
        loop = driver.eval_videos_rfcn
    elif streams:
        loop = functools.partial(driver.eval_videos_timeplex, streams=streams)
    else:
        loop = driver.eval_videos
    dets = loop(model, cfg, roidb, logger=None, open_video=open_video)
    want_map, want_ap = driver.evaluate_map(dets, ds, roidb)
    assert mean_ap == want_map and np.isfinite(mean_ap)
    np.testing.assert_array_equal(ap, want_ap)
    out_dir = os.path.join(cfg.output_path, cfg.symbol, cfg.dataset.test_image_set)
    with open(os.path.join(out_dir, "detections.pkl"), "rb") as f:
        cached = pickle.load(f)
    assert sorted(cached) == list(range(sum(LENGTHS.values())))
    for i, d in dets.items():
        for field in ("labels", "scores", "boxes"):
            np.testing.assert_array_equal(cached[i][field], d[field])


def test_launcher_without_checkpoint_and_its_options(checkpoints, vid_tree, tmp_path):
    """No --ckpt and no train run: the random init, said so; the train
    run's directory is found; --vis raises naming the roadmap item."""
    cfg_path, ckpt, _ = checkpoints["rfcn_tiny_smoke"]
    cfg = tree_config(cfg_path, vid_tree, str(tmp_path / "out"))
    out_dir = os.path.join(cfg.output_path, cfg.symbol, cfg.dataset.test_image_set)
    lines = []

    class Log:
        info = warning = staticmethod(lines.append)

    assert lsfa_test.resolve_train_ckpt_dir(cfg, out_dir) is None
    lsfa_test.load_model(cfg, None, out_dir, Log, "cpu")
    assert lines[-1] == "NO checkpoint given: evaluating random init"
    train_dir = os.path.join(cfg.output_path, cfg.symbol, cfg.dataset.image_set, "checkpoints",
                             cfg.TRAIN.model_prefix)
    os.makedirs(os.path.dirname(train_dir))
    os.symlink(ckpt, train_dir)
    assert lsfa_test.resolve_train_ckpt_dir(cfg, out_dir) == train_dir
    lsfa_test.load_model(cfg, None, out_dir, Log, "cpu")
    assert lines[-1] == "loaded checkpoint epoch 0"
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        lsfa_test.main(["--cfg", cfg_path, "--vis", "2", "--device", "cpu"])
