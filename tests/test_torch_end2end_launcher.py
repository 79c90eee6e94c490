"""The train+test launcher (``lsfa_tpu_torch.experiments.
lsfa_end2end_train_test``) and ``train.driver.load_train_roidb`` over a
tiny ImageNet DET+VID tree (``chip_smoke.write_train_tree``: two DET
images, two videos of 14 frames, one stream a frame short of its
annotation; ``write_vid_tree`` for the val set), read through
``SyntheticVideoReader`` streams and seeded images.

`load_train_roidb` gives JAX's records (count, flipped copies, filtering,
video paths). `main` under a gloo process group of one rank (WORLD_SIZE
set, ``--device cpu``) writes the checkpoint and returns exactly the mAP
that ``train_net`` and then ``run_test`` give when called by hand without
a process group.
"""

import functools
import json
import os
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import seeded_image, write_train_tree, write_vid_tree
from lsfa_tpu.config import load_config as jax_load_config
from lsfa_tpu.train.driver import load_train_roidb as jax_load_train_roidb
from lsfa_tpu_torch.config import load_config
from lsfa_tpu_torch.data.loader import SyntheticPreparedVideo, SyntheticVideoReader
from lsfa_tpu_torch.experiments import lsfa_end2end_train_test as launcher
from lsfa_tpu_torch.experiments.lsfa_test import run_test
from lsfa_tpu_torch.parallel import mesh
from lsfa_tpu_torch.tools.dryrun_multihost import free_port
from lsfa_tpu_torch.train.checkpoint import load_checkpoint
from lsfa_tpu_torch.train.driver import load_train_roidb, train_net

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
VIDEO_HW, DET_HW = (96, 128), (75, 100)
# the streams' frames: vid_b and val_b end a frame before their annotations
FRAMES = {"vid_a": 14, "vid_b": 13, "val_a": 14, "val_b": 12}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(config path, dataset path) of the tiny LSFA over the tree, with a
    fixed reference offset (no random draw: the loader's workers may take
    batches in any order)."""
    tmp = tmp_path_factory.mktemp("end2end")
    dataset = tmp / "ILSVRC2015"
    write_train_tree(dataset, 2, {"vid_a": 14, "vid_b": 14}, seed=1, det_hw=DET_HW,
                     video_hw=VIDEO_HW)
    image_set = write_vid_tree(dataset, {"val_a": 14, "val_b": 13}, *VIDEO_HW, seed=2)
    with open(os.path.join(ROOT, "lsfa_tpu_torch", "configs", "lsfa_tiny_smoke.json")) as f:
        twin = json.load(f)
    twin["output_path"] = str(tmp / "out")
    twin["dataset"].update(root_path=str(tmp / "root"), dataset_path=str(dataset),
                           image_set="DET_train_30classes+VID_train_15frames",
                           test_image_set=image_set)
    twin["TRAIN"].update(MIN_OFFSET=-4, MAX_OFFSET=-4)
    twin["TEST"]["test_epoch"] = 0
    path = tmp / "tiny_train_test.json"
    path.write_text(json.dumps(twin))
    return str(path), str(dataset)


def open_video(path):
    return SyntheticVideoReader(path, *VIDEO_HW, num_frames=FRAMES[Path(path).stem])


def open_eval_video(path, *args, **kw):
    return SyntheticPreparedVideo(path, *args, num_frames=FRAMES[Path(path).stem],
                                  content_hw=(60, 80), im_scale=0.625, **kw)


read_image = functools.partial(seeded_image, det_hw=DET_HW, video_hw=VIDEO_HW)


def test_load_train_roidb_matches_jax(tree, tmp_path):
    cfg_path, dataset = tree
    over = {"dataset": {"root_path": str(tmp_path / "port")}}
    got = load_train_roidb(load_config(cfg_path, overrides=over))
    jcfg = jax_load_config(os.path.join(ROOT, "configs", "lsfa_tiny_smoke.yaml"), overrides={
        "dataset": {"root_path": str(tmp_path / "jax"), "dataset_path": dataset,
                    "image_set": "DET_train_30classes+VID_train_15frames"}})
    want = jax_load_train_roidb(jcfg)
    assert len(got) == len(want) == 2 * (2 + 30)
    assert sum(r["flipped"] for r in got) == 32 and sum("pattern" not in r for r in got) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[-1]["video_path"].endswith(os.path.join("mpeg4_snippets", "train", "vid_b.mp4"))


def test_launcher_equals_train_net_then_run_test(tree, tmp_path, monkeypatch):
    cfg_path, _ = tree
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=free_port(), WORLD_SIZE=1, RANK=0,
                     LOCAL_RANK=0).items():
        monkeypatch.setenv(k, str(v))
    mean_ap, ap = launcher.main(["--cfg", cfg_path, "--max-steps", "2", "--device", "cpu"],
                                open_video=open_video, read_image=read_image,
                                open_eval_video=open_eval_video)
    assert not mesh.active()                  # the launcher ended the group it started
    cfg = load_config(cfg_path)
    ckpt = os.path.join(cfg.output_path, cfg.symbol, cfg.dataset.image_set, "checkpoints",
                        cfg.TRAIN.model_prefix)
    state, epoch = load_checkpoint(ckpt)
    assert epoch == 1 and state["step"] == 2

    monkeypatch.delenv("WORLD_SIZE")
    cfg = load_config(cfg_path, overrides={"output_path": str(tmp_path / "by_hand")})
    model = train_net(cfg, max_steps=2, device="cpu", open_video=open_video,
                      read_image=read_image)
    want_map, want_ap = run_test(cfg, model=model, open_video=open_eval_video,
                                 read_image=read_image)
    assert np.isfinite(mean_ap) and mean_ap == want_map
    np.testing.assert_array_equal(ap, want_ap)
    assert launcher.main(["--cfg", cfg_path, "--max-steps", "1", "--device", "cpu",
                          "--skip-test"], open_video=open_video, read_image=read_image) is None
