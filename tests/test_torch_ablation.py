"""The synthetic ablation ladder in the port (``lsfa_tpu_torch/tools/``:
train_synth_full, eval_rung, render_ablation) against the JAX tools
(``tools/*.py``), and the readers the card's rungs take
(``chip_smoke.RenderedSynthDataset``).

- `rung_cfg` equals JAX's key by key for every rung, smoke or full size.
- With train_net and the evaluation loop replaced by recorders in both
  tools, the config (schedule, warm starts) and the roidb (after the flip
  and the filter) that reach train_net are equal for a few --steps values;
  the reports carry the same keys.
- `eval_rung.rung_report` equals JAX's report on the same detections and
  annotations field for field (mAP, key and non-key mAP, mAP by offset, AP
  per class), with JAX's model calls replaced.
- render_ablation writes byte for byte JAX's ABLATION.md from copies of
  the committed runs/ablation_r04 and runs/ablation_r05 reports.
- One --cpu-smoke mv_only rung end to end (4 steps, 2 + 1 videos) and
  eval_rung over its checkpoint.
- The rendered dataset equals the encoded one (records, boxes, classes,
  paths, oracle states); a sample of an oracle record on the host chain
  raises, and the fast path takes the oracle grid.

Everything that encodes needs the native library, and skips without it.
"""

import copy
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from lsfa_tpu.data import synth as jax_synth
from lsfa_tpu.eval import driver as jax_eval_driver
from lsfa_tpu.train import checkpoint as jax_checkpoint
from lsfa_tpu.train import driver as jax_train_driver
from lsfa_tpu_torch.data import coviar
from lsfa_tpu_torch.data.loader import SyntheticVideoReader, load_pair_sample
from lsfa_tpu_torch.data.oracle_flow import oracle_mv_grid
from lsfa_tpu_torch.data.synth import make_synth_vid_dataset
from lsfa_tpu_torch.tools import eval_rung, render_ablation, train_synth_full
from lsfa_tpu_torch.train import driver as train_driver
from tests.test_torch_convert import two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
METRICS = ["rpn_acc", "rcnn_acc", "rpn_cls_loss", "rpn_bbox_loss", "rcnn_cls_loss",
           "rcnn_bbox_loss", "total_loss"]
SMALL = ["--cpu-smoke", "--profile", "hard", "--videos", "2", "--frames", "24",
         "--val-videos", "1"]


def jax_tool(name):
    """The JAX tool tools/<name>.py as a module (not a package there)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_TRAIN = jax_tool("train_synth_full")
JAX_EVAL = jax_tool("eval_rung")
JAX_RENDER = jax_tool("render_ablation")


def needs_codec():
    if not coviar.available():
        pytest.skip("native coviar plane not built (needs FFmpeg's libraries)")


def flat(tree, prefix=""):
    """{dotted key: value} of a nested config, sequences as tuples."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(tuple(x) if isinstance(x, list) else x for x in v) \
                if isinstance(v, (list, tuple)) else v
    return out


@pytest.mark.parametrize("cpu_smoke", [True, False])
@pytest.mark.parametrize("rung", train_synth_full.RUNGS)
def test_rung_cfg_matches_jax(rung, cpu_smoke, monkeypatch):
    monkeypatch.chdir(ROOT)                 # JAX's rung_cfg reads configs/ relative to it
    want, want_sizes = JAX_TRAIN.rung_cfg(rung, cpu_smoke)
    got, sizes = train_synth_full.rung_cfg(rung, cpu_smoke)
    assert flat(got) == flat(want)
    assert tuple(sizes) == tuple(want_sizes)
    assert got.network.get("oracle_mv", False) is (rung == "oracle")
    assert got.network.add_dcn is not cpu_smoke       # the rfcn rung turns DCN on too


def run_jax_train(monkeypatch, argv):
    """JAX's train_synth_full.main over `argv` with train_net, init_model and
    the evaluation loops replaced. Returns (the cfg and roidb train_net
    got, the report, the curves' lines)."""
    seen = {}

    def train_net(cfg, roidb=None, ckpt_dir=None, logger=None, max_steps=None,
                  metrics_hook=None):
        seen.update(cfg=copy.deepcopy(cfg), roidb=roidb)
        for step in range(max_steps):
            metrics_hook(step, {k: 0.5 for k in METRICS})
        return {}, {}

    with monkeypatch.context() as mp:
        mp.chdir(ROOT)
        mp.setattr(jax_train_driver, "train_net", train_net)
        mp.setattr(jax_train_driver, "init_model", lambda cfg, *a, **k: (None, {}, {}))
        mp.setattr(jax_eval_driver, "eval_videos", lambda *a, **k: {})
        mp.setattr(jax_eval_driver, "eval_videos_rfcn", lambda *a, **k: {})
        mp.setattr(sys, "argv", ["train_synth_full.py"] + argv)
        assert JAX_TRAIN.main() == 0
    out = argv[argv.index("--out") + 1]
    with open(os.path.join(out, "report.json")) as f:
        report = json.load(f)
    with open(os.path.join(out, "curves.jsonl")) as f:
        return seen, report, [json.loads(line) for line in f]


def run_port_train(monkeypatch, argv):
    """The port's train_synth_full.main over `argv` with train_net and the
    evaluation replaced. Returns what run_jax_train returns."""
    seen = {}

    def train_net(cfg, roidb=None, logger=None, ckpt_dir=None, max_steps=None,
                  metrics_hook=None, device=None, open_video=None):
        seen.update(cfg=copy.deepcopy(cfg), roidb=roidb, device=device)
        for step in range(max_steps):
            metrics_hook(step, {k: 0.5 for k in METRICS})

    with monkeypatch.context() as mp:
        mp.setattr(train_driver, "train_net", train_net)
        mp.setattr(train_synth_full, "evaluate", lambda *a, **k: {})
        report = {}
        assert train_synth_full.main(argv, report=report) == 0
    return seen, report["report"], [json.loads(c) for c in report["curves"]]


def same_records(got, want, got_dir, want_dir):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if isinstance(v, str):
                assert g[k] == v.replace(want_dir, got_dir), k
            elif k == "oracle":
                assert sorted(g[k]) == sorted(v)
                for name in v:
                    np.testing.assert_array_equal(g[k][name], v[name])
            else:
                np.testing.assert_array_equal(g[k], v, err_msg=k)


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    needs_codec()
    return str(tmp_path_factory.mktemp("port_data")), str(tmp_path_factory.mktemp("jax_data"))


@pytest.mark.parametrize("rung,steps", [("mv_only", 3), ("oracle", 250), ("rfcn", 40)])
def test_train_schedule_and_roidb_match_jax(rung, steps, data_dirs, tmp_path, monkeypatch):
    """The cfg and roidb that reach train_net, with warm starts named."""
    port_data, jax_data = data_dirs
    argv = SMALL + ["--rung", rung, "--steps", str(steps), "--log-every", "2",
                    "--init-from", "stage_a/checkpoints", "--init-flow", "flow_ckpt"]
    got, report, curves = run_port_train(
        monkeypatch, argv + ["--data", port_data, "--out", str(tmp_path / "port")])
    want, jreport, jcurves = run_jax_train(
        monkeypatch, argv + ["--data", jax_data, "--out", str(tmp_path / "jax")])
    assert got["device"].type == "cpu"
    g, w = flat(got["cfg"]), flat(want["cfg"])
    assert g.pop("output_path") == str(tmp_path / "port")
    assert w.pop("output_path") == str(tmp_path / "jax")
    assert g == w
    assert (g["network.pretrained_detector"], g["network.pretrained_flow"]) == (
        "stage_a/checkpoints", "flow_ckpt")
    assert g["TRAIN.warmup_step"] == min(100, steps // 10) and g["TRAIN.warmup"] is True
    same_records(got["roidb"], want["roidb"], port_data, jax_data)
    assert any(r["flipped"] for r in got["roidb"])
    assert ("oracle" in got["roidb"][0]) is (rung == "oracle")
    assert list(report) == list(jreport) == chip_smoke.RUNG_REPORT_KEYS
    assert curves == jcurves and [c["step"] for c in curves] == list(range(0, steps, 2))


def fixed_detections(n_videos, frames, seed=0):
    """(val roidb, annotations, detections) over n_videos of `frames`
    frames: 0-3 gt boxes a frame of classes 1-6, each found with
    probability 0.8 by a jittered box, plus false positives; class 6 is
    never detected."""
    rng = np.random.default_rng(seed)
    annos, dets = {}, {}
    for g in range(n_videos * frames):
        n = int(rng.integers(0, 4))
        xy = rng.uniform(0, 60, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (n, 2))], 1).astype(np.float32)
        labels = rng.integers(1, 7, n)
        annos[g] = {"labels": labels, "boxes": boxes}
        found = (rng.uniform(size=n) < 0.8) & (labels != 6)
        fp = int(rng.integers(0, 3))
        fp_xy = rng.uniform(0, 80, (fp, 2))
        dets[g] = {
            "labels": np.concatenate([labels[found], rng.integers(1, 6, fp)]).astype(int),
            "scores": rng.uniform(0.05, 1, int(found.sum()) + fp).astype(np.float32),
            "boxes": np.concatenate([boxes[found] + rng.normal(0, 3, (int(found.sum()), 4)),
                                     np.concatenate([fp_xy, fp_xy + 20], 1)]).astype(np.float32)}
    roidb = [{"vid_path": f"v{i}", "frame_seg_len": frames} for i in range(n_videos)]
    return roidb, annos, dets


@pytest.mark.parametrize("rung", ["mv_only", "rfcn"])
def test_rung_report_matches_jax(rung, tmp_path, monkeypatch):
    roidb, annos, dets = fixed_detections(3, 36)
    with monkeypatch.context() as mp:
        mp.chdir(ROOT)
        mp.setattr(jax_synth, "make_synth_vid_dataset", lambda *a, **k: (None, roidb, annos))
        mp.setattr(jax_train_driver, "init_model", lambda cfg, *a, **k: (None, {}, {}))
        mp.setattr(jax_checkpoint, "load_checkpoint", lambda *a, **k: ({"params": {}}, 3))
        mp.setattr(jax_eval_driver, "eval_videos", lambda *a, **k: dets)
        mp.setattr(jax_eval_driver, "eval_videos_rfcn", lambda *a, **k: dets)
        mp.setattr(sys, "argv", ["eval_rung.py", "--rung", rung, "--cpu-smoke",
                                 "--val-videos", "3", "--out", str(tmp_path)])
        assert JAX_EVAL.main() == 0
        jcfg, _ = JAX_TRAIN.rung_cfg(rung, True)
    with open(tmp_path / f"report_{rung}_xval.json") as f:
        want = json.load(f)
    assert list(want) == chip_smoke.XVAL_REPORT_KEYS
    got = json.loads(json.dumps(eval_rung.rung_report(
        dets, annos, jcfg.dataset.NUM_CLASSES, 36, jcfg.TEST.KEY_FRAME_INTERVAL)))
    for k in ("mAP_synth_val", "mAP_key_frames", "mAP_nonkey_frames", "mAP_by_offset",
              "ap_per_class"):
        assert got[k] == want[k], k
    assert want["ap_per_class"]["6"] == 0.0 and 0.0 < want["mAP_synth_val"] < 1.0
    assert len(want["mAP_by_offset"]) == jcfg.TEST.KEY_FRAME_INTERVAL


@pytest.mark.parametrize("name", ["ablation_r04", "ablation_r05"])
def test_render_ablation_writes_jax_bytes(name, tmp_path, monkeypatch):
    src = os.path.join(ROOT, "runs", name)
    dirs = [tmp_path / "jax", tmp_path / "port"]
    for d in dirs:
        d.mkdir()
        for f in os.listdir(src):
            if f.endswith(".json"):
                shutil.copy(os.path.join(src, f), d / f)
    with monkeypatch.context() as mp:
        mp.setattr(sys, "argv", ["render_ablation.py", "--dir", str(dirs[0])])
        JAX_RENDER.main()
    render_ablation.main(["--dir", str(dirs[1])])
    want = (dirs[0] / "ABLATION.md").read_bytes()
    assert (dirs[1] / "ABLATION.md").read_bytes() == want and b"| rfcn" in want


def test_cpu_smoke_rung_end_to_end(tmp_path):
    """train_synth_full at --cpu-smoke, rung mv_only, 4 steps over 2 train
    videos and 1 val video through the native decoder, then eval_rung over
    its checkpoint."""
    needs_codec()
    out, data = tmp_path / "mv_only", str(tmp_path / "data")
    report = {}
    assert train_synth_full.main(SMALL + ["--rung", "mv_only", "--steps", "4", "--log-every",
                                          "1", "--data", data, "--out", str(out)],
                                 report=report) == 0
    with open(out / "report.json") as f:
        rep = json.load(f)
    assert list(rep) == chip_smoke.RUNG_REPORT_KEYS
    assert rep["steps"] == 4 and rep["eval_frames"] == 36 and rep["platform"] == "cpu"
    curves = [json.loads(line) for line in (out / "curves.jsonl").read_text().splitlines()]
    assert [c["step"] for c in curves] == [0, 1, 2, 3]
    assert all(sorted(c) == sorted(["step"] + METRICS) for c in curves)
    assert all(np.isfinite(v) for c in curves for v in c.values())
    assert sorted(os.listdir(out / "checkpoints")) == ["1.pt"]

    xval = {}
    assert eval_rung.main(["--cpu-smoke", "--rung", "mv_only", "--ckpt", str(out / "checkpoints"),
                           "--val-videos", "1", "--data", data, "--out", str(tmp_path)],
                          report=xval) == 0
    with open(tmp_path / "report_mv_only_xval.json") as f:
        rep = json.load(f)
    assert list(rep) == chip_smoke.XVAL_REPORT_KEYS
    assert rep["ckpt_epoch"] == 1 and rep["eval_frames"] == 36
    assert all(np.isfinite(rep[k]) for k in ("mAP_synth_val", "mAP_key_frames",
                                            "mAP_nonkey_frames"))
    trained = report["model"].state_dict()
    assert all(torch.equal(v, trained[k]) for k, v in xval["model"].state_dict().items())


TINY = dict(n_videos=2, n_frames=14, seed=5, sizes=((128, 96), (96, 128)), profile="hard",
            oracle=True)


def test_rendered_dataset_equals_the_encoded_one(tmp_path):
    needs_codec()
    want = make_synth_vid_dataset(str(tmp_path), **TINY)
    got = chip_smoke.RenderedSynthDataset()(str(tmp_path), **TINY)
    for g, w in zip(got[:2], want[:2]):
        same_records(g, w, "", "")
    assert sorted(got[2]) == sorted(want[2])
    for k, w in want[2].items():
        for f in ("labels", "boxes"):
            np.testing.assert_array_equal(got[2][k][f], w[f])


def oracle_setup():
    """(tiny oracle-rung config, the rendered dataset, a landscape record
    of frame 5)."""
    cfg, sizes = train_synth_full.rung_cfg("oracle", cpu_smoke=True)
    data = chip_smoke.RenderedSynthDataset()
    records, _, _ = data("synth", **{**TINY, "sizes": sizes})
    rec = next(r for r in records if r["frame_seg_id"] == 5 and r["width"] > r["height"])
    return cfg, data, rec


def non_key_sample(rec, cfg, **kw):
    """load_pair_sample of `rec` under the first seed that draws a
    non-degenerate pair."""
    for seed in range(20):
        sample = load_pair_sample(rec, cfg, np.random.default_rng(seed), **kw)
        if sample["eq_flag"] == 0.0:
            return sample
    raise AssertionError("every draw gave the key path")


def test_oracle_record_on_the_host_chain_raises():
    """Where the analytic flow cannot replace the MVs (no fast path), an
    oracle record raises instead of training on the reader's own MVs."""
    cfg, data, rec = oracle_setup()
    bucket = tuple(cfg.tpu.default_bucket)
    with pytest.raises(ValueError, match="fast path"):
        load_pair_sample(rec, cfg, np.random.default_rng(0), open_video=data.train_reader)
    with pytest.raises(ValueError, match="decode_train_sample"):
        load_pair_sample(rec, cfg, np.random.default_rng(0), bucket_hw=bucket,
                         open_video=lambda p: SyntheticVideoReader(p, 96, 128, 14))
    cfg.network.oracle_mv = False           # the mv_only rung trains on the reader's MVs
    non_key_sample(rec, cfg, open_video=data.train_reader)


def test_fast_path_takes_the_oracle_grid():
    """RenderedTrainReader's fast path: the generator's flow in place of
    the clip's zero MVs."""
    cfg, data, rec = oracle_setup()
    bucket = tuple(cfg.tpu.default_bucket)
    sample = non_key_sample(rec, cfg, bucket_hw=bucket, open_video=data.train_reader)
    fh, fw = sample["motion_vector"].shape[1:3]
    want = oracle_mv_grid(rec["oracle"], 5, 0, fh, fw, float(sample["im_info"][2]),
                          cfg.network.RCNN_FEAT_STRIDE, (rec["height"], rec["width"]))
    np.testing.assert_array_equal(sample["motion_vector"][0], want)
    assert np.abs(want).max() > 0
    cfg.network.oracle_mv = False
    assert not non_key_sample(rec, cfg, bucket_hw=bucket,
                              open_video=data.train_reader)["motion_vector"].any()


def test_native_fast_path_takes_the_oracle_grid(tmp_path):
    """The native decoder's one-call sample on this host: the oracle grid
    replaces the decoded MVs, as JAX's does."""
    needs_codec()
    cfg, sizes = train_synth_full.rung_cfg("oracle", cpu_smoke=True)
    records, _, _ = make_synth_vid_dataset(str(tmp_path), **{**TINY, "sizes": sizes})
    rec = next(r for r in records if r["frame_seg_id"] == 5 and r["width"] > r["height"])
    bucket = tuple(cfg.tpu.default_bucket)
    sample = non_key_sample(rec, cfg, bucket_hw=bucket)
    fh, fw = sample["motion_vector"].shape[1:3]
    want = oracle_mv_grid(rec["oracle"], 5, 0, fh, fw, float(sample["im_info"][2]),
                          cfg.network.RCNN_FEAT_STRIDE, (rec["height"], rec["width"]))
    np.testing.assert_array_equal(sample["motion_vector"][0], want)
    cfg.network.oracle_mv = False
    decoded = non_key_sample(rec, cfg, bucket_hw=bucket)["motion_vector"]
    assert not np.array_equal(decoded[0], want)
