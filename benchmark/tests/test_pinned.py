"""The harness's readings of the tiny cells are pinned (``data/
tiny_pinned.json``): from one seed, the seeded weights and the input pool
bit for bit, and the numbers the check compares to the last digit, so that
a change to how the harness finds a configuration's kind or a mix's entry
changes nothing that is measured or judged."""

import hashlib
import json
import time

import pytest
import torch

from benchmark import entries
from benchmark.harness import ROOT, run_cell, seeds
from benchmark.weights import make_state_dict

DATA = ROOT / "benchmark" / "tests" / "data"
PINNED = json.loads((DATA / "tiny_pinned.json").read_text())


def digest(named) -> str:
    h = hashlib.sha256()
    for name, t in named:
        t = t.detach().contiguous().cpu()
        h.update(f"{name} {t.dtype} {tuple(t.shape)}\n".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def load(name):
    return json.loads((DATA / f"{name}.json").read_text())


@pytest.mark.parametrize("cell", [k for k in PINNED if "/" in k])
def test_readings_are_pinned(cell):
    torch.set_num_threads(4)
    cfg, mix = (load(n) for n in cell.split("/"))
    want, seed = PINNED[cell], PINNED["seed"]
    s = seeds(seed)
    assert digest(make_state_dict(cfg, s["weights"], "cpu").items()) == want["weights_sha256"]
    pool = entries.driver(mix["entry"])(cfg, mix, s["inputs"], "cpu").pool
    assert digest(pool.items()) == want["pool_sha256"]
    r = run_cell(cfg, mix, load("tiny_checks"), [], seed, 1.5, False, "cpu", time.perf_counter())
    assert {k: c["value"] for k, c in r["checks"].items()} == want["checks"]
    assert r["readings"] == want["readings"]
