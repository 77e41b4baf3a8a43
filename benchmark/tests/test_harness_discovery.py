"""The harness finds configurations, backbone kinds, cells, traffic mixes
and per-layer metrics by name: adding each takes new files and the spec's
entries, and no file that is there is edited."""

import hashlib
import json
import os
import shutil

import pytest

import core
from conftest import add_backbone_cell, copy_bench, make_checkout, run_cell


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_the_committed_spec_is_valid():
    assert core.validate(core.spec()) == []


def test_new_cell_config_traffic_and_metric_are_new_files_only(tmp_path):
    root = make_checkout(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    before = _digests(bench)
    shutil.copy(os.path.join(bench, "configs", "tiny-resnet.json"),
                os.path.join(bench, "configs", "tiny-wide.json"))
    with open(os.path.join(bench, "traffic", "tiny-burst.json"), "w") as f:
        json.dump({"kind": "train_epoch", "batch": 4, "checked_steps": 3,
                   "warm_batches": 1, "trace_skip": 1, "trace_steps": 1}, f)
    with open(os.path.join(bench, "limits", "tiny-w.json"), "w") as f:
        json.dump({"loss_rel": 1e-4}, f)
    with open(os.path.join(bench, "metrics", "steps.train.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.counters.get('steps')\n")
    path = os.path.join(root, "BENCHMARK.json")
    sp = json.load(open(path))
    sp["configs"].append({"name": "tiny-wide", "source": "test",
                          "file": "benchmark/configs/tiny-wide.json",
                          "reduced": [], "why": "test"})
    sp["workloads"].append({"name": "tiny-w", "config": "tiny-wide",
                            "traffic": "tiny-burst", "chips": 1,
                            "why": "test"})
    sp["per_layer"].append({"name": "steps.train", "unit": "steps",
                            "better": "higher", "source": "host_clock",
                            "layer": "whole step", "moves": "train_img_s",
                            "workloads": ["tiny-w"]})
    json.dump(sp, open(path, "w"))
    after = _digests(bench)
    assert all(after[k] == v for k, v in before.items())
    assert core.validate(core.spec(root), bench) == []
    names = [m["name"] for m in core.cell_metrics(sp, "tiny-w",
                                                  "per_layer")]
    assert names == ["steps.train"]
    reader = core.metric_reader("steps.train", bench)

    class Ctx:
        counters = {"steps": 7}

    assert reader.read(Ctx) == 7
    assert core.driver("train_epoch", bench).run


def test_a_new_backbone_kind_is_new_files_only(tmp_path):
    # a kind that is a copy of vit.py: its reference file, a tiny
    # configuration of it, its limits and its fixture cell, all new
    bench = copy_bench(str(tmp_path))
    before = _digests(bench)
    with open(os.path.join(bench, "reference", "backbones", "vit.py")) as f:
        add_backbone_cell(bench, "vitcopy", "tiny-vc", f.read())
    after = _digests(bench)
    assert all(after[k] == v for k, v in before.items())
    assert len(after) == len(before) + 4
    root = make_checkout(str(tmp_path / "checkout"), bench)
    assert core.validate(core.spec(root), os.path.join(root,
                                                        "benchmark")) == []
    rc, res, err = run_cell(root, "tiny-vc", seed=2**32 + 5, seconds=1.0)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("bad", [
    ("name", "has space"), ("name", "a/b"), ("name", "a,b"),
    ("name", "x" * 65), ("name", "µs"), ("unit", "tokens per second"),
    ("unit", "µs"), ("unit", "x" * 17)])
def test_names_and_units_use_only_the_allowed_characters(bad):
    sp = core.spec()
    m = dict(sp["per_layer"][0])
    m[bad[0]] = bad[1]
    sp = {**sp, "per_layer": [m] + sp["per_layer"][1:]}
    assert core.validate(sp)


def test_a_missing_reader_or_traffic_file_is_found():
    sp = core.spec()
    sp = {**sp, "per_layer": sp["per_layer"] + [{
        "name": "nothing.train", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "x", "moves": "train_img_s"}]}
    assert any("no reader file" in b for b in core.validate(sp))
