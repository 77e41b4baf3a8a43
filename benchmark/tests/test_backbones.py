"""Each backbone kind is a file of the reference's
(``reference/backbones/<kind>.py``), found by the configuration's
``backbone.kind``: the chip configurations draw and count what they drew
and counted before the backbones became files, and a kind without a
sound file stops a run before any result."""

import hashlib
import json
import os

import pytest

import core
import seeded
import work
from conftest import add_backbone_cell, copy_bench, make_checkout, run_cell

#: sha256 of the JSON of ``seeded.backbone_leaves`` (name, shape, init in
#: draw order), its length, and ``work.step_flops(cfg, 2)``, as they were
#: when ``seeded.py`` and ``reference/nets.py`` held the backbones
PINNED = {
    "r152-fcggnn": (
        "52a27bf63d2d83b4b2778f0f9fcb28f9633c11e96d991abb545a2ea82684805f",
        930, 59_419_197_440),
    "vitl14-fcggnn": (
        "6121c97c3ac7d25b43d2e3edc429d407f2fb594f88804b8fa868a3f0c1149100",
        294, 975_233_089_536),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_chip_configurations_draw_and_count_as_before(name):
    cfg = core.config(name)
    leaves = seeded.backbone_leaves(cfg)
    blob = json.dumps([[n, list(s), list(i)] for n, s, i in leaves])
    digest, count, flops = PINNED[name]
    assert len(leaves) == count
    assert hashlib.sha256(blob.encode()).hexdigest() == digest
    assert work.step_flops(cfg, 2) == flops


def test_a_kind_without_a_file_is_reported_and_stops_a_run(tmp_path):
    bench = copy_bench(str(tmp_path))
    add_backbone_cell(bench, "nosuch", "tiny-ns", None)
    root = make_checkout(str(tmp_path / "checkout"), bench)
    want = "config tiny-nosuch: no backbone file " \
        "reference/backbones/nosuch.py"
    assert core.validate(core.spec(root),
                         os.path.join(root, "benchmark")) == [want]
    rc, res, err = run_cell(root, "tiny-ns", seed=11)
    assert rc != 0 and res is None, err[-3000:]
    assert want in err


def test_a_backbone_file_that_imports_the_program_stops_a_run(tmp_path):
    bench = copy_bench(str(tmp_path))
    with open(os.path.join(bench, "reference", "backbones", "vit.py")) as f:
        source = f.read()
    add_backbone_cell(bench, "vitport", "tiny-vp",
                      source + "\nimport " + core.PROGRAM + "  # noqa\n")
    root = make_checkout(str(tmp_path / "checkout"), bench)
    rc, res, err = run_cell(root, "tiny-vp", seed=12)
    assert rc == 3 and res is None, err[-3000:]
    assert "reference.backbones.vitport." + core.PROGRAM in err
