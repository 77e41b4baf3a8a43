"""Baked serving artifacts (``export_inference(bake_weights=True)``, JAX's
default kind) on the CPU: each entry a ``torch.export`` program that holds
its weights, no ``weights.pt``, the meta keys of the JAX artifact.  A
baked artifact serves logits bit-equal to the external artifact of the
same encoding (f32, bf16, int8; both backbones' kinds), its weights read
back equal to the external ones, and ``export_serving`` bakes unless
``--external`` is given, as the JAX tool does."""

import json
import os

import numpy as np
import pytest
import torch

from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.serving import (
    SituationModel, decode_weights, export_inference, load_inference)

HIDDEN = 64
#: the JAX artifact's meta keys (``situation_recognition_tpu/serving.py``)
JAX_META_KEYS = {"format_version", "batch_size", "weights", "platforms",
                 "bake_weights", "entries", "backbone", "hidden",
                 "image_size", "num_verbs", "num_labels", "max_role_count",
                 "verb_list", "label_list", "roles_per_verb"}


@pytest.fixture(scope="module", autouse=True)
def _two_intra_op_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(backbone, seed=0):
    model = SituationModel(ImsituEncoder.synthetic_full(0),
                           backbone=backbone, hidden=HIDDEN)
    g = torch.Generator().manual_seed(seed)
    model.backbone.reset_parameters(g)
    model.head.reset_parameters(g)
    return model.eval()


def _images(b, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, 256, 256, 3),
                                                dtype=np.uint8)


CASES = [("mini", "f32"), ("mini", "bf16"), ("mini", "int8"),
         ("vit_tiny", "int8")]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Each case exported both ways from one model: {(backbone, weights,
    bake): path}."""
    out = {}
    models = {b: _model(b) for b in {b for b, _ in CASES}}
    for backbone, weights in CASES:
        for bake in (False, True):
            path = str(tmp_path_factory.mktemp("art")
                       / f"{backbone}_{weights}_{int(bake)}")
            export_inference(models[backbone], path, batch_size=2,
                             weights=weights, bake_weights=bake)
            out[backbone, weights, bake] = path
    return out


@pytest.mark.parametrize("backbone,weights", CASES)
def test_baked_logits_are_bit_equal_to_the_external_ones(artifacts,
                                                         backbone, weights):
    images, verbs = _images(3, 1), np.array([5, 77, 400])
    served = {}
    for bake in (False, True):
        path = artifacts[backbone, weights, bake]
        fn = load_inference(path, device="cpu")
        assert not hasattr(fn, "model")          # the programs serve
        served[bake] = (fn(images), fn.gt(images, verbs),
                        decode_weights(path))
    (ext, ext_gt, ext_w), (got, got_gt, got_w) = served[False], served[True]
    for g, w in zip(got, ext):
        assert torch.equal(g, w)
    assert torch.equal(got_gt, ext_gt)
    # the weights read back from the baked program: the external decode
    for g_sd, w_sd in zip(got_w, ext_w):
        assert list(g_sd) == list(w_sd)
        for k in w_sd:
            assert torch.equal(g_sd[k], w_sd[k]), k


def test_baked_meta_files_and_programs(artifacts):
    path = artifacts["mini", "int8", True]
    assert sorted(os.listdir(path)) == ["meta.json", "model.pt2",
                                        "model_gt.pt2"]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert JAX_META_KEYS <= set(meta)
    assert meta["bake_weights"] is True and "weights_file" not in meta
    assert meta["platforms"] == ["cpu", "cuda"]
    assert {e: v["file"] for e, v in meta["entries"].items()} == {
        "argmax": "model.pt2", "gt": "model_gt.pt2"}
    # the program takes the images alone and holds the encoded weights:
    # int8 matrices with f32 scales, in the served layout
    ep = torch.export.load(os.path.join(path, "model.pt2"))
    user = [s for s in ep.graph_signature.input_specs
            if s.kind.name == "USER_INPUT"]
    assert len(user) == 1 and ep.example_inputs is None
    kinds = {spec[0] for spec in meta["baked"].values()}
    assert kinds == {"plain", "int8"}
    for name, spec in meta["baked"].items():
        if spec[0] == "int8":
            base = name.replace(".", "__")
            assert ep.state_dict[base + "__q"].dtype == torch.int8
            assert ep.state_dict[base + "__scale"].dtype == torch.float32


def test_load_inference_reads_both_kinds(artifacts):
    """Either kind loads as programs, rebuilds the eager model from the
    same weights, and serves another batch size through its chunks."""
    images = _images(5, 2)
    outs = []
    for bake in (False, True):
        path = artifacts["mini", "bf16", bake]
        fn = load_inference(path, device="cpu")
        eager = load_inference(path, device="cpu", rebuild=True)
        assert fn.meta["bake_weights"] is bake and hasattr(eager, "model")
        got, want = fn(images), eager(images)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_export_serving_bakes_unless_external(tmp_path, capsys):
    """``python -m situation_recognition_tpu_torch.export_serving`` of a
    port checkpoint: baked by default, ``--external`` writes weights.pt
    beside programs that take it — the JAX tool's meaning — and the two
    serve the same logits."""
    from situation_recognition_tpu_torch import export_serving
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig
    from situation_recognition_tpu_torch.utils.checkpoint import (
        save_checkpoint)

    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "imSitu", "overfitting.json")) as f:
        ann = json.load(f)
    ds = tmp_path / "imSitu"
    ds.mkdir()
    with open(ds / "train.json", "w") as f:
        json.dump(ann, f)
    tr = Trainer(ImsituEncoder(ann, verbose=False), TrainerConfig(
        hidden=HIDDEN, batch_size=2, backbone="mini",
        compute_dtype=torch.float32), device="cpu")
    ckpt = str(tmp_path / "sr")
    save_checkpoint(ckpt, {"epoch": 1, **tr.model_state_dict()})
    served = {}
    for flag in ([], ["--external"]):
        out = str(tmp_path / ("ext" if flag else "baked"))
        export_serving.main([ckpt, out, "--backbone", "mini", "--weights",
                             "int8", "--batch_size", "2", "--platform",
                             "cpu", "--dataset_folder", str(ds), *flag])
        said = capsys.readouterr().out
        assert ("int8 external" if flag else "int8 baked") in said
        assert os.path.exists(os.path.join(out, "weights.pt")) == bool(flag)
        fn = load_inference(out, device="cpu")
        assert fn.meta["bake_weights"] is (not flag)
        served[bool(flag)] = fn(_images(3, 4))
    for a, b in zip(served[False], served[True]):
        assert torch.equal(a, b)
