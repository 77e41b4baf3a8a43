"""The port's single-image inference (``Trainer.infer_verb`` /
``infer_nouns``, ``inference.results``, ``analize_subset``) and the CLI's
``--test_img`` / ``--subset`` modes on the CPU, against the JAX package
(``situation_recognition_tpu/inference.py``, its ``Trainer`` and its CLI's
transcript) on the same weights: a JAX mini trainer after one train step
(f32, 64², masked GGNN), converted by ``convert.py`` or exported in the
reference's torch layout (``utils/torch_export.py``), and the
``tests/golden`` dataset (``imSitu/overfitting.json``, synthetic JPEGs,
an ``imSitu/imsitu_space.json`` made from it, read from the working
directory as the reference does).

Stdout is compared byte for byte after masking the addresses of the PIL
reprs that ``display`` prints (as ``tests/test_golden_cli.py`` does).
Logits: f32 on both sides, the same convolutions and products summed in
other orders through the mini backbone and the head (the backbone's
features agree to 1e-4, ``tests/test_torch_resnet.py``), so within 1e-4
absolute and relative."""

import contextlib
import io
import json
import os
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from situation_recognition_tpu import inference as jinf
from situation_recognition_tpu.data import dataset as jds
from situation_recognition_tpu.data.encoder import (
    ImsituEncoder as JaxEncoder)
from situation_recognition_tpu.train import (
    Trainer as JaxTrainer, TrainerConfig as JaxConfig)
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch import inference as tinf
from situation_recognition_tpu_torch.cli import main
from situation_recognition_tpu_torch.data import dataset as tds
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "golden")
NUMBER = re.compile(r"-?\d+\.\d+|\d+")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
IMAGE = os.path.join("resized_256", "glaring_215.jpg")


def _masked_addresses(text: str) -> str:
    return re.sub(r"0x[0-9A-Fa-f]{6,}", "0xADDR", text)


def _stdout(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args, **kwargs)
    return ret, out.getvalue()


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The golden dataset: train/dev/test = overfitting.json, its
    imsitu_space.json, 256² synthetic JPEGs named as its keys, and a
    packed store of the same images."""
    root = tmp_path_factory.mktemp("torch_inference")
    ds = root / "imSitu"
    ds.mkdir()
    with open(os.path.join(_REPO, "imSitu", "overfitting.json")) as f:
        ann = json.load(f)
    for name in ("train.json", "dev.json", "test.json"):
        with open(ds / name, "w") as f:
            json.dump(ann, f)
    verbs, nouns = {}, {}
    for rec in ann.values():
        roles = {}
        for frame in rec["frames"]:
            for role, label in frame.items():
                roles.setdefault(role, {})
                if label and label != "UNK":
                    nouns.setdefault(label, {"gloss": [label + "_gloss"]})
        verbs.setdefault(rec["verb"], {"roles": roles})
    with open(ds / "imsitu_space.json", "w") as f:
        json.dump({"nouns": nouns, "verbs": verbs}, f)
    imgs = root / "resized_256"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for name in ann:
        low = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
        arr = np.asarray(Image.fromarray(low).resize((256, 256),
                                                     Image.BILINEAR))
        Image.fromarray(arr).save(imgs / name, quality=95)
    tds.write_packed(str(root / "packed"), (
        (name, np.asarray(Image.open(imgs / name).convert("RGB")))
        for name in ann))
    return root, ann


@pytest.fixture(scope="module")
def trained(workspace):
    """(JAX trainer after one train step, the port's trainer on its
    weights, the two encoders)."""
    root, ann = workspace
    jenc = JaxEncoder(ann, verbose=False)
    common = dict(hidden=64, batch_size=8, backbone="mini",
                  ggnn_impl="masked", image_size=64)
    jtr = JaxTrainer(jenc, JaxConfig(compute_dtype=jnp.float32, **common))
    train = jds.ImsituLoader(jds.ImsituDataset(
        str(root / "resized_256"), ann, jenc, train=True), 8, shuffle=True)
    jtr.train_epoch(train, 0)
    bstate, hstate = convert.from_jax(*jax.tree.map(
        np.asarray, (jtr.backbone_params, jtr.backbone_stats,
                     jtr.head_params)))
    tenc = ImsituEncoder(ann, verbose=False)
    ttr = Trainer(tenc, TrainerConfig(compute_dtype=torch.float32, **common),
                  device="cpu", backbone_state=bstate, head_state=hstate)
    return jtr, ttr, jenc, tenc


@pytest.fixture()
def in_workspace(workspace, monkeypatch):
    monkeypatch.chdir(workspace[0])
    return workspace[0]


@pytest.mark.parametrize("preproc", ["window", "exact"])
def test_infer_logits_match_jax(workspace, trained, preproc):
    root, ann = workspace
    jtr, ttr, jenc, _ = trained
    ds = jds.ImsituDataset(str(root / "resized_256"), ann, jenc,
                           train=False, preproc=preproc)
    windows = np.stack([ds.load_window(i, None) for i in range(len(ds))])
    verbs = ds.verbs
    got_v = ttr.infer_verb(windows)
    got_n = ttr.infer_nouns(windows, verbs)
    assert got_v.dtype == got_n.dtype == torch.float32
    assert got_v.device.type == got_n.device.type == "cpu"
    np.testing.assert_allclose(got_v.numpy(),
                               np.asarray(jtr.infer_verb(windows)),
                               **LOGIT_TOL)
    np.testing.assert_allclose(got_n.numpy(),
                               np.asarray(jtr.infer_nouns(windows, verbs)),
                               **LOGIT_TOL)


@pytest.mark.parametrize("verb,preproc", [
    ("glaring", "window"), ("", "window"), ("not_a_verb", "exact")])
def test_results_match_jax(in_workspace, trained, verb, preproc):
    """The given verb (100%) or the predicted one ("No ground truth verb
    found" on stdout), the role labels and the role-axis probabilities."""
    jtr, ttr, jenc, tenc = trained
    want, want_out = _stdout(jinf.results, jtr, IMAGE, jenc, verb,
                             preproc=preproc)
    got, got_out = _stdout(tinf.results, ttr, IMAGE, tenc, verb,
                           preproc=preproc)
    assert got_out == want_out
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_allclose([got[1]] + got[3], [want[1]] + want[3],
                               rtol=1e-4)


class _Stub:
    """Fixed logits: label 1 ('' in the fixture's vocabulary) wins every
    role."""

    def __init__(self, enc):
        self.v = np.zeros((1, enc.get_num_verbs()), np.float32)
        self.n = np.zeros((1, enc.max_role_count, enc.get_num_labels()),
                          np.float32)
        self.n[:, :, 1] = 5.0

    def infer_verb(self, images):
        return self.v

    def infer_nouns(self, images, verb_ids):
        return self.n


def test_an_empty_label_prints_a_dash(in_workspace, trained):
    _, _, jenc, tenc = trained
    assert tenc.label_list[1] == ""
    want = jinf.results(_Stub(jenc), IMAGE, jenc, "glaring")
    got = tinf.results(_Stub(tenc), IMAGE, tenc, "glaring")
    assert got == want
    assert set(got[2].values()) == {"-"}


@pytest.mark.parametrize("store", ["files", "packed"])
def test_analize_subset_prints_what_jax_prints(workspace, in_workspace,
                                                trained, store):
    """3 images drawn with replacement after ``random.seed(0)``; re-opened
    from ``img_dir``, or with no files there taken from the packed
    store."""
    root, ann = workspace
    jtr, ttr, jenc, tenc = trained
    img_dir = str(root / ("resized_256" if store == "files" else "none"))
    jset = jds.ImsituDataset(img_dir, ann, jenc, train=False)
    tset = tds.ImsituDataset(img_dir, ann, tenc, train=False)
    if store == "packed":
        jset.enable_packed(str(root / "packed"))
        tset.enable_packed(str(root / "packed"))
    random.seed(0)
    _, want = _stdout(jinf.analize_subset, jtr, jset, jenc, 3)
    random.seed(0)
    _, got = _stdout(tinf.analize_subset, ttr, tset, tenc, 3)
    assert _masked_addresses(got) == _masked_addresses(want)
    assert got.count("Analizing: ") == 3
    assert ("PIL.Image.Image image" in got) == (store == "packed")


@pytest.fixture(scope="module")
def exported(workspace, trained):
    """The JAX trainer's state exported in the reference's torch layout,
    in a saving folder of its own."""
    from flax import serialization

    from situation_recognition_tpu.utils.checkpoint import HISTORY_KEYS
    from situation_recognition_tpu.utils.torch_export import (
        export_reference_checkpoint)

    jtr = trained[0]
    ck = {"epoch": 1, **{k: [] for k in HISTORY_KEYS},
          **serialization.to_state_dict(jax.tree.map(
              np.asarray, jtr.model_state_dict()))}
    ref = export_reference_checkpoint(ck)

    def to_torch(x):
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.array(x, copy=True))
        return x

    folder = workspace[0] / "jx"
    folder.mkdir()
    torch.save(to_torch(ref), str(folder / "jax.pth"))
    trained[3].save(str(folder / "encoder"))
    return "jx"


def _cli(*extra):
    return _stdout(main, [
        "--platform", "cpu", "--backbone", "mini", "--image_size", "64",
        "--batch_size", "5", "--num_workers", "2",
        "--dataset_folder", "imSitu", "--imgset_dir", "resized_256",
        "--saving_folder", "jx", "--resume_model", "jax.pth",
        *extra])[1]


def _jax_test_img_transcript(jtr, jenc, image, verb):
    """What JAX ``cli.py:741-762`` prints for ``--test_img``."""
    def run():
        verb_name, verb_prob, labels, labels_prob = jinf.results(
            jtr, image, jenc, verb)
        print('&' * 50)
        print('Analizing: ', image)
        print(Image.open(image, 'r'))
        print('&' * 50)
        print('action ({:.2f}%): {}'.format(verb_prob, verb_name))
        for c, (k, v) in enumerate(labels.items()):
            print('{} ({:.2f}%): {}'.format(k, labels_prob[c], v))
    return _stdout(run)[1]


@pytest.mark.parametrize("image,verb,golden", [
    ("talking_90.jpg", "", "test_img_pred.txt"),
    ("glaring_215.jpg", "glaring", "test_img_verb.txt")])
def test_cli_test_img_of_a_jax_export(in_workspace, trained, exported, image,
                                      verb, golden):
    """``--test_img`` (with and without ``--verb``) on the exported JAX
    weights prints the JAX CLI's transcript of them, in the form of the
    golden transcript of the same image."""
    jtr, _, jenc, _ = trained
    image = os.path.join("resized_256", image)
    got = _cli("--test_img", image, *(["--verb", verb] if verb else []))
    lines = got.splitlines()
    assert lines[:2] == ["Loading encoder file",
                         "Resume training from: jax.pth"]
    body = "\n".join(lines[2:]) + "\n"
    assert _masked_addresses(body) == _masked_addresses(
        _jax_test_img_transcript(jtr, jenc, image, verb))
    with open(os.path.join(GOLDEN, golden)) as f:
        want = f.read().splitlines()
    assert _form(lines[2:]) == _form(want[1:])


def _form(lines):
    """A transcript's form: numbers masked, and the role lines (whose
    count and names follow the verb the weights pick) as one marker."""
    out = []
    for x in (NUMBER.sub("#", _masked_addresses(x)) for x in lines):
        if x.startswith("action (#%): "):
            x = "action (#%): VERB"
        elif re.fullmatch(r"\S+ \(#%\): \S.*", x):
            x = "ROLES"
            if out and out[-1] == x:
                continue
        out.append(x)
    return out


def test_cli_subset_of_a_jax_export(workspace, in_workspace, trained,
                                    exported):
    """``--subset 2`` prints the JAX ``analize_subset`` of the exported
    weights on the dev split, drawn after ``random.seed(--seed)``."""
    root, ann = workspace
    jtr, _, jenc, _ = trained
    got = _cli("--subset", "2")
    random.seed(0)
    _, want = _stdout(jinf.analize_subset, jtr, jds.ImsituDataset(
        "resized_256", ann, jenc, train=False), jenc, 2)
    lines = got.splitlines()
    assert lines[:2] == ["Loading encoder file",
                         "Resume training from: jax.pth"]
    assert _masked_addresses("\n".join(lines[2:]) + "\n") == \
        _masked_addresses(want)
