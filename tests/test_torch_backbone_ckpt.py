"""``--backbone_ckpt`` through the port's CLI (``cli.main``) against the
JAX CLI's ``_load_backbone`` on the same files, at mini widths on the CPU:
a CLIP visual tower (``visual.`` keys, a 224 grid) at another
``--image_size``, a torchvision ViT (``mlp.linear_*`` spelling, a
classifier head) at a smaller and a larger grid, a flax msgpack backbone;
the backbone the port's trainer holds must equal the JAX trainer's
(``convert.vit_state_from_jax``) within 1e-6 (the resampled position
embedding: the same cubic weights, f32 sums in another order), every other
tensor exactly.  A msgpack grid that does not fit raises, and a checkpoint
dropped in ``--saving_folder`` is converted once and cached as the JAX CLI
names it."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import situation_recognition_tpu.cli as jax_cli
import situation_recognition_tpu.models.vit as jax_vit
import situation_recognition_tpu.train as jax_train
from situation_recognition_tpu.data.encoder import ImsituEncoder as JaxEncoder
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.cli import main
from situation_recognition_tpu_torch.models import vit as port_vit
from situation_recognition_tpu_torch.train import Trainer
from situation_recognition_tpu_torch.utils import msgpack

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the resampled position embedding: f32 sums in another order
POS_TOL = 1e-6
# a CLIP-variant tower small enough for the CPU: ViT-L/14's patch and
# layout at width 128 in two blocks of two heads of 64
CLIP_SMALL = dict(patch=14, width=128, depth=2, heads=2)


@pytest.fixture(autouse=True)
def small_clip(monkeypatch):
    """``vit_l14_clip`` at ``CLIP_SMALL`` in both packages (their config
    tables patched for the test; no file changes)."""
    def jax_clip(dtype=None):
        return jax_vit.ViT(**CLIP_SMALL, dtype=dtype, clip_variant=True)

    monkeypatch.setitem(jax_train._VITS, "vit_l14_clip", jax_clip)
    for widths in (jax_train.VIT_WIDTHS, port_vit.VIT_WIDTHS):
        monkeypatch.setitem(widths, "vit_l14_clip", CLIP_SMALL["width"])
    monkeypatch.setitem(port_vit.VIT_CONFIGS, "vit_l14_clip",
                        (14, 128, 2, 2, True))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """train/dev/test = ``imSitu/overfitting.json`` and synthetic images."""
    root = tmp_path_factory.mktemp("torch_backbone_ckpt")
    ds = root / "imSitu"
    ds.mkdir()
    with open(os.path.join(_REPO, "imSitu", "overfitting.json")) as f:
        ann = json.load(f)
    for name in ("train.json", "dev.json", "test.json"):
        with open(ds / name, "w") as f:
            json.dump(ann, f)
    imgs = root / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for name in ann:
        Image.fromarray(rng.integers(0, 255, (256, 256, 3), dtype=np.uint8)
                        ).save(imgs / name)
    return root


def _port_backbone(monkeypatch, workdir, backbone, size, folder, *extra):
    """``cli.main --evaluate_dev`` with the evaluation replaced by a
    capture of the trainer → (its backbone state in f32, the run's
    stdout and stderr)."""
    seen = {}

    def capture(self, loader, logging=False, preempt=None):
        seen["trainer"] = self

    monkeypatch.setattr(Trainer, "evaluate", capture)
    err = io.StringIO()
    with contextlib.redirect_stdout(err), contextlib.redirect_stderr(err):
        main(["--platform", "cpu", "--backbone", backbone,
              "--image_size", str(size), "--batch_size", "5",
              "--num_workers", "0",
              "--dataset_folder", str(workdir / "imSitu"),
              "--imgset_dir", str(workdir / "imgs"),
              "--saving_folder", str(workdir / folder), "--evaluate_dev",
              *extra])
    return seen["trainer"]._backbone_source(), err.getvalue()


def _jax_backbone(workdir, backbone, size, path):
    """The JAX CLI's ``_load_backbone`` of ``path`` into a JAX trainer →
    its backbone params in the port's layout."""
    import jax.numpy as jnp

    with open(workdir / "imSitu" / "train.json") as f:
        enc = JaxEncoder(json.load(f), verbose=False)
    cfg = jax_train.TrainerConfig(
        hidden=jax_train.default_hidden(backbone), batch_size=8,
        backbone=backbone, image_size=size, compute_dtype=jnp.float32)
    trainer = jax_train.Trainer(enc, cfg)
    jax_cli._load_backbone(trainer, str(path))
    return convert.vit_state_from_jax(_np_tree(trainer.backbone_params))


def _np_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_same(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        g = got[k].float()
        if k == "encoder.pos_embedding":
            assert g.shape == w.shape, k
            assert (g - w).abs().max().item() <= POS_TOL, k
        else:
            assert torch.equal(g, w), k


def _random_vit_state(backbone, image, seed):
    m = port_vit.build_vit(backbone, image_size=image)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    return m.state_dict()


def _clip_layout(state, prefix="visual."):
    """The port's CLIP-variant ViT state → CLIP's visual-tower keys."""
    d = state["class_token"].shape[-1]
    out = {prefix + "class_embedding": state["class_token"].reshape(d),
           prefix + "positional_embedding": state["encoder.pos_embedding"][0],
           prefix + "conv1.weight": state["conv_proj.weight"],
           prefix + "proj": torch.randn(d, 32)}
    for ours, theirs in (("ln_pre", "ln_pre"), ("encoder.ln", "ln_post")):
        for p in ("weight", "bias"):
            out[f"{prefix}{theirs}.{p}"] = state[f"{ours}.{p}"]
    names = (("self_attention.in_proj_", "attn.in_proj_"),
             ("self_attention.out_proj.", "attn.out_proj."),
             ("mlp.0.", "mlp.c_fc."), ("mlp.3.", "mlp.c_proj."),
             ("ln_1.", "ln_1."), ("ln_2.", "ln_2."))
    for k, v in state.items():
        if k.startswith("encoder.layers.encoder_layer_"):
            i, rest = k[len("encoder.layers.encoder_layer_"):].split(".", 1)
            for ours, theirs in names:
                if rest.startswith(ours):
                    out[f"{prefix}transformer.resblocks.{i}.{theirs}"
                        f"{rest[len(ours):]}"] = v
    return out


@pytest.mark.parametrize("prefix", ["visual.", ""])
def test_clip_tower_at_another_grid_loads_as_jax_loads_it(
        monkeypatch, workdir, tmp_path, prefix):
    """A CLIP tower at the 224 grid (16² + 1 tokens of 14-pixel patches)
    through ``--backbone_ckpt`` at ``--image_size 336`` (24² + 1): every
    tower weight where JAX puts it, the position embedding resampled."""
    state = _clip_layout(_random_vit_state("vit_l14_clip", 224, 1), prefix)
    path = tmp_path / "clip.pth"
    torch.save(state, path)
    got, err = _port_backbone(monkeypatch, workdir, "vit_l14_clip", 336,
                              f"ck_clip{len(prefix)}", "--backbone_ckpt",
                              str(path))
    assert "[Missed]" not in err and "[Mismatch]" not in err
    assert got["encoder.pos_embedding"].shape == (1, 24 * 24 + 1, 128)
    _assert_same(got, _jax_backbone(workdir, "vit_l14_clip", 336, path))


@pytest.mark.parametrize("image", [96, 320], ids=["shrink", "grow"])
def test_torchvision_vit_at_another_grid_loads_as_jax_loads_it(
        monkeypatch, workdir, tmp_path, image):
    """A torchvision ViT (vit_tiny: patch 32, 7² + 1 tokens at 224) in
    the ``mlp.linear_*`` spelling, with its classifier, at 3² + 1 and
    10² + 1 tokens."""
    state = {}
    for k, v in _random_vit_state("vit_tiny", 224, 2).items():
        state[k.replace(".mlp.0.", ".mlp.linear_1.")
              .replace(".mlp.3.", ".mlp.linear_2.")] = v
    state["heads.head.weight"] = torch.randn(10, 64)
    state["heads.head.bias"] = torch.randn(10)
    path = tmp_path / "vit.pth"
    torch.save(state, path)
    got, err = _port_backbone(monkeypatch, workdir, "vit_tiny", image,
                              f"ck_tv{image}", "--backbone_ckpt", str(path))
    assert "[Missed]" not in err and "[Mismatch]" not in err
    _assert_same(got, _jax_backbone(workdir, "vit_tiny", image, path))


def test_msgpack_backbone_loads_and_a_foreign_grid_raises(
        monkeypatch, workdir, tmp_path):
    """A flax msgpack backbone (``params``, JAX layout) loads as it is; at
    another ``--image_size`` its grid no longer fits and the CLI raises
    the JAX CLI's error instead of keeping a random embedding."""
    state = _random_vit_state("vit_tiny", 224, 3)
    path = str(tmp_path / "backbone.msgpack")
    msgpack.write(path, {"params": convert.vit_params_to_jax(state, 2),
                         "batch_stats": {}})
    got, _ = _port_backbone(monkeypatch, workdir, "vit_tiny", 224, "ck_mp",
                            "--backbone_ckpt", path)
    _assert_same(got, _jax_backbone(workdir, "vit_tiny", 224, path))
    _assert_same(got, state)
    with pytest.raises(ValueError, match="does not match --image_size 96"):
        _port_backbone(monkeypatch, workdir, "vit_tiny", 96, "ck_mp2",
                       "--backbone_ckpt", path)


def test_dropped_checkpoint_is_converted_and_cached(monkeypatch, workdir):
    """A ``backbone.pth`` in ``--saving_folder`` is converted at the run's
    size and cached as ``backbone_<size>.msgpack``, which the next run
    picks up first, and which flax and the JAX CLI read to the same
    weights."""
    from flax import serialization

    folder = workdir / "ck_drop"
    folder.mkdir()
    state = _random_vit_state("vit_tiny", 224, 4)
    torch.save(state, folder / "backbone.pth")
    first, err = _port_backbone(monkeypatch, workdir, "vit_tiny", 96,
                                "ck_drop")
    cache = folder / "backbone_96.msgpack"
    assert "converted" in err and cache.is_file()
    with open(cache, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    assert set(tree) == {"params", "batch_stats"}
    _assert_same(first, _jax_backbone(workdir, "vit_tiny", 96, cache))
    os.remove(folder / "backbone.pth")
    again, err = _port_backbone(monkeypatch, workdir, "vit_tiny", 96,
                                "ck_drop")
    assert "converted" not in err and "no pretrained backbone" not in err
    _assert_same(again, first)
