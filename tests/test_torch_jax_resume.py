"""The JAX package's own msgpack checkpoints resumed by the port without
JAX: ``--resume_model`` reads the file with ``utils/msgpack.py`` and
converts it with ``convert.export_reference_checkpoint``.  The model and
Adamax state must be bit-equal to the JAX package's route (its
``load_checkpoint`` + ``utils/torch_export.export_reference_checkpoint``,
loaded by ``Trainer.load_model_state``), and the next train step must
match the JAX trainer's within ``tests/test_torch_train.py``'s lockstep
bounds (losses rtol 2e-4; head parameters rtol 2e-3 / atol 2e-5; BN
statistics 1e-5).  Mini backbone at 64², f32, on the CPU; a vit_tiny
checkpoint carries its backbone; and the CLI resumes one in a process
where ``jax``, ``flax`` and ``msgpack`` cannot be imported."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from situation_recognition_tpu.data.encoder import ImsituEncoder as JaxEnc
from situation_recognition_tpu.train import (
    Trainer as JaxTrainer, TrainerConfig as JaxConfig)
from situation_recognition_tpu.utils.checkpoint import (
    load_checkpoint as jax_load, save_checkpoint as jax_save)
from situation_recognition_tpu.utils.torch_export import (
    export_reference_checkpoint as jax_export)
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.cli import _load_resume
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.train import Trainer, TrainerConfig
from tests.test_torch_train import (
    B, LOSS_TOL, PARAM_TOL, STATS_TOL, _assert_trees_close, _batch,
    _jax_step, _port_step)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = dict(hidden=64, batch_size=B, backbone="mini", lr=0.002,
              dropout_rate=0.0, ggnn_impl="masked", image_size=64)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(seed=0, **kw):
    return Trainer(ImsituEncoder.synthetic_full(0),
                   TrainerConfig(compute_dtype=torch.float32, seed=seed,
                                 **dict(COMMON, **kw)), device="cpu")


def _jax(**kw):
    return JaxTrainer(JaxEnc.synthetic_full(0),
                      JaxConfig(compute_dtype=jnp.float32,
                                **dict(COMMON, **kw)))


def _save_jax(jtr, path, epoch=2):
    """What the JAX trainer's ``fit`` writes at an epoch's end."""
    jax_save(path, {"epoch": epoch, "avg_scores": [10.0, 11.5],
                    "verb_losses": [3.0, 2.5], "nouns_losses": [9.0, 8.0],
                    "val_avg_scores": [12.0, 13.0],
                    "val_verb_losses": [3.1, 2.9],
                    "val_nouns_losses": [9.1, 8.9],
                    **jax.device_get(jtr.model_state_dict())})


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_torch(v) for v in x)
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x, copy=True))
    return x


def _assert_bit_equal(a, b, path=""):
    if torch.is_tensor(a):
        b = torch.as_tensor(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("steps", [1, 3])
def test_jax_msgpack_resume_equals_the_jax_export(tmp_path, steps):
    enc = JaxEnc.synthetic_full(0)
    jtr = _jax()
    for i in range(steps):
        _jax_step(jtr, _batch(enc, B, seed=80 + i))
    path = str(tmp_path / "jax_ckpt")
    _save_jax(jtr, path)
    with open(path, "rb") as f:
        assert f.read(1)[0] & 0xf0 == 0x80        # a msgpack map

    direct = _port(seed=11)
    ckpt = _load_resume(direct, path)
    assert ckpt["epoch"] == 2 and ckpt["val_avg_scores"] == [12.0, 13.0]
    via_jax = _port(seed=12)
    via_jax.load_model_state(_to_torch(jax_export(jax_load(path))))
    got, want = direct.model_state_dict(), via_jax.model_state_dict()
    for part in ("model_state_dict", "optimizer_state_dict", "opt_steps"):
        _assert_bit_equal(got[part], want[part], part)
    assert direct.opt_steps == steps
    # the dropout stream continues as the JAX CLI's own resume continues
    # it (the JAX export to torch drops it)
    assert direct.step_count == jtr.step_count == steps

    # the next step, as JAX takes it
    batch = _batch(enc, B, seed=90)
    jl, jk = _jax_step(jtr, batch)
    tl, tk = _port_step(direct, batch)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a, b)
    _assert_trees_close(convert.head_params_to_jax(direct.head.state_dict()),
                        jax.tree.map(np.asarray, jtr.head_params),
                        PARAM_TOL, "head params after the resumed step")
    _assert_trees_close(convert.resnet_stats_to_jax(
        direct.backbone.state_dict()),
        jax.tree.map(np.asarray, jtr.backbone_stats), STATS_TOL,
        "BN statistics after the resumed step")


def test_jax_vit_checkpoint_carries_its_backbone(tmp_path):
    """A vit_tiny JAX checkpoint: the backbone arrives in torchvision's
    layout, bit-equal to the JAX trainer's parameters."""
    jtr = _jax(backbone="vit_tiny", image_size=64)
    path = str(tmp_path / "jax_vit")
    _save_jax(jtr, path)
    port = _port(backbone="vit_tiny", image_size=64)
    _load_resume(port, path)
    want = convert.vit_state_from_jax(jax.tree.map(np.asarray,
                                                   jtr.backbone_params))
    got = port._backbone_source()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k]), k


def test_cli_resumes_a_jax_checkpoint_without_jax(tmp_path):
    """``python -m situation_recognition_tpu_torch.cli --resume_model``
    of a JAX msgpack checkpoint, in a process that cannot import jax,
    flax or msgpack: the evaluation runs and prints the scores."""
    ds = tmp_path / "imSitu"
    ds.mkdir()
    with open(os.path.join(_REPO, "imSitu", "overfitting.json")) as f:
        ann = json.load(f)
    for name in ("train.json", "dev.json", "test.json"):
        with open(ds / name, "w") as f:
            json.dump(ann, f)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for name in ann:
        Image.fromarray(rng.integers(0, 255, (256, 256, 3), dtype=np.uint8)
                        ).save(imgs / name)
    from situation_recognition_tpu.data.encoder import ImsituEncoder

    jtr = JaxTrainer(ImsituEncoder(ann, verbose=False),
                     JaxConfig(compute_dtype=jnp.float32, **COMMON))
    folder = tmp_path / "ck"
    folder.mkdir()
    _save_jax(jtr, str(folder / "jax_sr"))
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'msgpack', 'optax',"
            " 'situation_recognition_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from situation_recognition_tpu_torch.cli import main\n"
            f"main({['--platform', 'cpu', '--backbone', 'mini', '--image_size', '64', '--batch_size', '5', '--num_workers', '0', '--dataset_folder', str(ds), '--imgset_dir', str(imgs), '--saving_folder', str(folder), '--resume_model', 'jax_sr', '--evaluate_dev']!r})\n")
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.splitlines()
    assert "Resume training from: jax_sr" in out
    after = out[out.index("Resume training from: jax_sr") + 1:]
    assert after[0] == "=> evaluating model with dev-set..."
    assert any("gt-value" in line for line in after)
    assert "not a torch checkpoint" not in proc.stderr
