"""Checkpoints of the port in the reference's torch layout: a bit-exact
round trip, the key layout of ``tests/torch_refmodel.py``'s reference
model, the Adamax index map in both directions, and resumes across
packages — a JAX export resumed here and a port checkpoint resumed by the
JAX CLI each take the next step within ``tests/test_torch_train.py``'s
lockstep tolerances (losses rtol 2e-4, head parameters rtol 2e-3 / atol
2e-5, BN statistics 1e-5) of the other package's next step.  Mini
backbone at 64², f32, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from situation_recognition_tpu.data.encoder import ImsituEncoder as JaxEnc
from situation_recognition_tpu.train import (
    Trainer as JaxTrainer, TrainerConfig as JaxConfig)
from situation_recognition_tpu.utils.torch_export import (
    export_reference_checkpoint)
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.train import Trainer, TrainerConfig
from situation_recognition_tpu_torch.utils.checkpoint import (
    HISTORY_KEYS, load_checkpoint, restore_tolerant, save_checkpoint)
from tests.test_torch_train import (
    B, LOSS_TOL, PARAM_TOL, STATS_TOL, _assert_trees_close, _batch,
    _jax_step, _port_step)

COMMON = dict(hidden=64, batch_size=B, backbone="mini", lr=0.002,
              dropout_rate=0.0, ggnn_impl="masked", image_size=64)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread while this module runs: the suite runs several
    worker processes per core, and their thread pools spin against each
    other (these small steps ran 20x slower under load with the default
    pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(seed=0, **kw):
    cfg = dict(COMMON, **kw)
    return Trainer(ImsituEncoder.synthetic_full(0),
                   TrainerConfig(compute_dtype=torch.float32, seed=seed,
                                 **cfg), device="cpu")


def _jax():
    return JaxTrainer(JaxEnc.synthetic_full(0),
                      JaxConfig(compute_dtype=jnp.float32, **COMMON))


def _ckpt(trainer, epoch=1):
    return {"epoch": epoch,
            **{k: [0.5 * (i + 1) for i in range(epoch)]
               for k in HISTORY_KEYS},
            **trainer.model_state_dict()}


def _assert_equal(a, b, path=""):
    """Nested dicts / lists of tensors and numbers, bit for bit."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("ft", [False, True])
def test_round_trip_is_bit_exact(tmp_path, ft):
    """Two steps, save, load into a fresh trainer (the same seed, which
    also keys the dropout streams), save again: parameters, BN statistics,
    Adamax state, step_count, opt_steps and the histories are equal bit
    for bit, and the next step is too."""
    enc = ImsituEncoder.synthetic_full(0)
    tr = _port(train_backbone=ft, dropout_rate=0.5)
    for i in range(2):
        _port_step(tr, _batch(enc, B, seed=50 + i))
    path = str(tmp_path / "ck")
    save_checkpoint(path, _ckpt(tr, epoch=2))
    back = _port(train_backbone=ft, dropout_rate=0.5)
    loaded = load_checkpoint(path)
    back.load_model_state(loaded)
    assert (back.step_count, back.opt_steps) == (tr.step_count, 2)
    _assert_equal(_ckpt(back, epoch=2), _ckpt(tr, epoch=2))
    for k in HISTORY_KEYS:
        assert loaded[k] == [0.5, 1.0]
    batch = _batch(enc, B, seed=60)
    _port_step(tr, batch)
    _port_step(back, batch)
    _assert_equal(back.model_state_dict(), tr.model_state_dict())


def test_layout_loads_strict_into_the_reference_model():
    """``model_state_dict`` has the reference's keys in its registration
    order (the twins share one tensor) and loads ``strict=True``."""
    from tests.torch_refmodel import RefFCGGNN

    enc = ImsituEncoder.synthetic_full(0)
    tr = _port()
    msd = tr.model_state_dict()["model_state_dict"]
    ref = RefFCGGNN(JaxEnc.synthetic_full(0), d=64, width=2)
    assert list(msd) == list(ref.state_dict())
    ref.load_state_dict(msd, strict=True)
    assert msd["convnet_verbs.model.conv1.weight"] is \
        msd["convnet_nouns.model.conv1.weight"]
    # the reference's optimizer over its trainable parameters takes the
    # Adamax state as it is
    _port_step(tr, _batch(enc, B, seed=3))
    osd = tr.model_state_dict()["optimizer_state_dict"]
    opt = torch.optim.Adamax(
        [p for p in ref.parameters() if p.requires_grad], lr=0.002)
    opt.load_state_dict(osd)
    assert float(opt.state_dict()["state"][0]["step"]) == 1.0


@pytest.mark.parametrize("ft", [False, True])
def test_adamax_index_map_both_ways(ft):
    """Reference index i holds the state of the parameter the reference
    registers i-th (the backbone, fine-tuned, between verb_emb and
    ggsnn); loading maps each entry back onto that parameter."""
    enc = ImsituEncoder.synthetic_full(0)
    tr = _port(train_backbone=ft)
    _port_step(tr, _batch(enc, B, seed=4))
    osd = tr.model_state_dict()["optimizer_state_dict"]
    named = dict(tr.head.named_parameters())
    named.update({"convnet_verbs.model." + n: p
                  for n, p in tr.backbone.named_parameters()})
    names = tr._param_names()[0]
    assert names[:3] == (["role_emb.weight", "verb_emb.weight",
                          "convnet_verbs.model.conv1.weight"] if ft else
                         ["role_emb.weight", "verb_emb.weight",
                          "ggsnn.W_p.weight"])
    assert osd["param_groups"][0]["params"] == list(range(len(names)))
    live = tr.optimizer.state
    for i, name in enumerate(names):
        assert torch.equal(osd["state"][i]["exp_avg"],
                           live[named[name]]["exp_avg"]), name
    # the other way: perturb one reference entry, load, find it there
    other = _port(seed=5, train_backbone=ft)
    osd["state"][2]["exp_inf"] = osd["state"][2]["exp_inf"] + 1.0
    other.load_model_state({"model_state_dict":
                            tr.model_state_dict()["model_state_dict"],
                            "optimizer_state_dict": osd})
    p = dict(other.head.named_parameters())
    p.update({"convnet_verbs.model." + n: q
              for n, q in other.backbone.named_parameters()})
    assert torch.equal(other.optimizer.state[p[names[2]]]["exp_inf"],
                       osd["state"][2]["exp_inf"])


def test_frozen_to_fine_tune_reinitialises_adamax(capsys):
    enc = ImsituEncoder.synthetic_full(0)
    frozen = _port()
    _port_step(frozen, _batch(enc, B, seed=6))
    ft = _port(seed=3, train_backbone=True)
    ft.load_model_state(frozen.model_state_dict())
    out = capsys.readouterr().out
    assert "[Mismatch]" in out and "optimizer" in out
    assert not ft.optimizer.state and ft.opt_steps == 0
    for a, b in zip(ft.head.parameters(), frozen.head.parameters()):
        assert torch.equal(a, b)
    losses, _ = _port_step(ft, _batch(enc, B, seed=7))
    assert np.isfinite(losses).all()


def test_restore_tolerant_reports_missed_and_mismatch(capsys):
    target = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.ones(1)}
    out = restore_tolerant(target, {"a": np.ones(2, np.float64),
                                    "b": torch.ones(4), "z": torch.ones(1)})
    text = capsys.readouterr().out
    assert "[Mismatch]: b" in text and "[Missed]: c" in text
    assert out["a"].dtype == torch.float32 and out["a"].sum() == 2
    assert out["b"] is target["b"] and out["c"] is target["c"]


def _export_jax(jtr, path, epoch=1):
    ck = {"epoch": epoch, **{k: [] for k in HISTORY_KEYS},
          **serialization.to_state_dict(jax.tree.map(
              np.asarray, jtr.model_state_dict()))}
    ref = export_reference_checkpoint(ck)

    def to_torch(x):
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to_torch(v) for v in x)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.array(x, copy=True))
        return x

    torch.save(to_torch(ref), path)


def _compare(jtr, ttr, what):
    _assert_trees_close(convert.head_params_to_jax(ttr.head.state_dict()),
                        jax.tree.map(np.asarray, jtr.head_params),
                        PARAM_TOL, f"{what} head params")
    _assert_trees_close(convert.resnet_stats_to_jax(
        ttr.backbone.state_dict()),
        jax.tree.map(np.asarray, jtr.backbone_stats), STATS_TOL,
        f"{what} BN statistics")


def test_jax_export_resumes_onto_jax_next_step(tmp_path):
    from situation_recognition_tpu_torch.cli import _load_resume

    enc = JaxEnc.synthetic_full(0)
    jtr = _jax()
    _jax_step(jtr, _batch(enc, B, seed=70))
    path = str(tmp_path / "jax.pth")
    _export_jax(jtr, path)
    ttr = _port(seed=11)
    _load_resume(ttr, path)
    assert ttr.opt_steps == 1
    _compare(jtr, ttr, "resumed")
    batch = _batch(enc, B, seed=71)
    jl, jk = _jax_step(jtr, batch)
    tl, tk = _port_step(ttr, batch)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a, b)
    _compare(jtr, ttr, "after the next step")


def test_port_checkpoint_resumes_in_the_jax_cli(tmp_path):
    from situation_recognition_tpu.cli import _load_resume as jax_resume

    enc = JaxEnc.synthetic_full(0)
    jtr = _jax()
    tree = jax.tree.map(np.asarray, (jtr.backbone_params, jtr.backbone_stats,
                                     jtr.head_params))
    bstate, hstate = convert.from_jax(*tree)
    ttr = Trainer(ImsituEncoder.synthetic_full(0),
                  TrainerConfig(compute_dtype=torch.float32, **COMMON),
                  device="cpu", backbone_state=bstate, head_state=hstate)
    _port_step(ttr, _batch(enc, B, seed=80))
    path = str(tmp_path / "port")
    save_checkpoint(path, _ckpt(ttr, epoch=1))
    fresh = _jax()
    ck = jax_resume(fresh, path)
    assert ck["epoch"] == 1 and ck["avg_scores"] == [0.5]
    _compare(fresh, ttr, "resumed")
    batch = _batch(enc, B, seed=81)
    jl, jk = _jax_step(fresh, batch)
    tl, tk = _port_step(ttr, batch)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a, b)
    _compare(fresh, ttr, "after the next step")
