"""The port's data parallelism in a 2-rank gloo world on the CPU
(``tests/torch_dist_worker.py``, scenario ``dp``): mini backbone, f32,
dropout 0, train-mode BN, global batch 8 (4 a rank), the port's seeded
weights carried into the JAX trainers by ``convert.py``.

* Against JAX's ``Trainer`` on ``make_mesh(num_devices=2)`` (global BN
  statistics, as the port's): 3 train steps (the last on a wrapped batch
  of 5) and ``evaluate`` — losses rtol 2e-4, the top-k equal, the head
  within ``tests/test_torch_train.py``'s lockstep bounds (rtol 2e-3 /
  atol 2e-5), BN statistics 1e-5; the same scores.
* Against the port's single process at the global batch: dropout 0.5,
  ``grad_accum`` 2, and the backbone's gradients through the global-
  statistics BN under ``train_backbone`` (rtol 1e-4 / atol 1e-6: the same
  f32 sums in another order).
* A preemption flag set on one rank stops both at the same step boundary,
  with one snapshot (rank 0's); ``fit`` writes on rank 0 only.
* The explicit twin (``parallel/spmd.py``) against JAX's
  ``make_shardmap_train_step`` on 2 devices (per-rank BN, the running
  statistics averaged).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.data.encoder import (
    ImsituEncoder as JaxEncoder)
from situation_recognition_tpu.parallel.mesh import make_mesh as jax_mesh
from situation_recognition_tpu.parallel.spmd import make_shardmap_train_step
from situation_recognition_tpu.train import (
    Trainer as JaxTrainer, TrainerConfig as JaxConfig)
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.train import Trainer, TrainerConfig
from tests.test_torch_train import (
    LOSS_TOL, PARAM_TOL, STATS_TOL, _assert_trees_close, _jax_step)
from tests.torch_dist_worker import (
    COMMON, EVAL, STEPS, B, ListLoader, batch, run_world, steps)

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
JAX_COMMON = {k: v for k, v in COMMON.items() if k != "compute_dtype"}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_weights():
    """The port's seeded mini weights: (backbone state, head state)."""
    one = Trainer(ImsituEncoder.synthetic_full(0), TrainerConfig(**COMMON),
                  device="cpu")
    return one.backbone.state_dict(), one.head.state_dict()


def jax_trainer_from(weights, mesh, **kw):
    """JAX's Trainer on ``mesh`` holding ``weights`` (given, its flax init
    is not run: most of a cold trainer's construction time)."""
    bstate, hstate = weights
    return JaxTrainer(
        JaxEncoder.synthetic_full(0),
        JaxConfig(compute_dtype=jnp.float32, **JAX_COMMON, **kw), mesh=mesh,
        backbone_variables={
            "params": convert.resnet_params_to_jax(bstate),
            "batch_stats": convert.resnet_stats_to_jax(bstate)},
        head_params=convert.head_params_to_jax(hstate))


@pytest.fixture(scope="module")
def weights():
    return port_weights()


@pytest.fixture(scope="module")
def jax_trainer(weights):
    return jax_trainer_from(weights, jax_mesh(num_devices=2))


@pytest.fixture(scope="module")
def jax_lockstep(jax_trainer, world):
    """JAX's 3 steps and ``evaluate`` on the world's batches."""
    jtr = jax_trainer
    enc = JaxEncoder.synthetic_full(0)
    out = {"steps": [_jax_step(jtr, batch(enc, n, seed))
                     for n, seed in STEPS]}
    out["head"] = jax.tree.map(np.asarray, jtr.head_params)
    out["stats"] = jax.tree.map(np.asarray, jtr.backbone_stats)
    loader = ListLoader([batch(enc, n, s) for n, s in EVAL])
    out["eval"] = jtr.evaluate(loader)
    return out


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    """The weights in ``weights.pt``, and each rank's results of the
    ``dp`` scenario."""
    d = tmp_path_factory.mktemp("dp_world")
    torch.save(weights, d / "weights.pt")
    return str(d), run_world("dp", 2, str(d))


def _one_process(directory, **kw):
    bstate, hstate = torch.load(os.path.join(directory, "weights.pt"))
    return Trainer(ImsituEncoder.synthetic_full(0),
                   TrainerConfig(**{**COMMON, **kw}), device="cpu",
                   backbone_state=bstate, head_state=hstate)


def _head(msd):
    return convert.head_params_to_jax(convert.from_reference(msd)[1])


def _stats(backbone_state):
    return convert.resnet_stats_to_jax(backbone_state)


def _assert_ranks_equal(res, key):
    a, b = res[0][key], res[1][key]
    np.testing.assert_array_equal(a["losses"], b["losses"])
    for k in a["msd"]:
        torch.testing.assert_close(a["msd"][k], b["msd"][k], rtol=0, atol=0,
                                   msg=f"{key}: rank 1's {k}")
    for k in a["backbone"]:
        torch.testing.assert_close(a["backbone"][k], b["backbone"][k],
                                   rtol=0, atol=0)


def test_dp_world_matches_the_jax_mesh_trainer(jax_lockstep, world):
    _, res = world
    for i, (jl, jk) in enumerate(jax_lockstep["steps"]):
        got = res[0]["lockstep"]
        np.testing.assert_allclose(got["losses"][i], jl, **LOSS_TOL,
                                   err_msg=f"losses at step {i}")
        for a, b in zip(got["topk"][i], jk):
            np.testing.assert_array_equal(a, b, err_msg=f"top-k, step {i}")
    _assert_ranks_equal(res, "lockstep")
    _assert_trees_close(_head(res[0]["lockstep"]["msd"]),
                        jax_lockstep["head"], PARAM_TOL, "head params")
    _assert_trees_close(_stats(res[0]["lockstep"]["backbone"]),
                        jax_lockstep["stats"], STATS_TOL, "BN statistics")


def test_dp_world_evaluate_matches_jax(jax_lockstep, world):
    """Each rank scores the gathered rows of the whole split."""
    _, res = world
    j1, j5, jlosses, _ = jax_lockstep["eval"]
    for r in res:
        ev = r["eval"]
        assert ev["n"] == sum(n for n, _ in EVAL)
        assert ev["top1"] == j1.get_average_results_both()
        assert ev["top5"] == j5.get_average_results_both()
        for k in jlosses:
            np.testing.assert_allclose(ev["losses"][k], jlosses[k],
                                       **LOSS_TOL)


@pytest.mark.parametrize("key,kw,plan", [
    ("dropout", {"dropout_rate": 0.5}, STEPS[:2]),
    ("lockstep", {}, STEPS)])
def test_dp_world_equals_one_process(world, key, kw, plan):
    """A world equals one process at the global batch, dropout too."""
    d, res = world
    one = _one_process(d, **kw)
    want = steps(one, plan)
    np.testing.assert_allclose(res[0][key]["losses"], want["losses"],
                               **LOSS_TOL)
    msd = one.model_state_dict()["model_state_dict"]
    for k, v in res[0][key]["msd"].items():
        np.testing.assert_allclose(v.numpy(), msd[k].numpy(), **PARAM_TOL,
                                   err_msg=k)
    _assert_ranks_equal(res, key)


def test_dp_grad_accum_equals_one_process(world):
    d, res = world
    one = _one_process(d, grad_accum=2)
    loader = ListLoader(batch(one.encoder, B, 40 + i) for i in range(4))
    _, _, mean = one.train_epoch(loader, 0)
    for r in res:
        assert r["accum"]["opt_steps"] == one.opt_steps == 2
        np.testing.assert_allclose(r["accum"]["mean"], mean, **LOSS_TOL)
    msd = one.model_state_dict()["model_state_dict"]
    for k, v in res[0]["accum"]["msd"].items():
        np.testing.assert_allclose(v.numpy(), msd[k].numpy(), **PARAM_TOL,
                                   err_msg=k)


def test_global_bn_backward_equals_one_process(world):
    """``train_backbone``: each rank's all-reduced gradients are the
    global batch's, the BN scales and shifts and every conv included."""
    d, res = world
    one = _one_process(d, train_backbone=True)
    args, _ = one._upload(batch(one.encoder, B, 70))
    one.accum_step(*args, first=True)
    want = {n: p.grad for n, p in list(one.backbone.named_parameters())
            + list(one.head.named_parameters())}
    for r in res:
        got = r["ft_grads"]
        assert set(got) == set(want)
        for n, g in want.items():
            np.testing.assert_allclose(got[n].numpy(), g.numpy(),
                                       **GRAD_TOL, err_msg=n)


def test_preemption_on_one_rank_stops_both_at_one_boundary(world):
    _, res = world
    r0, r1 = res[0]["preempt"], res[1]["preempt"]
    assert r0["raised"] and r1["raised"]
    assert r0["batch"] == r1["batch"] == 2
    assert r0["steps"] == r1["steps"] == 2
    assert r0["saved"] is True and r0["mids"] == 1
    assert r1["saved"] is False and r1["mids"] == 0


def test_fit_writes_on_rank_zero_only(world):
    d, _ = world
    folder = os.path.join(d, "fit")
    names = set(os.listdir(folder))
    assert "sr" in names
    assert not [n for n in names if n.endswith(".tmp")]
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [0]
    ck = torch.load(os.path.join(folder, "sr"), weights_only=True)
    assert ck["epoch"] == 1 and len(ck["avg_scores"]) == 1


def test_spmd_twin_matches_jax_shardmap_step(weights, world):
    """Per-rank BN statistics, the running ones averaged; dropout 0."""
    _, res = world
    jtr = jax_trainer_from(weights, jax_mesh(num_devices=2))
    step = make_shardmap_train_step(jtr)
    enc = JaxEncoder.synthetic_full(0)
    hp, opt, stats = jtr.head_params, jtr.opt_state, jtr.backbone_stats
    for i, (n, seed) in enumerate(STEPS[:2]):
        arrays, valid, _ = jtr._pad_batch(batch(enc, n, seed))
        hp, opt, stats, losses, _ = step(
            hp, opt, jtr.backbone_params, stats,
            jax.random.fold_in(jtr._dropout_base, i), arrays["images"],
            arrays["flip"], arrays["verbs"], arrays["labels"], valid)
        np.testing.assert_allclose(res[0]["spmd"]["losses"][i],
                                   [float(x) for x in losses], **LOSS_TOL,
                                   err_msg=f"losses at step {i}")
    _assert_ranks_equal(res, "spmd")
    _assert_trees_close(_head(res[0]["spmd"]["msd"]),
                        jax.tree.map(np.asarray, hp), PARAM_TOL,
                        "head params")
    _assert_trees_close(_stats(res[0]["spmd"]["backbone"]),
                        jax.tree.map(np.asarray, stats), STATS_TOL,
                        "BN statistics")
