"""The port's classifier tensor parallelism in gloo worlds on the CPU
(``tests/torch_dist_worker.py``, scenario ``tp``): a world of 2 (model 2)
and of 4 (data 2 x model 2), mini backbone, f32, dropout 0, train-mode BN,
global batch 8, the port's seeded weights (in the JAX trainer too).

Against JAX's ``Trainer`` on ``make_mesh(num_devices=4, model=2)``: 3
train steps (the last on a wrapped batch of 5), with
``tests/test_torch_train.py``'s bounds (losses rtol 2e-4, the top-k equal,
the head gathered rtol 2e-3 / atol 2e-5, BN statistics 1e-5); then
``evaluate``, equal to the port's single process's.  The gathered
checkpoint equals the single process's within the same bounds, key for
key (names, shapes, Adamax state), and scattered into a fresh TP trainer
it continues as the trainer it came from.  The explicit twin refuses TP.
"""

import jax
import numpy as np
import pytest
import torch

from situation_recognition_tpu.data.encoder import (
    ImsituEncoder as JaxEncoder)
from situation_recognition_tpu.parallel.mesh import make_mesh as jax_mesh
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.train import Trainer, TrainerConfig
from tests.test_torch_dist import jax_trainer_from, port_weights
from tests.test_torch_train import (
    LOSS_TOL, PARAM_TOL, STATS_TOL, _assert_trees_close)
from tests.torch_dist_worker import (
    COMMON, STEPS, batch, evaluate, run_world, steps)


def _jax_step(jtr, batch):
    """One step of JAX's TP trainer on host arrays (its jit places them,
    as ``tests/test_sharding.py``'s TP step does)."""
    arrays, valid, n = jtr._pad_batch(batch)
    (jtr.head_params, jtr.opt_state, jtr.backbone_stats, losses,
     topk) = jtr._train_step(
        jtr.head_params, jtr.opt_state, jtr.backbone_params,
        jtr.backbone_stats, jax.random.fold_in(jtr._dropout_base,
                                               jtr.step_count),
        arrays["images"], arrays["flip"], arrays["verbs"], arrays["labels"],
        valid)
    # the next step's jit takes the statistics and the head as they were
    # placed at construction (XLA may hand a 64-channel BN leaf back split
    # over the model axis)
    jtr.backbone_stats = jax.device_put(jtr.backbone_stats, jtr._repl)
    jtr.head_params = jax.device_put(jtr.head_params, jtr._head_sh)
    jtr.opt_state = jtr._place_opt_state(jtr.opt_state)
    jtr.step_count += 1
    return np.array([float(x) for x in losses]), [
        np.asarray(x)[:n] for x in topk]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The weights, a JAX TP trainer holding them, and its 3 steps; the
    port's single process on them, its 3 steps and ``evaluate``."""
    state = port_weights()
    jtr = jax_trainer_from(state, jax_mesh(num_devices=4, model=2),
                           model_axis=2)
    spec = jtr.head_params["nouns_classifier"]["kernel"].sharding.spec
    assert "model" in str(spec)
    enc = JaxEncoder.synthetic_full(0)
    out = {"state": state,
           "steps": [_jax_step(jtr, batch(enc, n, s)) for n, s in STEPS]}
    out["head"] = jax.tree.map(np.asarray, jtr.head_params)
    out["stats"] = jax.tree.map(np.asarray, jtr.backbone_stats)
    one = Trainer(ImsituEncoder.synthetic_full(0), TrainerConfig(**COMMON),
                  device="cpu", backbone_state=state[0], head_state=state[1])
    steps(one)
    out["one"] = one.model_state_dict()
    out["one_eval"] = evaluate(one)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["model2", "data2xmodel2"])
def world(request, weights, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"tp{request.param}")
    torch.save(weights["state"], d / "weights.pt")
    return request.param, run_world("tp", request.param, str(d))


def test_tp_world_matches_the_jax_tp_trainer(weights, world):
    size, res = world
    for r in res:
        assert r["shape"] == {"data": size // 2, "model": 2}
        assert r["shard_shape"] == (ImsituEncoder.synthetic_full(0)
                                    .get_num_verbs(), COMMON["hidden"] // 2)
        got = r["lockstep"]
        for i, (jl, jk) in enumerate(weights["steps"]):
            np.testing.assert_allclose(got["losses"][i], jl, **LOSS_TOL,
                                       err_msg=f"losses at step {i}")
            for a, b in zip(got["topk"][i], jk):
                np.testing.assert_array_equal(a, b)
        head = convert.head_params_to_jax(
            convert.from_reference(got["msd"])[1])
        _assert_trees_close(head, weights["head"], PARAM_TOL, "head params")
        _assert_trees_close(convert.resnet_stats_to_jax(got["backbone"]),
                            weights["stats"], STATS_TOL, "BN statistics")


def test_tp_world_evaluate_matches_one_process(weights, world):
    """``evaluate`` after the 3 steps: the single process's scores and
    losses (which ``tests/test_torch_dist.py`` and
    ``tests/test_torch_train.py`` hold to JAX's)."""
    _, res = world
    want = weights["one_eval"]
    for r in res:
        assert r["eval"]["n"] == want["n"]
        assert r["eval"]["top1"] == want["top1"]
        assert r["eval"]["top5"] == want["top5"]
        for k in want["losses"]:
            np.testing.assert_allclose(r["eval"]["losses"][k],
                                       want["losses"][k], **LOSS_TOL)


def test_tp_checkpoint_equals_the_single_process_one(weights, world):
    _, res = world
    want = weights["one"]
    for r in res:
        msd, osd = r["lockstep"]["msd"], r["lockstep"]["osd"]
        assert list(msd) == list(want["model_state_dict"])
        for k, v in want["model_state_dict"].items():
            assert msd[k].shape == v.shape, k
            np.testing.assert_allclose(msd[k].numpy(), v.numpy(),
                                       **PARAM_TOL, err_msg=k)
        assert osd["param_groups"] == want["optimizer_state_dict"][
            "param_groups"]
        for i, s in want["optimizer_state_dict"]["state"].items():
            for k in ("exp_avg", "exp_inf"):
                assert osd["state"][i][k].shape == s[k].shape


def test_tp_checkpoint_resumes(world):
    _, res = world
    for r in res:
        np.testing.assert_allclose(r["resume"]["from"], r["resume"]["orig"],
                                   rtol=1e-6)
        for k, v in r["resume"]["orig_msd"].items():
            np.testing.assert_allclose(r["resume"]["msd"][k].numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_spmd_twin_refuses_tensor_parallelism(world):
    _, res = world
    for r in res:
        assert "data-parallel only" in r["spmd_refused"]
