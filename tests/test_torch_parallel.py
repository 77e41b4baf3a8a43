"""The port's multi-device pieces that need no world of several
processes, on the CPU:

* ``parallel/mesh.py``: a rank's coordinates against JAX's
  ``make_mesh(num_devices=4, model=2)`` device array, the refusals
  (overcommit, divisibility, a model group across nodes) and
  ``head_param_sharding`` against JAX's, leaf for leaf;
* ``init_distributed``'s arguments;
* ``ImsituLoader(shard=...)``: every rank's blocks bit-equal to the JAX
  loader's sharded blocks and, put together, to the port's unsharded
  batches wrapped as the trainer wraps them (the last, partial batch
  included); the shard validation; a trainer's row block of a whole
  global batch and its check of a loader's shard;
* ``load_inference(devices=["cpu", "cpu"])`` equal to one device, on the
  rebuilt model and on a portable program (batch 5 through a baked batch
  of 2: chunks on both devices);
* the CLI's ``--distributed`` usage errors: JAX's, line for line;
* in a gloo world of this one process: the global-statistics BatchNorm
  against its ``native_batch_norm`` path, forward and backward (f32,
  1e-5), and a trainer on its mesh, collectives and all, against the
  trainer without one (dropout 0.5; the lockstep bounds of
  ``tests/test_torch_train.py``).
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from situation_recognition_tpu import cli as jax_cli
from situation_recognition_tpu.data import dataset as jds
from situation_recognition_tpu.data.encoder import ImsituEncoder as JaxEnc
from situation_recognition_tpu.parallel.mesh import (
    head_param_sharding as jax_sharding, make_mesh as jax_mesh)
from situation_recognition_tpu_torch import cli
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.data import dataset as tds
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.parallel import (
    head_param_sharding, init_distributed, make_mesh)
from situation_recognition_tpu_torch.parallel.mesh import (
    Mesh, check_model_groups)
from situation_recognition_tpu_torch.serving import (
    SituationModel, export_inference, load_inference)
from situation_recognition_tpu_torch.train import Trainer, TrainerConfig
from tests.test_torch_train import LOSS_TOL, PARAM_TOL
from tests.torch_dist_worker import COMMON, batch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_make_mesh_of_one_process():
    mesh = make_mesh()
    assert (mesh.world, mesh.model, mesh.rank) == (1, 1, 0)
    assert mesh.data_group is None and mesh.model_group is None
    assert mesh.rows(8) == slice(0, 8)


def test_make_mesh_rejects_overcommit():
    with pytest.raises(ValueError, match="visible"):
        make_mesh(world=4096)
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(model=2)


def test_a_model_group_across_nodes_is_refused():
    check_model_groups(["a", "a", "b", "b"], 2)
    with pytest.raises(ValueError, match="span nodes"):
        check_model_groups(["a", "a", "b", "b"], 4)
    with pytest.raises(ValueError, match="span nodes"):
        check_model_groups(["a", "b", "a", "b"], 2)


def test_mesh_coordinates_match_jax():
    devices = jax_mesh(num_devices=4, model=2).devices
    for rank in range(4):
        mesh = Mesh(world=4, model=2, rank=rank)
        (d, m), = np.argwhere(np.vectorize(lambda x: x.id)(devices) == rank)
        assert (mesh.data_index, mesh.model_index) == (d, m)
        assert mesh.shape == {"data": 2, "model": 2}
        assert mesh.rows(8) == slice(4 * d, 4 * d + 4)
        assert mesh.cols(64) == slice(32 * m, 32 * m + 32)


def test_a_model_axis_that_does_not_divide_hidden_is_refused():
    """JAX's ``device_put`` of a ``P('model', None)`` kernel refuses a
    contraction dim that the model axis does not divide; so do the mesh's
    column blocks and a trainer on a model axis of 3 at hidden 64 (which
    would leave one input column out of both classifiers)."""
    with pytest.raises(ValueError, match="divisible by 3, but it is equal "
                                         "to 64"):
        Mesh(world=3, model=3, rank=0).cols(64)
    with pytest.raises(ValueError, match="divisible by 3, but it is equal "
                                         "to 64"):
        Trainer(ImsituEncoder.synthetic_full(0),
                TrainerConfig(**{**COMMON, "model_axis": 3}), device="cpu",
                mesh=Mesh(world=3, model=3, rank=0))
    assert Mesh(world=3, model=3, rank=2).cols(66) == slice(44, 66)


def test_head_param_sharding_matches_jax():
    """The same leaves split, on the contraction dim: JAX's P('model',
    None) of an (in, out) kernel is the port's (None, 'model') of torch's
    (out, in) weight."""
    trainer = Trainer(ImsituEncoder.synthetic_full(0),
                      TrainerConfig(**COMMON), device="cpu")
    state = trainer.head.state_dict()
    # each tensor tagged with its index, to find it in the JAX tree
    tagged = {k: torch.full(v.shape, float(i)) for i, (k, v)
              in enumerate(state.items())}
    tree = convert.head_params_to_jax(tagged)
    names = list(state)
    port = head_param_sharding(make_mesh(), state)
    jax_specs = jax_sharding(jax_mesh(num_devices=4, model=2), tree)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    specs = dict(jax.tree_util.tree_leaves_with_path(
        jax_specs, is_leaf=lambda x: hasattr(x, "spec")))
    assert len(leaves) == len(names)
    for path, leaf in leaves:
        name = names[int(np.asarray(leaf).flat[0])]
        want = tuple(specs[path].spec)
        assert tuple(reversed(port[name])) == want, name
    assert sorted(n for n, s in port.items() if s) == [
        "nouns_classifier.1.weight", "verb_classifier.1.weight"]


def test_init_distributed_arguments(monkeypatch):
    with pytest.raises(ValueError, match="together"):
        init_distributed("127.0.0.1:1", None, 0, device="cpu")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        init_distributed(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed("127.0.0.1:1", 1, 0)


# ---------------------------------------------------------------- loader


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    with open(os.path.join(_REPO, "imSitu", "overfitting.json")) as f:
        ann = json.load(f)
    d = tmp_path_factory.mktemp("shard_imgs")
    rng = np.random.default_rng(7)
    for name in ann:
        arr = rng.integers(0, 255, (256, 300, 3), dtype=np.uint8)
        Image.fromarray(arr).save(str(d / name), quality=95)
    return ann, str(d)


@pytest.mark.parametrize("train", [True, False])
def test_sharded_blocks_equal_jax_and_the_wrapped_batches(images, train):
    ann, img_dir = images
    big = 4              # 5 examples: one full batch, one partial of 1
    common = dict(batch_size=big, shuffle=train, seed=3, num_workers=2,
                  decoder="python")
    tds_ = tds.ImsituDataset(img_dir, ann, ImsituEncoder(ann, verbose=False),
                             train=train)
    jds_ = jds.ImsituDataset(img_dir, ann, JaxEnc(ann, verbose=False),
                             train=train)
    for epoch in (0, 1):
        full = tds.ImsituLoader(tds_, **common)
        full.set_epoch(epoch)
        full = list(full)
        blocks = []
        for rank in (0, 1):
            ours = tds.ImsituLoader(tds_, **common, shard=(rank, 2))
            ref = jds.ImsituLoader(jds_, **common, shard=(rank, 2))
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            a, b = list(ours), list(ref)
            assert len(a) == len(b) == len(full) == 2
            for x, y in zip(a, b):
                assert x["global_n"] == y["global_n"]
                assert x["shard"] == y["shard"] == (rank, 2)
                for k in ("images", "flip", "verbs", "labels",
                          "verbs_global", "labels_global"):
                    assert x[k].dtype == y[k].dtype, k
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            blocks.append(a)
        for g, s0, s1 in zip(full, *blocks):
            n = len(g["verbs"])
            assert s0["global_n"] == n
            idx = np.arange(big) % n
            for k in ("images", "flip", "verbs", "labels"):
                np.testing.assert_array_equal(
                    np.concatenate([s0[k], s1[k]]), np.asarray(g[k])[idx])
            np.testing.assert_array_equal(s1["labels_global"],
                                          np.asarray(g["labels"])[idx])


def test_shard_validation(images):
    ann, img_dir = images
    ds = tds.ImsituDataset(img_dir, ann, ImsituEncoder(ann, verbose=False),
                           train=False)
    with pytest.raises(ValueError, match="divisible"):
        tds.ImsituLoader(ds, batch_size=5, shuffle=False, shard=(0, 2))
    with pytest.raises(ValueError, match="rank"):
        tds.ImsituLoader(ds, batch_size=4, shuffle=False, shard=(2, 2))
    ds.enable_window_cache()
    with pytest.raises(ValueError, match="window cache"):
        list(tds.ImsituLoader(ds, batch_size=4, shuffle=False,
                              shard=(0, 2)))


def test_trainer_takes_its_rows_and_checks_the_shard():
    """Rank 1 of a data axis of 2 (no collective without a process
    group): a whole global batch, wrapped, cut to rows 4..8; a loader's
    block of another rank refused."""
    enc = ImsituEncoder.synthetic_full(0)
    mesh = Mesh(world=2, model=1, rank=1)
    tr = Trainer(enc, TrainerConfig(**COMMON), device="cpu", mesh=mesh)
    assert tr.head.dropout_rows == (4, 8)
    b = batch(enc, 5, 0)
    arrays, valid, n = tr._pad_batch(b)
    assert n == 5
    np.testing.assert_array_equal(valid, [1, 0, 0, 0])
    np.testing.assert_array_equal(arrays["verbs"],
                                  b["verbs"][np.arange(4, 8) % 5])
    block = {k: v[:4] for k, v in b.items()}
    with pytest.raises(ValueError, match="does not match"):
        tr._pad_batch({**block, "shard": (0, 2), "global_n": 8})
    arrays, valid, n = tr._pad_batch({**block, "shard": (1, 2),
                                      "global_n": 5})
    np.testing.assert_array_equal(valid, [1, 0, 0, 0])
    with pytest.raises(ValueError, match="divisible"):
        Trainer(enc, TrainerConfig(**{**COMMON, "batch_size": 5}),
                device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="model_axis"):
        Trainer(enc, TrainerConfig(**{**COMMON, "model_axis": 2}),
                device="cpu")


# --------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    enc = ImsituEncoder.synthetic_full(0)
    model = SituationModel(enc, backbone="mini", hidden=64)
    g = torch.Generator().manual_seed(0)
    model.backbone.reset_parameters(g)
    model.head.reset_parameters(g)
    path = str(tmp_path_factory.mktemp("multi") / "mini")
    export_inference(model.eval(), path, batch_size=2)
    return path


@pytest.mark.parametrize("rebuild", [True, False],
                         ids=["rebuilt", "program"])
def test_load_inference_on_two_devices_equals_one(artifact, rebuild):
    one = load_inference(artifact, device="cpu", rebuild=rebuild)
    two = load_inference(artifact, devices=["cpu", "cpu"], rebuild=rebuild)
    assert len(two.loaded) == 2 and two.batch_size == 2
    assert two.loaded[0] is not two.loaded[1]
    images = np.random.default_rng(1).integers(0, 256, (5, 256, 256, 3),
                                               dtype=np.uint8)
    for a, b in zip(two(images), one(images)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    verbs = np.arange(5) * 7
    torch.testing.assert_close(two.gt(images, verbs), one.gt(images, verbs),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="non-empty"):
        load_inference(artifact, devices=[])


# ------------------------------------------------------------------ CLI


def _stderr_of(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as info:
        main(argv)
    assert info.value.code == 2
    return err.getvalue().strip().splitlines()[-1]


@pytest.mark.parametrize("flags", [
    ["--distributed", "--test_img", "x.jpg"],
    ["--distributed", "--subset", "2"],
    ["--distributed", "--cache_device"],
], ids=["test_img", "subset", "cache_device"])
def test_distributed_usage_errors_are_jax_s(flags):
    argv = ["--platform", "cpu", *flags]
    want = _stderr_of(jax_cli.main, argv)
    assert _stderr_of(cli.main, argv) == want


# ------------------------------------------------- a gloo world of one


@pytest.fixture
def world_of_one():
    """A gloo world of this one process (``init_distributed``)."""
    from situation_recognition_tpu_torch.parallel import destroy
    from tests.torch_dist_worker import free_port

    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        yield torch.distributed.group.WORLD
    finally:
        destroy()


def test_global_batch_norm_in_a_world_of_one_matches_native(world_of_one):
    """The global-statistics BN (the f32 view's moments, one all-reduce,
    ``F.batch_norm`` with them; its backward's all-reduced sums) against
    the layer's ``native_batch_norm`` path: output, running statistics,
    and the gradients of x, the scale and the shift (f32, 1e-5)."""
    from situation_recognition_tpu_torch.models.resnet import BatchNorm
    from situation_recognition_tpu_torch.parallel import distributed

    g = torch.Generator().manual_seed(5)
    x0 = torch.randn(6, 8, 5, 5, generator=g) * 1.5 + 0.3
    dy = torch.randn(x0.shape, generator=g)
    out = {}
    for name, group in (("global", world_of_one), ("native", None)):
        bn = BatchNorm(8, eps=1e-5).train()
        bn.weight.data = torch.linspace(0.5, 1.5, 8)
        bn.bias.data = torch.linspace(-0.2, 0.2, 8)
        bn.stats_group = group
        x = x0.clone().requires_grad_(True)
        before = distributed.COUNTS["bn"]
        bn(x).backward(dy)
        out[name] = (bn(x0).detach(), bn.running_mean.clone(),
                     bn.running_var.clone(), x.grad, bn.weight.grad,
                     bn.bias.grad)
        # forward, backward, and the forward above: one all-reduce each
        assert distributed.COUNTS["bn"] - before == (3 if group else 0)
    for a, b in zip(out["global"], out["native"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_a_world_of_one_trains_as_one_process(world_of_one):
    """The trainer on a mesh of a world of one issues its collectives
    (BN, denominators, losses, top-k, one gradient all-reduce a step) and
    trains as the trainer without a mesh: 2 steps, dropout 0.5."""
    from situation_recognition_tpu_torch.parallel import distributed
    from tests.torch_dist_worker import STEPS, steps

    enc = ImsituEncoder.synthetic_full(0)
    kw = {**COMMON, "dropout_rate": 0.5}
    one = Trainer(enc, TrainerConfig(**kw), device="cpu")
    state = (one.backbone.state_dict(), one.head.state_dict())
    world = Trainer(enc, TrainerConfig(**kw), device="cpu",
                    backbone_state=state[0], head_state=state[1],
                    mesh=make_mesh())
    distributed.COUNTS.clear()
    got = steps(world, STEPS[:2])
    counts = dict(distributed.COUNTS)
    want = steps(one, STEPS[:2])
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d)
               for m in world.backbone.modules())
    assert counts == {"bn": 2 * n_bn, "den": 2, "loss": 2, "fetch": 2,
                      "grad": 2}
    # the same f32 math in another order: tests/test_torch_train.py's
    # lockstep bounds (Adamax's step is the sign of a gradient near 0)
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
    for a, b in zip(got["topk"], want["topk"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for (n, p), q in zip(world.head.named_parameters(),
                         one.head.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   **PARAM_TOL, err_msg=n)
