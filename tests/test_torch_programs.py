"""The serving artifact's exported programs on the CPU: ``torch.export``
programs of both entries that take the weights as their argument, loaded
with no model code rebuilt.  The portable programs match the eager model
rebuilt from the same artifact within 1e-6 for both entries and for batch
sizes other than the baked one; a ``cuda`` artifact refuses the CPU with
the JAX loader's message; the programs hold no weights; an artifact
without programs still loads by rebuilding, and the loader's default
rebuilds where the card would run kernels that the programs leave out;
the kernels' custom ops pass
``opcheck`` on CPU tensors, and a program traced through K1 takes the
folded operands as its arguments; ``export_serving`` runs end to end
(from a JAX msgpack checkpoint too); and ``server.py`` serves an int8
program artifact and hot-reloads either kind."""

import io
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.ops import ggnn_kernel as tk
from situation_recognition_tpu_torch.serving import (
    SituationModel, export_inference, load_inference)

HIDDEN = 64
# the program against the eager model on the same weights: the same
# operations, traced
PROGRAM_TOL = 1e-6
BACKBONES = ("mini", "vit_tiny")


@pytest.fixture(scope="module", autouse=True)
def _two_intra_op_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(backbone, seed=0, dtype=torch.float32):
    enc = ImsituEncoder.synthetic_full(0)
    model = SituationModel(enc, backbone=backbone, hidden=HIDDEN,
                           dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    model.backbone.reset_parameters(g)
    model.head.reset_parameters(g)
    return model.eval()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    out = {}
    for backbone in BACKBONES:
        path = str(tmp_path_factory.mktemp("prog") / backbone)
        export_inference(_model(backbone), path, batch_size=2)
        out[backbone] = path
    return out


@pytest.fixture(scope="module")
def loaded(artifacts):
    """Each artifact loaded twice: its programs, and the eager model
    rebuilt from the same weights."""
    return {b: (load_inference(p, device="cpu"),
                load_inference(p, device="cpu", rebuild=True))
            for b, p in artifacts.items()}


def _strip_programs(path):
    """An artifact → this package's format before programs: the weights
    and the meta alone, without the programs' keys."""
    for f in ("model.pt2", "model_gt.pt2"):
        os.remove(os.path.join(path, f))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    for e in meta["entries"].values():
        del e["file"]
    for k in ("platforms", "bake_weights", "program_weights", "impls",
              "traced_on"):
        del meta[k]
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def _images(b, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, 256, 256, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("b", [2, 3, 1])
@pytest.mark.parametrize("backbone", BACKBONES)
def test_portable_program_matches_the_eager_model(loaded, backbone, b):
    fn, eager = loaded[backbone]
    assert not hasattr(fn, "model") and hasattr(eager, "model")
    images = _images(b, b)
    got, want = fn(images), eager(images)
    assert got[0].shape == (b, 504) and got[2].shape == (b, 6, 2001)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    for i in (0, 2):
        torch.testing.assert_close(got[i], want[i], rtol=0,
                                   atol=PROGRAM_TOL)
    verbs = np.arange(b) * 97 % 504
    torch.testing.assert_close(fn.gt(images, verbs),
                               eager.gt(images, verbs), rtol=0,
                               atol=PROGRAM_TOL)


def test_meta_and_files_of_a_program_artifact(artifacts):
    path = artifacts["mini"]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["weights"] == "f32" and meta["bake_weights"] is False
    assert meta["platforms"] == ["cpu", "cuda"]
    assert meta["weights_file"] == "weights.pt"
    assert {e: v["file"] for e, v in meta["entries"].items()} == {
        "argmax": "model.pt2", "gt": "model_gt.pt2"}
    assert meta["impls"] == {"ggnn": "masked", "vit_blocks": None}
    # the programs take the weights: they hold none of their own
    ep = torch.export.load(os.path.join(path, "model.pt2"))
    assert not ep.state_dict and ep.example_inputs is None
    weights = os.path.getsize(os.path.join(path, "weights.pt"))
    for f in ("model.pt2", "model_gt.pt2"):
        assert os.path.getsize(os.path.join(path, f)) < weights
    user = [s.arg.name for s in ep.graph_signature.input_specs
            if s.kind.name == "USER_INPUT"]
    assert len(user) == len(meta["program_weights"]) + 1


def test_cuda_artifact_refuses_the_cpu(artifacts, tmp_path):
    """The device check is the JAX loader's, on the meta's platforms."""
    import shutil

    path = str(tmp_path / "cuda_art")
    shutil.copytree(artifacts["mini"], path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    meta["platforms"] = ["cuda"]
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(RuntimeError,
                       match=r"exported for platforms \['cuda'\] but the "
                             r"device is 'cpu'; re-export with "
                             r"platform='portable'"):
        load_inference(path, device="cpu")
    # the same weights rebuild on the CPU when asked
    assert load_inference(path, device="cpu", rebuild=True).model


def test_refusals(tmp_path):
    model = _model("mini")
    path = str(tmp_path / "never")
    with pytest.raises(ValueError, match="move the model to the card"):
        export_inference(model, path, platform="cuda")
    with pytest.raises(ValueError, match="move the model to the card"):
        export_inference(model, path, platform="cuda", bake_weights=True)
    with pytest.raises(ValueError, match="platform"):
        export_inference(model, path, platform="tpu")
    assert not os.path.exists(path)
    with pytest.raises(ValueError, match="non-empty"):
        load_inference(path, device="cpu", devices=[])


def test_impl_overrides_serve_the_rebuilt_model(artifacts):
    kernel = load_inference(artifacts["mini"], device="cpu",
                            ggnn_impl="kernel")
    assert kernel.model.head.ggsnn.impl == "kernel"
    with pytest.raises(ValueError, match="rebuild=True"):
        load_inference(artifacts["mini"], device="cpu", ggnn_impl="kernel",
                       rebuild=False)


def test_artifact_without_programs_loads_by_rebuilding(loaded, tmp_path):
    model = _model("mini")
    path = str(tmp_path / "old")
    export_inference(model, path, batch_size=2)
    _strip_programs(path)
    assert sorted(os.listdir(path)) == ["meta.json", "weights.pt"]
    fn = load_inference(path, device="cpu")
    assert fn.model is not None and fn.meta["platforms"] == ["cpu", "cuda"]
    images = _images(3, 9)
    got, want = fn(images), loaded["mini"][0](images)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=PROGRAM_TOL)
    with pytest.raises(ValueError, match="holds no programs"):
        load_inference(path, device="cpu", rebuild=False)


@pytest.mark.parametrize("impls,dtype,device,rebuilt", [
    ({"ggnn": "masked"}, "bfloat16", "cuda", True),
    ({"ggnn": "masked"}, "float32", "cuda", False),
    ({"ggnn": "kernel"}, "bfloat16", "cuda", False),
    ({"ggnn": "masked"}, "bfloat16", "cpu", False),
    ({"ggnn": "kernel"}, "bfloat16", "cpu", False),
])
def test_the_default_serves_the_card_through_its_kernels(impls, dtype,
                                                         device, rebuilt):
    """``load_inference``'s default: a portable program of a bf16 model on
    the card is served by the rebuilt model (whose GGNN resolves to K1
    there); a ``cuda`` program, an f32 model and the CPU serve the
    programs (a ``cuda`` artifact on the CPU then meets the JAX loader's
    refusal)."""
    from situation_recognition_tpu_torch.serving import _serves_rebuilt

    meta = {"entries": {"argmax": {"file": "model.pt2"}},
            "compute_dtype": dtype, "impls": impls}
    assert _serves_rebuilt(meta, torch.device(device), "auto",
                           "auto") is rebuilt


# ------------------------------------------------------------ custom ops


def test_custom_ops_pass_opcheck_on_the_cpu():
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk
    from situation_recognition_tpu_torch.ops.ggnn import GGNNParams

    g = torch.Generator().manual_seed(0)
    d, r = 128, 3
    params = GGNNParams(*[torch.randn((d, d) if i % 2 == 0 else (d,),
                                      generator=g) * 0.05
                          for i in range(14)])
    weights = tk.fold_gate_weights(params, float(r))
    ops = tk.kernel_weights(weights)
    for got, want in zip(tk.unprepare(ops, weights[3]), weights):
        assert torch.equal(got, want)
    h = torch.randn(4 * r, d, generator=g).bfloat16()
    mask = (torch.rand(4 * r, generator=g) > 0.3).float()
    torch.testing.assert_close(
        tk.folded_rows_prepared(h, mask, ops, weights[3], r, 4),
        tk.folded_reference(h, mask, weights, r, 4), rtol=0, atol=0)
    torch.library.opcheck(torch.ops.srtorch.ggnn_folded,
                          (h, mask, *ops, weights[3], r, 4))
    shapes = [(d,), (d,), (3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,),
              (4 * d, d), (4 * d,), (d, 4 * d), (d,)]
    w = vk.kernel_weights(tv.BlockWeights(*[
        torch.randn(s, generator=g) * 0.05 for s in shapes]))
    x = torch.randn(2 * 5, d, generator=g).bfloat16()
    torch.library.opcheck(torch.ops.srtorch.vit_qkv, (x, *w[:4], 1e-6))
    q, k, v = torch.ops.srtorch.vit_qkv(x, *w[:4], 1e-6)
    torch.library.opcheck(torch.ops.srtorch.vit_attention,
                          (q, k, v, 2, True, 5, 5, True))
    ctx = torch.ops.srtorch.vit_attention(q, k, v, 2, True, 5, 5, False)
    torch.library.opcheck(torch.ops.srtorch.vit_out_mlp,
                          (x, ctx, *w[4:], 1e-6, False))


def test_k1_program_takes_the_folded_operands_as_arguments(monkeypatch):
    """A program traced through K1 (the kernel path resolved on the CPU,
    where the op runs the twin) calls the op on placeholders: the fold is
    made once outside the program, not in it, and the program equals the
    eager kernel path."""
    from situation_recognition_tpu_torch import serving

    model = _model("mini", dtype=torch.bfloat16)
    monkeypatch.setattr(serving, "resolve_ggnn_impl",
                        lambda impl, dtype, dev: "kernel")
    dev = torch.device("cpu")
    with serving._program_paths(model, "cuda", dev) as (ops, impls):
        assert impls["ggnn"] == "kernel" and len(ops) == 6
        backbone, head = serving._state_dicts(model)
        weights = dict(serving._serving_state(
            backbone, head, model.role_ids, model.role_mask, True,
            torch.bfloat16, dev), **ops)
        stub = torch.from_numpy(_images(2, 4))
        with torch.no_grad():
            ep = torch.export.export(serving._Program(model),
                                     (weights, stub), strict=False)
    k1 = [n for n in ep.graph.nodes
          if n.op == "call_function" and "ggnn_folded" in str(n.target)]
    assert len(k1) == 2
    for node in k1:
        operands = node.args[2:7]
        assert all(a.op == "placeholder" for a in operands), operands
    assert model.head.ggsnn.operands is None
    model.head.ggsnn.impl = "kernel"
    with torch.inference_mode():
        want = model.serve(stub)
        got = ep.module()(weights, stub)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------- export_serving and server


def _jax_msgpack_checkpoint(path):
    """A mini JAX trainer's checkpoint as the JAX package writes it →
    (the trainer, its encoder vocabulary's train.json folder)."""
    import jax
    import jax.numpy as jnp

    from situation_recognition_tpu.data.encoder import (
        ImsituEncoder as JaxEnc)
    from situation_recognition_tpu.train import Trainer, TrainerConfig
    from situation_recognition_tpu.utils.checkpoint import save_checkpoint

    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "imSitu", "overfitting.json")) as f:
        ann = json.load(f)
    jtr = Trainer(JaxEnc(ann, verbose=False), TrainerConfig(
        hidden=HIDDEN, batch_size=8, backbone="mini",
        compute_dtype=jnp.float32, ggnn_impl="masked"))
    save_checkpoint(path, {"epoch": 1,
                           **jax.device_get(jtr.model_state_dict())})
    return jtr, ann


def test_export_serving_from_a_jax_checkpoint(tmp_path, capsys):
    """``python -m situation_recognition_tpu_torch.export_serving`` of a
    JAX msgpack checkpoint: an int8 artifact whose decoded weights serve
    the JAX trainer's predictions within the int8 bound, and an f32 one
    within 1e-4 of them."""
    from situation_recognition_tpu_torch import export_serving

    jtr, ann = _jax_msgpack_checkpoint(str(tmp_path / "jax_ckpt"))
    ds = tmp_path / "imSitu"
    ds.mkdir()
    with open(ds / "train.json", "w") as f:
        json.dump(ann, f)
    images = _images(3, 5)
    live = np.asarray(jtr.infer_verb(images))
    for w, tol in (("f32", 1e-4), ("int8", 0.03 * np.abs(live).max())):
        out = str(tmp_path / f"art_{w}")
        export_serving.main([str(tmp_path / "jax_ckpt"), out,
                             "--backbone", "mini", "--weights", w,
                             "--batch_size", "2", "--platform", "cpu",
                             "--dataset_folder", str(ds)])
        assert f"exported {out}" in capsys.readouterr().out
        fn = load_inference(out, device="cpu")
        assert fn.meta["weights"] == w and fn.meta["bake_weights"] is True
        np.testing.assert_allclose(fn(images)[0].numpy(), live, rtol=0,
                                   atol=tol)
    for bad in (["--target", "cuda"],):
        with pytest.raises(SystemExit):
            export_serving.main([str(tmp_path / "jax_ckpt"),
                                 str(tmp_path / "x"), "--platform", "cpu",
                                 "--dataset_folder", str(ds), *bad])


def test_server_serves_an_int8_program_and_reloads(artifacts, tmp_path):
    from PIL import Image

    from situation_recognition_tpu_torch.server import serve_http

    path = str(tmp_path / "int8")
    export_inference(_model("mini", seed=5), path, batch_size=2,
                     weights="int8")
    httpd = serve_http(path, port=0, device="cpu", max_wait_ms=0,
                       allow_reload=True)
    host, port = httpd.server_address[:2]
    base = f"http://{host}:{port}"
    try:
        with urllib.request.urlopen(base + "/meta", timeout=60) as r:
            meta = json.load(r)
        assert meta["weights"] == "int8"
        assert meta["platforms"] == ["cpu", "cuda"]
        buf = io.BytesIO()
        Image.fromarray(_images(1, 6)[0]).save(buf, format="PNG")
        req = urllib.request.Request(base + "/predict", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.load(r)
        assert body["verb"] in json.load(open(os.path.join(
            path, "meta.json")))["verb_list"]
        old = str(tmp_path / "old")
        export_inference(_model("mini"), old, batch_size=2)
        _strip_programs(old)
        for target in (artifacts["mini"], old):
            req = urllib.request.Request(
                base + "/admin/reload",
                data=json.dumps({"artifact": target}).encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                assert json.load(r)["status"] == "reloaded"
            with urllib.request.urlopen(base + "/meta", timeout=60) as r:
                assert json.load(r)["weights"] == "f32"
    finally:
        httpd.shutdown()
        httpd.batcher.close()
