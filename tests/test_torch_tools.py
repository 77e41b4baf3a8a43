"""The port's tools (``situation_recognition_tpu_torch/tools/``) on the
CPU: ``profile_step`` builds its table from a CPU ``torch.profiler`` run
and names the hand kernels by their CUDA kernel names; ``perf_guard``,
``bench_vit_block``, ``bench_input`` and ``bench_e2e`` run end to end at
tiny sizes (checks of the tools, not measurements); ``pack_dataset``
writes the JAX tool's store byte for byte; a JAX msgpack checkpoint →
``convert_torch`` → ``.pth`` resumes the port equal to
``convert.export_reference_checkpoint``, and ``export_torch`` writes it
back to msgpack that the JAX package reads."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_intra_op_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_profile_step_table_from_a_cpu_run(tmp_path, monkeypatch, capsys):
    from situation_recognition_tpu_torch.tools import profile_step

    monkeypatch.setenv("BENCH_BATCH", "2")
    monkeypatch.setenv("BENCH_IMAGE_SIZE", "32")
    out = profile_step.main(["--device", "cpu", "--steps", "2", "--top", "5",
                             "--json", str(tmp_path / "p.json"),
                             "--keep-trace", str(tmp_path / "trace")])
    printed = capsys.readouterr().out
    assert "by category:" in printed and "host operators" in printed
    assert out["rows"] and out["idle_share"] is None
    assert abs(sum(r["pct"] for r in out["rows"]) - 100.0) < 1e-6
    assert {"convolution", "gemm"} <= set(out["categories"])
    assert out["rows"][0]["ms_per_step"] >= out["rows"][-1]["ms_per_step"]
    with open(tmp_path / "p.json") as f:
        assert json.load(f)["mode"] == "train"
    assert os.listdir(tmp_path / "trace") == ["profile_step_train.json"]


@pytest.mark.parametrize("name,want", [
    ("void ggnn_gemm_kernel<0, 128, 256, StepArgs>(CUtensorMap)",
     "K1/K2 ggnn_folded"),
    ("ggnn_agg_kernel(bf16 const*)", "K1/K2 ggnn_folded"),
    ("void ggnn_gemm_kernel<3, 128, 128, BwdArgs>(CUtensorMap)",
     "K3 ggnn_folded_bwd"),
    ("ggnn_bwd_prep_kernel(bf16 const*)", "K3 ggnn_folded_bwd"),
    ("void attn_kernel<true, false>(bf16 const*)", "K5/K7 vit_attention"),
    ("void dkv_kernel<true>(bf16 const*)", "K8 vit_attention_bwd"),
    ("void gemm_kernel<0, 256>(CUtensorMap)", "K4/K6 vit_block"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc",
     "convolution"),
    ("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NTN", "gemm"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise")])
def test_profile_step_categories(name, want):
    from situation_recognition_tpu_torch.tools.profile_step import category

    assert category(name) == want


def test_perf_guard_and_bench_vit_block_run(capsys):
    from situation_recognition_tpu_torch.tools import (
        bench_vit_block, perf_guard)

    os.environ["PERF_GUARD_ITERS"] = "1"
    try:
        out = perf_guard.main(["--device", "cpu", "--batch", "2",
                               "--hidden", "64", "--vit-batch", "1",
                               "--vit-tokens", "9", "--vit-width", "64",
                               "--vit-blocks", "1"])
    finally:
        del os.environ["PERF_GUARD_ITERS"]
    for k in ("ggnn_kernel_ms", "ggnn_masked_ms", "ggnn_ratio",
              "vit_stream_ms", "vit_block_ms", "vit_ratio"):
        assert out[k] > 0, k
    assert json.loads(capsys.readouterr().out.strip()) == out
    rows = bench_vit_block.main(["--device", "cpu", "--batch", "1",
                                 "--blocks", "1", "--tokens", "9", "--dim",
                                 "64", "--iters", "1"])
    assert [r["variant"] for r in rows] == [
        "plain", "block:softmax", "block:exp2", "stream:exp2"]
    assert rows[0]["max_abs_diff_vs_plain"] == 0.0
    # the kernels' twins in bf16 against the plain block
    assert all(r["max_abs_diff_vs_plain"] < 0.05 for r in rows)


def test_bench_input_and_bench_e2e_run(monkeypatch, capsys):
    from situation_recognition_tpu_torch.tools import bench_e2e, bench_input

    rows = bench_input.main(["--n", "8", "--batch", "4", "--workers", "1",
                             "--epochs", "1"])
    assert [r["decoder"] for r in rows] == ["native", "python",
                                            "python cached"]
    assert rows[1]["img_s"][0] > 0 and rows[2]["img_s"][0] > 0
    assert "img_s" in rows[0] or "unavailable" in rows[0]
    monkeypatch.setenv("BENCH_BATCH", "4")
    monkeypatch.setenv("BENCH_WORKERS", "1")
    out = bench_e2e.main(["8", "--device", "cpu", "--steps", "1"])
    for k in ("input_cold", "input_cache_fill", "input_warm", "step", "e2e",
              "e2e_devcache"):
        assert out[k] > 0, k
    assert "h2d" not in out and out["bottleneck"] in ("input_warm", "step")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out


def test_pack_dataset_writes_the_jax_tools_store(tmp_path):
    from PIL import Image

    from situation_recognition_tpu_torch.tools import pack_dataset

    rng = np.random.default_rng(0)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, (w, h) in enumerate(((300, 256), (256, 400), (512, 384),
                                (200, 180))):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / f"im{i}.jpg", quality=90)
    ann = tmp_path / "a.json"
    with open(ann, "w") as f:
        json.dump({"im2.jpg": {}, "im0.jpg": {}}, f)
    for extra in ([], ["--annotations", str(ann)]):
        jax_out, port_out = tmp_path / "jax", tmp_path / "port"
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
        proc = subprocess.run(
            [sys.executable, os.path.join(_REPO, "tools", "pack_dataset.py"),
             str(img_dir), str(jax_out), *extra], env=env, cwd=_REPO,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        pack_dataset.main([str(img_dir), str(port_out), *extra])
        for f in ("images.bin", "index.json"):
            with open(jax_out / f, "rb") as a, open(port_out / f, "rb") as b:
                assert a.read() == b.read(), (f, extra)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A mini JAX trainer's checkpoint and backbone as the JAX package
    writes them (msgpack)."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from situation_recognition_tpu.data.encoder import (
        ImsituEncoder as JaxEnc)
    from situation_recognition_tpu.train import Trainer, TrainerConfig
    from situation_recognition_tpu.utils.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("jax_ckpt")
    jtr = Trainer(JaxEnc.synthetic_full(0), TrainerConfig(
        hidden=64, batch_size=8, backbone="mini", compute_dtype=jnp.float32,
        ggnn_impl="masked"))
    ckpt = str(root / "model")
    save_checkpoint(ckpt, {"epoch": 3, "avg_scores": [1.0, 2.5],
                           **jax.device_get(jtr.model_state_dict())})
    backbone = str(root / "backbone.msgpack")
    with open(backbone, "wb") as f:
        f.write(serialization.msgpack_serialize(jax.tree.map(
            np.asarray, {"params": jtr.backbone_params,
                         "batch_stats": jtr.backbone_stats})))
    return ckpt, backbone


def test_convert_torch_checkpoint_resumes_the_port(jax_checkpoint, tmp_path):
    from situation_recognition_tpu_torch import convert
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.tools import convert_torch
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig
    from situation_recognition_tpu_torch.utils import msgpack
    from situation_recognition_tpu_torch.utils.checkpoint import (
        load_checkpoint)

    ckpt, backbone = jax_checkpoint
    dst = str(tmp_path / "model.pth")
    convert_torch.main(["checkpoint", ckpt, dst])
    got = load_checkpoint(dst)
    want = convert.export_reference_checkpoint(msgpack.read(ckpt))
    assert got["epoch"] == 3 and got["avg_scores"] == [1.0, 2.5]
    assert list(got["model_state_dict"]) == list(want["model_state_dict"])
    for k, v in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k
    trainers = []
    for state in (got, want):
        tr = Trainer(ImsituEncoder.synthetic_full(0), TrainerConfig(
            hidden=64, batch_size=2, backbone="mini",
            compute_dtype=torch.float32), device="cpu")
        tr.load_model_state(state)
        trainers.append(tr)
    for (k, a), b in zip(trainers[0].head.state_dict().items(),
                         trainers[1].head.state_dict().values()):
        assert torch.equal(a, b), k
    assert trainers[0].opt_steps == trainers[1].opt_steps

    bb = str(tmp_path / "backbone.pth")
    convert_torch.main(["backbone", backbone, bb])
    tree = msgpack.read(backbone)
    want_bb = convert.resnet_state_from_jax(tree["params"],
                                            tree["batch_stats"])
    got_bb = torch.load(bb, weights_only=True)
    assert list(got_bb) == list(want_bb)
    for k, v in want_bb.items():
        assert torch.equal(got_bb[k], v), k


def test_export_torch_writes_msgpack_the_jax_package_reads(jax_checkpoint,
                                                           tmp_path):
    from flax import serialization

    from situation_recognition_tpu_torch.tools import (
        convert_torch, export_torch)
    from situation_recognition_tpu_torch.utils.checkpoint import (
        load_checkpoint)

    ckpt, backbone = jax_checkpoint
    pth = str(tmp_path / "model.pth")
    convert_torch.main(["checkpoint", ckpt, pth])
    back = str(tmp_path / "model.msgpack")
    export_torch.main(["checkpoint", pth, back])
    with open(back, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    with open(ckpt, "rb") as f:
        orig = serialization.msgpack_restore(f.read())
    assert int(tree["epoch"]) == 3
    for part in ("head_params", "backbone_params", "backbone_stats"):
        flat_a = serialization.to_state_dict(tree[part])
        flat_b = serialization.to_state_dict(orig[part])

        def leaves(t, pre=""):
            for k, v in t.items():
                if isinstance(v, dict):
                    yield from leaves(v, pre + k + "/")
                else:
                    yield pre + k, np.asarray(v)

        a, b = dict(leaves(flat_a)), dict(leaves(flat_b))
        assert set(a) == set(b), part
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # and back again: the same reference checkpoint's weights
    again = str(tmp_path / "again.pth")
    convert_torch.main(["checkpoint", back, again])
    one, two = load_checkpoint(pth), load_checkpoint(again)
    for k, v in one["model_state_dict"].items():
        assert torch.equal(two["model_state_dict"][k], v), k
    bb = str(tmp_path / "bb.pth")
    convert_torch.main(["backbone", backbone, bb])
    export_torch.main(["backbone", bb, str(tmp_path / "bb.msgpack")])
    with open(tmp_path / "bb.msgpack", "rb") as f:
        assert set(serialization.msgpack_restore(f.read())) == {
            "params", "batch_stats"}
