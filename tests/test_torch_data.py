"""The port's imSitu loader against the JAX package's: the same annotation
file (``imSitu/overfitting.json``), the same synthetic JPEGs (made with
PIL as ``tests/test_data_pipeline.py`` makes them) and the same seeds give
bit-equal batches — names, images (or window-cache ``indices``), verbs,
labels and flips — over two epochs, for train and eval splits, with 1 and
3 workers, on the PIL path, the packed store, the window cache and the
native decoder (port native against JAX native: its crops come from
another stream than the PIL path's)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from situation_recognition_tpu.data import dataset as jds
from situation_recognition_tpu.data.encoder import ImsituEncoder as JaxEnc
from situation_recognition_tpu_torch.data import dataset as tds
from situation_recognition_tpu_torch.data import native_decoder
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(340, 256), (256, 420), (256, 256), (512, 256), (300, 380)]


def _annotations():
    with open(os.path.join(_REPO, "imSitu", "overfitting.json")) as f:
        return json.load(f)


def _write_images(directory, names, sizes):
    rng = np.random.default_rng(0)
    for name, (h, w) in zip(names, sizes):
        low = rng.integers(0, 255, size=(8, 8, 3), dtype=np.uint8)
        arr = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR))
        Image.fromarray(arr).save(os.path.join(directory, name), quality=95)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Mixed-size JPEGs, square ones (a train window cache needs them),
    and the packed store of the mixed ones."""
    ann = _annotations()
    root = tmp_path_factory.mktemp("torch_data")
    mixed, square = root / "mixed", root / "square"
    mixed.mkdir()
    square.mkdir()
    _write_images(str(mixed), list(ann), SIZES)
    _write_images(str(square), list(ann), [(256, 256)] * len(ann))
    packed = str(root / "packed")
    assert tds.write_packed(packed, (
        (n, tds._decode_image(os.path.join(str(mixed), n)))
        for n in ann)) == len(ann)
    return {"ann": ann, "mixed": str(mixed), "square": str(square),
            "packed": packed}


def _pair(data, path, train, workers, decoder="python"):
    ann = data["ann"]
    img_dir = data["square"] if path == "window_cache" else data["mixed"]
    loaders = []
    for mod, enc in ((tds, ImsituEncoder(ann, verbose=False)),
                     (jds, JaxEnc(ann, verbose=False))):
        ds = mod.ImsituDataset(img_dir, ann, enc, train=train)
        if path == "packed":
            ds.enable_packed(data["packed"])
        elif path == "window_cache":
            ds.enable_window_cache()
        elif path == "decode_cache":
            ds.enable_decode_cache()
        loaders.append(mod.ImsituLoader(ds, batch_size=2, shuffle=train,
                                        seed=4, num_workers=workers,
                                        decoder=decoder))
    return loaders


def _assert_same_epochs(ours, ref, epochs=2):
    keys = ("images", "indices", "verbs", "labels", "flip")
    for epoch in range(epochs):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a["names"] == b["names"]
            assert sorted(k for k in keys if k in a) \
                == sorted(k for k in keys if k in b)
            for k in keys:
                if k in b:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("path", ["pil", "packed", "window_cache",
                                  "decode_cache"])
def test_batches_equal_jax(data, path, train, workers):
    ours, ref = _pair(data, path, train, workers)
    assert ours.decoder == ref.decoder == "python"
    _assert_same_epochs(ours, ref)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("train", [True, False])
def test_native_batches_equal_jax_native(data, train, workers):
    from situation_recognition_tpu.data import native_decoder as jnd

    if not native_decoder.available():
        pytest.skip("g++ -ljpeg cannot build the port's native decoder")
    if not jnd.available():
        pytest.skip("the JAX package's native decoder did not build")
    ours, ref = _pair(data, "pil", train, workers, decoder="native")
    assert ours.decoder == ref.decoder == "native"
    _assert_same_epochs(ours, ref)


def test_partial_window_cache_mixes_index_and_pixel_batches(data):
    """A prefix cache of 3 rows: the first batch is ``indices``, the
    next reach past the prefix and carry pixels, as in JAX."""
    ann = data["ann"]
    loaders = []
    for mod, enc in ((tds, ImsituEncoder(ann, verbose=False)),
                     (jds, JaxEnc(ann, verbose=False))):
        ds = mod.ImsituDataset(data["mixed"], ann, enc, train=False)
        ds.enable_window_cache(max_rows=3)
        assert ds.window_cache_rows == 3
        loaders.append(mod.ImsituLoader(ds, batch_size=2, shuffle=False))
    got = list(loaders[0])
    assert "indices" in got[0] and "images" in got[1]
    _assert_same_epochs(*loaders, epochs=1)


def test_start_batch_skips_once(data):
    ours, ref = _pair(data, "pil", True, 1)
    ours.start_batch = ref.start_batch = 1
    a, b = list(ours), list(ref)
    assert [x["names"] for x in a] == [x["names"] for x in b]
    assert len(a) == 2 and len(list(ours)) == 3


def test_refusals(data):
    ann = data["ann"]
    enc = ImsituEncoder(ann, verbose=False)
    ds = tds.ImsituDataset(data["mixed"], ann, enc, train=True)
    with pytest.raises(ValueError, match="ROADMAP §1 item 8"):
        tds.ImsituLoader(ds, batch_size=2, shuffle=True, shard=(0, 2))
    with pytest.raises(ValueError, match="square"):
        ds.enable_window_cache()
    with pytest.raises(ValueError, match="prefetch"):
        tds.ImsituLoader(ds, batch_size=2, shuffle=True, prefetch=0)
    exact = tds.ImsituDataset(data["mixed"], ann, enc, train=False,
                              preproc="exact")
    with pytest.raises(ValueError, match="packed"):
        exact.enable_packed(data["packed"])
    with pytest.raises(ValueError, match="exact"):
        tds.ImsituDataset(data["mixed"], ann, enc, train=True,
                          preproc="exact")


def test_exact_preproc_equals_jax(data):
    ann = data["ann"]
    ours = tds.ImsituDataset(data["mixed"], ann,
                             ImsituEncoder(ann, verbose=False), train=False,
                             preproc="exact")
    ref = jds.ImsituDataset(data["mixed"], ann, JaxEnc(ann, verbose=False),
                            train=False, preproc="exact")
    _assert_same_epochs(tds.ImsituLoader(ours, 2, shuffle=False),
                        jds.ImsituLoader(ref, 2, shuffle=False), epochs=1)


def test_loader_error_reaches_the_consumer(data, monkeypatch):
    """A batch that fails to build raises in the consumer, also when the
    queue of ready batches is full."""
    ours, _ = _pair(data, "pil", True, 1)
    ours.prefetch = 1
    calls = []
    make = ours._make_batch

    def failing(indices):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("broken image")
        return make(indices)

    monkeypatch.setattr(ours, "_make_batch", failing)
    it = iter(ours)
    next(it)
    import time

    time.sleep(0.3)              # the producer fills the queue, then fails
    with pytest.raises(RuntimeError, match="broken image"):
        for _ in it:
            pass


def test_six_concurrent_native_builds_all_succeed(tmp_path):
    """Six processes build the decoder at once into one empty build
    directory: each writes its own temporary file and renames it into
    place, so every one gets a loadable library and none is left
    half-written."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    code = (
        "import sys, ctypes\n"
        "from situation_recognition_tpu_torch.data import native_decoder as nd\n"
        "nd.BUILD_DIR = sys.argv[1]\n"
        "path = nd.ensure_built()\n"
        "ctypes.CDLL(path).srtpu_decode_window_batch\n"
        "print(path)\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    errors = [err for p, (_, err) in zip(procs, outs) if p.returncode]
    if errors and "jpeglib" in errors[0]:
        pytest.skip("no libjpeg headers")
    assert not errors, errors[0]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(paths.pop())]
