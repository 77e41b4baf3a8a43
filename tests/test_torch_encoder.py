"""The port's encoder tables against the JAX encoder's."""

import json
import os

import numpy as np
import pytest

from situation_recognition_tpu.data.encoder import ImsituEncoder as JaxEncoder
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TABLES = ("role_ids", "role_counts", "role_mask", "adjacency")
_VOCAB = ("verb_list", "role_list", "label_list", "roles_per_verb",
          "max_role_count")


def _pair(source):
    if source == "overfitting":
        with open(os.path.join(_REPO, "imSitu", "overfitting.json")) as f:
            data = json.load(f)
        return (ImsituEncoder(data, verbose=False),
                JaxEncoder(data, verbose=False))
    return ImsituEncoder.synthetic_full(0), JaxEncoder.synthetic_full(0)


@pytest.mark.parametrize("source", ["overfitting", "synthetic_full"])
def test_tables_equal_jax(source):
    ours, ref = _pair(source)
    for name in _VOCAB:
        assert getattr(ours, name) == getattr(ref, name), name
    for name in _TABLES:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("source", ["overfitting", "synthetic_full"])
def test_adjacency_lookup_equals_jax(source):
    ours, ref = _pair(source)
    verbs = np.arange(ours.get_num_verbs())[::3]
    np.testing.assert_array_equal(ours.get_adj_matrix_noself(verbs),
                                  ref.get_adj_matrix_noself(verbs))


def test_synthetic_full_is_the_real_model_shape():
    enc = ImsituEncoder.synthetic_full(0)
    assert (enc.get_num_verbs(), enc.get_num_roles(),
            enc.get_num_labels(), enc.max_role_count) == (504, 190, 2001, 6)
    assert set(enc.role_counts.tolist()) == {1, 2, 3, 4, 5, 6}


@pytest.mark.parametrize("source", ["overfitting", "synthetic_full"])
def test_dict_roundtrip_and_jax_interchange(source):
    """to_dict → JSON → from_dict rebuilds the same tables, and a JAX
    encoder's dict builds them too (serving meta carries these keys)."""
    ours, ref = _pair(source)
    back = ImsituEncoder.from_dict(json.loads(json.dumps(ours.to_dict())))
    from_jax = ImsituEncoder.from_dict(ref.to_dict())
    for enc in (back, from_jax):
        for name in _VOCAB:
            assert getattr(enc, name) == getattr(ours, name), name
        for name in _TABLES:
            np.testing.assert_array_equal(getattr(enc, name),
                                          getattr(ours, name))


def _json(name):
    with open(os.path.join(_REPO, "imSitu", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["overfitting.json", "o.json"])
def test_encode_and_lookups_equal_jax(name):
    """``encode``, ``get_label_ids``, the role lookups and the per-verb
    counts of every record equal the JAX encoder's, exactly."""
    data = _json(name)
    ours = ImsituEncoder(data, verbose=False)
    ref = JaxEncoder(data, verbose=False)
    for item in data.values():
        v, labels = ours.encode(item)
        jv, jlabels = ref.encode(item)
        assert v == jv
        assert labels.dtype == jlabels.dtype
        np.testing.assert_array_equal(labels, jlabels)
        np.testing.assert_array_equal(
            ours.get_label_ids(item["verb"], item["frames"]),
            ref.get_label_ids(item["verb"], item["frames"]))
    verbs = np.arange(ours.get_num_verbs())
    for v in verbs:
        assert ours.get_role_count(v) == ref.get_role_count(v)
        np.testing.assert_array_equal(ours.get_role_ids(v),
                                      ref.get_role_ids(v))
    np.testing.assert_array_equal(ours.get_role_ids_batch(verbs[::-1]),
                                  ref.get_role_ids_batch(verbs[::-1]))
    np.testing.assert_array_equal(
        ours.get_verb2role_encoding_batch(verbs),
        ref.get_verb2role_encoding_batch(verbs))


def test_unseen_label_maps_to_unk_or_raises():
    data = _json("overfitting.json")
    ours = ImsituEncoder(data, verbose=False)
    ref = JaxEncoder(data, verbose=False)
    item = dict(next(iter(data.values())))
    role = ours.roles_per_verb[item["verb"]][0]
    item["frames"] = [dict(f, **{role: "never-seen"})
                      for f in item["frames"]]
    if "UNK" in ours.label_list:
        np.testing.assert_array_equal(ours.encode(item)[1],
                                      ref.encode(item)[1])
    else:
        with pytest.raises(ValueError):
            ours.encode(item)
        with pytest.raises(ValueError):
            ref.encode(item)


@pytest.mark.parametrize("train", [False, True])
def test_transforms_equal_jax(train):
    """``dev_transform`` / ``train_transform`` of one image against the
    JAX encoder's: the same window and flip draws from the same seed, and
    f32 transforms within ``test_torch_transforms.py``'s f32 tolerance
    (rtol 1e-5, atol 2e-5)."""
    ours = ImsituEncoder.synthetic_full(0)
    ref = JaxEncoder.synthetic_full(0)
    img = np.random.default_rng(3).integers(0, 256, (256, 300, 3),
                                            dtype=np.uint8)
    if train:
        got = ours.train_transform(img, np.random.default_rng(7))
        want = ref.train_transform(img, np.random.default_rng(7))
    else:
        got, want = ours.dev_transform(img), ref.dev_transform(img)
    assert got.shape == want.shape == (224, 224, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["overfitting.json", "o.json"])
def test_save_load_round_trip_and_jax_file(tmp_path, name):
    """The port's ``save``/``load`` round-trips, and the file the JAX
    encoder saves (the CLI's ``<saving_folder>/encoder``) loads here into
    the same tables, and the port's file into the JAX encoder."""
    data = _json(name)
    ours = ImsituEncoder(data, verbose=False)
    ref = JaxEncoder(data, verbose=False)
    ours.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "jax"))
    for enc in (ImsituEncoder.load(str(tmp_path / "port")),
                ImsituEncoder.load(str(tmp_path / "jax")),
                JaxEncoder.load(str(tmp_path / "port"))):
        for attr in _VOCAB:
            assert getattr(enc, attr) == getattr(ours, attr), attr
        for attr in _TABLES:
            np.testing.assert_array_equal(getattr(enc, attr),
                                          getattr(ours, attr))
