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
