"""``utils/msgpack.py`` against flax's ``msgpack_serialize`` /
``msgpack_restore`` on the CPU: every leaf of a file flax wrote reads back
bit for bit (f32, bf16 — as a torch.bfloat16 tensor —, int8, int32, numpy
scalars, nested dicts, ``_tuple_to_dict`` lists, chunked arrays), and flax
reads back what the port writes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from situation_recognition_tpu_torch.utils import msgpack


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((4, 2)),
                                       jnp.bfloat16)),
        "int8": rng.integers(-127, 128, (7,)).astype(np.int8),
        "int32": rng.integers(-2 ** 31, 2 ** 31 - 1, (2, 3)).astype(np.int32),
        "f64_0d": np.asarray(rng.standard_normal()),
        "empty": np.zeros((0, 4), np.float32),
        "scalars": {"i": np.int32(-7), "f": np.float32(1.25),
                    "u": np.uint8(200), "b": np.bool_(True)},
        "nested": {"a": {"b": {"c": rng.standard_normal(2).astype(
            np.float32)}}},
        "history": serialization.to_state_dict([0.5, 1.5, 2.5]),
        "python": {"int": 3, "big": 2 ** 40, "neg": -70000, "float": 0.1,
                   "str": "ünïcode", "none": None, "true": True,
                   "false": False},
    }


def _bits(x):
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy().tobytes(), "bfloat16", \
            tuple(x.shape)
    a = np.asarray(x)
    name = "bfloat16" if a.dtype == jnp.bfloat16 else a.dtype.name
    return a.tobytes(), name, a.shape


def _assert_bit_equal(got, want, path="") -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_bit_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)) or torch.is_tensor(want):
        assert isinstance(got, (np.ndarray, np.generic)) \
            or torch.is_tensor(got), path
        assert _bits(got) == _bits(want), path
        assert type(got) is type(want) or torch.is_tensor(got), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("seed", [0, 1])
def test_reads_what_flax_writes(seed):
    want = _tree(seed)
    got = msgpack.loads(serialization.msgpack_serialize(want))
    _assert_bit_equal(got, want)
    assert torch.is_tensor(got["bf16"]) and got["bf16"].dtype == torch.bfloat16
    assert isinstance(got["scalars"]["i"], np.int32)
    assert msgpack.tuple_list(got["history"]) == [0.5, 1.5, 2.5]


def test_reads_chunked_arrays(monkeypatch, tmp_path):
    """Arrays above flax's chunk limit (set to 64 bytes inside the test)
    come back whole, from bytes and from a file."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(2)
    want = {"big": rng.standard_normal((9, 7)).astype(np.float32),
            "bigbf": np.asarray(jnp.asarray(rng.standard_normal((5, 13)),
                                            jnp.bfloat16)),
            "small": np.arange(3, dtype=np.int32)}
    blob = serialization.msgpack_serialize(want)
    assert b"__msgpack_chunked_array__" in blob
    path = tmp_path / "chunked.msgpack"
    path.write_bytes(blob)
    for got in (msgpack.loads(blob), msgpack.read(str(path))):
        _assert_bit_equal(got, want)


@pytest.mark.parametrize("chunk", [None, 48])
def test_flax_reads_what_the_port_writes(monkeypatch, tmp_path, chunk):
    """``write`` → ``flax.serialization.msgpack_restore``: the same leaves
    (a bf16 tensor as flax's bfloat16 array), with the port's own chunking
    when its limit is set small."""
    if chunk is not None:
        monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", chunk)
    want = _tree(3)
    port_tree = msgpack.loads(serialization.msgpack_serialize(want))
    port_tree["torch_f32"] = torch.arange(30, dtype=torch.float32).reshape(
        5, 6)
    path = str(tmp_path / "port.msgpack")
    msgpack.write(path, port_tree)
    with open(path, "rb") as f:
        blob = f.read()
    assert blob == msgpack.dumps(port_tree)
    assert (b"__msgpack_chunked_array__" in blob) == (chunk is not None)
    back = serialization.msgpack_restore(blob)
    np.testing.assert_array_equal(back.pop("torch_f32"),
                                  np.arange(30, dtype=np.float32)
                                  .reshape(5, 6))
    assert back["bf16"].dtype == jnp.bfloat16
    _assert_bit_equal(back, want)


def test_refuses_what_is_not_flax_msgpack():
    with pytest.raises(ValueError, match="truncated"):
        msgpack.loads(serialization.msgpack_serialize({"a": 1})[:-1])
    with pytest.raises(ValueError, match="after the msgpack object"):
        msgpack.loads(serialization.msgpack_serialize({"a": 1}) + b"\x00")
    with pytest.raises(TypeError, match="cannot write"):
        msgpack.dumps({"a": object()})
