"""Device and host transforms of the port against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.data import transforms as jt
from situation_recognition_tpu_torch.data import transforms as tt


def _images(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("src,dst", [(256, 224), (224, 224), (300, 224),
                                     (256, 336)])
def test_resize_matrix_equal(src, dst):
    np.testing.assert_array_equal(tt._resize_matrix(src, dst),
                                  jt._resize_matrix(src, dst))


# f32 on both sides; the 256-long contractions are summed in other
# orders, at values up to ~2.6 after normalisation
F32_TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("size", [256, 224])
def test_eval_transform_matches_jax_f32(size):
    x = _images(3, size, size)
    want = np.asarray(jt.eval_transform(jnp.asarray(x)))
    got = tt.eval_transform(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 224, 224, 3)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("size", [256, 224])
def test_device_transform_flip_matches_jax_f32(size):
    x = _images(4, size, size, seed=1)
    flip = np.array([True, False, True, False])
    want = np.asarray(jt.device_transform(jnp.asarray(x), jnp.asarray(flip)))
    got = tt.device_transform(torch.from_numpy(x),
                              torch.from_numpy(flip)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_identity_branch_is_exact():
    x = _images(2, 224, 224, seed=2)
    got = tt.eval_transform(torch.from_numpy(x)).numpy()
    want = np.asarray(jt.eval_transform(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_eval_transform_bf16_within_one_lsb_of_f32():
    """bf16 (the JAX bf16 dot does not run on the CPU, so the bound is the
    JAX docstring's): the bf16 row pass costs at most ~1 uint8 LSB
    (1/255/std after normalising) plus the final bf16 rounding (2^-6 at
    |z| < 4)."""
    x = _images(2, 256, 256, seed=3)
    f32 = tt.eval_transform(torch.from_numpy(x)).numpy()
    got = tt.eval_transform(torch.from_numpy(x),
                            dtype=torch.bfloat16).float().numpy()
    lsb = 1.0 / 255.0 / tt.IMAGENET_STD.min()
    np.testing.assert_allclose(got, f32, rtol=0, atol=lsb + 2 ** -6)


def test_device_transform_rejects_non_uint8():
    with pytest.raises(ValueError):
        tt.eval_transform(torch.zeros(1, 256, 256, 3))


@pytest.mark.parametrize("full", [256, 259, 300, 341, 383, 500, 512, 1024])
def test_center_offset_equal(full):
    assert tt._center_offset(full) == jt._center_offset(full)


@pytest.mark.parametrize("hw", [(224, 224), (256, 341), (300, 260),
                                (224, 400), (181, 225)])
def test_host_window_exact_equal(hw):
    img = _images(1, *hw, seed=4)[0]
    np.testing.assert_array_equal(tt.host_window_exact(img),
                                  jt.host_window_exact(img))


@pytest.mark.parametrize("hw", [(256, 256), (256, 341), (383, 256),
                                (200, 300)])
def test_host_window_equal(hw):
    img = _images(1, *hw, seed=5)[0]
    np.testing.assert_array_equal(tt.host_window(img, train=False),
                                  jt.host_window(img, train=False))
    a = tt.host_window(img, train=True, rng=np.random.default_rng(7))
    b = jt.host_window(img, train=True, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(a, b)
