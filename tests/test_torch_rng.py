"""materialist_tpu_torch.rng is bit-exact with jax.random's partitionable
threefry: keys, splits, fold-ins and uniforms of the shapes the shader
draws."""

import jax
import numpy as np
import pytest
import torch

from materialist_tpu_torch import rng


def _np(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 3, 12345, 2 ** 31 - 1])
def test_key_and_split(seed):
    k, kt = jax.random.PRNGKey(seed), rng.key(seed)
    np.testing.assert_array_equal(_np(k), kt.numpy())
    for num in (1, 2, 3, 16):
        np.testing.assert_array_equal(_np(jax.random.split(k, num)),
                                      rng.split(kt, num).numpy())


@pytest.mark.parametrize("data", [0, 1, 2, 991, 1000000, 3500007])
def test_fold_in(data):
    k, kt = jax.random.PRNGKey(7), rng.key(7)
    np.testing.assert_array_equal(_np(jax.random.fold_in(k, data)),
                                  rng.fold_in(kt, data).numpy())


@pytest.mark.parametrize("shape", [(1, 1024, 1), (1, 1024, 2), (4, 96, 2),
                                   (3, 7)])
def test_uniform_bits(shape):
    k = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 1), 3)[2]
    kt = rng.split(rng.fold_in(rng.key(3), 1), 3)[2]
    u = np.asarray(jax.random.uniform(k, shape))
    ut = rng.uniform(kt, shape).numpy()
    assert ut.dtype == np.float32 and ut.shape == u.shape
    np.testing.assert_array_equal(u.view(np.int32), ut.view(np.int32))


def test_uniform_on_device_argument():
    ut = rng.uniform(rng.key(0), (2, 5), device="cpu")
    assert ut.device == torch.device("cpu")
    assert float(ut.min()) >= 0.0 and float(ut.max()) < 1.0
