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


@pytest.mark.parametrize("lo,hi", [(1.0, 4.0), (0.05, 0.95), (0.8, 2.5),
                                   (-3.0, 7.5)])
@pytest.mark.parametrize("shape", [(), (2,), (4, 4, 3), (1000,)])
def test_uniform_bounds(shape, lo, hi):
    """``minval``/``maxval`` scale as XLA's CPU backend computes them (one
    rounding of product and sum), over keys that exercise both roundings."""
    for seed in range(6):
        u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                          minval=lo, maxval=hi))
        ut = rng.uniform(rng.key(seed), shape, minval=lo, maxval=hi).numpy()
        assert ut.dtype == np.float32 and ut.shape == u.shape
        np.testing.assert_array_equal(u.view(np.int32), ut.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(0, 64), (0, 7), (3, 3), (5, 2),
                                   (-100, 70000), (0, 2 ** 31 - 1),
                                   (-2 ** 31, 2 ** 31 - 1)])
@pytest.mark.parametrize("shape", [(4,), (3, 5), (1000,)])
def test_randint(shape, lo, hi):
    """Spans below and above 2¹⁶ (where jax's uint32 multiplier wraps to
    0), empty ranges (minval returned) and the full int32 range."""
    for seed in (0, 1, 12345):
        r = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                          lo, hi))
        rt = rng.randint(rng.key(seed), shape, lo, hi).numpy()
        assert rt.dtype == r.dtype == np.int32
        np.testing.assert_array_equal(r, rt)


@pytest.mark.parametrize("p", [0.5, 0.1, 0.9])
@pytest.mark.parametrize("shape", [(4,), (1000,)])
def test_bernoulli(shape, p):
    for seed in (0, 2, 99):
        b = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p,
                                            shape))
        bt = rng.bernoulli(rng.key(seed), p, shape).numpy()
        assert bt.dtype == np.bool_
        np.testing.assert_array_equal(b, bt)


def test_device_trainer_batch_draw():
    """The device trainer's draw of a step (``scripts/
    train_matnet_device.py:132-144``): split, indices over 64 tuples and
    flips of a batch of 4, along a chain of step keys."""
    k, kt = jax.random.PRNGKey(1), rng.key(1)
    for _ in range(5):
        k, sub = jax.random.split(k)
        kt, subt = rng.split(kt)
        ki, kf = jax.random.split(sub)
        kit, kft = rng.split(subt)
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(ki, (4,), 0, 64)),
            rng.randint(kit, (4,), 0, 64).numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(kf, 0.5, (4,))),
            rng.bernoulli(kft, 0.5, (4,)).numpy())
