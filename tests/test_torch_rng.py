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


def _jax_keys():
    """Pairs of equal keys (JAX, port): a seed's, and keys from split and
    fold_in as the trace derives its streams'."""
    k, kt = jax.random.PRNGKey(5), rng.key(5)
    yield k, kt
    yield (jax.random.fold_in(jax.random.split(k, 3)[1], 991),
           rng.fold_in(rng.split(kt, 3)[1], 991))
    yield (jax.random.split(jax.random.fold_in(k, 2 ** 31 + 17), 4)[3],
           rng.split(rng.fold_in(kt, 2 ** 31 + 17), 4)[3])


@pytest.mark.parametrize("dims", [1, 2])
@pytest.mark.parametrize("s,n", [(8, 4096), (3, 1025), (64, 257), (1, 1)])
def test_lattice_matches_jax(s, n, dims):
    """The port's lattice stream and ``_stream_uniform`` (lattice and
    i.i.d.) equal the JAX package's ``_lds_uniform`` and
    ``_stream_uniform`` bit for bit, eager and under ``jax.jit``."""
    from materialist_tpu.render import shader as jshader

    from materialist_tpu_torch.render import shader
    lds_jit = jax.jit(jshader._lds_uniform, static_argnums=(1, 2, 3))
    for k, kt in _jax_keys():
        want = np.asarray(jshader._lds_uniform(k, s, n, dims))
        assert want.dtype == np.float32 and want.shape == (s, n, dims)
        np.testing.assert_array_equal(np.asarray(lds_jit(k, s, n, dims)),
                                      want)
        for got in (rng.lattice(kt, s, n, shader._LATTICE_G[dims]),
                    shader._stream_uniform(shader.RenderConfig(), kt, s, n,
                                           dims, torch.device("cpu"))):
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          want.view(np.int32))
        iid = np.asarray(jshader._stream_uniform(
            jshader.RenderConfig(lds=False), k, s, n, dims))
        got = shader._stream_uniform(shader.RenderConfig(lds=False), kt, s,
                                     n, dims, torch.device("cpu"))
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      iid.view(np.int32))


# the 1024² bench's pixels: a stream hashes (1, 1,048,576, dims)
_BENCH_N = 1024 * 1024


@pytest.mark.parametrize("dims", [1, 2])
def test_draws_match_jax_at_the_bench_count(dims):
    """Bits, uniforms and the lattice over the 1024² bench's stream (8
    samples of 1,048,576 pixels) equal ``jax.random`` and the JAX
    package's ``_lds_uniform`` bit for bit."""
    from materialist_tpu.render import shader as jshader

    from materialist_tpu_torch.render import shader
    k, kt = list(_jax_keys())[1]
    shape = (1, _BENCH_N, dims)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(k, shape)).astype(np.int64),
        rng.bits(kt, shape).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(k, shape)).view(np.int32),
        rng.uniform(kt, shape).numpy().view(np.int32))
    want = np.asarray(jshader._lds_uniform(k, 8, _BENCH_N, dims))
    got = rng.lattice(kt, 8, _BENCH_N, shader._LATTICE_G[dims]).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# the lattice stream as the shader composed it before the draw became one
# kernel on the card: generators copied to the device, t * g + u, fmod
_OLD_G = {1: (0.6180339887498949,),
          2: (0.7548776662466927, 0.5698402909980532)}


def _old_stream(key, s, n, dims):
    g = torch.tensor(_OLD_G[dims], dtype=torch.float32)
    t = torch.arange(s, dtype=torch.float32)[:, None, None]
    return torch.fmod(t * g + rng.uniform(key, (1, n, dims)), 1.0)


@pytest.mark.parametrize("dims", [1, 2])
@pytest.mark.parametrize("s,n", [(8, 1024), (3, 1025), (1, 1)])
def test_lattice_is_the_old_composition(s, n, dims):
    from materialist_tpu_torch.render import shader
    kt = rng.fold_in(rng.split(rng.key(5), 3)[1], 991)
    want = _old_stream(kt, s, n, dims)
    for got in (rng.lattice(kt, s, n, shader._LATTICE_G[dims]),
                rng.lattice_plain(kt, s, n, shader._LATTICE_G[dims]),
                shader._stream_uniform(shader.RenderConfig(), kt, s, n, dims,
                                       torch.device("cpu"))):
        assert got.dtype == torch.float32 and got.shape == (s, n, dims)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("draw", ["bits", "uniform", "lattice"])
def test_draws_raise_on_other_devices_dtypes_and_keys(draw):
    kt = rng.key(3)
    call = {"bits": lambda k, d: rng.bits(k, (4,), d),
            "uniform": lambda k, d: rng.uniform(k, (4,), d),
            "lattice": lambda k, d: rng.lattice(k, 2, 4, (0.5,), d)}[draw]
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        call(kt, "meta")
    # checked before anything reaches a card
    with pytest.raises(TypeError, match="int64 tensor of shape"):
        call(kt.to(torch.int32), "cuda")
    with pytest.raises(TypeError, match="int64 tensor of shape"):
        call(rng.split(kt, 2), "cuda")


@pytest.mark.parametrize("gens", [(), (0.1, 0.2, 0.3)])
def test_lattice_raises_for_other_widths(gens):
    for dev in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="1 or 2 generators"):
            rng.lattice(rng.key(0), 2, 4, gens, dev)


def test_draw_counter_and_its_bound_at_the_bench_stream():
    from materialist_tpu_torch.ops.kernels import _lib

    from perfbench import files
    assert "threefry.cu" in _lib.SOURCES and "threefry_draw" in _lib.LAUNCHES
    mod = files.load("roofline", "threefry_draw")
    assert set(mod.KERNELS) <= set(_lib.kernel_names())
    # the 1024² bench's 2-dim lattice stream: 8 samples of 1,048,576 pixels
    # by 2 dims, 4 bytes each; 73 operations a hashed value
    assert mod.bound((1048576 * 2, 8, 4, 2)) == (8 * 1048576 * 2 * 4,
                                                 1048576 * 2 * 73)
    assert mod.bound((4, 1, 8, 0)) == (32, 4 * 73)


@pytest.mark.parametrize("shape", [(5,), (3, 7), (1, 1023, 2)])
def test_cpu_bits_are_the_int64_version_and_launch_nothing(shape):
    from materialist_tpu_torch.ops.kernels import _lib
    from materialist_tpu_torch.utils import profiling as P
    kt = rng.split(rng.key(11), 2)[1]
    k1, k2 = int(kt[0]), int(kt[1])
    cnt = torch.arange(int(np.prod(shape)), dtype=torch.int64)
    b1, b2 = rng.threefry2x32(k1, k2, cnt >> 32, cnt & 0xFFFFFFFF)
    before = dict(_lib.LAUNCHES)
    with P.span("test.draw_root"):
        got = rng.bits(kt, shape)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert torch.equal(got, (b1 ^ b2).reshape(shape))
    assert torch.equal(rng.bits_plain(kt, shape), got)
    assert _lib.LAUNCHES == before
    rec = P.recent("test.draw_root")[-1]
    assert rec["counts"][P.RNG_VALUES] == int(np.prod(shape))
    assert rec["spans"]["rng.bits"]["calls"] == 1


# key words at the ends of uint32, and one from the middle
_EDGE_WORDS = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0, 0xFFFFFFFF),
               (0xFFFFFFFF, 0), (0x12345678, 0x9ABCDEF0)]


def _key_pair(words):
    return (jax.numpy.asarray(np.array(words, dtype=np.uint32)),
            torch.tensor(words, dtype=torch.int64))


@pytest.mark.parametrize("words", _EDGE_WORDS)
def test_split_matches_jax_for_every_caller_count(words):
    """``split`` hashes in Python ints: every ``num`` a caller passes (chunks,
    groups, 2, 3, 8, at most spp = 64) equals ``jax.random.split``."""
    k, kt = _key_pair(words)
    for num in range(1, 65):
        np.testing.assert_array_equal(_np(jax.random.split(k, num)),
                                      rng.split(kt, num).numpy())


@pytest.mark.parametrize("words", _EDGE_WORDS)
def test_fold_in_matches_jax_up_to_the_uint32_end(words):
    k, kt = _key_pair(words)
    for data in (0, 1, 991, 2 ** 31 - 1, 2 ** 31, 3500007,
                 2 ** 32 - 2, 2 ** 32 - 1):
        np.testing.assert_array_equal(_np(jax.random.fold_in(k, data)),
                                      rng.fold_in(kt, data).numpy())


@pytest.mark.parametrize("seed", [0, 17, 2 ** 31 + 5])
def test_trace_chunk_key_tree_matches_jax(seed):
    """A trace chunk's keys (``render/shader.py``): the film jitter's
    fold_in(key, 991), then split(fold_in(key, b), 3) for bounces 0–2, on
    each chunk key of a relight pass's split(key, 8)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 8)
    kts = rng.split(rng.key(seed), 8)
    for c in range(8):
        k, kt = ks[c], kts[c]
        np.testing.assert_array_equal(_np(jax.random.fold_in(k, 991)),
                                      rng.fold_in(kt, 991).numpy())
        for b in range(3):
            np.testing.assert_array_equal(
                _np(jax.random.split(jax.random.fold_in(k, b), 3)),
                rng.split(rng.fold_in(kt, b), 3).numpy())


@pytest.mark.parametrize("num", [1, 2, 3, 8, 64])
def test_keys_are_contiguous_cpu_int64(num):
    kt = rng.split(rng.key(4), 3)[2]
    keys = rng.split(kt, num)
    half = num // 2
    for got, shape in ((keys, (num, 2)), (rng.fold_in(kt, num), (2,)),
                       (keys[num - 1], (2,)), (keys[half:], (num - half, 2))):
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        assert tuple(got.shape) == shape and got.is_contiguous()
        assert 0 <= int(got.min()) and int(got.max()) <= 0xFFFFFFFF
    # callers unpack rows as keys, and split and fold_in a row
    first, *_ = keys
    assert torch.equal(rng.fold_in(first, 1), rng.fold_in(keys[0].clone(), 1))
    assert torch.equal(rng.split(first, 2), rng.split(keys[0].clone(), 2))


def test_key_hash_counter_under_a_root_and_without_one():
    from materialist_tpu_torch.utils import profiling as P
    kt = rng.key(8)
    with P.span("test.keys_root"):
        rng.split(kt, 5)
        rng.fold_in(kt, 3)
        rng.split(rng.fold_in(kt, 0), 3)
    rec = P.recent("test.keys_root")[-1]
    assert rec["counts"][P.RNG_KEY_HASHES] == 5 + 1 + 1 + 3
    assert rec["spans"]["rng.keys"]["calls"] == 4
    # no root open: rng.keys is its own root and nothing is counted
    rng.split(kt, 7)
    rng.fold_in(kt, 2)
    assert P.RNG_KEY_HASHES not in P.recent("rng.keys")[-1]["counts"]
    with P.span("test.keys_after"):
        pass
    assert P.recent("test.keys_after")[-1]["counts"] == {}
