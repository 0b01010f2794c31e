"""The port's threefry keys, bits and normals against ``jax.random`` (with
``jax_threefry_partitionable=True``, as the reference package pins it).

Keys, bits, ``prng.log`` and normals are bitwise equal. The normals'
inverse error function takes XLA's own ``log`` (``prng.log``) and a
correctly rounded square root in its far branch, as XLA does; with
torch's CPU ``log`` and ``sqrt`` there, draws differed by up to 3 ulp."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.core import prng

jax.config.update("jax_threefry_partitionable", True)



def _t(keys) -> torch.Tensor:
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 123_456, 2**31 - 1, -5])
def test_prngkey_bitwise(seed):
    ref = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(), ref)


@pytest.mark.parametrize("n", [2, 3, 14, 7 * 64])
def test_split_bitwise(n):
    key = jax.random.PRNGKey(42)
    ref = np.asarray(jax.random.split(key, n)).astype(np.int64)
    np.testing.assert_array_equal(prng.split(_t(key), n).numpy(), ref)


def test_split_batched_like_vmap():
    keys = jax.random.split(jax.random.PRNGKey(3), 12).reshape(3, 4, 2)
    ref = np.asarray(jax.vmap(jax.vmap(jax.random.split))(keys)).astype(np.int64)
    np.testing.assert_array_equal(prng.split(_t(keys), 2).numpy(), ref)


@pytest.mark.parametrize("shape", [(11,), (3, 5)])
def test_random_bits_bitwise(shape):
    keys = jax.random.split(jax.random.PRNGKey(1), 64)
    ref = np.asarray(
        jax.vmap(lambda k: jax.random.bits(k, shape))(keys)
    ).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(_t(keys), shape).numpy(), ref)


def test_normal_ulp_gap():
    keys = jax.random.split(jax.random.PRNGKey(42), 200_000)
    ref = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (11,)))(keys))
    got = prng.normal(_t(keys), (11,)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    ulp = np.abs(
        got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64)
    )
    # the near branch (|z| below ~0.92, most of the draws) is bitwise
    assert (ulp[np.abs(ref) < 0.9] == 0).all()
    # and so is the far branch, through XLA's log and a correctly rounded sqrt
    assert ulp.max() == 0


def test_log_bitwise_equal_to_xla():
    """``prng.log`` is XLA's float32 ``log`` bit for bit, on 1.2 million
    inputs log-uniform over (1e-30, 1], the uniform draws' own grid near 1,
    and the special values."""
    rng = np.random.default_rng(0)
    x = np.exp(rng.uniform(np.log(1e-30), 0.0, 1_000_000)).astype(np.float32)
    grid = (np.arange(1, 200_001, dtype=np.float32) * np.float32(2.0**-23))
    x = np.concatenate([x, grid, 1.0 - grid[:1000], np.float32([1.0, 0.5, 2.0, 1e-30])])
    want = np.asarray(jax.numpy.log(x))
    got = prng.log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    special = np.float32([0.0, -1.0, np.inf, np.nan])
    np.testing.assert_array_equal(prng.log(torch.from_numpy(special)).numpy(),
                                  np.asarray(jax.numpy.log(special)))


def test_uniform_range():
    u = prng.uniform(prng.split(prng.PRNGKey(0), 256), (64,), -1.0, 1.0)
    assert u.dtype == torch.float32
    assert bool((u >= -1.0).all()) and bool((u < 1.0).all())
