"""repro_torch.prng against jax.random: bit-equal keys, splits and draws.

Bit equality (no tolerance) is the contract: the engines draw every index,
delay and mask from these functions, so one differing bit would change
which samples a port run visits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch import prng

SEEDS = [0, 1, 42, 2**31 - 1]


@pytest.fixture(autouse=True)
def _partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax_threefry_partitionable=True only")


def _np(key):
    return np.asarray(key, np.uint32).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS + [-5])
def test_prngkey_and_split(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    for num in (2, 3, 40484):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      _np(jax.random.split(jk, num)))


def test_batched_prngkey_matches_vmap():
    seeds = [0, 3, 9, 12345]
    jk = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    np.testing.assert_array_equal(prng.keys_from_seeds(seeds).numpy(), _np(jk))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(40484,), (4, 2048), (3, 5, 7)])
def test_uniform_and_bernoulli(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    for p in (0.5, 0.98):
        np.testing.assert_array_equal(
            prng.bernoulli(tk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("maxval", [1, 96, 20242, 70000, 2**31 - 1])
def test_randint(seed, maxval):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for shape in ((40484,), (16, 3)):
        np.testing.assert_array_equal(
            prng.randint(tk, shape, 0, maxval).numpy(),
            np.asarray(jax.random.randint(jk, shape, 0, maxval)))


def test_batched_keys_match_vmapped_draws():
    """A leading batch of keys equals jax.vmap over the same keys — the
    engine draws every row's (and every step's) stream this way."""
    jks = jax.random.split(jax.random.PRNGKey(7), 6)
    tks = prng.split(prng.PRNGKey(7), 6)
    np.testing.assert_array_equal(
        prng.uniform(tks, (9, 2048)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (9, 2048)))(jks)))
    np.testing.assert_array_equal(
        prng.split(tks, 5).numpy(),
        _np(jax.vmap(lambda k: jax.random.split(k, 5))(jks)))
    np.testing.assert_array_equal(
        prng.randint(tks, (11,), 0, 96).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (11,), 0, 96))(jks)))


def test_seed_out_of_range_raises():
    with pytest.raises(ValueError):
        prng.PRNGKey(2**31)
