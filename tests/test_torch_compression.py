"""repro_torch.core.compression against repro.core.compression on the CPU.

The same numpy-seeded tree (three leaves of 35, 300 and 24 elements, in a
dict whose keys are not in sorted order) goes through both packages with
the same key:

  * top-k keeps the same coordinates, the values within rtol 1e-6;
  * rand-k keeps the indices ``jax.random.choice(key, n, (k,),
    replace=False)`` keeps (`prng.choice`, `prng.permutation`), scaled by
    n/k as the JAX package scales them;
  * int8 draws the same noise: equal, except one quantisation step where
    ``x/scale + noise`` lies within 1e-6 of a half-integer;
  * `compressed_update` carries its residuals over 3 calls;
  * `compressed_bytes` is equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro_torch import prng
from repro_torch.core import compression as pc

FRACS = (0.01, 0.5)
# the JAX package's operators jitted: eagerly each primitive compiles apart
J_TOPK = jax.jit(jc.topk_compress, static_argnums=1)
J_RANDK = jax.jit(jc.randk_compress, static_argnums=1)
J_INT8 = jax.jit(jc.int8_compress)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal((7, 5)).astype(np.float32),
            "a": rng.standard_normal(300).astype(np.float32),
            "c": (10 * rng.standard_normal((2, 3, 4))).astype(np.float32)}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


@pytest.mark.parametrize("n", [10, 1000, 2000])
def test_permutation_matches_jax(n):
    """1000 elements take one sort round, 2000 two."""
    for seed in (0, 5):
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        got = prng.permutation(prng.PRNGKey(seed), n).numpy()
        np.testing.assert_array_equal(got, want)
        k = max(1, n // 3)
        np.testing.assert_array_equal(
            prng.choice(prng.PRNGKey(seed), n, k).numpy(),
            np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                                         replace=False)))


@pytest.mark.parametrize("frac", FRACS)
def test_topk_matches_jax(frac):
    jt, pt = _both(_tree())
    (jcomp, jres), (pcomp, pres) = J_TOPK(jt, frac), \
        pc.topk_compress(pt, frac)
    assert list(pcomp) == sorted(jt)
    for k in jt:
        np.testing.assert_array_equal(pcomp[k].numpy() != 0,
                                      np.asarray(jcomp[k]) != 0)
        np.testing.assert_allclose(pcomp[k].numpy(), np.asarray(jcomp[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(pres[k].numpy(), np.asarray(jres[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("frac", FRACS)
def test_randk_matches_jax(frac):
    tree = _tree(1)
    jt, pt = _both(tree)
    (jcomp, jres), (pcomp, pres) = \
        J_RANDK(jt, frac, jax.random.PRNGKey(3)), \
        pc.randk_compress(pt, frac, prng.PRNGKey(3))
    for k in sorted(tree):
        n = tree[k].size
        kept = max(1, int(n * frac))
        got, want = pcomp[k].numpy().reshape(-1), np.asarray(jcomp[k]).ravel()
        np.testing.assert_array_equal(got != 0, want != 0)
        assert np.count_nonzero(got) == kept
        np.testing.assert_allclose(
            got[got != 0],
            tree[k].reshape(-1)[got != 0] * np.float32(n / kept), rtol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(pres[k].numpy(), np.asarray(jres[k]),
                                   rtol=1e-6)


def test_int8_matches_jax():
    tree = _tree(2)
    jt, pt = _both(tree)
    (jcomp, jres), (pcomp, pres) = \
        J_INT8(jt, jax.random.PRNGKey(4)), \
        pc.int8_compress(pt, prng.PRNGKey(4))
    # the noise both draw (prng.uniform equals jax.random.uniform in bits,
    # tests/test_torch_prng.py)
    keys = prng.split(prng.PRNGKey(4), 3)
    for i, k in enumerate(sorted(tree)):
        x = tree[k]
        scale = np.float32(max(np.abs(x).max(), 1e-12)) / np.float32(127.0)
        noise = prng.uniform(keys[i], x.shape, minval=-0.5,
                             maxval=0.5).numpy()
        v = x / scale + noise
        near_half = np.abs(np.abs(v - np.floor(v)) - 0.5) < 1e-6
        got, want = pcomp[k].numpy(), np.asarray(jcomp[k])
        step = np.abs(got - want) / scale
        assert np.all((got == want) | (near_half & (np.abs(step - 1) < 1e-3)))
        np.testing.assert_allclose(pres[k].numpy() + got, x, atol=1e-5)


@pytest.mark.parametrize("method", ["none", "topk", "randk", "int8"])
def test_compressed_update_carries_residuals(method):
    """3 calls, each on a fresh gradient tree plus the carried residual."""
    jt, pt = _both(_tree(3))
    jef, pef = jc.init_error_feedback(jt), pc.init_error_feedback(pt)
    for i in range(3):
        jg, pg = _both(_tree(10 + i))
        # eager, op by op as the port computes: under jit XLA fuses int8's
        # x - q*scale into one rounding, an ulp of |x| from the port's
        jsent, jef = jc.compressed_update(jg, jef, method, 0.1,
                                          jax.random.PRNGKey(i))
        psent, pef = pc.compressed_update(pg, pef, method, 0.1,
                                          prng.PRNGKey(i))
        for k in jt:
            np.testing.assert_allclose(psent[k].numpy(),
                                       np.asarray(jsent[k]), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(pef.residual[k].numpy(),
                                       np.asarray(jef.residual[k]),
                                       rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        pc.compressed_update(pg, pef, "fp4", 0.1, prng.PRNGKey(0))


@pytest.mark.parametrize("method", ["none", "topk", "randk", "int8"])
def test_compressed_bytes_matches_jax(method):
    jt, pt = _both(_tree())
    for frac in FRACS:
        assert pc.compressed_bytes(pt, method, frac) == \
            jc.compressed_bytes(jt, method, frac)
