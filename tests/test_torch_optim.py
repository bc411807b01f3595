"""repro_torch.optim against repro.optim on the same numpy inputs:
`clip_by_global_norm`, sgd, momentum and adamw over 3 applications (rtol
1e-6, atol 1e-7: elementwise float32 arithmetic in the same order; the
global norm's sum differs in order), and the three schedules at the
warm-up's edges, mid-way and at the end (rtol 1e-6), with the step as a
device int32 tensor as the train state holds it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JaxTrainConfig
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import make_schedule as jax_make_schedule
from repro_torch.config import TrainConfig
from repro_torch.optim import clip_by_global_norm, make_optimizer, make_schedule


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal(7)).astype(np.float32),
                  "s": np.float32(scale * rng.standard_normal())}}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, rtol=1e-6, atol=1e-7):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("max_norm", [0.5, 1e9, 0.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    """Active, inactive, and off (max_norm 0: the tree as it is, norm 0)."""
    tree = _tree(0)
    got, gnorm = clip_by_global_norm(_torch(tree), max_norm)
    want, wnorm = jax_clip(_jax(tree), max_norm)
    _close(got, want)
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-6)


@pytest.mark.parametrize("name,wd", [("sgd", 0.0), ("sgd", 0.1),
                                     ("momentum", 0.0), ("momentum", 0.1),
                                     ("adamw", 0.0), ("adamw", 0.1),
                                     ("svrg", 0.0)])
def test_optimizers_match_jax_over_three_applications(name, wd):
    cfg = dict(optimizer=name, weight_decay=wd, beta1=0.8)
    opt, jopt = make_optimizer(TrainConfig(**cfg)), \
        jax_make_optimizer(JaxTrainConfig(**cfg))
    assert opt.name == jopt.name
    params = _tree(1)
    p, jp = _torch(params), _jax(params)
    st, jst = opt.init(p), jopt.init(jp)
    for i in range(3):
        v = _tree(10 + i, 0.3)
        lr = np.float32(0.05 * (i + 1))
        step = torch.tensor(i, dtype=torch.int32)
        p, st = opt.apply(_torch(v), st, torch.tensor(lr), p, step)
        jp, jst = jopt.apply(_jax(v), jst, jnp.asarray(lr), jp,
                             jnp.asarray(i, jnp.int32))
        _close(p, jp)
        _close(st, jst)
    assert all(x.dtype == torch.float32 for x in (p["w"], p["b"]["c"]))


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_schedules_match_jax(schedule, warmup):
    cfg = dict(steps=100, warmup_steps=warmup, learning_rate=0.3,
               schedule=schedule)
    fn, jfn = make_schedule(TrainConfig(**cfg)), \
        jax_make_schedule(JaxTrainConfig(**cfg))
    warm = max(1, warmup)
    for step in (0, warm - 1, warm, 55, 99, 150):
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(jfn(step)), rtol=1e-6,
                                   err_msg=f"step {step}")
        assert float(fn(step)) == float(got)


def test_tree_helpers_match_jax():
    """repro_torch.utils.tree against repro.utils.tree on the same nested
    tree (dicts sorted, a NamedTuple, a 0-d leaf)."""
    from typing import NamedTuple

    from repro.utils import tree as jt
    from repro_torch.utils import tree as pt

    class Pair(NamedTuple):
        a: object
        b: object

    def both(seed):
        t = _tree(seed)
        return (Pair(_torch(t), _torch(_tree(seed + 1))),
                Pair(_jax(t), _jax(_tree(seed + 1))))

    (x, jx), (y, jy) = both(0), both(5)
    _close(pt.tree_add(x, y).a, jt.tree_add(jx, jy).a)
    _close(pt.tree_sub(x, y).b, jt.tree_sub(jx, jy).b)
    _close(pt.tree_scale(x, 0.3).a, jt.tree_scale(jx, 0.3).a)
    _close(pt.tree_axpy(0.7, x, y).b, jt.tree_axpy(0.7, jx, jy).b)
    np.testing.assert_allclose(float(pt.tree_dot(x, y)),
                               float(jt.tree_dot(jx, jy)), rtol=1e-6)
    np.testing.assert_allclose(float(pt.global_norm(x)),
                               float(jt.global_norm(jx)), rtol=1e-6)
    assert pt.tree_size(x) == jt.tree_size(jx) == 2 * (30 + 7 + 1)
    assert pt.tree_bytes(x) == jt.tree_bytes(jx)
    half = pt.tree_cast(x, torch.bfloat16)
    assert pt.tree_bytes(half) == jt.tree_bytes(jt.tree_cast(jx, jnp.bfloat16))
    zeros = pt.tree_zeros_like(x)
    assert float(pt.global_norm(zeros)) == 0.0 and isinstance(zeros, Pair)
    assert [k for k, _ in pt.tree_flatten_with_path(x)] == \
        ["a/b/c", "a/b/s", "a/w", "b/b/c", "b/b/s", "b/w"]
