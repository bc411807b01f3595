"""The port's mixture-of-experts family on the CPU against the JAX package's,
on the same inputs: the configs and param defs, `moe_ffn` alone (with
capacity drops, ties among the router's probabilities and an overflowing
expert), prefill / decode, the training loss with the router aux and its
gradient, and the SVRG train step, for the reduced forms of
deepseek-moe-16b (shared experts, a dense first layer) and
qwen3-moe-235b-a22b (QK-norm, GQA, no shared experts), with the JAX weights
carried across by `convert.to_model_params`.

What the JAX function routes (its top-k, dispatch and combine) is read by
spies on its module's ``jax.lax.top_k`` and ``jnp.einsum``, under
``jax.disable_jit`` where the layers run inside a scan; nothing of the JAX
package is edited.

Tolerances, float32: `moe_ffn` y rtol 1e-5 with atol 1e-5 of its scale
(its largest magnitude: the JAX init rule's std 1/sqrt(L) puts y in the
hundreds, and an entry that is a sum of such terms cancelling to a small
value carries their float32 rounding, ~4e-6 of the scale), aux rtol 1e-5;
routes and dispatch equal, combine rtol 1e-5, atol 1e-5 (the router's
softmax differs in its last bits between the packages; 1e-4 in the model,
the logits' tolerance); prefill and decode logits rtol 1e-4, atol 1e-4
and caches rtol 1e-4 with atol 1e-4 of the cache's scale
(tests/test_torch_models.py's header); the loss rtol 1e-5 and its gradient
per leaf rtol 1e-4, atol 1e-5 (backward sums in another order), for
deepseek plus 1e-3 of the leaf's scale (`GRAD_ATOL_OF_SCALE`); params
after SVRG steps tests/test_torch_train.py's rtol 1e-4, atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SVRGConfig as JaxSVRGConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.data.synthetic_lm import SyntheticLMDataset
from repro.models import moe as jmoe
from repro.models.factory import build_model as jax_build_model
from repro.sharding.rules import init_from_defs as jax_init_from_defs
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.state import make_snapshot_fns as jax_make_snapshot_fns
from repro.train.state import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.config import SVRGConfig, TrainConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.distributed import value_and_grad
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.models import moe
from repro_torch.models import transformer
from repro_torch.models.factory import build_model
from repro_torch.train.loop import device_batch
from repro_torch.train.state import make_snapshot_fns, make_train_step
from repro_torch.utils.tree import tree_flatten_with_path, tree_map

MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: tree}


class _Spy:
    """A module stand-in: the attributes named in ``hooks`` (dotted paths
    such as ``"lax.top_k"``) are replaced, every other is the module's."""

    def __init__(self, real, hooks, prefix=""):
        self._real, self._hooks, self._prefix = real, hooks, prefix

    def __getattr__(self, name):
        path = self._prefix + name
        if path in self._hooks:
            return self._hooks[path]
        attr = getattr(self._real, name)
        if any(h.startswith(path + ".") for h in self._hooks):
            return _Spy(attr, self._hooks, path + ".")
        return attr


@pytest.fixture
def jax_routes(monkeypatch):
    """What each call of the JAX package's `moe_ffn` routes, in call order:
    ``top_k`` (probs, values, indices), ``dispatch`` and ``combine``."""
    seen = {"top_k": [], "dispatch": [], "combine": []}

    def top_k(x, k):
        v, i = jax.lax.top_k(x, k)
        seen["top_k"].append((np.asarray(x), np.asarray(v), np.asarray(i)))
        return v, i

    def einsum(spec, *ops, **kw):
        if spec == "bnsec,bnsd->ebncd":
            seen["dispatch"].append(np.asarray(ops[0]))
        elif spec == "bnsec,ebncd->bnsd":
            seen["combine"].append(np.asarray(ops[0]))
        return jnp.einsum(spec, *ops, **kw)

    monkeypatch.setattr(jmoe, "jax", _Spy(jax, {"lax.top_k": top_k}))
    monkeypatch.setattr(jmoe, "jnp", _Spy(jnp, {"einsum": einsum}))
    return seen


@pytest.fixture
def port_routes(monkeypatch):
    """Each `moe.route` result of the port, in call order."""
    seen = []
    real = moe.route

    def spy(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(moe, "route", spy)
    return seen


def _assert_routes_equal(got, want, msg="", tol=1e-5):
    """The port's routings against the JAX function's: chosen experts and
    dispatch equal, combine (the renormalised router probabilities at the
    kept slots) within ``tol`` (rtol and atol)."""
    assert len(got) == len(want["top_k"]) == len(want["dispatch"]) > 0, msg
    for i, r in enumerate(got):
        np.testing.assert_array_equal(r.topi.numpy(), want["top_k"][i][2],
                                      err_msg=f"{msg} topi {i}")
        np.testing.assert_array_equal(r.dispatch.numpy(), want["dispatch"][i],
                                      err_msg=f"{msg} dispatch {i}")
        np.testing.assert_allclose(r.combine.numpy(), want["combine"][i],
                                   rtol=tol, atol=tol,
                                   err_msg=f"{msg} combine {i}")


# ---------------------------------------------------------------------------
# Configs and param defs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_configs_equal_jax_field_for_field(arch):
    assert get_config(arch).to_dict() == jax_get_config(arch).to_dict()
    assert reduced_config(arch).to_dict() == jax_reduced_config(arch).to_dict()


@pytest.mark.parametrize("arch", MOE)
def test_param_defs_equal_jax(arch):
    """Full width: the same keys, shapes, axes, inits and dtypes (deepseek's
    dense layer at moe_d_ff·(top_k + shared) = 11264, its MoE blocks
    without ``mlp``)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mine, theirs = _flat(moe.param_defs(cfg)), _flat(jmoe.param_defs(jcfg))
    assert sorted(mine) == sorted(theirs)
    for path, d in mine.items():
        t = theirs[path]
        assert (d.shape, d.axes, d.init, d.scale, d.dtype) == \
            (t.shape, t.axes, t.init, t.scale, t.dtype), path
    if arch == "deepseek-moe-16b":
        assert mine["/dense_blocks/mlp/w_up"].shape == (1, 2048, 11264)
        assert "/moe_blocks/mlp/w_up" not in mine


@pytest.mark.parametrize("S,Sg,C", [(2048, 256, 30), (512, 256, 30),
                                    (1, 1, 1), (320, 64, 8)])
def test_group_size_and_capacity(S, Sg, C):
    """deepseek's routing groups: 256 tokens and 30 slots at prefill, a
    group of one token with 1 slot at decode."""
    cfg = get_config("deepseek-moe-16b")
    assert moe.group_size(S) == Sg
    assert moe.capacity(cfg, Sg) == C


# ---------------------------------------------------------------------------
# moe_ffn alone
# ---------------------------------------------------------------------------

def _layer_params(arch, seed=0):
    """The first MoE layer's ``moe`` params of the reduced config, drawn by
    the JAX package's init and perturbed (every entry nonzero)."""
    jcfg = jax_reduced_config(arch)
    defs = jmoe._moe_mlp_defs(jcfg, 1, "float32")
    p = jax.tree.map(lambda x: np.asarray(x[0]), jax_init_from_defs(
        jax.random.PRNGKey(seed), defs))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda x: x + (0.05 * rng.standard_normal(x.shape)
                                       ).astype(np.float32), p)


def _ffn_pair(arch, p, x, jax_routes, port_routes):
    cfg, jcfg = reduced_config(arch), jax_reduced_config(arch)
    want_y, want_aux = jmoe.moe_ffn(jnp.asarray(x), jax.tree.map(
        jnp.asarray, p), jcfg)
    got_y, got_aux = moe.moe_ffn(torch.tensor(x), convert.to_model_params(
        p, "cpu"), cfg)
    want_y = np.asarray(want_y)
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=1e-5,
                               atol=1e-5 * np.abs(want_y).max())
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    assert got_aux.dtype == torch.float32
    _assert_routes_equal(port_routes, jax_routes, arch)
    return port_routes[-1]


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("S", [32, 320])
def test_moe_ffn_matches_jax(arch, S, jax_routes, port_routes):
    """Random routing: one group of 32 tokens (capacity 10 of an expected
    load 8, so some tokens are dropped) and 5 groups of 64."""
    x = _normal((2, S, 128), 3)
    r = _ffn_pair(arch, _layer_params(arch), x, jax_routes, port_routes)
    assert r.dispatch.shape[1:3] == (S // moe.group_size(S),
                                     moe.group_size(S))


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal values: the lower index first, as `jax.lax.top_k` orders them,
    on rows drawn from 4 levels (many ties) and on a hand-made row."""
    rng = np.random.default_rng(4)
    probs = (rng.integers(0, 4, (256, 8)) / 4).astype(np.float32)
    probs[0] = [0.1, 0.3, 0.1, 0.3, 0.2, 0.3, 0.0, 0.0]
    for k in (1, 2, 3, 6, 8):
        v, i = moe.top_k(torch.tensor(probs), k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert moe.top_k(torch.tensor(probs[:1]), 2)[1].tolist() == [[1, 3]]


def _steered_router(p, columns, seed):
    """Router weights under which every token's logits for ``columns`` are
    equal and far above the others': those columns identical, each with a
    large weight on feature 0, which the inputs hold at 3."""
    router = 0.01 * _normal(p["router"].shape, seed)
    router[:, columns] = router[:, columns[:1]]
    router[0, columns] = 5.0
    return {**p, "router": router}


def _steered_inputs(S, seed):
    x = _normal((2, S, 128), seed)
    x[..., 0] = 3.0
    return x


@pytest.mark.parametrize("arch", MOE)
def test_tied_experts_route_as_jax(arch, jax_routes, port_routes):
    """Experts 2, 5 and 6 tie for every token (equal router columns, so
    equal probabilities bit for bit): the top 2 are 2 then 5 for every
    token, as `lax.top_k` orders them, and expert 2, wanted by all 32
    tokens of the group at rank 0, keeps the first 10 (its capacity)."""
    p = _steered_router(_layer_params(arch), [2, 5, 6], 5)
    r = _ffn_pair(arch, p, _steered_inputs(32, 6), jax_routes, port_routes)
    assert bool((r.topi[..., 0] == 2).all() and (r.topi[..., 1] == 5).all())
    kept = r.dispatch.sum(dim=(-1, -3))               # [B, n, E]
    assert kept[..., 2].tolist() == [[10], [10]]
    assert kept[..., 5].tolist() == [[10], [10]]


@pytest.mark.parametrize("arch", MOE)
def test_overflowing_expert_drops_as_jax(arch, jax_routes, port_routes):
    """Every token wants expert 3 first (rank 0): it keeps the first 10
    tokens of each group and drops the rest; the rank-1 choices spread over
    the other experts. The kept set and the combine weights are the JAX
    function's."""
    p = _steered_router(_layer_params(arch, seed=7), [3], 8)
    r = _ffn_pair(arch, p, _steered_inputs(32, 9), jax_routes, port_routes)
    assert bool((r.topi[..., 0] == 3).all())
    kept = r.dispatch.sum(dim=(-1, -3))               # [B, n, E]
    assert kept[..., 3].tolist() == [[10], [10]]
    # tokens 10..31 lost their rank-0 expert: only their rank-1 weight
    slots = r.dispatch[0, 0].sum(-1)                  # [Sg, E]
    assert slots[:10, 3].tolist() == [1.0] * 10 and slots[10:, 3].sum() == 0
    assert float(r.dispatch.sum()) < 2 * 32 * 2


# ---------------------------------------------------------------------------
# Prefill and decode of the reduced architectures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE)
def model_pair(request):
    arch = request.param
    jbundle = jax_build_model(jax_reduced_config(arch))
    jparams = jax_init_from_defs(jax.random.PRNGKey(0), jbundle.param_defs)
    leaves, treedef = jax.tree.flatten(jparams)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + (0.05 * rng.standard_normal(x.shape)
                               ).astype(np.float32) for x in leaves]
    jparams = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    bundle = build_model(reduced_config(arch), device="cpu")
    params = convert.to_model_params(jax.tree.map(np.asarray, jparams), "cpu")
    return arch, jbundle, jparams, bundle, params


def test_to_model_params_carries_the_moe_tree(model_pair):
    _, jbundle, jparams, bundle, params = model_pair
    got = {k: (tuple(v.shape), str(v.dtype)) for k, v in
           tree_flatten_with_path(params)}
    want = {k: (tuple(v.shape), f"torch.{v.dtype}") for k, v in
            _flat(jax.tree.map(np.asarray, jparams)).items()}
    assert {"/" + k: v for k, v in got.items()} == want
    defs = {k: (tuple(d.shape), f"torch.{d.dtype}") for k, d in
            _flat(bundle.param_defs).items()}
    assert defs == want


def _close_cache(got, want, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=msg)


def test_prefill_and_decode_match_jax(model_pair, jax_routes, port_routes):
    """A 20-token prompt (one group, capacity 7) and 3 decode steps (each
    token its own group): logits, caches and every MoE layer's routes."""
    arch, jbundle, jparams, bundle, params = model_pair
    cfg = bundle.cfg
    V = cfg.vocab_size
    S, cache_len = 20, 24
    toks = np.random.default_rng(2).integers(0, V, (2, S + 3)).astype(np.int32)
    before = gqa_flash.launches
    with jax.disable_jit():
        jlogits, jcache = jbundle.prefill_fn(
            jparams, {"tokens": jnp.asarray(toks[:, :S])}, cache_len)
    logits, cache = bundle.prefill_fn(params, {"tokens": torch.tensor(
        toks[:, :S])}, cache_len)
    assert gqa_flash.launches == before          # the plain version here
    assert logits.dtype == torch.float32 and logits.shape == (2, V)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4, err_msg=arch)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape == \
            (cfg.num_layers, 2, cfg.num_kv_heads, cache_len, cfg.head_dim)
        assert not cache[name][:, :, :, S:].any()
        _close_cache(cache[name], jcache[name], f"{arch} cache {name}")
    moe_layers = cfg.num_layers - cfg.first_dense_layers
    assert len(port_routes) == moe_layers
    for step in range(3):
        pos = S + step
        with jax.disable_jit():
            jlogits, jcache = jbundle.decode_fn(
                jparams, jcache, jnp.asarray(toks[:, pos]),
                jnp.asarray(pos, jnp.int32))
        logits, cache2 = bundle.decode_fn(params, cache,
                                          torch.tensor(toks[:, pos]), pos)
        assert cache2 is cache                   # updated in place
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"{arch} decode {step}")
        for name in ("k", "v"):
            _close_cache(cache[name], jcache[name],
                         f"{arch} decode {step} cache {name}")
    assert len(port_routes) == 4 * moe_layers
    assert all(r.dispatch.shape[2:] == (1, cfg.num_experts, 1)
               for r in port_routes[moe_layers:])
    _assert_routes_equal(port_routes, jax_routes, arch, tol=1e-4)


def test_prefill_attends_through_the_flash_wrapper(model_pair, monkeypatch):
    """Prefill: one `gqa_flash` call per layer, dense and MoE alike, all
    global; training: none."""
    _, _, _, bundle, params = model_pair
    calls = []

    def spy(*args, **kw):
        calls.append(kw["window"])
        return gqa_flash(*args, **kw)

    monkeypatch.setattr(transformer, "gqa_flash", spy)
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, bundle.cfg.vocab_size, (2, 16)))
    batch = {"tokens": toks, "targets": toks,
             "mask": torch.ones(toks.shape, dtype=torch.float32)}
    bundle.loss_fn(params, batch)
    assert calls == []
    bundle.prefill_fn(params, batch, 16)
    assert calls == [0] * bundle.cfg.num_layers


# ---------------------------------------------------------------------------
# Training: loss with the router aux, its gradient, the SVRG step
# ---------------------------------------------------------------------------

SEQ, BATCH = 32, 4


def _jnp_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p)))
                     for p in path): np.asarray(leaf) for path, leaf in flat}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree_flatten_with_path(tree)}


def _assert_trees_close(got, want, rtol, atol, atol_of_scale=0.0):
    """Leaf by leaf; ``atol_of_scale`` adds that fraction of each leaf's
    largest magnitude to ``atol``."""
    got, want = _np(got), _jnp_flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        tol = atol + atol_of_scale * float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=tol,
                                   err_msg=key)


# deepseek's gradients: its dense first layer and the embedding sit below
# three MoE layers whose outputs reach the hundreds (the init rule's std
# 1/sqrt(L)), and both packages' float32 gradients there stray from the
# float64 one by up to ~3e-4 of the leaf's scale, more than atol 1e-5
GRAD_ATOL_OF_SCALE = {"deepseek-moe-16b": 1e-3, "qwen3-moe-235b-a22b": 0.0}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_aux_and_gradient_match_jax(model_pair, remat):
    """The factory's loss (cross-entropy + router_aux_loss · aux) and its
    gradient per leaf, the router's included, with the MoE layers
    rematerialised or not; the aux alone from `hidden_states`. Where a leaf
    gets atol of its own scale (deepseek, `GRAD_ATOL_OF_SCALE`), both
    packages' gradients are held to the same bound against the port's
    gradient in float64, so the slack is float32's in either package."""
    arch, _, jparams, _, params = model_pair
    cfg = reduced_config(arch).with_overrides(remat=remat)
    jcfg = jax_reduced_config(arch).with_overrides(remat=remat)
    bundle, jbundle = build_model(cfg, device="cpu"), jax_build_model(jcfg)
    batch = SyntheticLMDataset(cfg.vocab_size, SEQ, BATCH, seed=2).batch_at(0)
    want, jgrad = jax.jit(jax.value_and_grad(jbundle.loss_fn))(jparams, batch)
    got, grad = value_and_grad(bundle.loss_fn)(params,
                                               device_batch(batch, "cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    of_scale = GRAD_ATOL_OF_SCALE[arch]
    _assert_trees_close(grad, jgrad, rtol=1e-4, atol=1e-5,
                        atol_of_scale=of_scale)
    if of_scale:
        b64 = build_model(cfg.with_overrides(dtype="float64",
                                             param_dtype="float64"), "cpu")
        _, exact = value_and_grad(b64.loss_fn)(
            tree_map(torch.Tensor.double, params),
            device_batch(batch, "cpu"))
        for ours in (_np(grad), _jnp_flat(jgrad)):
            for key, x in _np(exact).items():
                np.testing.assert_allclose(
                    ours[key], x, rtol=1e-4,
                    atol=1e-5 + of_scale * np.abs(x).max(), err_msg=key)
    assert float(np.abs(np.asarray(
        jgrad["moe_blocks"]["moe"]["router"])).max()) > 0
    _, aux = moe.hidden_states(cfg, params, torch.tensor(batch["tokens"]))
    _, jaux = jmoe.hidden_states(jcfg, jparams, jnp.asarray(batch["tokens"]))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 0


def test_svrg_steps_match_jax_and_fused_matches_unfused(model_pair):
    """A snapshot over 2 batches, then 2 unfused SVRG steps against the JAX
    package's (loss rtol 1e-5, params rtol 1e-4, atol 1e-6), and the fused
    step (K1's plain version, one call per leaf, expert leaves viewed
    [numel/F, F]) against the unfused one from the same state (params rtol
    1e-5, atol 1e-6, metrics equal)."""
    arch, jbundle, _, bundle, _ = model_pair
    base = dict(steps=2, learning_rate=0.05, warmup_steps=1, log_every=50)
    tcfg = TrainConfig(svrg=SVRGConfig(snapshot_batches=2), **base)
    jtcfg = JaxTrainConfig(svrg=JaxSVRGConfig(snapshot_batches=2), **base)
    ds = SyntheticLMDataset(bundle.cfg.vocab_size, SEQ, BATCH, seed=3)
    jstate = jax_init_train_state(jax.random.PRNGKey(1), jbundle, jtcfg)
    state = convert.to_train_state(jstate, "cpu")
    begin, accum, fin = make_snapshot_fns(bundle, tcfg)
    jbegin, jaccum, jfin = (jax.jit(f) for f in
                            jax_make_snapshot_fns(jbundle, jtcfg))
    state, jstate = begin(state), jbegin(jstate)
    for j in range(2):
        state = accum(state, device_batch(ds.batch_at(j), "cpu"))
        jstate = jaccum(jstate, ds.batch_at(j))
    state, jstate = fin(state), jfin(jstate)
    fused = make_train_step(bundle, tcfg, use_fused_update=True)
    step = make_train_step(bundle, tcfg)
    jstep = jax.jit(jax_make_train_step(jbundle, jtcfg))
    for i in range(2):
        b = ds.batch_at(i + 2)
        sf, mf = fused(state, device_batch(b, "cpu"))
        state, m = step(state, device_batch(b, "cpu"))
        jstate, jm = jstep(jstate, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss step {i}")
        assert all(torch.equal(mf[k], m[k]) for k in m)
        for (k, a), (_, c) in zip(tree_flatten_with_path(sf.params),
                                  tree_flatten_with_path(state.params)):
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} step {i}")
    _assert_trees_close(state.params, jstate.params, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# The factory and the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_factory_builds_the_moe_bundle(arch):
    bundle = build_model(reduced_config(arch), device="cpu")
    assert bundle.param_defs == moe.param_defs(bundle.cfg)
    assert bundle.cache_defs(2, 8) == transformer.cache_defs(bundle.cfg, 2, 8)
    batch = bundle.make_inputs(2, 8, torch.Generator().manual_seed(0))
    assert sorted(batch) == ["mask", "targets", "tokens"]


def test_bf16_weights_serve_the_bits_of_cast_float32_ones():
    """Weights drawn in bf16 (what `launch.serve.run` draws for a bf16
    model) are the float32 draw cast, bit for bit: serving either gives
    the same logits."""
    cfg = dataclasses.replace(reduced_config("deepseek-moe-16b"),
                              dtype="bfloat16")
    from repro_torch.sharding.rules import init_from_defs
    f32 = build_model(cfg, device="cpu")
    b16 = build_model(cfg.with_overrides(param_dtype="bfloat16"), device="cpu")
    p32 = init_from_defs(torch.Generator().manual_seed(0), f32.param_defs)
    p16 = init_from_defs(torch.Generator().manual_seed(0), b16.param_defs)
    for (k, a), (_, b) in zip(tree_flatten_with_path(f32.cast(p32)),
                              tree_flatten_with_path(p16)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), k
