"""The port's SSM family (falcon-mamba-7b) on the CPU against the JAX
package's, on the same inputs: the configs and param defs, `_ssm_params`,
`selective_scan` at one chunk and at several (``CHUNK`` patched to 8 in
both packages' modules by monkeypatch: S = 24 is 3 chunks of 8, S = 20
halves the chunk to 4 and makes 5), from zero or a carried state, prefill
at one chunk and at several and decode steps (the recurrence at S = 1),
every cache leaf, the loss and the gradient of every leaf (5 chunks,
rematerialised or not), two SVRG train steps, the factory and both CLIs;
the JAX weights carried across by `convert.to_model_params`. The causal
conv and the scan are `rglru`'s, tested in tests/test_torch_rglru.py.

Tolerances, float32: `_ssm_params` rtol 1e-4, atol 1e-5; `selective_scan`
rtol 1e-4 with atol 1e-6 of the output's scale (y and the state reach the
thousands, sums of dt·x·B terms that cancel to small entries, whose
float32 rounding is a fraction of the terms, not of the entry); the loss
rtol 1e-5; the fused SVRG step against the unfused one
rtol 1e-5, atol 1e-6.

Looser limits, and why. The init rule's std 1/sqrt(L) is 1/2 in the
4-layer stack, and the SSM's output reaches the thousands (dt·x·B summed
over the state), so float32 rounding shows at 1e-5 of a leaf's scale.
Each comparison with the JAX package is paired with one against the
port's own float64 run of the same function (float64 outside the
function's own float32 points: the norms and the SSM), and both are held
in terms of the leaf's scale (its largest magnitude): prefill and decode
logits and caches within 2e-4 of the JAX package's and 1e-4 of the
float64 run's (measured: 8.2e-5 and 3.6e-5); gradients, and each leaf's
change over the SVRG steps, rtol 1e-4, atol 1e-6 plus 3e-4 of the scale
of the JAX package's and 2e-4 of the float64 run's (measured against the
float64 run: 7.2e-5 for the port, 2.9e-5 for the JAX package).
"""
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
from repro.models import mamba as jmamba
from repro.models.factory import build_model as jax_build_model
from repro.sharding.rules import init_from_defs as jax_init_from_defs
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.state import make_snapshot_fns as jax_make_snapshot_fns
from repro.train.state import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.config import SVRGConfig, TrainConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.distributed import value_and_grad
from repro_torch.launch import serve, train
from repro_torch.models import mamba
from repro_torch.models.factory import build_model
from repro_torch.train.loop import device_batch
from repro_torch.train.state import make_snapshot_fns, make_train_step
from repro_torch.utils.tree import tree_flatten_with_path, tree_map

ARCH = "falcon-mamba-7b"
RTOL, ATOL, GRAD_ATOL = 1e-4, 1e-5, 1e-6
# (against the JAX package, against the port in float64), of the scale
SERVE_OF_SCALE = (2e-4, 1e-4)
GRAD_OF_SCALE = (3e-4, 2e-4)


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _close_of_scale(got, want, of_scale, msg, rtol=0.0, atol=0.0):
    """Within ``rtol`` and ``atol`` plus ``of_scale`` of want's largest
    magnitude."""
    want = np.asarray(want, np.float64)
    _close(np.asarray(got, np.float64), want, rtol=rtol,
           atol=atol + of_scale * float(np.abs(want).max()), msg=msg)


def _f64(cfg, params):
    """The bundle and params of ``cfg`` in float64."""
    return (build_model(cfg.with_overrides(dtype="float64",
                                           param_dtype="float64"), "cpu"),
            tree_map(torch.Tensor.double, params))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: tree}


@pytest.fixture
def chunk8(monkeypatch):
    """CHUNK 8 in the JAX package's module and the port's alike."""
    monkeypatch.setattr(jmamba, "CHUNK", 8)
    monkeypatch.setattr(mamba, "CHUNK", 8)


# ---------------------------------------------------------------------------
# Configs and param defs
# ---------------------------------------------------------------------------

def test_configs_equal_jax_field_for_field():
    assert get_config(ARCH).to_dict() == jax_get_config(ARCH).to_dict()
    assert reduced_config(ARCH).to_dict() == jax_reduced_config(ARCH).to_dict()
    cfg = reduced_config(ARCH)
    assert (cfg.num_layers, cfg.ssm_state, cfg.dt_rank_actual, cfg.d_inner) \
        == (4, 4, 8, 256)


def test_param_defs_equal_jax():
    """Full width: the same keys, shapes, axes, inits and dtypes, and the
    same cache defs (64 layers, d_inner 8192, N 16)."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    for mine, theirs in ((mamba.param_defs(cfg), jmamba.param_defs(jcfg)),
                         (mamba.cache_defs(cfg, 4, 2064),
                          jmamba.cache_defs(jcfg, 4, 2064))):
        mine, theirs = _flat(mine), _flat(theirs)
        assert sorted(mine) == sorted(theirs)
        for path, d in mine.items():
            t = theirs[path]
            assert (d.shape, d.axes, d.init, d.scale, d.dtype) == \
                (t.shape, t.axes, t.init, t.scale, t.dtype), path
    assert _flat(mamba.cache_defs(cfg, 4, 2064))["/ssm"].shape == \
        (64, 4, 8192, 16)


# ---------------------------------------------------------------------------
# The SSM's parameters and the selective scan alone
# ---------------------------------------------------------------------------

def _layer_params(seed=0):
    """The first layer's params of the reduced config, drawn by the JAX
    package's init and perturbed (every entry nonzero)."""
    jcfg = jax_reduced_config(ARCH)
    p = jax.tree.map(lambda x: np.asarray(x[0]), jax_init_from_defs(
        jax.random.PRNGKey(seed), jmamba.param_defs(jcfg)["blocks"]))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda x: x + (0.05 * rng.standard_normal(x.shape)
                                       ).astype(np.float32), p)


def test_ssm_params_match_jax():
    """dA, dBx and C of a post-conv input, dt spanning softplus's range."""
    p = _layer_params()
    x = _normal((2, 6, 256), 1, scale=2.0)
    want = jmamba._ssm_params(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                              jax_reduced_config(ARCH))
    got = mamba._ssm_params(torch.tensor(x), convert.to_model_params(
        p, "cpu"), reduced_config(ARCH))
    assert [tuple(t.shape) for t in got] == [(2, 6, 256, 4)] * 2 + [(2, 6, 4)]
    for name, g, w in zip(("dA", "dBx", "C"), got, want):
        _close(g, w, msg=name)


@pytest.mark.parametrize("S,with_h0", [(8, False), (24, True), (20, False),
                                       (20, True)])
def test_selective_scan_matches_jax(chunk8, S, with_h0):
    """One chunk (S = 8), 3 chunks of 8 (S = 24), and 5 chunks of 4
    (S = 20: the halving rule), from zero or a carried state."""
    p = _layer_params()
    x = _normal((2, S, 256), 2)
    h0 = _normal((2, 256, 4), 3) if with_h0 else None
    want_y, want_h = jmamba.selective_scan(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p),
        jax_reduced_config(ARCH), None if h0 is None else jnp.asarray(h0))
    got_y, got_h = mamba.selective_scan(
        torch.tensor(x), convert.to_model_params(p, "cpu"),
        reduced_config(ARCH), None if h0 is None else torch.tensor(h0))
    assert got_h.dtype == torch.float32 and got_y.shape == (2, S, 256)
    _close_of_scale(got_y, want_y, 1e-6, "y", rtol=RTOL)
    _close_of_scale(got_h, want_h, 1e-6, "h", rtol=RTOL)


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_pair():
    jbundle = jax_build_model(jax_reduced_config(ARCH))
    jparams = jax_init_from_defs(jax.random.PRNGKey(0), jbundle.param_defs)
    leaves, treedef = jax.tree.flatten(jparams)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + (0.05 * rng.standard_normal(x.shape)
                               ).astype(np.float32) for x in leaves]
    jparams = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    bundle = build_model(reduced_config(ARCH), device="cpu")
    params = convert.to_model_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jbundle, jparams, bundle, params


def test_to_model_params_carries_the_ssm_tree(model_pair):
    _, jparams, bundle, params = model_pair
    got = {k: (tuple(v.shape), str(v.dtype)) for k, v in
           tree_flatten_with_path(params)}
    want = {k: (tuple(v.shape), f"torch.{v.dtype}") for k, v in
            _flat(jax.tree.map(np.asarray, jparams)).items()}
    assert {"/" + k: v for k, v in got.items()} == want
    assert {k: (tuple(d.shape), f"torch.{d.dtype}") for k, d in
            _flat(bundle.param_defs).items()} == want


DECODE_STEPS = 4


@pytest.mark.parametrize("S", [5, 24])
def test_prefill_and_decode_match_jax(model_pair, chunk8, S):
    """A prompt of one chunk (5) and of 3 chunks of 8 (24), then 4 decode
    steps: logits and every cache leaf after each call, against the JAX
    package and the port's float64 run."""
    jbundle, jparams, bundle, params = model_pair
    b64, p64 = _f64(bundle.cfg, params)
    V = bundle.cfg.vocab_size
    cache_len = S + DECODE_STEPS
    toks = np.random.default_rng(S).integers(
        0, V, (2, cache_len)).astype(np.int32)
    prompt = {"tokens": torch.tensor(toks[:, :S])}
    jlogits, jcache = jbundle.prefill_fn(
        jparams, {"tokens": jnp.asarray(toks[:, :S])}, cache_len)
    logits, cache = bundle.prefill_fn(params, prompt, cache_len)
    logits64, cache64 = b64.prefill_fn(p64, prompt, cache_len)
    assert logits.dtype == torch.float32 and logits.shape == (2, V)
    assert sorted(cache) == sorted(jcache) == ["conv", "ssm"]
    for name in cache:
        assert cache[name].shape == jcache[name].shape, name
        assert str(cache[name].dtype) == f"torch.{jcache[name].dtype}", name
    for step in range(DECODE_STEPS + 1):
        for name, got, want, exact in (
                ("logits", logits, jlogits, logits64),
                *((n, cache[n], jcache[n], cache64[n]) for n in cache)):
            msg = f"S {S} step {step} {name}"
            _close_of_scale(got, want, SERVE_OF_SCALE[0], f"{msg} vs JAX")
            _close_of_scale(got, exact, SERVE_OF_SCALE[1], f"{msg} vs f64")
        if step == DECODE_STEPS:
            break
        pos = S + step
        jlogits, jcache = jbundle.decode_fn(jparams, jcache,
                                            jnp.asarray(toks[:, pos]),
                                            jnp.asarray(pos, jnp.int32))
        tok = torch.tensor(toks[:, pos])
        logits, cache2 = bundle.decode_fn(params, cache, tok, pos)
        logits64, cache64 = b64.decode_fn(p64, cache64, tok, pos)
        assert cache2 is cache                   # updated in place


def test_no_kernel_on_the_ssm_path(model_pair, monkeypatch):
    """Prefill, decode and the loss launch no kernel of the repo: no
    attention, and no `gqa_flash` call."""
    from repro_torch.models import transformer

    _, _, bundle, params = model_pair
    calls = []
    monkeypatch.setattr(transformer, "gqa_flash",
                        lambda *a, **kw: calls.append(kw))
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, bundle.cfg.vocab_size, (2, 16)))
    batch = {"tokens": toks, "targets": toks,
             "mask": torch.ones(toks.shape, dtype=torch.float32)}
    bundle.loss_fn(params, batch)
    _, cache = bundle.prefill_fn(params, batch, 17)
    bundle.decode_fn(params, cache, toks[:, 0], 16)
    assert calls == []


# ---------------------------------------------------------------------------
# Training: loss, gradients, SVRG steps
# ---------------------------------------------------------------------------

def _np(tree):
    return {k: np.asarray(v) for k, v in tree_flatten_with_path(tree)}


def _jnp_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p)))
                     for p in path): np.asarray(leaf) for path, leaf in flat}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradient_match_jax(model_pair, chunk8, remat):
    """S = 20: every layer's selective scan takes 5 chunks of 4,
    rematerialised chunk by chunk under grad, and with ``remat="full"``
    each layer too.
    The loss, and the gradient of every leaf against the JAX package's and
    the port's float64 one."""
    _, jparams, _, params = model_pair
    cfg = reduced_config(ARCH).with_overrides(remat=remat)
    jbundle = jax_build_model(jax_reduced_config(ARCH).with_overrides(
        remat=remat))
    bundle = build_model(cfg, device="cpu")
    batch = SyntheticLMDataset(cfg.vocab_size, 20, 2, seed=2).batch_at(0)
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jbundle.loss_fn(p, b)))(jparams, batch)
    got, grad = value_and_grad(bundle.loss_fn)(params,
                                               device_batch(batch, "cpu"))
    b64, p64 = _f64(cfg, params)
    _, exact = value_and_grad(b64.loss_fn)(p64, device_batch(batch, "cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    got, want, exact = _np(grad), _jnp_flat(jgrad), _np(exact)
    assert sorted(got) == sorted(want) == sorted(exact)
    for key in want:
        _close_of_scale(got[key], want[key], GRAD_OF_SCALE[0], f"{key} vs JAX",
                        rtol=RTOL, atol=GRAD_ATOL)
        _close_of_scale(got[key], exact[key], GRAD_OF_SCALE[1],
                        f"{key} vs f64", rtol=RTOL, atol=GRAD_ATOL)
    assert float(np.abs(np.asarray(jgrad["blocks"]["A_log"])).max()) > 0


def test_svrg_steps_match_jax_and_fused_matches_unfused(model_pair):
    """A snapshot over 2 batches, then 2 unfused SVRG steps against the JAX
    package's (loss rtol 1e-5; each leaf's change over the steps as its
    gradient, rtol 1e-4, atol 1e-6 plus 3e-4 of the change's scale), and
    the fused step (K1's plain version, one call per leaf) against the
    unfused one from the same state (params rtol 1e-5, atol 1e-6, metrics
    equal)."""
    jbundle, _, bundle, _ = model_pair
    base = dict(steps=2, learning_rate=0.05, warmup_steps=1, log_every=50)
    tcfg = TrainConfig(svrg=SVRGConfig(snapshot_batches=2), **base)
    jtcfg = JaxTrainConfig(svrg=JaxSVRGConfig(snapshot_batches=2), **base)
    ds = SyntheticLMDataset(bundle.cfg.vocab_size, 32, 4, seed=3)
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
    start = _np(state.params)
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
            _close(a, c, rtol=1e-5, atol=1e-6, msg=f"{k} step {i}")
    got, want = _np(state.params), _jnp_flat(jstate.params)
    assert sorted(got) == sorted(want)
    for key, p0 in start.items():
        _close_of_scale(got[key] - p0, want[key] - p0, GRAD_OF_SCALE[0], key,
                        rtol=RTOL, atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# The factory and the CLIs
# ---------------------------------------------------------------------------

def test_factory_builds_the_ssm_bundle():
    bundle = build_model(reduced_config(ARCH), device="cpu")
    assert bundle.param_defs == mamba.param_defs(bundle.cfg)
    assert bundle.cache_defs(2, 8) == mamba.cache_defs(bundle.cfg, 2, 8)
    batch = bundle.make_inputs(2, 8, torch.Generator().manual_seed(0))
    assert sorted(batch) == ["mask", "targets", "tokens"]


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "12", "--new-tokens", "3"])
    out, err = capsys.readouterr()
    assert "tok/s) on cpu" in err
    assert out.count("[") == 3                  # a [2, 3] array of tokens


def test_train_cli_runs_on_the_cpu(capsys):
    train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                "3", "--seq", "16", "--batch", "2"])
    err = capsys.readouterr().err
    assert "steps/s" in err and "tokens/s on cpu" in err
