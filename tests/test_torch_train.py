"""The port's training path on the CPU against the JAX package's, from the
same numpy seeds and the same converted state: `lm_loss`, the training
forward and its gradient, the unfused train step for each optimizer (with
SVRG snapshots and microbatches), the snapshot pass, the fused SVRG step
against the unfused one (K1's plain version), the train loop with its
checkpoint resume, and the CLI.

Sizes are tests/test_train_loop.py's: 2 layers, d_model 32, vocab 128,
seq 32, batch 8; learning rate 0.05. float32 throughout. Tolerances:
losses rtol 1e-5 (one forward, summation order); gradients per leaf rtol
1e-4, atol 1e-6 and params after 3 steps the same (backward sums and the
optimizer's elementwise rounding differ between XLA:CPU and torch); the
fused step against the unfused one rtol 1e-5, atol 1e-6 (the same terms
rounded in another order).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SVRGConfig as JaxSVRGConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import reduced_config as jax_reduced_config
from repro.data.synthetic_lm import SyntheticLMDataset
from repro.models import layers as jnn
from repro.models.factory import build_model as jax_build_model
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.state import make_snapshot_fns as jax_make_snapshot_fns
from repro.train.state import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.config import SVRGConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.core.distributed import value_and_grad
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.kernels.svrg_update.ops import svrg_update
from repro_torch.models import layers as nn
from repro_torch.models import transformer
from repro_torch.models.factory import build_model
from repro_torch.sharding.rules import is_param_def
from repro_torch.train.loop import device_batch, train
from repro_torch.train.state import (
    init_train_state, make_snapshot_fns, make_train_state_defs,
    make_train_step)
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves, tree_map

# tests/test_train_loop.py's sizes; gemma3's pattern with one window-8
# layer and one global layer
OVERRIDES = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                 head_dim=16, d_ff=64, vocab_size=128, global_every=2)
SEQ, BATCH, LR = 32, 8, 0.05


def _configs(arch="gemma3-4b"):
    over = dict(OVERRIDES)
    if arch != "gemma3-4b":
        over.pop("global_every")
    return (reduced_config(arch).with_overrides(**over),
            jax_reduced_config(arch).with_overrides(**over))


@pytest.fixture(scope="module")
def models():
    cfg, jcfg = _configs()
    ds = SyntheticLMDataset(cfg.vocab_size, SEQ, BATCH)
    return build_model(cfg, device="cpu"), jax_build_model(jcfg), ds


def _tcfgs(**kw):
    svrg = kw.pop("svrg", {})
    base = dict(steps=3, learning_rate=LR, warmup_steps=1, log_every=50)
    base.update(kw)
    return (TrainConfig(svrg=SVRGConfig(**svrg), **base),
            JaxTrainConfig(svrg=JaxSVRGConfig(**svrg), **base))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree_flatten_with_path(tree)}


def _jnp_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p)))
                     for p in path): np.asarray(leaf) for path, leaf in flat}


def _assert_trees_close(got, want, rtol, atol, atol_of_scale=0.0):
    """Leaf by leaf; ``atol_of_scale`` adds that fraction of each leaf's
    largest magnitude to ``atol``."""
    got, want = _np(got), _jnp_flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        tol = atol + atol_of_scale * float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=tol,
                                   err_msg=key)


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# Config, loss and forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["TrainConfig", "SVRGConfig"])
def test_train_configs_are_the_jax_fields(name):
    import repro.config as jconfig
    import repro_torch.config as pconfig
    mine = [(f.name, f.default, f.default_factory)
            for f in dataclasses.fields(getattr(pconfig, name))]
    theirs = [(f.name, f.default, f.default_factory)
              for f in dataclasses.fields(getattr(jconfig, name))]
    assert [m[:2] for m in mine] == [t[:2] for t in theirs]
    assert [m[2] is dataclasses.MISSING for m in mine] == \
        [t[2] is dataclasses.MISSING for t in theirs]


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("chunk", [8, 12])
def test_lm_loss_and_its_gradient_match_jax(softcap, chunk):
    """chunk 8 divides S = 32 (4 checkpointed chunks); 12 does not (one
    block, as in the JAX package)."""
    B, S, D, V = 2, SEQ, 16, 40
    h, e = _normal((B, S, D), 1), _normal((V, D), 2, 0.3)
    t = np.random.default_rng(3).integers(0, V, (B, S)).astype(np.int32)
    m = (np.random.default_rng(4).random((B, S)) < 0.8).astype(np.float32)

    def jloss(h, e):
        return jnn.lm_loss(h, e, jnp.asarray(t), jnp.asarray(m), chunk=chunk,
                           softcap=softcap)

    want, (jgh, jge) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(e))
    th = torch.tensor(h, requires_grad=True)
    te = torch.tensor(e, requires_grad=True)
    got = nn.lm_loss(th, te, torch.tensor(t), torch.tensor(m), chunk=chunk,
                     softcap=softcap)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jge), rtol=1e-4,
                               atol=1e-6)


def _f64(bundle):
    """The same model with float64 params and activations."""
    cfg = bundle.cfg.with_overrides(dtype="float64", param_dtype="float64")
    return build_model(cfg, device="cpu")


def _double(tree):
    return tree_map(lambda x: x.double() if x.is_floating_point() else x,
                    tree)


@pytest.mark.parametrize("arch,atol_of_scale", [("gemma3-4b", 0.0),
                                                ("chatglm3-6b", 1e-4)])
def test_loss_fn_and_gradient_per_leaf_match_jax(arch, atol_of_scale):
    """At params carried from the JAX package's init: gemma3 (QK-norm,
    window and global layers, tied embeddings; rtol 1e-4, atol 1e-6) and
    chatglm3 (partial RoPE, qkv bias, an untied head). chatglm3's embedding
    gradient (no embedding scale, largest entry ~0.6) is a sum of float32
    backward passes whose rounding exceeds 1e-6 in either package: its
    leaves get atol 1e-4 of their own scale, as the caches do in
    tests/test_torch_models.py, and both packages' gradients are held to
    the same bound against the port's gradient in float64."""
    cfg, jcfg = _configs(arch)
    jbundle = jax_build_model(jcfg)
    bundle = build_model(cfg, device="cpu")
    jstate = jax_init_train_state(jax.random.PRNGKey(1), jbundle,
                                  JaxTrainConfig(optimizer="sgd"))
    params = convert.to_train_state(jstate, "cpu").params
    batch = SyntheticLMDataset(cfg.vocab_size, SEQ, BATCH, seed=2).batch_at(0)
    want, jgrad = jax.jit(jax.value_and_grad(jbundle.loss_fn))(
        jstate.params, batch)
    got, grad = value_and_grad(bundle.loss_fn)(params,
                                               device_batch(batch, "cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _assert_trees_close(grad, jgrad, rtol=1e-4, atol=1e-6,
                        atol_of_scale=atol_of_scale)
    if atol_of_scale:
        _, exact = value_and_grad(_f64(bundle).loss_fn)(
            _double(params), device_batch(batch, "cpu"))
        for ours in (_np(grad), _jnp_flat(jgrad)):
            for key, x in _np(exact).items():
                np.testing.assert_allclose(
                    ours[key], x, rtol=1e-4,
                    atol=1e-6 + atol_of_scale * np.abs(x).max(), err_msg=key)


def test_make_inputs_matches_jax_shapes(models):
    """The factory's concrete batch: the JAX package's keys, shapes and
    dtypes; tokens and targets in [0, vocab), mask ones, on the
    generator's device."""
    from repro.config import ShapeConfig
    bundle, jbundle, _ = models
    want = jbundle.make_inputs(ShapeConfig("t", "train", 24, 3),
                               jax.random.PRNGKey(0))
    got = bundle.make_inputs(3, 24, torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype) == f"torch.{want[key].dtype}", key
    for key in ("tokens", "targets"):
        assert 0 <= int(got[key].min()) and int(got[key].max()) < 128
    assert bool((got["mask"] == 1).all())


def test_hidden_states_never_calls_the_flash_kernel(models, monkeypatch):
    """The training forward attends in plain torch (K4 has no backward);
    prefill, through the same block body, still calls `gqa_flash` once
    per layer."""
    bundle, _, ds = models
    calls = []

    def spy(*args, **kw):
        calls.append(kw["window"])
        return gqa_flash(*args, **kw)

    monkeypatch.setattr(transformer, "gqa_flash", spy)
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(gen, bundle, _tcfgs(optimizer="sgd")[0])
    before = gqa_flash.launches
    batch = device_batch(ds.batch_at(0), "cpu")
    make_train_step(bundle, _tcfgs(optimizer="sgd")[0])(state, batch)
    assert calls == [] and gqa_flash.launches == before
    bundle.prefill_fn(state.params, batch, SEQ)
    assert calls == transformer._layer_flags(bundle.cfg).tolist()


def test_flash_kernel_refuses_to_run_under_autograd(monkeypatch):
    """On a CUDA tensor under grad, `gqa_flash` raises before it builds or
    launches anything: K4 has no backward. (The route is forced here; the
    card's own check is in tests/test_torch_cuda.py.)"""
    from repro_torch.kernels import dispatch
    monkeypatch.setattr(dispatch, "route", lambda *t: dispatch.CUDA)
    q = torch.zeros((1, 4, 2, 16), requires_grad=True)
    k = torch.zeros((1, 4, 1, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        gqa_flash(q, k, k, causal=True, window=0)


# ---------------------------------------------------------------------------
# Train step, snapshot, fused update
# ---------------------------------------------------------------------------

def _states(models, tcfg, jtcfg, seed=0):
    _, jbundle, _ = models
    jstate = jax_init_train_state(jax.random.PRNGKey(seed), jbundle, jtcfg)
    return convert.to_train_state(jstate, "cpu"), jstate


def _snapshot(models, tcfg, jtcfg, state, jstate):
    bundle, jbundle, ds = models
    begin, accum, fin = make_snapshot_fns(bundle, tcfg)
    jbegin, jaccum, jfin = (jax.jit(f) for f in
                            jax_make_snapshot_fns(jbundle, jtcfg))
    state, jstate = begin(state), jbegin(jstate)
    for j in range(tcfg.svrg.snapshot_batches):
        b = ds.batch_at(131 * 0 + j)
        state, jstate = accum(state, device_batch(b, "cpu")), jaccum(jstate, b)
    return fin(state), jfin(jstate)


@pytest.mark.parametrize("optimizer,microbatches", [
    ("sgd", 1), ("momentum", 1), ("adamw", 1), ("svrg", 1), ("svrg", 2)])
def test_train_step_matches_jax(models, optimizer, microbatches):
    """3 unfused steps from the same state (after one snapshot for SVRG):
    loss per step rtol 1e-5; params, optimizer state and SVRG state after
    the steps rtol 1e-4, atol 1e-6; lr and |v| per step rtol 1e-5.

    AdamW's params get atol 1e-5: its step m/(√v + eps) has the size of lr
    whatever the gradient's, so an entry whose gradient is at float32
    rounding level moves by a rounding-sized fraction of lr, differently in
    each package. Both packages' AdamW params are held to that bound
    against the port's own steps in float64."""
    bundle, jbundle, ds = models
    tcfg, jtcfg = _tcfgs(optimizer=optimizer, microbatches=microbatches,
                         svrg=dict(snapshot_batches=2))
    state, jstate = _states(models, tcfg, jtcfg)
    if optimizer == "svrg":
        state, jstate = _snapshot(models, tcfg, jtcfg, state, jstate)
    step = make_train_step(bundle, tcfg)
    jstep = jax.jit(jax_make_train_step(jbundle, jtcfg))
    for i in range(3):
        b = ds.batch_at(i + 1)
        state, m = step(state, device_batch(b, "cpu"))
        jstate, jm = jstep(jstate, b)
        for key in ("loss", "lr", "v_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key} step {i}")
    assert int(state.step) == int(jstate.step) == 3
    atol = 1e-5 if optimizer == "adamw" else 1e-6
    _assert_trees_close(state.params, jstate.params, rtol=1e-4, atol=atol)
    if optimizer == "adamw":
        exact, _ = _states(models, tcfg, jtcfg)
        exact = _double(exact)
        step64 = make_train_step(_f64(bundle), tcfg)
        for i in range(3):
            exact, _ = step64(exact, device_batch(ds.batch_at(i + 1), "cpu"))
        for ours in (_np(state.params), _jnp_flat(jstate.params)):
            for key, x in _np(exact.params).items():
                np.testing.assert_allclose(ours[key], x, rtol=1e-4,
                                           atol=atol, err_msg=key)
    _assert_trees_close(state.opt_state, jstate.opt_state, rtol=1e-4,
                        atol=1e-6)
    if optimizer == "svrg":
        _assert_trees_close(state.svrg, jstate.svrg, rtol=1e-4, atol=1e-6)


def test_snapshot_fns_match_jax(models):
    """begin / accumulate over 2 reference batches / finalize: g_snap (the
    mean gradient) rtol 1e-4, atol 1e-6; w_snap equal to the params and a
    distinct tensor from them at init."""
    tcfg, jtcfg = _tcfgs(svrg=dict(snapshot_batches=2))
    state, jstate = _states(models, tcfg, jtcfg, seed=3)
    assert all(a is not b and a.data_ptr() != b.data_ptr() for a, b in zip(
        tree_leaves(state.params), tree_leaves(state.svrg.w_snap)))
    state, jstate = _snapshot(models, tcfg, jtcfg, state, jstate)
    _assert_trees_close(state.svrg.g_snap, jstate.svrg.g_snap, rtol=1e-4,
                        atol=1e-6)
    assert int(state.svrg.accum_count) == 0 and int(state.svrg.snap_step) == 0
    for a, b in zip(tree_leaves(state.svrg.w_snap), tree_leaves(state.params)):
        assert torch.equal(a, b)
    assert sum(float(g.abs().sum()) for g in tree_leaves(state.svrg.g_snap)) > 0


@pytest.mark.parametrize("grad_clip,wd,microbatches", [
    (0.05, 0.0, 1), (0.05, 0.1, 1), (0.0, 0.1, 1), (0.05, 0.0, 2)])
def test_fused_step_matches_unfused(models, grad_clip, wd, microbatches):
    """The fused SVRG step (K1's plain version on the CPU, one call per
    leaf) against the unfused step, each step from the same state, with
    the clip active (|v| > grad_clip), off, with weight decay and with
    microbatches: params rtol 1e-5, atol 1e-6; loss, |v| and lr equal (|v|
    rtol 1e-6 with microbatches, where the fused step averages g and g0
    apart and the unfused step v)."""
    bundle, _, ds = models
    tcfg, _ = _tcfgs(grad_clip=grad_clip, weight_decay=wd,
                     microbatches=microbatches, svrg=dict(snapshot_batches=2))
    state = init_train_state(torch.Generator().manual_seed(4), bundle, tcfg)
    begin, accum, fin = make_snapshot_fns(bundle, tcfg)
    state = begin(state)
    for j in range(2):
        state = accum(state, device_batch(ds.batch_at(j), "cpu"))
    state = fin(state)
    fused = make_train_step(bundle, tcfg, use_fused_update=True)
    unfused = make_train_step(bundle, tcfg)
    for i in range(3):
        b = device_batch(ds.batch_at(i + 1), "cpu")
        before = svrg_update.launches
        sf, mf = fused(state, b)
        assert svrg_update.launches == before       # the plain version
        state, mu = unfused(state, b)
        assert torch.equal(mf["loss"], mu["loss"])
        assert torch.equal(mf["lr"], mu["lr"])
        if microbatches == 1:
            assert torch.equal(mf["v_norm"], mu["v_norm"])
        else:
            np.testing.assert_allclose(float(mf["v_norm"]),
                                       float(mu["v_norm"]), rtol=1e-6)
        if grad_clip:
            assert float(mu["v_norm"]) > grad_clip
        for (k, a), (_, c) in zip(tree_flatten_with_path(sf.params),
                                  tree_flatten_with_path(state.params)):
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} step {i}")


def test_fused_step_only_for_svrg(models):
    tcfg, _ = _tcfgs(optimizer="adamw")
    with pytest.raises(ValueError, match="svrg"):
        make_train_step(models[0], tcfg, use_fused_update=True)


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adamw", "svrg"])
def test_train_state_defs_mirror_the_state(models, optimizer):
    """`make_train_state_defs`: the shapes and dtypes of the state
    `init_train_state` draws, and of the JAX package's defs, leaf for
    leaf."""
    from repro.sharding.rules import ParamDef as JaxParamDef
    from repro.train.state import make_train_state_defs as jax_defs
    bundle, jbundle, _ = models
    tcfg, jtcfg = _tcfgs(optimizer=optimizer)
    state = init_train_state(torch.Generator().manual_seed(0), bundle, tcfg)
    defs = make_train_state_defs(bundle, tcfg)
    got = tree_map(lambda t: f"{tuple(t.shape)} {t.dtype}", state)
    want = tree_map(lambda d: f"{tuple(d.shape)} torch.{d.dtype}", defs,
                    is_leaf=is_param_def)
    assert tree_flatten_with_path(got) == tree_flatten_with_path(want)
    theirs = jax.tree_util.tree_leaves(
        jax_defs(jbundle, jtcfg),
        is_leaf=lambda x: isinstance(x, JaxParamDef))
    assert [f"{tuple(d.shape)} torch.{d.dtype}" for d in theirs] == \
        [leaf for _, leaf in tree_flatten_with_path(want)]


# ---------------------------------------------------------------------------
# Loop, resume, CLI
# ---------------------------------------------------------------------------

def _loop_tcfg(steps, ckdir="", **kw):
    return TrainConfig(
        steps=steps, optimizer="svrg", learning_rate=1.0, warmup_steps=2,
        schedule="constant", checkpoint_dir=ckdir, checkpoint_every=5,
        svrg=SVRGConfig(snapshot_every=10, snapshot_batches=2), **kw)


def test_svrg_training_decreases_loss(models):
    """tests/test_train_loop.py's check over 20 SVRG steps."""
    bundle, _, ds = models
    losses = []
    train(bundle, _loop_tcfg(20, log_every=50), ds.batch_at,
          hooks=lambda s, m: losses.append(m["loss"]))
    assert len(losses) == 2 and losses[-1] < losses[0] - 0.2, losses


def test_resume_after_failure_equals_uninterrupted_run(models, tmp_path):
    """A run that fails at step 12 (checkpoints at 5 and 10), resumed to
    20, ends with the params, SVRG state and step of an uninterrupted
    20-step run, bit for bit."""
    bundle, _, ds = models
    ckdir = str(tmp_path / "ck")

    def fail_at_12(step, m):
        if step == 12:
            raise KeyboardInterrupt("simulated failure")

    with pytest.raises(KeyboardInterrupt):
        train(bundle, _loop_tcfg(20, ckdir, log_every=1), ds.batch_at,
              hooks=fail_at_12)
    from repro_torch.checkpoint import Checkpointer
    assert Checkpointer(ckdir).list_steps() == [5, 10]
    seen = []
    resumed = train(bundle, _loop_tcfg(20, ckdir, log_every=1), ds.batch_at,
                    hooks=lambda s, m: seen.append(s))
    assert seen == list(range(10, 20))
    straight = train(bundle, _loop_tcfg(20, log_every=50), ds.batch_at)
    for (k, a), (_, b) in zip(tree_flatten_with_path(resumed),
                              tree_flatten_with_path(straight)):
        assert torch.equal(a, b), k


def test_train_cli_runs_on_the_cpu():
    """`python -m repro_torch.launch.train --arch gemma3-4b --reduced
    --device cpu --steps 3` exits 0 and reports its rates on the CPU."""
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma3-4b", "--reduced", "--device", "cpu", "--steps", "3"],
        cwd=repo, env={**os.environ, "PYTHONPATH": str(repo / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "steps/s" in proc.stderr and "tokens/s on cpu" in proc.stderr
