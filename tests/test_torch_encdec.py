"""The port's encoder-decoder family (whisper-large-v3) on the CPU against
the JAX package's, on the same inputs: the configs and param defs, the
sinusoid, `encode` (every padded row included), prefill logits and every
cache leaf, four decode steps, the loss and the gradient of every leaf,
two SVRG steps (fused against unfused), `generate`'s tokens, the factory,
the serve session and both CLIs.

Both packages run the reduced config with ``encoder_seq`` 13: the JAX
reduction's 16 frames pad to 16, so its pad mask would never be
exercised; 13 frames pad to 16, and the 3 padded frames must drop out of
the encoder's and the cross-attention's sums. The JAX weights are carried
across by `convert.to_model_params`, with every bias and layernorm
parameter overwritten by numpy draws from a seed, so none is 0 or 1; the
frame embeddings are numpy draws.

Tolerances, float32 (tests/test_torch_models.py's): logits rtol 1e-4, atol
1e-4; the encoder's output and the caches rtol 1e-4 with atol 1e-4 of the
tensor's own scale (its largest magnitude); the loss rtol 1e-5; params
after SVRG steps rtol 1e-5, atol 1e-6 (fused against unfused). Prefill
attention is the flash kernel's plain version here, the plain attention in
JAX.

Gradients: rtol 1e-4, atol 1e-6 plus 5e-3 of the leaf's scale, against
the JAX package's and against the port's own float64 run. The init rule's
std 1/sqrt(L) (0.5 to 0.7 for these 2- and 4-layer stacks) saturates the
softmaxes, and float32 shows in the gradients: measured, the port lies
up to 2.7e-3 of the leaf's scale from the float64 run, the JAX package
1.6e-3, and the two 1.9e-3 from each other. The k biases' gradients are 0 in exact arithmetic (a bias on
every key shifts a row's scores alike) and ~1e-9 here: atol 1e-6 holds
them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.data.synthetic_lm import SyntheticLMDataset
from repro.models import encdec as jencdec
from repro.models.factory import _lm_inputs as jax_lm_inputs
from repro.models.factory import build_model as jax_build_model
from repro.serve.loop import generate as jax_generate
from repro.sharding.rules import init_from_defs as jax_init_from_defs
from repro_torch import convert
from repro_torch.config import SVRGConfig, TrainConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.distributed import value_and_grad
from repro_torch.launch import serve, train
from repro_torch.models import encdec
from repro_torch.models.factory import build_model
from repro_torch.serve.loop import ServeSession, generate
from repro_torch.train.loop import device_batch
from repro_torch.train.state import (init_train_state, make_snapshot_fns,
                                     make_train_step)
from repro_torch.utils.tree import tree_flatten_with_path, tree_map

ARCH = "whisper-large-v3"
ENC_SEQ = 13          # pads to 16: 3 padded frames
RTOL, ATOL = 1e-4, 1e-4
GRAD_OF_SCALE = 5e-3


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _close_of_scale(got, want, msg, of_scale=1e-4, rtol=RTOL, atol=0.0):
    want = np.asarray(want)
    _close(got, want, rtol=rtol, atol=atol + of_scale * float(
        np.abs(want).max()), msg=msg)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: tree}


def _jnp_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_key(path): np.asarray(leaf) for path, leaf in flat}


def _cfgs(**kw):
    return (reduced_config(ARCH).with_overrides(encoder_seq=ENC_SEQ, **kw),
            jax_reduced_config(ARCH).with_overrides(encoder_seq=ENC_SEQ, **kw))


def _feats(cfg, B, seed):
    return _normal((B, cfg.encoder_seq, cfg.encoder_feature_dim), seed)


# ---------------------------------------------------------------------------
# Configs, param defs, the sinusoid
# ---------------------------------------------------------------------------

def test_configs_equal_jax_field_for_field():
    assert get_config(ARCH).to_dict() == jax_get_config(ARCH).to_dict()
    assert reduced_config(ARCH).to_dict() == jax_reduced_config(ARCH).to_dict()


def test_param_and_cache_defs_equal_jax():
    """Full width: the same keys, shapes, axes, inits and dtypes; the
    cross caches over the 1504 padded frames."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    for mine, theirs in ((encdec.param_defs(cfg), jencdec.param_defs(jcfg)),
                         (encdec.cache_defs(cfg, 4, 464),
                          jencdec.cache_defs(jcfg, 4, 464))):
        mine, theirs = _flat(mine), _flat(theirs)
        assert sorted(mine) == sorted(theirs)
        for path, d in mine.items():
            t = theirs[path]
            assert (d.shape, d.axes, d.init, d.scale, d.dtype) == \
                (t.shape, t.axes, t.init, t.scale, t.dtype), path
    assert encdec.enc_seq_padded(cfg) == jencdec.enc_seq_padded(jcfg) == 1504
    assert _flat(encdec.cache_defs(cfg, 4, 464))["/xk"].shape == \
        (32, 4, 20, 1504, 64)


@pytest.mark.parametrize("S,dim", [(1504, 1280), (16, 128), (5, 2)])
def test_sinusoid_matches_jax(S, dim):
    """Positions up to 1503. The angle pos·freq is float32, and XLA's and
    torch's exp may give freq an ulp apart, so the angles (up to ~1.5e3
    rad) differ by an ulp of their size: atol 2 ulps of float32(S), 2.4e-4
    at S 1504, 3.8e-6 at 16."""
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    _close(encdec._sinusoid(torch.tensor(pos), dim),
           jencdec._sinusoid(jnp.asarray(pos), dim), rtol=0,
           atol=2 * float(np.spacing(np.float32(S))))


def test_sinusoid_frequencies_within_an_ulp_of_jax():
    """The table is not bit-equal to the JAX package's: XLA's float32 exp
    and torch's round apart on some frequencies (48 of 640 at d_model
    1280), never by more than one ulp. `_sinusoid` computes on the CPU
    whatever the positions' device, so the card and the CPU path share
    one table (tests/test_torch_cuda.py holds that on the card)."""
    half = 640
    step = np.float32(np.log(np.float32(1e4))) / np.float32(half - 1)
    arg = -np.arange(half, dtype=np.float32) * step
    mine = encdec._sinusoid(torch.zeros((1, 1), dtype=torch.int32), 2 * half)
    assert mine.device.type == "cpu"
    theirs = np.asarray(jnp.exp(jnp.asarray(arg)))
    freqs = torch.exp(torch.as_tensor(arg)).numpy()
    ulps = np.abs(freqs.view(np.int32) - theirs.view(np.int32))
    assert ulps.max() <= 1


@pytest.mark.parametrize("n,dim", [(1504, 1280), (5000, 64)])
def test_sinusoid_table_is_resident_and_matches_jax(n, dim):
    """The table the encoder and every decode step index: positions 0 ..
    n'-1 in whole blocks, the same tensor on later calls (nothing is
    recomputed or copied per token), each row within the tolerance of
    `test_sinusoid_matches_jax` of the JAX package's."""
    table = encdec._sinusoid_table(n, dim, "cpu")
    rows = table.shape[0]
    assert rows >= n and rows % encdec._TABLE_BLOCK == 0
    assert table.shape == (rows, dim) and table.dtype == torch.float32
    assert encdec._sinusoid_table(n - 1, dim, "cpu") is table
    pos = np.arange(n, dtype=np.int32)[None]
    _close(table[:n][None], jencdec._sinusoid(jnp.asarray(pos), dim),
           rtol=0, atol=2 * float(np.spacing(np.float32(n))))


# ---------------------------------------------------------------------------
# The model, reduced, with 3 padded frames
# ---------------------------------------------------------------------------

def _key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)


@pytest.fixture(scope="module")
def model_pair():
    cfg, jcfg = _cfgs()
    jbundle = jax_build_model(jcfg)
    jparams = jax_init_from_defs(jax.random.PRNGKey(0), jbundle.param_defs)
    defs = _flat(jbundle.param_defs)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jparams)
    # biases and layernorm params drawn: none is 0 or 1
    leaves = []
    for i, (path, x) in enumerate(flat):
        init = defs["/" + _key(path)].init
        x = np.asarray(x)
        if init == "zeros":
            x = _normal(x.shape, 100 + i, 0.3)
        elif init == "ones":
            x = 1.0 + _normal(x.shape, 100 + i, 0.1)
        leaves.append(jnp.asarray(x))
    jparams = jax.tree.unflatten(treedef, leaves)
    bundle = build_model(cfg, device="cpu")
    params = convert.to_model_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jbundle, jparams, bundle, params


def test_to_model_params_carries_the_encdec_tree(model_pair):
    _, jparams, bundle, params = model_pair
    got = {"/" + k: (tuple(v.shape), str(v.dtype)) for k, v in
           tree_flatten_with_path(params)}
    want = {k: (tuple(v.shape), f"torch.{v.dtype}") for k, v in
            _flat(jax.tree.map(np.asarray, jparams)).items()}
    assert got == want
    assert {k: (tuple(d.shape), f"torch.{d.dtype}") for k, d in
            _flat(bundle.param_defs).items()} == want
    assert float(np.abs(np.asarray(params["dec_blocks"]["xattn"]["bk"])).min()) > 0


@pytest.mark.parametrize("attend", ["flash", "plain"])
def test_encode_matches_jax_padded_rows_included(model_pair, attend):
    """All 16 rows, the 3 padded ones too, through the kernel's path (the
    valid keys' view) and the plain attention (masked by position)."""
    jbundle, jparams, bundle, params = model_pair
    feats = _feats(bundle.cfg, 2, 7)
    want = jencdec.encode(jbundle.cfg, jparams, jnp.asarray(feats))
    got = encdec.encode(bundle.cfg, params, torch.tensor(feats),
                        attend={"flash": encdec.flash_attend,
                                "plain": encdec.plain_attend}[attend])
    assert got.shape == (2, 16, bundle.cfg.d_model)
    _close_of_scale(got, want, "encode")


def test_counting_the_padded_frames_would_fail(model_pair):
    """The comparison above sees the pad: the encoder attending over all 16
    frames, the 3 padded ones counted, departs from the JAX package."""
    jbundle, jparams, bundle, params = model_pair
    feats = _feats(bundle.cfg, 2, 7)
    want = np.asarray(jencdec.encode(jbundle.cfg, jparams, jnp.asarray(feats)))

    def over_the_pad(q, k, v, pos_q, pos_k, *, causal, n_keys):
        return encdec.gqa_flash(q, k, v, causal=causal, window=0)

    got = encdec.encode(bundle.cfg, params, torch.tensor(feats),
                        attend=over_the_pad).numpy()
    assert np.abs(got - want).max() > 1e-2 * np.abs(want).max()


DECODE_STEPS = 4


def test_prefill_and_decode_match_jax(model_pair):
    jbundle, jparams, bundle, params = model_pair
    V = bundle.cfg.vocab_size
    S, cache_len = 10, 10 + DECODE_STEPS
    toks = np.random.default_rng(2).integers(
        0, V, (2, cache_len)).astype(np.int32)
    feats = _feats(bundle.cfg, 2, 9)
    jax_decode = jax.jit(jbundle.decode_fn)
    jlogits, jcache = jbundle.prefill_fn(
        jparams, {"tokens": jnp.asarray(toks[:, :S]),
                  "enc_feats": jnp.asarray(feats)}, cache_len)
    logits, cache = bundle.prefill_fn(
        params, {"tokens": torch.tensor(toks[:, :S]),
                 "enc_feats": torch.tensor(feats)}, cache_len)
    assert logits.dtype == torch.float32 and logits.shape == (2, V)
    assert sorted(cache) == sorted(jcache) == ["k", "v", "xk", "xv"]
    assert cache["xk"].shape == (4, 2, 4, 16, 32)
    for step in range(DECODE_STEPS + 1):
        _close(logits, jlogits, msg=f"logits step {step}")
        for name in cache:
            assert cache[name].shape == jcache[name].shape, name
            _close_of_scale(cache[name], jcache[name],
                            f"cache {name} step {step}")
        if step == DECODE_STEPS:
            break
        pos = S + step
        jlogits, jcache = jax_decode(jparams, jcache,
                                     jnp.asarray(toks[:, pos]),
                                     jnp.asarray(pos, jnp.int32))
        logits, cache2 = bundle.decode_fn(params, cache,
                                          torch.tensor(toks[:, pos]), pos)
        assert cache2 is cache                   # updated in place


def test_decode_matches_full_prefill(model_pair):
    """Decode at position S reproduces the prefill of S + 1 tokens (cache
    against recompute, tests/test_models_smoke.py's tolerance)."""
    _, _, bundle, params = model_pair
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, bundle.cfg.vocab_size, (2, 12)))
    feats = torch.tensor(_feats(bundle.cfg, 2, 10))
    _, cache = bundle.prefill_fn(params, {"tokens": toks[:, :11],
                                          "enc_feats": feats}, 12)
    dec, _ = bundle.decode_fn(params, cache, toks[:, 11], 11)
    full, _ = bundle.prefill_fn(params, {"tokens": toks, "enc_feats": feats},
                                12)
    torch.testing.assert_close(dec, full, atol=5e-4, rtol=1e-3)


def test_prefill_attends_through_the_flash_wrapper(model_pair, monkeypatch):
    """Prefill: one `gqa_flash` call per encoder layer (non-causal, 16
    queries over the 13 valid frames) and two per decoder layer (the
    causal self-attention, S over S; the cross-attention, non-causal, S
    over 13), 3 x 32 = 96 at full depth; training and decode: none."""
    _, _, bundle, params = model_pair
    calls = []
    real = encdec.gqa_flash

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"], kw["window"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(encdec, "gqa_flash", spy)
    cfg = bundle.cfg
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 9)))
    batch = {"tokens": toks, "targets": toks,
             "mask": torch.ones(toks.shape, dtype=torch.float32),
             "enc_feats": torch.tensor(_feats(cfg, 2, 11))}
    bundle.loss_fn(params, batch)
    assert calls == []
    _, cache = bundle.prefill_fn(params, batch, 10)
    assert calls == [(16, 13, False, 0)] * cfg.encoder_layers + \
        [(9, 9, True, 0), (9, 13, False, 0)] * cfg.num_layers
    bundle.decode_fn(params, cache, toks[:, 0], 9)
    assert len(calls) == cfg.encoder_layers + 2 * cfg.num_layers


def test_generate_equals_jax(model_pair):
    jbundle, jparams, bundle, params = model_pair
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                              bundle.cfg.vocab_size)
    feats = _feats(bundle.cfg, 2, 12)
    want = jax_generate(jbundle, jparams, {"tokens": toks,
                                           "enc_feats": jnp.asarray(feats)},
                        max_new_tokens=6, cache_len=14)
    got = generate(bundle, params, {"tokens": np.asarray(toks),
                                    "enc_feats": feats},
                   max_new_tokens=6, cache_len=14)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Training: loss, gradients, SVRG steps
# ---------------------------------------------------------------------------

def _batch(cfg, seq, B, seed, step):
    batch = SyntheticLMDataset(cfg.vocab_size, seq, B, seed=seed).batch_at(step)
    return {**batch, "enc_feats": _feats(cfg, B, 50 + step)}


def test_loss_and_gradient_match_jax(model_pair):
    """Rematerialised (the config's remat "full"): the loss, and the
    gradient of every leaf against the JAX package's and the port's own
    float64 one (see the header for the limits)."""
    _, jparams, _, params = model_pair
    cfg, jcfg = _cfgs(remat="full")
    jbundle = jax_build_model(jcfg)
    bundle = build_model(cfg, device="cpu")
    batch = _batch(cfg, 12, 2, 2, 0)
    want, jgrad = jax.jit(jax.value_and_grad(jbundle.loss_fn))(jparams, batch)
    got, grad = value_and_grad(bundle.loss_fn)(params,
                                               device_batch(batch, "cpu"))
    b64 = build_model(cfg.with_overrides(dtype="float64",
                                         param_dtype="float64"), "cpu")
    _, exact = value_and_grad(b64.loss_fn)(
        tree_map(torch.Tensor.double, params),
        {k: v.double() if v.is_floating_point() else v
         for k, v in device_batch(batch, "cpu").items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    got = {k: np.asarray(v) for k, v in tree_flatten_with_path(grad)}
    exact = {k: np.asarray(v) for k, v in tree_flatten_with_path(exact)}
    want = _jnp_flat(jgrad)
    assert sorted(got) == sorted(want) == sorted(exact)
    for key in want:
        for ref, name in ((want, "JAX"), (exact, "float64")):
            _close_of_scale(got[key], ref[key], f"{key} vs {name}",
                            of_scale=GRAD_OF_SCALE, atol=1e-6)
    assert float(np.abs(want["enc_in_proj"]).max()) > 0


def test_remat_gives_the_same_loss_and_gradient(model_pair):
    """Without rematerialisation the loss and every gradient are those of
    the rematerialised run (the same ops, recomputed)."""
    _, _, bundle, params = model_pair
    batch = device_batch(_batch(bundle.cfg, 12, 2, 2, 0), "cpu")
    runs = [value_and_grad(build_model(bundle.cfg.with_overrides(remat=r),
                                       "cpu").loss_fn)(params, batch)
            for r in ("none", "full")]
    (loss0, g0), (loss1, g1) = runs
    assert float(loss0) == float(loss1)
    for (k, a), (_, b) in zip(tree_flatten_with_path(g0),
                              tree_flatten_with_path(g1)):
        _close(a, b, rtol=1e-6, atol=1e-9, msg=k)


def test_fused_svrg_step_matches_unfused(model_pair):
    """A snapshot over 2 batches, then 2 SVRG steps: the fused step (K1's
    plain version here, one call per leaf) against the unfused one from
    the same state (params rtol 1e-5, atol 1e-6, metrics equal); the
    losses finite. The loss and its gradient are held to the JAX
    package's above."""
    _, _, bundle, _ = model_pair
    tcfg = TrainConfig(steps=2, learning_rate=0.05, warmup_steps=1,
                       svrg=SVRGConfig(snapshot_batches=2))
    state = init_train_state(torch.Generator().manual_seed(1), bundle, tcfg)
    begin, accum, fin = make_snapshot_fns(bundle, tcfg)
    state = begin(state)
    for j in range(2):
        state = accum(state, device_batch(_batch(bundle.cfg, 16, 2, 3, j),
                                          "cpu"))
    state = fin(state)
    fused = make_train_step(bundle, tcfg, use_fused_update=True)
    step = make_train_step(bundle, tcfg)
    for i in range(2):
        b = device_batch(_batch(bundle.cfg, 16, 2, 3, i + 2), "cpu")
        sf, mf = fused(state, b)
        state, m = step(state, b)
        assert bool(torch.isfinite(m["loss"]))
        assert all(torch.equal(mf[k], m[k]) for k in m)
        for (k, a), (_, c) in zip(tree_flatten_with_path(sf.params),
                                  tree_flatten_with_path(state.params)):
            _close(a, c, rtol=1e-5, atol=1e-6, msg=f"{k} step {i}")


# ---------------------------------------------------------------------------
# The factory, the serve session and the CLIs
# ---------------------------------------------------------------------------

def test_factory_builds_the_encdec_bundle():
    cfg = reduced_config(ARCH)
    bundle = build_model(cfg, device="cpu")
    assert bundle.param_defs == encdec.param_defs(cfg)
    assert bundle.cache_defs(2, 8) == encdec.cache_defs(cfg, 2, 8)


def test_make_inputs_extras_equal_jax_concrete_inputs():
    cfg = reduced_config(ARCH)
    got = build_model(cfg, device="cpu").make_inputs(
        2, 8, torch.Generator().manual_seed(0))
    jcfg = jax_reduced_config(ARCH)
    want = jax_lm_inputs(jcfg, 2, 8, concrete=True, key=jax.random.PRNGKey(0),
                         extra={"enc_feats": (jcfg.encoder_seq,
                                              jcfg.encoder_feature_dim)})
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        assert str(got[name].dtype) == f"torch.{want[name].dtype}", name
    np.testing.assert_array_equal(got["enc_feats"].numpy(),
                                  np.asarray(want["enc_feats"]))


def test_session_prefill_forwards_the_frames(model_pair, monkeypatch):
    """`ServeSession.prefill` hands the prefill every input of the batch,
    each as a tensor on the bundle's device (numpy in, torch out)."""
    _, _, bundle, params = model_pair
    seen = {}
    real = bundle.prefill_fn

    def spy(p, batch, cache_len):
        seen.update(batch)
        return real(p, batch, cache_len)

    monkeypatch.setattr(bundle, "prefill_fn", spy)
    feats = _feats(bundle.cfg, 2, 13)
    sess = ServeSession(bundle, params, cache_len=8)
    sess.prefill({"tokens": np.ones((2, 5), np.int32), "enc_feats": feats})
    assert sorted(seen) == ["enc_feats", "tokens"] and sess.pos == 5
    assert isinstance(seen["enc_feats"], torch.Tensor)
    np.testing.assert_array_equal(seen["enc_feats"].numpy(), feats)


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "12", "--new-tokens", "3"])
    out, err = capsys.readouterr()
    assert "tok/s) on cpu" in err
    assert out.count("[") == 3                  # a [2, 3] array of tokens


def test_serve_run_feeds_the_jax_cli_ones():
    res = serve.run(ARCH, reduced=True, batch=2, prompt_len=6, new_tokens=2,
                    device="cpu")
    feats = res["batch"]["enc_feats"]
    cfg = res["cfg"]
    assert feats.shape == (2, cfg.encoder_seq, cfg.encoder_feature_dim)
    assert feats.dtype == torch.float32 and bool((feats == 1).all())


def test_train_cli_runs_on_the_cpu(capsys):
    train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                "3", "--seq", "16", "--batch", "2"])
    err = capsys.readouterr().err
    assert "steps/s" in err and "tokens/s on cpu" in err
