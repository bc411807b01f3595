"""The port's dense transformer on the CPU against the JAX package's, on the
same inputs: the configs, the layers, and prefill / decode of the reduced
forms of the four dense architectures with the JAX weights carried across
by `convert.to_model_params`.

Tolerance, float32: logits rtol 1e-4, atol 1e-4 (matmul summation order
and transcendental rounding differ between XLA:CPU and torch; prefill
attention is the flash kernel's plain version here, the plain attention in
JAX). Caches rtol 1e-4 with atol 1e-4 of the cache's own scale (its largest
magnitude): the init rule's std 1/sqrt(L) makes K and V reach ~25, and the
two packages' rounding differences grow with depth to ~1e-5 of that scale
in the fourth layer, more than 1e-4 on its small entries. The layers alone
at 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import layers as jnn
from repro.models import transformer as jtf
from repro.models.factory import build_model as jax_build_model
from repro.sharding.rules import init_from_defs as jax_init_from_defs
from repro_torch import convert
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config, list_configs, reduced_config
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tf
from repro_torch.models.factory import build_model
from repro_torch.sharding.rules import ParamDef, init_from_defs

DENSE = ["chatglm3-6b", "command-r-plus-104b", "gemma3-4b", "stablelm-12b"]
# every arch the port registers: the dense ones, the mixture-of-experts
# ones, the encoder-decoder and vision ones, the hybrid and SSM ones and
# the paper's logistic regression
PORTED = sorted(DENSE + ["deepseek-moe-16b", "qwen3-moe-235b-a22b",
                         "whisper-large-v3", "llama-3.2-vision-11b",
                         "recurrentgemma-2b", "falcon-mamba-7b",
                         "paper-logreg"])


def _normal(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# Configs and param defs
# ---------------------------------------------------------------------------

def test_registry_holds_the_dense_configs():
    """The dense configs, and beside them the other ported families'."""
    assert list_configs() == PORTED
    assert set(DENSE) < set(list_configs())


@pytest.mark.parametrize("arch", DENSE)
def test_configs_equal_jax_field_for_field(arch):
    assert get_config(arch).to_dict() == jax_get_config(arch).to_dict()
    assert reduced_config(arch).to_dict() == jax_reduced_config(arch).to_dict()


def test_model_config_fields_are_the_jax_fields():
    from repro.config import ModelConfig as JaxModelConfig
    mine = [(f.name, f.default) for f in dataclasses.fields(ModelConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxModelConfig)]
    assert mine == theirs


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", DENSE)
def test_param_defs_and_layer_windows_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mine, theirs = _flat(tf.param_defs(cfg)), _flat(jtf.param_defs(jcfg))
    assert sorted(mine) == sorted(theirs)
    for path, d in mine.items():
        t = theirs[path]
        assert (d.shape, d.axes, d.init, d.scale, d.dtype) == \
            (t.shape, t.axes, t.init, t.scale, t.dtype), path
    np.testing.assert_array_equal(tf._layer_flags(cfg), jtf._layer_flags(jcfg))


def test_init_from_defs_follows_the_jax_rules():
    """Same shapes, dtypes and constant inits; the "normal" std is
    scale / sqrt(shape[0]) (the layer count for stacked weights)."""
    gen = torch.Generator().manual_seed(0)
    defs = {"w": ParamDef((4, 256, 64), (None,) * 3),
            "e": ParamDef((512, 64), (None, None), "embed", scale=0.02),
            "z": ParamDef((3,), (None,), "zeros"),
            "o": ParamDef((3,), (None,), "ones", dtype="bfloat16")}
    p = init_from_defs(gen, defs)
    assert list(p) == sorted(defs)
    assert abs(float(p["w"].std()) - 0.5) < 0.01
    assert abs(float(p["e"].std()) - 0.02) < 0.001
    assert torch.equal(p["z"], torch.zeros(3))
    assert p["o"].dtype == torch.bfloat16 and bool((p["o"] == 1).all())
    again = init_from_defs(torch.Generator().manual_seed(0), defs)
    assert all(torch.equal(p[k], again[k]) for k in defs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_from_defs_scales_in_place_with_the_old_bits(dtype):
    """Scaling the float32 draw in place before the cast gives the bits of
    the out-of-place ``(normal * scale).to(dtype)`` from the same
    generator, for each drawn init."""
    defs = {"a_normal": ParamDef((3, 40, 24), (None,) * 3, dtype=dtype),
            "b_embed": ParamDef((64, 24), (None, None), "embed", scale=0.02,
                                dtype=dtype),
            "c_scaled": ParamDef((24,), (None,), "scaled", scale=0.5,
                                 dtype=dtype)}
    got = init_from_defs(torch.Generator().manual_seed(5), defs)
    gen = torch.Generator().manual_seed(5)
    dt = getattr(torch, dtype)
    for name, scale in (("a_normal", 1.0 / 3 ** 0.5), ("b_embed", 0.02),
                        ("c_scaled", 0.5)):
        normal = torch.randn(defs[name].shape, generator=gen)
        assert torch.equal(got[name], (normal * scale).to(dt)), name


def test_registry_holds_every_jax_config():
    """The port registers what the JAX package registers, every family."""
    from repro.configs import list_configs as jax_list_configs
    assert list_configs() == jax_list_configs()


def test_factory_raises_for_an_unknown_family():
    cfg = dataclasses.replace(get_config("gemma3-4b"), family="diffusion")
    with pytest.raises(ValueError, match="unknown family 'diffusion'"):
        build_model(cfg, device="cpu")


def test_no_device_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(reduced_config("gemma3-4b"))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_norms_match_jax():
    x, s, b = _normal((2, 5, 64), 0), _normal((64,), 1, 0.1), _normal((64,), 2)
    _close(nn.rmsnorm(torch.tensor(x), torch.tensor(s)),
           jnn.rmsnorm(jnp.asarray(x), jnp.asarray(s)))
    _close(nn.layernorm(torch.tensor(x), torch.tensor(s), torch.tensor(b)),
           jnn.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))


@pytest.mark.parametrize("arch", ["gemma3-4b", "chatglm3-6b", "stablelm-12b"])
def test_rope_matches_jax(arch):
    """Full (neox), half (chatglm's 2d) and quarter (stablelm) rotation."""
    cfg = reduced_config(arch)
    x = _normal((2, 12, 4, 32), 3)
    pos = np.tile(np.arange(12, dtype=np.int32) + 3, (2, 1))
    _close(nn.apply_rope(torch.tensor(x), torch.tensor(pos), cfg),
           jnn.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                          jax_reduced_config(arch)))


@pytest.mark.parametrize("activation,glu", [("silu", True), ("gelu", True),
                                            ("relu", False)])
def test_mlp_matches_jax(activation, glu):
    cfg = dataclasses.replace(reduced_config("stablelm-12b"),
                              activation=activation, glu=glu, use_bias=not glu)
    jcfg = dataclasses.replace(jax_reduced_config("stablelm-12b"),
                               activation=activation, glu=glu,
                               use_bias=not glu)
    p = {"w_gate": _normal((32, 48), 4, 0.2), "w_up": _normal((32, 48), 5, 0.2),
         "w_down": _normal((48, 32), 6, 0.2), "b_up": _normal((48,), 7),
         "b_down": _normal((32,), 8)}
    x = _normal((2, 3, 32), 9)
    _close(nn.mlp(torch.tensor(x), convert.to_model_params(p, "cpu"), cfg),
           jnn.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                   jcfg))


@pytest.mark.parametrize("Q,chunk_q,window", [(16, 2048, 0), (16, 2048, 4),
                                              (32, 8, 0), (32, 8, 6),
                                              (48, 8, 0)])
def test_attention_matches_jax(Q, chunk_q, window):
    """The plain GQA path, one block and q-chunked (4 and 6 chunks: the
    JAX package's unrolled and scanned branches), with padded keys."""
    B, N, K, h = 2, 4, 2, 16
    q, k, v = _normal((B, Q, N, h), 10), _normal((B, Q, K, h), 11), \
        _normal((B, Q, K, h), 12)
    pos = np.tile(np.arange(Q, dtype=np.int32), (B, 1))
    pos_k = pos.copy()
    pos_k[1, :3] = -1                       # padding in row 1
    got = nn.attention(*(torch.tensor(a) for a in (q, k, v, pos, pos_k)),
                       window=window, chunk_q=chunk_q)
    want = jnn.attention(*(jnp.asarray(a) for a in (q, k, v, pos, pos_k)),
                         window=window, chunk_q=chunk_q)
    _close(got, want)


def test_gqa_project_and_output_match_jax():
    cfg = reduced_config("chatglm3-6b")
    jcfg = jax_reduced_config("chatglm3-6b")
    D, N, K, h = 32, 4, 2, 8
    p = {"wq": _normal((D, N, h), 13, 0.2), "wk": _normal((D, K, h), 14, 0.2),
         "wv": _normal((D, K, h), 15, 0.2), "wo": _normal((N, h, D), 16, 0.2),
         "bq": _normal((N, h), 17), "bk": _normal((K, h), 18),
         "bv": _normal((K, h), 19), "bo": _normal((D,), 20)}
    tp = convert.to_model_params(p, "cpu")
    jp = {key: jnp.asarray(v) for key, v in p.items()}
    x = _normal((2, 5, D), 21)
    got = nn.gqa_project(torch.tensor(x), tp, cfg, True)
    want = jnn.gqa_project(jnp.asarray(x), jp, jcfg, True)
    for g, w in zip(got, want):
        assert g.is_contiguous()           # the layout the CUDA kernel reads
        _close(g, w)
    _close(nn.attn_output(got[0], tp, True), jnn.attn_output(want[0], jp, True))


# ---------------------------------------------------------------------------
# Prefill and decode of the reduced dense architectures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=DENSE)
def model_pair(request):
    arch = request.param
    jcfg = jax_reduced_config(arch)
    jbundle = jax_build_model(jcfg)
    jparams = jax_init_from_defs(jax.random.PRNGKey(0), jbundle.param_defs)
    # nonzero biases and norm scales, so every parameter is exercised
    leaves, treedef = jax.tree.flatten(jparams)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + (0.05 * rng.standard_normal(x.shape)
                               ).astype(np.float32) for x in leaves]
    jparams = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    bundle = build_model(reduced_config(arch), device="cpu")
    params = convert.to_model_params(jax.tree.map(np.asarray, jparams), "cpu")
    return arch, jbundle, jparams, bundle, params


def _close_cache(got, want, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=msg)


def test_prefill_and_decode_match_jax(model_pair):
    arch, jbundle, jparams, bundle, params = model_pair
    V = bundle.cfg.vocab_size
    S, cache_len = 20, 24
    toks = np.random.default_rng(2).integers(0, V, (2, S + 2)).astype(np.int32)
    jlogits, jcache = jbundle.prefill_fn(jparams, {"tokens": jnp.asarray(
        toks[:, :S])}, cache_len)
    logits, cache = bundle.prefill_fn(params, {"tokens": torch.tensor(
        toks[:, :S])}, cache_len)
    assert logits.dtype == torch.float32 and logits.shape == (2, V)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4, err_msg=arch)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        _close_cache(cache[name], jcache[name], f"{arch} cache {name}")
    for step in range(2):
        pos = S + step
        jlogits, jcache = jbundle.decode_fn(jparams, jcache, jnp.asarray(
            toks[:, pos]), jnp.asarray(pos, jnp.int32))
        logits, cache2 = bundle.decode_fn(params, cache,
                                          torch.tensor(toks[:, pos]), pos)
        assert cache2 is cache                   # updated in place
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"{arch} decode {step}")
        for name in ("k", "v"):
            _close_cache(cache[name], jcache[name], f"{arch} cache {name}")


def test_decode_matches_full_prefill(model_pair):
    """Decode at position S reproduces the prefill of S + 1 tokens (cache
    against recompute, the tolerance of tests/test_models_smoke.py)."""
    _, _, _, bundle, params = model_pair
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, bundle.cfg.vocab_size, (2, 16)))
    _, cache = bundle.prefill_fn(params, {"tokens": toks[:, :15]}, 16)
    dec, _ = bundle.decode_fn(params, cache, toks[:, 15], 15)
    full, _ = bundle.prefill_fn(params, {"tokens": toks}, 16)
    torch.testing.assert_close(dec, full, atol=5e-4, rtol=1e-3)
