"""The port's serve loop on the CPU against the JAX package's: greedy
`generate` tokens on the same weights, the session stepped by hand, the
prompts of the CLI, temperature sampling, and the CLI itself.

Greedy tokens and prompt tokens must be equal. The sampling's uniforms are
bit-equal to JAX's (the same threefry bits and float arithmetic); its Gumbel
noise differs by float32 rounding of log (XLA's and torch's), so sampled
tokens are compared on the same logits, where that rounding cannot move an
argmax unless two entries tie to ~1e-6.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models.factory import build_model as jax_build_model
from repro.serve.loop import generate as jax_generate
from repro.sharding.rules import init_from_defs as jax_init_from_defs
from repro_torch import convert, prng
from repro_torch.configs import reduced_config
from repro_torch.models.factory import build_model
from repro_torch.serve.loop import ServeSession, generate

REPO = Path(__file__).resolve().parents[1]
# tests/test_serve.py's config
SERVE_OVERRIDES = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
                       head_dim=16, d_ff=64, vocab_size=128)


def _pair(arch, **overrides):
    jcfg = jax_reduced_config(arch).with_overrides(**overrides)
    jbundle = jax_build_model(jcfg)
    jparams = jax_init_from_defs(jax.random.PRNGKey(0), jbundle.param_defs)
    bundle = build_model(reduced_config(arch).with_overrides(**overrides),
                         device="cpu")
    params = convert.to_model_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jbundle, jparams, bundle, params


@pytest.fixture(scope="module", params=["gemma3-4b", "chatglm3-6b"])
def pair(request):
    overrides = SERVE_OVERRIDES if request.param == "chatglm3-6b" else {}
    return _pair(request.param, **overrides)


def test_generate_greedy_equals_jax(pair):
    jbundle, jparams, bundle, params = pair
    V = bundle.cfg.vocab_size
    toks = jax.random.randint(jax.random.PRNGKey(1), (3, 12), 0, V)
    want = jax_generate(jbundle, jparams, {"tokens": toks}, max_new_tokens=6,
                        cache_len=18)
    got = generate(bundle, params, {"tokens": np.asarray(toks)},
                   max_new_tokens=6, cache_len=18)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_matches_stepwise_session(pair):
    _, _, bundle, params = pair
    batch = {"tokens": prng.randint(prng.PRNGKey(2), (2, 8), 0,
                                    bundle.cfg.vocab_size)}
    out = generate(bundle, params, batch, max_new_tokens=4, cache_len=16)
    sess = ServeSession(bundle, params, cache_len=16)
    toks = [torch.argmax(sess.prefill(batch), -1)]
    for _ in range(3):
        toks.append(torch.argmax(sess.decode(toks[-1]), -1))
    assert sess.pos == 11
    assert torch.equal(out, torch.stack(toks, 1))


def test_temperature_generate_in_range_and_deterministic(pair):
    _, _, bundle, params = pair
    batch = {"tokens": torch.ones((2, 8), dtype=torch.int64)}
    out = generate(bundle, params, batch, max_new_tokens=5, cache_len=16,
                   temperature=1.0, seed=7)
    again = generate(bundle, params, batch, max_new_tokens=5, cache_len=16,
                     temperature=1.0, seed=7)
    assert out.shape == (2, 5) and torch.equal(out, again)
    assert int(out.min()) >= 0 and int(out.max()) < bundle.cfg.vocab_size


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_returns_int32_like_jax(pair, temperature):
    """`repro_torch.serve.generate` returns int32 tokens, as the JAX package
    does (greedy: the same tokens), and the session decodes the int32
    tokens it feeds back."""
    from repro_torch.serve import ServeSession as Session
    from repro_torch.serve import generate as public_generate
    jbundle, jparams, bundle, params = pair
    toks = jax.random.randint(jax.random.PRNGKey(3), (2, 10), 0,
                              bundle.cfg.vocab_size)
    kw = dict(max_new_tokens=4, cache_len=14, temperature=temperature, seed=5)
    want = np.asarray(jax_generate(jbundle, jparams, {"tokens": toks}, **kw))
    got = public_generate(bundle, params, {"tokens": np.asarray(toks)}, **kw)
    assert want.dtype == np.int32 and got.dtype == torch.int32
    assert got.shape == want.shape
    if temperature == 0.0:
        np.testing.assert_array_equal(got.numpy(), want)
        sess = Session(bundle, params, cache_len=14)
        tok = torch.argmax(sess.prefill({"tokens": np.asarray(toks)}), -1)
        steps = [tok.to(torch.int32)]
        for _ in range(3):
            steps.append(torch.argmax(sess.decode(steps[-1]), -1)
                         .to(torch.int32))
        assert torch.equal(torch.stack(steps, 1), got)


def test_param_defs_through_public_names_match_jax(pair):
    """`repro_torch.sharding.ParamDef` / `init_from_defs`: the reference's
    fields, and the same tree of shapes and dtypes from the same defs."""
    from repro.sharding import ParamDef as JaxParamDef
    from repro_torch.sharding import ParamDef, init_from_defs
    from repro_torch.sharding.rules import tree_map
    _, jparams, bundle, _ = pair
    assert ParamDef._fields == JaxParamDef._fields
    params = init_from_defs(torch.Generator().manual_seed(0),
                            bundle.param_defs)
    got = tree_map(lambda t: (tuple(t.shape),
                              str(t.dtype).replace("torch.", "")), params)
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    assert got == want


@pytest.mark.parametrize("shape,V", [((4, 2048), 262144), ((3, 17), 512)])
def test_prompt_tokens_equal_jax(shape, V):
    for seed in (0, 5):
        got = prng.randint(prng.PRNGKey(seed), shape, 0, V)
        want = jax.random.randint(jax.random.PRNGKey(seed), shape, 0, V)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_uniforms_bit_equal_jax():
    tiny = float(np.finfo(np.float32).tiny)
    for seed in (0, 3):
        got = prng.uniform(prng.PRNGKey(seed), (4, 1000), minval=tiny)
        want = jax.random.uniform(jax.random.PRNGKey(seed), (4, 1000),
                                  minval=tiny)
        assert np.array_equal(got.numpy().view(np.uint32),
                              np.asarray(want).view(np.uint32))
    g = prng.gumbel(prng.PRNGKey(1), (4, 1000)).numpy()
    np.testing.assert_allclose(
        g, np.asarray(jax.random.gumbel(jax.random.PRNGKey(1), (4, 1000))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_sampled_tokens_equal_jax_on_the_same_logits(temperature):
    """The serve loop's key chain (split each step) and its categorical."""
    from repro.serve.loop import _sample as jax_sample
    from repro_torch.serve.loop import _sample
    logits = np.random.default_rng(4).standard_normal((6, 4, 300))
    logits = logits.astype(np.float32)
    key, jkey = prng.PRNGKey(11), jax.random.PRNGKey(11)
    for step in range(6):
        got = _sample(torch.tensor(logits[step]), temperature, key)
        want = jax_sample(jnp.asarray(logits[step]), temperature, jkey)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        key, _ = prng.split(key)
        jkey, _ = jax.random.split(jkey)


def test_cli_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-4b", "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "12", "--new-tokens", "3"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
                       "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "tok/s) on cpu" in proc.stderr
    assert proc.stdout.count("[") == 3          # a [2, 3] array of tokens


def test_cli_without_a_card_raises():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-4b", "--reduced"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
                       "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
