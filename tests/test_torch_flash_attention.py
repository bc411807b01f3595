"""The port's flash attention (K4) on the CPU: its plain version against the
JAX package's Pallas kernel (interpret mode) and its jnp oracle, over the
parametrisation of tests/test_kernels.py, the wrapper's GQA layout, and its
key length of its own (``Sk != Sq``, non-causal) against the JAX package's
`layers.attention` with padded key positions.

Tolerances are those of tests/test_kernels.py: float32 atol/rtol 2e-5 (the
kernel's online softmax sums in another order than the oracle's softmax),
bfloat16 3e-2 (both round scores and probabilities to bfloat16, in
different places). The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_ops
from repro.kernels.flash_attention.kernel import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models import layers as jax_layers
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("S,bq,bk", [(128, 64, 64), (256, 64, 128),
                                     (256, 128, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (True, 8),
                                           (False, 0)])
def test_plain_matches_jax_kernel_and_oracle(S, bq, bk, causal, window):
    BH, d = 4, 32
    q, k, v = (_normal((BH, S, d), S + bq + window + i) for i in range(3))
    got = attention_ref(*(torch.tensor(a)[None] for a in (q, k, v)),
                        causal=causal, window=window)[0].numpy()
    j = [jnp.asarray(a) for a in (q, k, v)]
    kern = jax_flash(*j, causal=causal, window=window, bq=bq, bk=bk,
                     interpret=True)
    oracle = jax_ref(*(a[None] for a in j), causal=causal, window=window)[0]
    for want in (kern, oracle):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("N,K", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("window", [0, 32])
def test_gqa_flash_matches_jax_wrapper(N, K, window):
    B, S, h = 2, 128, 16
    q = _normal((B, S, N, h), N * 17 + K)
    k = _normal((B, S, K, h), N * 17 + K + 1)
    v = _normal((B, S, K, h), N * 17 + K + 2)
    got = gqa_flash(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                    causal=True, window=window)
    assert got.shape == (B, S, N, h)
    j = [jnp.asarray(a) for a in (q, k, v)]
    for want in (jax_ops.gqa_flash(*j, causal=True, window=window,
                                   interpret=True, force_kernel=True,
                                   bq=64, bk=64),
                 jax_ops.gqa_flash(*j, causal=True, window=window)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_dtypes_match_jax_kernel(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x = _normal((2, 128, 32), 9)
    got = attention_ref(*(torch.tensor(x).to(tdt)[None],) * 3, causal=True)[0]
    assert got.dtype == tdt
    xj = jnp.asarray(x).astype(jdt)
    want = jax_flash(xj, xj, xj, causal=True, bq=64, bk=64, interpret=True)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_ragged_length_matches_oracle():
    """The port takes any S (the TPU kernel asserts S % bq == 0)."""
    B, S, N, K, h = 1, 77, 4, 2, 24
    q, k, v = (_normal((B, S, n, h), 5 + n) for n in (N, K, K))
    got = gqa_flash(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                    window=8)
    want = jax_ops.gqa_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_cpu_tensors_never_touch_the_launch_counter():
    before = gqa_flash.launches
    x = torch.tensor(_normal((1, 64, 2, 8), 3))
    gqa_flash(x, x, x)
    gqa_flash(x.to(torch.bfloat16), *(x.to(torch.bfloat16),) * 2, window=4)
    assert gqa_flash.launches == before


def test_wrapper_rejects_mismatched_heads():
    q = torch.zeros((1, 8, 6, 8))
    kv = torch.zeros((1, 8, 4, 8))
    with pytest.raises(ValueError, match="K dividing N"):
        gqa_flash(q, kv, kv)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "command-r-plus-104b",
                                  "gemma3-4b", "stablelm-12b"])
def test_route_of_every_config_head_width(arch):
    """On the card, bf16 at each head width of configs/ (256, 128, 160, and
    the reduced configs' 32) takes the tensor-core kernel; float32 the
    CUDA-core one."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels.flash_attention.ops import route

    for cfg in (get_config(arch), reduced_config(arch)):
        assert cfg.head_dim % 16 == 0
        assert route(torch.bfloat16, cfg.head_dim) == "wgmma"
        assert route(torch.float32, cfg.head_dim) == "simt"


@pytest.mark.parametrize("h", [8, 24, 40, 136, 248])
def test_route_of_bf16_widths_off_16_is_simt(h):
    from repro_torch.kernels.flash_attention.ops import route

    assert route(torch.bfloat16, h) == "simt"
    assert route(torch.bfloat16, h + 8) == "wgmma"


def test_cpu_tensors_touch_no_route_counter():
    before = dict(gqa_flash.launches_by_route)
    assert set(before) == {"wgmma", "simt"}
    for dtype, h in ((torch.float32, 16), (torch.bfloat16, 16),
                     (torch.bfloat16, 24)):
        x = torch.tensor(_normal((1, 40, 2, h), h)).to(dtype)
        gqa_flash(x, x, x, window=8)
    assert gqa_flash.launches_by_route == before


# (Sq, keys in the buffer, valid keys, N, K): whisper's encoder (16 frames,
# 13 valid), its cross-attention (a prompt over them), the vision model's
# cross-attention (every image token valid, GQA), more keys than queries
# and fewer
KEY_LENGTHS = [(16, 16, 13, 4, 4), (9, 16, 13, 4, 4), (12, 8, 8, 8, 2),
               (5, 40, 33, 6, 3), (40, 7, 3, 4, 1)]


@pytest.mark.parametrize("Sq,Sp,Sk,N,K", KEY_LENGTHS)
def test_key_length_matches_jax_attention_with_padded_keys(Sq, Sp, Sk, N, K):
    """Non-causal attention of Sq queries over the first Sk of Sp keys (the
    view ``k[:, :Sk]``, as the encoder-decoder calls it) against the JAX
    package's `layers.attention` over all Sp keys with the last Sp - Sk at
    position -2^30: the padded keys drop out of every sum. 2e-5."""
    B, h = 2, 16
    q = _normal((B, Sq, N, h), Sq + Sp)
    k = _normal((B, Sp, K, h), Sq + Sp + 1)
    v = _normal((B, Sp, K, h), Sq + Sp + 2)
    pos_q = np.tile(np.arange(Sq, dtype=np.int32), (B, 1))
    pos_k = np.tile(np.where(np.arange(Sp) < Sk, np.arange(Sp), -(1 << 30)
                             ).astype(np.int32), (B, 1))
    got = gqa_flash(torch.tensor(q), torch.tensor(k)[:, :Sk],
                    torch.tensor(v)[:, :Sk], causal=False, window=0)
    assert got.shape == (B, Sq, N, h)
    want = jax_layers.attention(*(jnp.asarray(a) for a in (q, k, v, pos_q,
                                                           pos_k)),
                                causal=False, window=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_equal_lengths_still_match_jax_oracle(causal, window):
    """With Sq == Sk the wrapper computes what it computed before the key
    length: the JAX oracle's function, GQA 6:2."""
    B, S, N, K, h = 2, 64, 6, 2, 16
    q, k, v = (_normal((B, S, n, h), 40 + n) for n in (N, K, K))
    got = gqa_flash(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                    causal=causal, window=window)
    rep = [jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)]
    rep[1], rep[2] = (jnp.repeat(t, N // K, axis=1) for t in rep[1:])
    want = jax_ref(*rep, causal=causal, window=window).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 8), (True, 8)])
def test_key_length_refuses_causal_and_windowed(causal, window):
    q = torch.zeros((1, 16, 4, 8))
    kv = torch.zeros((1, 13, 4, 8))
    with pytest.raises(ValueError, match="non-causal attention without a "
                       "window"):
        gqa_flash(q, kv, kv, causal=causal, window=window)


def test_key_length_on_the_cpu_touches_no_counter():
    before = gqa_flash.launches, dict(gqa_flash.launches_by_route)
    q = torch.tensor(_normal((1, 16, 2, 16), 1))
    kv = torch.tensor(_normal((1, 13, 2, 16), 2))
    for dtype in (torch.float32, torch.bfloat16):
        gqa_flash(q.to(dtype), kv.to(dtype), kv.to(dtype), causal=False)
    assert (gqa_flash.launches, gqa_flash.launches_by_route) == before
