"""chip_smoke.py's limit for the bf16 tensor-core attention kernel, on the
CPU: the plain attention in float32, rounded to bf16 as the kernel's output
is, passes it; the planted faults the script makes at every bf16 case (each
query block's last KV tile dropped on the second half's rows, the output 2%
too large) fail it, and so does, where the keys are the first rows of a
padded buffer (a key length of its own), the attention with the padded
keys counted. The kernel itself runs only on the card.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _plain_f32(q, k, v, window, causal=True):
    G = q.shape[2] // k.shape[2]
    kt, vt = (t.float().transpose(1, 2).repeat_interleave(G, dim=1)
              for t in (k, v))
    return attention_ref(q.float().transpose(1, 2), kt, vt, causal=causal,
                         window=window).transpose(1, 2)


@pytest.mark.parametrize("S,N,K,h,window", [(1024, 4, 4, 128, 0),
                                            (1024, 4, 2, 256, 256),
                                            (1024, 10, 1, 256, 512)])
def test_bf16_limit_passes_rounding_and_rejects_planted_faults(S, N, K, h,
                                                               window):
    rng = np.random.default_rng(S + N + h + window)
    q = torch.tensor(rng.standard_normal((1, S, N, h)),
                     dtype=torch.float32).to(torch.bfloat16)
    k, v = (torch.tensor(rng.standard_normal((1, S, K, h)),
                         dtype=torch.float32).to(torch.bfloat16)
            for _ in range(2))
    ref = _plain_f32(q, k, v, window)
    out = ref.to(torch.bfloat16)
    elem, row = smoke.attention_gaps(out, ref)
    assert elem <= smoke.BF16_ATOL and row <= smoke.BF16_ROW_REL
    faults = smoke.planted_faults(q, k, v, out, window)
    assert set(faults) == {"last_kv_tile_dropped_past_half",
                           "output_2pct_too_large"}
    for name, bad in faults.items():
        elem, row = smoke.attention_gaps(bad, ref)
        assert elem > smoke.BF16_ATOL or row > smoke.BF16_ROW_REL, name


# (Sq, Sk, rows of the key buffer, N, K, h): whisper-large-v3's encoder
# and cross-attention (1500 valid frames of 1504) and the vision model's
# cross-attention (1601 image tokens, the buffer padded to 1616), with
# fewer heads
@pytest.mark.parametrize("Sq,Sk,Sp,N,K,h", [(1504, 1500, 1504, 2, 2, 64),
                                            (448, 1500, 1504, 2, 2, 64),
                                            (2048, 1601, 1616, 4, 1, 128)])
def test_bf16_limit_rejects_the_padded_keys_counted(Sq, Sk, Sp, N, K, h):
    rng = np.random.default_rng(Sq + Sk + h)
    q = torch.tensor(rng.standard_normal((1, Sq, N, h)),
                     dtype=torch.float32).to(torch.bfloat16)
    k_pad, v_pad = (torch.tensor(rng.standard_normal((1, Sp, K, h)),
                                 dtype=torch.float32).to(torch.bfloat16)
                    for _ in range(2))
    k, v = k_pad[:, :Sk], v_pad[:, :Sk]
    ref = _plain_f32(q, k, v, 0, causal=False)
    out = ref.to(torch.bfloat16)
    elem, row = smoke.attention_gaps(out, ref)
    assert elem <= smoke.BF16_ATOL and row <= smoke.BF16_ROW_REL
    faults = smoke.planted_faults(q, k, v, out, 0, False, k_pad, v_pad)
    assert set(faults) == {"last_kv_tile_dropped_past_half",
                           "output_2pct_too_large", "padded_keys_counted"}
    for name, bad in faults.items():
        elem, row = smoke.attention_gaps(bad, ref)
        assert elem > smoke.BF16_ATOL or row > smoke.BF16_ROW_REL, name


@pytest.mark.parametrize("arch,launches", [
    ("gemma3-4b", 34), ("deepseek-moe-16b", 28), ("recurrentgemma-2b", 8),
    ("falcon-mamba-7b", 0), ("whisper-large-v3", 96),
    ("llama-3.2-vision-11b", 40)])
def test_flash_launches_per_prefill_of_each_full_config(arch, launches):
    """The K4 launches the serve phases require of one prefill: one per
    attending layer, whisper's encoder layers once and its decoder layers
    twice (self- and cross-attention)."""
    from repro_torch.configs import get_config

    assert smoke.attention_layers(get_config(arch)) == launches


@pytest.mark.parametrize("arch,cut,full", [
    ("whisper-large-v3", dict(encoder_layers=2, num_layers=2),
     dict(encoder_layers=32, num_layers=32)),
    ("llama-3.2-vision-11b", dict(num_layers=5), dict(num_layers=40))])
def test_depth_cut_draws_at_the_full_models_scale(arch, cut, full):
    """`scale_to_full_depth`: each stacked "normal" leaf of the cut model
    at the full stack's std 1/sqrt(L_full), every other leaf as drawn;
    `draw_zero_leaves` leaves no zero-initialised leaf at 0."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.rules import init_from_defs
    from repro_torch.utils.tree import tree_flatten_with_path

    cfg = reduced_config(arch)
    bundle = build_model(cfg.with_overrides(**cut), "cpu")
    full_defs = build_model(cfg.with_overrides(**full), "cpu").param_defs
    params = init_from_defs(torch.Generator().manual_seed(0),
                            bundle.param_defs)
    before = {k: v.clone() for k, v in tree_flatten_with_path(params)}
    smoke.scale_to_full_depth(params, bundle.param_defs, full_defs)
    smoke.draw_zero_leaves(params, bundle.param_defs,
                           torch.Generator().manual_seed(1))

    def defs_of(tree, prefix=""):
        for key, d in tree.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(d, dict):
                yield from defs_of(d, path)
            else:
                yield path, d

    fulls = dict(defs_of(full_defs))
    for path, d in defs_of(bundle.param_defs):
        x = dict(tree_flatten_with_path(params))[path]
        if d.init == "zeros":
            assert bool((x != 0).all()), path
        elif d.init == "normal" and d.shape[0] != fulls[path].shape[0]:
            want = 1 / np.sqrt(fulls[path].shape[0])
            assert abs(float(x.std()) / want - 1) < 0.05, path
        else:
            assert torch.equal(x, before[path]), path


def test_encdec_card_vs_cpu_limit_tightened_not_loosened():
    """whisper's card-vs-CPU limit stands below the recurrent families'
    5e-3 it was held at before its sinusoid table moved to the CPU; the
    vision model's stays at it."""
    whisper, vision = smoke.ENCDEC_VLM_ATOL
    assert whisper < smoke.RECURRENT_ATOL == 5e-3
    assert vision == smoke.RECURRENT_ATOL
    assert [arch for arch, _, _ in smoke.ENCDEC_VLM_CUT] == \
        [smoke.ENCDEC_ARCH, smoke.VLM_ARCH]


def test_objectives_and_server_phases_plan_their_groups():
    """Phase `objectives`' 5 rows make one AsySVRG/SVRG group and a Hogwild!
    row, fused or batched, and its card-vs-CPU rows the AsySVRG group at
    M̃ 4096; phase `server`'s size flush puts the three fused L2 rows of
    its two tenants in one group beside the nonconvex request's two."""
    from repro_torch.core.objectives import NonconvexLogistic
    from repro_torch.core.sweep import plan_sweep
    from repro_torch.service.scheduler import SweepRequest, coalesce

    rng = np.random.default_rng(0)
    n, p = 20242, 8
    X = rng.standard_normal((n, p)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    ncv = NonconvexLogistic(X, y, lam=smoke.NCV_LAM, alpha=smoke.NCV_ALPHA,
                            device="cpu")
    for mode in ("vmap", "fused"):
        plan = plan_sweep(ncv, 2, smoke.ncv_specs(n, mode))
        assert sorted(len(m) for m in plan.groups.values()) == [1, 4]
        assert {k[2] for k in plan.groups} == {40480, 20240}
    short = plan_sweep(ncv, 1, smoke.ncv_specs(n, "vmap", smoke.NCV_CPU_INNER)[:4])
    assert [k[2] for k in short.groups] == [4096]

    from repro_torch.core.objective import (LogisticRegression,
                                            register_objective,
                                            unregister_objective)
    obj = LogisticRegression(X, y, 1e-4, device="cpu")
    register_objective("rcv1-nonconvex", ncv)
    try:
        reqs = [SweepRequest(request_id=i, specs=tuple(specs), epochs=2,
                             tenant=tenant)
                for i, (tenant, specs) in enumerate(smoke.server_specs())]
        batch = coalesce(obj, reqs)
    finally:
        unregister_objective("rcv1-nonconvex")
    sizes = sorted(len(m) for m in batch.groups.values())
    assert sizes == [1, 1, 3]
