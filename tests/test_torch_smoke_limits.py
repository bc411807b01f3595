"""chip_smoke.py's limit for the bf16 tensor-core attention kernel, on the
CPU: the plain attention in float32, rounded to bf16 as the kernel's output
is, passes it; the planted faults the script makes at every bf16 case (each
query block's last KV tile dropped on the second half's rows, the output 2%
too large) fail it. The kernel itself runs only on the card.
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


def _plain_f32(q, k, v, window):
    G = q.shape[2] // k.shape[2]
    kt, vt = (t.float().transpose(1, 2).repeat_interleave(G, dim=1)
              for t in (k, v))
    return attention_ref(q.float().transpose(1, 2), kt, vt, window=window
                         ).transpose(1, 2)


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
