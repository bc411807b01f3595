"""The port's CUDA kernels and engine on the card, each against its plain
torch version. Runs on a machine with a CUDA device and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX, which the port does not
need.) Elsewhere every test skips: a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.config import SVRGConfig
from repro_torch.core.asysvrg import run_asysvrg
from repro_torch.core.objective import LogisticRegression
from repro_torch.core.svrg import run_svrg
from repro_torch.core.sweep import SweepSpec, run_sweep
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels import regularizer
from repro_torch.kernels.logreg_grad.ops import logreg_grad
from repro_torch.kernels.logreg_grad.ref import logreg_grad_ref
from repro_torch.kernels.svrg_update.ops import svrg_update
from repro_torch.kernels.svrg_update.ref import svrg_update_ref
from repro_torch.kernels.sweep_epoch import kernel
from repro_torch.kernels.sweep_epoch import ops as sweep_ops
from repro_torch.kernels.sweep_epoch.ops import kernel_draws, sweep_epoch
from repro_torch.kernels.sweep_epoch.ref import draws, sweep_epoch_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no "
                    "CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", [(1, 2048), (3, 1000), (2, 33), (77,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_svrg_update_kernel_equals_plain(gen, shape, dtype):
    """Same float32 arithmetic in the same order, no FMA: equal bits."""
    u, g, g0, gf = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                    for _ in range(4))
    lr = torch.rand(shape[0] if len(shape) == 2 else 1, generator=gen,
                    device="cuda")
    before = svrg_update.launches
    out = svrg_update(u, g, g0, gf, lr, wd=0.01)
    assert svrg_update.launches == before + 1
    assert torch.equal(out, svrg_update_ref(u, g, g0, gf, lr, 0.01))


@pytest.mark.parametrize("n,p", [(96, 64), (1000, 333), (20242, 2048)])
def test_logreg_grad_kernel_matches_plain(gen, n, p):
    """rtol 1e-5, atol 1e-6 (summation order); rows independent bitwise."""
    X = torch.randn((n, p), generator=gen, device="cuda") / p ** 0.5
    y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    W = 0.3 * torch.randn((5, p), generator=gen, device="cuda")
    G = logreg_grad(X, y, W, 1e-4)
    torch.testing.assert_close(G, logreg_grad_ref(X, y, W, 1e-4),
                               rtol=1e-5, atol=1e-6)
    for c in range(5):
        assert torch.equal(G[c], logreg_grad(X, y, W[c:c + 1], 1e-4)[0])


@pytest.mark.parametrize("epilogue", ["ring", "acc", "ring+acc"])
@pytest.mark.parametrize("d", [2048, 33])
@pytest.mark.parametrize("rows", [1, 4, 133])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_svrg_update_epilogue_equals_plain(gen, dtype, rows, d, epilogue):
    """The update, its ring store and its running sum in one launch, each
    bit-equal to the plain version's torch ops on the same tensors."""
    u, g, g0, gf = (torch.randn((rows, d), generator=gen, device="cuda")
                    .to(dtype) for _ in range(4))
    lr = torch.rand(rows, generator=gen, device="cuda")
    ring0 = torch.randn((rows, 6, d), generator=gen, device="cuda").to(dtype)
    acc0 = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    slot = torch.randint(0, 6, (rows,), generator=gen, device="cuda")
    got, want = [], []
    for fn in (svrg_update, svrg_update_ref):
        ring, acc = ring0.clone(), acc0.clone()
        kw = dict(ring=ring if "ring" in epilogue else None,
                  slot=slot if "ring" in epilogue else None,
                  acc=acc if "acc" in epilogue else None)
        (got if fn is svrg_update else want).append(
            (fn(u, g, g0, gf, lr, 0.01, **kw), ring, acc))
    before = svrg_update.launches
    svrg_update(u, g, g0, gf, lr, 0.01, ring=ring0.clone(), slot=slot)
    assert svrg_update.launches == before + 1
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)


def test_svrg_update_rejects_a_bad_epilogue(gen):
    x = torch.randn((2, 8), generator=gen, device="cuda")
    ring = torch.zeros((2, 3, 8), device="cuda")
    slot = torch.zeros(2, dtype=torch.int64, device="cuda")
    lr = torch.full((2,), 0.1, device="cuda")
    bad = [dict(ring=ring), dict(slot=slot),
           dict(ring=ring.double(), slot=slot),
           dict(ring=ring[:, :, :4], slot=slot),
           dict(ring=torch.zeros((3, 3, 8), device="cuda"), slot=slot),
           dict(ring=ring, slot=slot.int()),
           dict(ring=ring, slot=slot.cpu()),
           dict(acc=torch.zeros((2, 8), device="cuda").T.contiguous().T),
           dict(acc=torch.zeros((2, 8), dtype=torch.bfloat16, device="cuda")),
           dict(acc=torch.zeros((2, 8)))]
    for kw in bad:
        with pytest.raises(ValueError):
            svrg_update(x, x, x, x, lr, **kw)
    with pytest.raises(ValueError):
        svrg_update(x, x, x, x, lr.cpu())


# widths: rcv1, news20, odd, just past the kernel's column tiers, tiny, and
# past the on-chip width (the two-pass kernels)
@pytest.mark.parametrize("n,p", [(20242, 2048), (19996, 4096), (1001, 333),
                                 (777, 4097), (50, 7), (300, 9000)])
@pytest.mark.parametrize("C", [1, 3, 4, 5, 9])
def test_logreg_grad_widths_and_chunks_match_plain(gen, n, p, C):
    """rtol 1e-5, atol 1e-6 (summation order); each row bit-equal to itself
    alone, across the chunk edge (C = 5, 9)."""
    X = torch.randn((n, p), generator=gen, device="cuda") / p ** 0.5
    y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    W = 0.3 * torch.randn((C, p), generator=gen, device="cuda")
    before = logreg_grad.launches
    G = logreg_grad(X, y, W, 1e-4)
    assert logreg_grad.launches == before + 1
    torch.testing.assert_close(G, logreg_grad_ref(X, y, W, 1e-4),
                               rtol=1e-5, atol=1e-6)
    for c in range(C):
        assert torch.equal(G[c], logreg_grad(X, y, W[c:c + 1], 1e-4)[0])


def test_logreg_grad_library_pipeline_and_no_spills(gen):
    """The one-pass kernel's SASS holds the bulk copy and the mbarrier wait,
    and no kernel of the library spills registers."""
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build

    _build.library("logreg_grad")
    lib = _build.target("logreg_grad")[1]
    log = lib.with_suffix(".log").read_text()
    spills = [ln for ln in log.splitlines() if "spill" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    assert not spills, spills
    sass = subprocess.run(
        [str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True, timeout=120).stdout
    assert sass.count("UBLKCP") > 0 and sass.count("SYNCS.PHASECHK") > 0


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = torch.randn((4, 8), generator=gen, device="cuda")
    with pytest.raises(ValueError):
        svrg_update(x.T, x.T, x.T, x.T, 0.1)
    with pytest.raises(TypeError):
        svrg_update(*(x.double(),) * 4, 0.1)
    with pytest.raises(ValueError):
        logreg_grad(x, torch.ones(3, device="cuda"), x[:1], 0.0)
    with pytest.raises(TypeError):
        logreg_grad(x.double(), torch.ones(4, device="cuda"), x[:1], 0.0)


def test_engine_on_the_card_matches_cpu(gen):
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((96, 64)) / 8).astype(np.float32)
    y = np.where(rng.random(96) < 0.5, -1.0, 1.0).astype(np.float32)
    cfg = SVRGConfig(scheme="unlock", step_size=0.5, num_threads=4,
                     inner_steps=32)
    card = run_asysvrg(LogisticRegression(X, y, 1e-3), 2, cfg, seed=1)
    cpu = run_asysvrg(LogisticRegression(X, y, 1e-3, device="cpu"), 2, cfg,
                      seed=1)
    assert card.w.device.type == "cuda"
    np.testing.assert_allclose(card.history, cpu.history, rtol=1e-5)
    np.testing.assert_allclose(card.w.cpu().numpy(), cpu.w.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("option", [1, 2])
def test_svrg_on_the_card_matches_cpu(gen, option):
    """Serial SVRG, whose running sum goes through the kernel's epilogue."""
    rng = np.random.default_rng(1)
    X = (rng.standard_normal((96, 64)) / 8).astype(np.float32)
    y = np.where(rng.random(96) < 0.5, -1.0, 1.0).astype(np.float32)
    card = run_svrg(LogisticRegression(X, y, 1e-3), 2, 0.5, num_inner=40,
                    option=option, seed=2)
    cpu = run_svrg(LogisticRegression(X, y, 1e-3, device="cpu"), 2, 0.5,
                   num_inner=40, option=option, seed=2)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-5)
    np.testing.assert_allclose(card[0].cpu().numpy(), cpu[0].numpy(),
                               rtol=1e-5, atol=1e-6)


def _sweep_inputs(gen, n, d, C):
    X = torch.randn((n, d), generator=gen, device="cuda") / d ** 0.5
    y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    w = 0.1 * torch.randn((C, d), generator=gen, device="cuda")
    mu = 0.01 * torch.randn((C, d), generator=gen, device="cuda")
    keys = prng.keys_from_seeds(range(C), "cuda")
    return X, y, w, mu, keys


@pytest.mark.parametrize("d", [33, 1000])
@pytest.mark.parametrize("engine,option", [("asysvrg", 2), ("asysvrg", 1),
                                           ("hogwild", 0)])
@pytest.mark.parametrize("placement", ["shared", "global"])
def test_sweep_epoch_kernel_matches_plain(gen, d, engine, option, placement):
    """Each scheme and delay kind, with drops; the ring in shared memory
    (τ = 3) or, past the block's shared memory, in device memory. Limit
    1e-5 on the iterate, rtol 1e-6 on the loss (the float64 sums differ in
    order only)."""
    tau = 3 if placement == "shared" else {33: 1800, 1000: 60}[d]
    X, y, w, mu, keys = _sweep_inputs(gen, 300, d, 3)
    step = torch.tensor([0.5, 0.3, 0.2], device="cuda")
    args = (X, y, 1e-3, w, mu, keys, step, [tau, 1, tau], [0, 1, 2], [2, 1, 2])
    kw = dict(engine=engine, total=64, buf_len=tau + 1, option=option,
              drop_prob=0.1)
    before = dict(sweep_epoch.placements)
    out, loss = sweep_epoch(*args, **kw)
    torch.cuda.synchronize()
    assert sweep_epoch.placements[placement] == before[placement] + 1
    want, want_loss = sweep_epoch_ref(*args, **kw)
    assert bool(torch.isfinite(out).all())
    assert float((out - want).abs().max()) <= 1e-5
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0.0)


def test_sweep_epoch_hogwild_ring_stays_shared_longer(gen):
    """Hogwild! keeps no u0, mu or acc, so its ring stays in shared memory
    at a length where an AsySVRG row's ring moves to device memory."""
    d = 1000
    limit = kernel.max_shared_bytes(torch.device("cuda"))
    buf_len = max(b for b in range(1, 200)
                  if sweep_ops.shared_bytes(d, b, "hogwild", "shared") <= limit)
    assert sweep_ops.shared_bytes(d, buf_len, "asysvrg", "shared") > limit
    X, y, w, _, keys = _sweep_inputs(gen, 300, d, 2)
    step = torch.tensor([0.5, 0.3], device="cuda")
    tau = buf_len - 1
    args = (X, y, 1e-3, w, None, keys, step, [tau, 2], [2, 1], [2, 1])
    kw = dict(engine="hogwild", total=64, buf_len=buf_len, option=0,
              drop_prob=0.1)
    before = sweep_epoch.placements["shared"]
    out, loss = sweep_epoch(*args, **kw)
    assert sweep_epoch.placements["shared"] == before + 1
    want, want_loss = sweep_epoch_ref(*args, **kw)
    assert float((out - want).abs().max()) <= 1e-5
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0.0)


def _sweep_vs_plain(gen, *, n, d, engine, total, tau=(7, 7, 7), option=2,
                    placement=None, exact=False, reg=1e-3):
    """One ``sweep_epoch`` launch (at ``placement``, or the one chosen by
    size) against the plain version, every reader and delay kind with
    drops: iterate within 1e-5 and loss within rtol 1e-6, or with
    ``exact`` equal bits. ``reg``: the penalty (L2 λ, or ``(lam, alpha)``).
    Returns the placement that ran."""
    C = len(tau)
    X, y, w, mu, keys = _sweep_inputs(gen, n, d, C)
    step = torch.tensor([0.5, 0.3, 0.2][:C], device="cuda")
    args = (X, y, reg, w, mu if engine == "asysvrg" else None, keys, step,
            list(tau), [0, 1, 2][:C], [2, 1, 2][:C])
    kw = dict(engine=engine, total=total, buf_len=max(tau) + 1,
              option=option, drop_prob=0.1)
    before = dict(sweep_epoch.placements)
    out, loss = sweep_epoch(*args, **kw, placement=placement)
    torch.cuda.synchronize()
    used = [k for k, v in sweep_epoch.placements.items() if v != before[k]]
    assert len(used) == 1 and placement in (None, used[0])
    want, want_loss = sweep_epoch_ref(*args, **kw)
    assert bool(torch.isfinite(out).all())
    if exact:
        assert torch.equal(out, want) and torch.equal(loss, want_loss)
    assert float((out - want).abs().max()) <= 1e-5
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0.0)
    return used[0]


@pytest.mark.parametrize("total", [1, 2, 3, 4, 5, 9])
@pytest.mark.parametrize("engine", ["asysvrg", "hogwild"])
def test_sweep_epoch_short_epochs(gen, total, engine):
    """Epochs shorter than, as long as and past the queue (S = 2)."""
    assert _sweep_vs_plain(gen, n=300, d=33, engine=engine,
                           total=total) == "shared"


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("d", [33, 2048])
def test_sweep_epoch_same_row_in_consecutive_stages(gen, n, d):
    """With n = 1 every step stages the same row, with n = 3 most do."""
    _sweep_vs_plain(gen, n=n, d=d, engine="asysvrg", total=64)


@pytest.mark.parametrize("engine,option", [("asysvrg", 2), ("asysvrg", 1),
                                           ("hogwild", 0)])
def test_sweep_epoch_rcv1_width_equals_plain_bits(gen, engine, option):
    """d = 2048 at τ = 7 (rcv1's shape): the kernel's arithmetic is the
    plain version's, operation for operation, so iterate and loss are
    equal bits."""
    assert _sweep_vs_plain(gen, n=500, d=2048, engine=engine, total=128,
                           option=option, exact=True) == "shared"


@pytest.mark.parametrize("placement", list(sweep_ops.PLACEMENTS))
@pytest.mark.parametrize("engine,option", [("asysvrg", 2), ("asysvrg", 1),
                                           ("hogwild", 0)])
def test_sweep_epoch_clipped_penalty_equals_plain_bits(gen, engine, option,
                                                       placement):
    """The clipped penalty of NonconvexLogistic (λ 1e-2, α 10) at rcv1's
    width, every placement: its gradient at the read iterate and at u0 and
    its sum in the loss take the plain version's float32 steps, so iterate
    and loss are equal bits."""
    assert _sweep_vs_plain(gen, n=500, d=2048, engine=engine, total=128,
                           option=option, placement=placement, exact=True,
                           reg=(1e-2, 10.0)) == placement


@pytest.mark.parametrize("n,p,C", [(96, 64, 1), (1000, 333, 3),
                                   (20242, 2048, 5), (19996, 4096, 4)])
def test_logreg_grad_clipped_penalty_matches_plain(gen, n, p, C):
    """K2 with the clipped penalty: rtol 1e-5, atol 1e-6 (summation order),
    each row bit-equal alone; an L2 call on the same inputs unchanged by
    the penalty's argument."""
    X = torch.randn((n, p), generator=gen, device="cuda") / p ** 0.5
    y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    W = 0.5 * torch.randn((C, p), generator=gen, device="cuda")
    reg = (1e-2, 10.0)
    G = logreg_grad(X, y, W, reg)
    torch.testing.assert_close(G, logreg_grad_ref(X, y, W, reg), rtol=1e-5,
                               atol=1e-6)
    for c in range(C):
        assert torch.equal(G[c], logreg_grad(X, y, W[c:c + 1], reg)[0])
    assert torch.equal(logreg_grad(X, y, W, 1e-4), logreg_grad(X, y, W, (1e-4,)))


def test_nonconvex_fused_sweep_matches_batched_on_the_card(gen):
    """NonconvexLogistic fused (K2 + K3 with the clipped penalty) against
    batched (K1 + K2) on the card, rtol 1e-5, atol 1e-6, and a row alone
    equal in bits to the row in its group."""
    from repro_torch.core.objectives import NonconvexLogistic

    rng = np.random.default_rng(1)
    X = (rng.standard_normal((300, 96)) / 8).astype(np.float32)
    y = np.where(rng.random(300) < 0.5, -1.0, 1.0).astype(np.float32)
    obj = NonconvexLogistic(X, y, lam=1e-2, alpha=10.0)

    def specs(mode):
        return [SweepSpec(scheme=s, step_size=0.5, num_threads=4,
                          inner_steps=32, seed=c, engine_mode=mode)
                for c, s in enumerate(("consistent", "inconsistent",
                                       "unlock"))] + \
            [SweepSpec(algo="hogwild", scheme="unlock", step_size=0.5,
                       num_threads=4, tau=-1, engine_mode=mode)]

    before = sweep_epoch.launches
    fused = run_sweep(obj, 2, specs("fused"))
    assert sweep_epoch.launches == before + 4          # 2 groups x 2 epochs
    batched = run_sweep(obj, 2, specs("vmap"))
    np.testing.assert_allclose(fused.histories, batched.histories,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fused.final_w, batched.final_w, rtol=1e-5,
                               atol=1e-6)
    alone = run_sweep(obj, 2, [specs("fused")[1]])
    assert np.array_equal(alone.final_w[0], fused.final_w[1])
    assert np.array_equal(alone.histories[0], fused.histories[1])


def test_mlp_sweep_on_the_card_matches_cpu(gen):
    """The MLP on the batched engine (K1 per update) on the card and on the
    CPU: rtol 1e-5, atol 1e-6 (float64 inside, rounded once, on both)."""
    from repro_torch.core.objectives import mlp_lm_objective

    kw = dict(vocab_size=16, seq_len=4, d_model=8, d_hidden=16)
    specs = [SweepSpec(scheme=s, step_size=0.1, tau=2, num_threads=4,
                       inner_steps=32, seed=c)
             for c, s in enumerate(("consistent", "inconsistent", "unlock"))]
    before = svrg_update.launches
    card = run_sweep(mlp_lm_objective(32, **kw), 2, specs)
    assert svrg_update.launches == before + 2 * 128
    cpu = run_sweep(mlp_lm_objective(32, device="cpu", **kw), 2, specs)
    np.testing.assert_allclose(card.histories, cpu.histories, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(card.final_w, cpu.final_w, rtol=1e-5,
                               atol=1e-6)


MLP_KW = dict(vocab_size=16, seq_len=4, d_model=8, d_hidden=16)


@pytest.mark.parametrize("activation", ["relu", "gelu", "silu"])
def test_mlp_sample_grad_kernel_matches_objective(gen, activation):
    """The MLP kernel's hand-written backward against the objective's
    `torch.func` gradient on the card, rtol 1e-6, atol 1e-7 (float64
    inside, rounded once), at the objective's default widths."""
    from repro_torch.core.objectives import mlp_lm_objective
    from repro_torch.kernels.sweep_epoch_mlp import sample_grad

    obj = mlp_lm_objective(64, activation=activation)
    data = obj.data_args()
    W = obj.init_flat() + 0.3 * torch.randn((2, obj.flat_dim), generator=gen,
                                            device="cuda")
    for c in range(2):
        for i in (0, 33, 63):
            g = sample_grad(*data, i, W[c].contiguous(), obj.kernel_widths)
            want = obj.flat_sample_grad(data, torch.tensor(i), W[c])
            torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("placement", ["shared", "global"])
@pytest.mark.parametrize("engine", ["asysvrg", "hogwild"])
def test_sweep_epoch_mlp_kernel_matches_plain(gen, engine, placement):
    """One epoch launch against the plain version from the same inputs, the
    three readers (the unlock row dropping 10% of its coordinates), at each
    placement: iterates and losses within rtol 1e-5, atol 1e-6."""
    from repro_torch.core.objectives import mlp_lm_objective
    from repro_torch.kernels.sweep_epoch_mlp.ops import sweep_epoch_mlp
    from repro_torch.kernels.sweep_epoch_mlp.ref import sweep_epoch_mlp_ref

    obj = mlp_lm_objective(32, **MLP_KW)
    C, d = 3, obj.flat_dim
    w = obj.init_flat() + 0.05 * torch.randn((C, d), generator=gen,
                                             device="cuda")
    mu = 1e-3 * torch.randn((C, d), generator=gen, device="cuda")
    args = (*obj.data_args(), w, mu if engine == "asysvrg" else None,
            prng.keys_from_seeds(range(C), "cuda"),
            torch.full((C,), 0.1, device="cuda"), [2, 2, 1], [0, 1, 2],
            [1, 2, 1])
    kw = dict(widths=obj.kernel_widths, engine=engine, total=64, buf_len=3,
              option=2, drop_prob=0.1)
    before = dict(sweep_epoch_mlp.placements)
    out, loss = sweep_epoch_mlp(*args, placement=placement, **kw)
    assert sweep_epoch_mlp.placements[placement] == before[placement] + 1
    ref, ref_loss = sweep_epoch_mlp_ref(*args, **kw)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seq_len", [5, 20])
@pytest.mark.parametrize("engine", ["asysvrg", "hogwild"])
def test_sweep_epoch_mlp_kernel_cycles_positions(gen, engine, seq_len):
    """One epoch launch against the plain version where the positions do
    not fill the warps evenly: S 5 (5 position warps a set) and S 20 (8
    warps, positions cycling, the last round 4 warps short); the three
    readers, the unlock row dropping 10%; rtol 1e-5, atol 1e-6."""
    from repro_torch.core.objectives import mlp_lm_objective
    from repro_torch.kernels.sweep_epoch_mlp.ops import sweep_epoch_mlp
    from repro_torch.kernels.sweep_epoch_mlp.ref import sweep_epoch_mlp_ref

    obj = mlp_lm_objective(32, **dict(MLP_KW, seq_len=seq_len))
    C, d = 3, obj.flat_dim
    w = obj.init_flat() + 0.05 * torch.randn((C, d), generator=gen,
                                             device="cuda")
    mu = 1e-3 * torch.randn((C, d), generator=gen, device="cuda")
    args = (*obj.data_args(), w, mu if engine == "asysvrg" else None,
            prng.keys_from_seeds(range(C), "cuda"),
            torch.full((C,), 0.1, device="cuda"), [2, 2, 1], [0, 1, 2],
            [1, 2, 1])
    kw = dict(widths=obj.kernel_widths, engine=engine, total=48, buf_len=3,
              option=2, drop_prob=0.1)
    out, loss = sweep_epoch_mlp(*args, **kw)
    ref, ref_loss = sweep_epoch_mlp_ref(*args, **kw)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)


def test_sweep_epoch_mlp_full_grad_and_loss_at_64_samples(gen):
    """The full gradient and the loss over n 64, several samples at once
    (`full_sets`), against the objective's on the card: rtol 1e-6, atol
    1e-7; the loss entry equal to the full gradient's loss."""
    from repro_torch.core.objectives import mlp_lm_objective
    from repro_torch.kernels.sweep_epoch_mlp import mlp_full_grad, mlp_loss

    obj = mlp_lm_objective(64, **MLP_KW)
    data = obj.data_args()
    W = obj.init_flat() + 0.3 * torch.randn((3, obj.flat_dim), generator=gen,
                                            device="cuda")
    mu, f = mlp_full_grad(*data, W, obj.kernel_widths)
    torch.testing.assert_close(mu, obj.flat_full_grad(data, W), rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(f, obj.flat_loss(data, W), rtol=1e-6, atol=0)
    assert torch.equal(mlp_loss(*data, W, obj.kernel_widths), f)


def test_sweep_epoch_mlp_full_grad_and_loss_match_objective(gen):
    from repro_torch.core.objectives import mlp_lm_objective
    from repro_torch.kernels.sweep_epoch_mlp import mlp_full_grad, mlp_loss

    obj = mlp_lm_objective(32, **MLP_KW)
    data = obj.data_args()
    W = obj.init_flat() + 0.3 * torch.randn((3, obj.flat_dim), generator=gen,
                                            device="cuda")
    mu, f = mlp_full_grad(*data, W, obj.kernel_widths)
    torch.testing.assert_close(mu, obj.flat_full_grad(data, W), rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(f, obj.flat_loss(data, W), rtol=1e-6, atol=0)
    assert torch.equal(mlp_loss(*data, W, obj.kernel_widths), f)


def test_sweep_epoch_mlp_unstaged_entries_match_plain(gen):
    """At V 256, D 64, H 256 the row and its transposed copies do not fit
    a block beside one set, so the full-gradient, loss and sample-gradient
    blocks read the row where it lies: each against its plain version."""
    from repro_torch.core.objectives import mlp_lm_objective
    from repro_torch.kernels.sweep_epoch_mlp import ops as mlp_ops
    from repro_torch.kernels.sweep_epoch_mlp.ref import (full_grad_ref,
                                                         sample_grad_ref)

    obj = mlp_lm_objective(64, vocab_size=256, seq_len=8, d_model=64,
                           d_hidden=256)
    widths, data = obj.kernel_widths, obj.data_args()
    limit = mlp_ops._limit(torch.device("cuda"))
    assert mlp_ops.full_layout(8, mlp_ops.MLPWidths(*widths), obj.n,
                               limit)[1] is False
    W = obj.init_flat() + 0.05 * torch.randn((2, obj.flat_dim),
                                             generator=gen, device="cuda")
    mu, f = mlp_ops.mlp_full_grad(*data, W, widths)
    mu_ref, f_ref = full_grad_ref(*data, W, widths)
    torch.testing.assert_close(mu, mu_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(f, f_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mlp_ops.mlp_loss(*data, W, widths), f_ref,
                               rtol=1e-5, atol=1e-6)
    g = mlp_ops.sample_grad(*data, 17, W[1].contiguous(), widths)
    want = sample_grad_ref(*data, torch.tensor([17], device="cuda"), W[1:],
                           widths)[0]
    torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-7)


def test_mlp_fused_sweep_matches_batched_on_the_card(gen):
    """The MLP fused (its own kernel: per group one loss launch, per epoch
    one full-gradient and one epoch launch, no K1) against batched (K1 per
    update) on the card, rtol 1e-5, atol 1e-6; a row alone equal in bits
    to the row in its group."""
    from repro_torch.core.objectives import mlp_lm_objective
    from repro_torch.kernels.sweep_epoch_mlp.ops import sweep_epoch_mlp

    obj = mlp_lm_objective(32, **MLP_KW)

    def specs(mode):
        return [SweepSpec(scheme=s, step_size=0.1, tau=2, num_threads=4,
                          inner_steps=32, seed=c, engine_mode=mode)
                for c, s in enumerate(("consistent", "inconsistent",
                                       "unlock"))] + \
            [SweepSpec(algo="hogwild", scheme="unlock", step_size=0.1,
                       num_threads=4, tau=-1, engine_mode=mode)]

    before = (sweep_epoch_mlp.launches, svrg_update.launches)
    fused = run_sweep(obj, 2, specs("fused"))
    # 2 groups x (1 loss + 2 epochs) + 2 snapshots of the AsySVRG group
    assert (sweep_epoch_mlp.launches, svrg_update.launches) == \
        (before[0] + 8, before[1])
    batched = run_sweep(obj, 2, specs("vmap"))
    np.testing.assert_allclose(fused.histories, batched.histories,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fused.final_w, batched.final_w, rtol=1e-5,
                               atol=1e-6)
    alone = run_sweep(obj, 2, [specs("fused")[1]])
    assert np.array_equal(alone.final_w[0], fused.final_w[1])
    assert np.array_equal(alone.histories[0], fused.histories[1])


@pytest.mark.parametrize("placement", list(sweep_ops.PLACEMENTS))
@pytest.mark.parametrize("d", [33, 2048])
@pytest.mark.parametrize("engine", ["asysvrg", "hogwild"])
def test_sweep_epoch_every_placement_matches_plain(gen, engine, d, placement):
    """Each placement, named, whatever the size would pick: unaligned
    (d = 33) and aligned rows, epochs of 1 and 37 steps."""
    for total in (1, 37):
        _sweep_vs_plain(gen, n=300, d=d, engine=engine, total=total,
                        placement=placement)


@pytest.mark.parametrize("engine", ["asysvrg", "hogwild"])
def test_sweep_epoch_news20_width_placements(gen, engine):
    """At news20's width (d = 4096, buf_len 10) the placement chosen by
    size, then every placement that fits the block, at a short epoch."""
    limit = kernel.max_shared_bytes(torch.device("cuda"))
    tau = (9, 9, 9)
    chosen = _sweep_vs_plain(gen, n=400, d=4096, engine=engine, total=48,
                             tau=tau)
    assert chosen == sweep_ops.choose_placement(4096, 10, engine, limit)
    for placement in sweep_ops.PLACEMENTS:
        if sweep_ops.shared_bytes(4096, 10, engine, placement) <= limit:
            _sweep_vs_plain(gen, n=400, d=4096, engine=engine, total=48,
                            tau=tau, placement=placement)


def test_sweep_epoch_launch_refuses_a_block_too_large(gen):
    X, y, w, mu, keys = _sweep_inputs(gen, 100, 4096, 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sweep_epoch(X, y, 1e-3, w, mu, keys,
                    torch.tensor([0.5], device="cuda"), [9], [0], [1],
                    engine="asysvrg", total=8, buf_len=10, option=2,
                    drop_prob=0.0, placement="shared")


def test_sweep_epoch_kernel_refuses_bytes_off_its_layout(gen):
    """The C entry checks the caller's shared-memory size against its own
    layout: bytes off by a granule, or those of another placement."""
    X, y, w, mu, keys = _sweep_inputs(gen, 100, 64, 1)
    row_ints = torch.tensor([[3], [0], [1]], dtype=torch.int32, device="cuda")
    out, loss = torch.empty_like(w), torch.empty(1, device="cuda")
    terms = torch.empty((1, 100), dtype=torch.float64, device="cuda")
    nbytes = sweep_ops.shared_bytes(64, 4, "asysvrg", "shared")
    for staged, smem in ((True, nbytes + 16), (True, nbytes - 16),
                         (False, nbytes)):
        rc = kernel.launch(X, y, w, mu, keys, torch.tensor([0.5], device="cuda"),
                           row_ints, None, out, terms, loss, engine="asysvrg",
                           total=8, buf_len=4, option=2, drop=False,
                           staged=staged, smem_bytes=smem,
                           reg=regularizer.regularizer(1e-3), keep_p=1.0)
        assert rc != 0


@pytest.mark.parametrize("n,d", [(97, 33), (20242, 1000)])
@pytest.mark.parametrize("tau,delay_id", [(0, 0), (5, 1), (7, 2)])
def test_sweep_epoch_draws_equal_prng(gen, n, d, tau, delay_id):
    key = prng.PRNGKey(1234, "cuda")
    got = kernel_draws(key, n, d, tau, delay_id, 40)
    want = draws(key, n, d, tau, delay_id, 40)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fused_row_alone_equals_row_in_group(gen):
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((96, 64)) / 8).astype(np.float32)
    y = np.where(rng.random(96) < 0.5, -1.0, 1.0).astype(np.float32)
    obj = LogisticRegression(X, y, 1e-3)
    specs = [SweepSpec(scheme=s, step_size=0.5, num_threads=4, inner_steps=32,
                       seed=c, engine_mode="fused")
             for c, s in enumerate(("consistent", "inconsistent", "unlock"))]
    group = run_sweep(obj, 2, specs)
    for c, spec in enumerate(specs):
        alone = run_sweep(obj, 2, [spec])
        assert np.array_equal(alone.final_w[0], group.final_w[c])
        assert np.array_equal(alone.histories[0], group.histories[c])


@pytest.mark.parametrize("dtype,tol,route", [
    (torch.float32, 2e-5, "simt"), (torch.bfloat16, 3e-2, "wgmma")])
@pytest.mark.parametrize("Sq,Sk,Sp,N,K,h", [
    (80, 77, 80, 4, 4, 64), (24, 77, 80, 4, 4, 64), (130, 33, 48, 8, 2, 128),
    (64, 200, 200, 4, 1, 32), (200, 64, 64, 6, 3, 256)])
def test_flash_attention_key_length_matches_plain(gen, dtype, tol, route, Sq,
                                                  Sk, Sp, N, K, h):
    """Non-causal Sq queries over the first Sk rows of a key buffer of Sp
    rows (the view the encoder-decoder passes), on both routes, against
    the plain version over the same view; the rows past Sk hold large
    values, which must not leak in. Sk ragged against both kv tiles, more
    keys than queries and fewer."""
    q = torch.randn((2, Sq, N, h), generator=gen, device="cuda").to(dtype)
    k_pad, v_pad = (torch.randn((2, Sp, K, h), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
    k_pad[:, Sk:] = 30.0
    v_pad[:, Sk:] = 1e3
    k, v = k_pad[:, :Sk], v_pad[:, :Sk]
    before = _launches()
    out = gqa_flash(q, k, v, causal=False, window=0)
    torch.cuda.synchronize()
    _assert_one_launch(before, route)
    assert out.shape == q.shape
    torch.testing.assert_close(out.float(),
                               _flash_plain(q, k, v, False, 0).float(),
                               atol=tol, rtol=tol)


def test_flash_attention_key_length_refused_causal(gen):
    q = torch.randn((1, 64, 2, 32), generator=gen, device="cuda")
    kv = torch.randn((1, 60, 2, 32), generator=gen, device="cuda")
    before = _launches()
    for causal, window in ((True, 0), (False, 8)):
        with pytest.raises(ValueError, match="non-causal"):
            gqa_flash(q, kv, kv, causal=causal, window=window)
    assert _launches() == before


def _flash_plain(q, k, v, causal, window):
    """The plain version on the same CUDA tensors, after the kv repeat."""
    G = q.shape[2] // k.shape[2]
    kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1) for t in (k, v))
    return attention_ref(q.transpose(1, 2), kt, vt, causal=causal,
                         window=window).transpose(1, 2)


def _flash_inputs(gen, B, S, N, K, h, dtype):
    q = torch.randn((B, S, N, h), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, S, K, h), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


def _launches():
    return gqa_flash.launches, dict(gqa_flash.launches_by_route)


def _assert_one_launch(before, route):
    total, by_route = before
    want = dict(by_route, **{route: by_route[route] + 1})
    assert (gqa_flash.launches, gqa_flash.launches_by_route) == (total + 1, want)


@pytest.mark.parametrize("h", [32, 128, 160, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("S,causal,window", [
    (128, True, 0), (256, True, 8), (256, True, 32), (200, True, 32),
    (77, True, 0), (128, False, 0), (160, False, 24)])
def test_flash_attention_kernel_matches_plain(gen, h, dtype, tol, S, causal,
                                              window):
    """float32 2e-5 (summation order) on the CUDA-core route; bfloat16 3e-2
    on the tensor-core route: the plain version rounds the scores to
    bfloat16 before its float32 softmax, the kernel keeps them in float32
    (both round the probabilities to bfloat16). Windows 8 and 32 lie
    inside the kernels' 64-row query tiles, so rows fully masked within a
    processed kv tile occur; S 200 and 77 are ragged."""
    B, N, K = 2, 4, 2
    q, k, v = _flash_inputs(gen, B, S, N, K, h, dtype)
    before = _launches()
    out = gqa_flash(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    _assert_one_launch(before, "simt" if dtype == torch.float32 else "wgmma")
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(),
                               _flash_plain(q, k, v, causal, window).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("h", [32, 128, 160, 256])
@pytest.mark.parametrize("S,causal,window", [
    (200, True, 8), (200, True, 63), (200, True, 64), (200, True, 65),
    (2000, True, 1024), (2000, True, 0), (77, True, 0), (200, False, 0),
    (300, False, 65)])
def test_flash_attention_wgmma_matches_plain(gen, h, S, causal, window):
    """The tensor-core route in bf16 (3e-2) at the repo's head widths:
    windows inside, at and across the 32/64-key and 64-row tile edges and
    gemma3-4b's 1024; S ragged against both tile sizes; non-causal with
    and without a window."""
    q, k, v = _flash_inputs(gen, 2, S, 4, 2, h, torch.bfloat16)
    before = _launches()
    out = gqa_flash(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    _assert_one_launch(before, "wgmma")
    torch.testing.assert_close(out.float(),
                               _flash_plain(q, k, v, causal, window).float(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("N,K", [(4, 4), (4, 2), (8, 1), (16, 1), (6, 3)])
@pytest.mark.parametrize("h", [128, 256])
def test_flash_attention_wgmma_gqa_and_fused_views(gen, N, K, h):
    """Query head n reads kv head n // (N / K) on the tensor-core route, with
    q, k and v as views into one fused projection (strided heads)."""
    B, S = 2, 192
    qkv = torch.randn((B, S, N + 2 * K, h), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv[:, :, :N], qkv[:, :, N:N + K], qkv[:, :, N + K:]
    before = _launches()
    out = gqa_flash(q, k, v, window=65)
    torch.cuda.synchronize()
    _assert_one_launch(before, "wgmma")
    torch.testing.assert_close(out.float(),
                               _flash_plain(q, k, v, True, 65).float(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("h", [24, 40, 136])
def test_flash_attention_bf16_widths_off_16_take_simt(gen, h):
    """bf16 head widths that are a multiple of 8 but not of 16 go to the
    CUDA-core kernel."""
    q, k, v = _flash_inputs(gen, 2, 200, 4, 2, h, torch.bfloat16)
    before = _launches()
    out = gqa_flash(q, k, v, window=65)
    torch.cuda.synchronize()
    _assert_one_launch(before, "simt")
    torch.testing.assert_close(out.float(),
                               _flash_plain(q, k, v, True, 65).float(),
                               atol=3e-2, rtol=3e-2)


def test_flash_attention_simt_launcher_takes_bf16_at_h256(gen):
    """The CUDA-core kernel launched directly (as chip_smoke.py times it
    beside the tensor-core kernel) on the serve path's bf16 head width."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    q, k, v = _flash_inputs(gen, 2, 300, 4, 2, 256, torch.bfloat16)
    out = torch.empty_like(q)
    before = _launches()
    assert flash_kernel.launch(q, k, v, out, causal=True, window=65,
                               route="simt") == 0
    torch.cuda.synchronize()
    assert _launches() == before
    torch.testing.assert_close(out.float(),
                               _flash_plain(q, k, v, True, 65).float(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("N,K", [(4, 4), (8, 1), (16, 1), (6, 3)])
def test_flash_attention_kernel_gqa_and_strides(gen, N, K):
    """Query head n reads kv head n // (N / K); q, k and v may be views
    into one fused projection (strided heads)."""
    B, S, h = 2, 192, 64
    qkv = torch.randn((B, S, N + 2 * K, h), generator=gen, device="cuda")
    q, k, v = qkv[:, :, :N], qkv[:, :, N:N + K], qkv[:, :, N + K:]
    before = _launches()
    out = gqa_flash(q, k, v, window=50)
    _assert_one_launch(before, "simt")
    torch.testing.assert_close(out, _flash_plain(q, k, v, True, 50),
                               atol=2e-5, rtol=2e-5)


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(gen):
    x = torch.randn((1, 64, 2, 16), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        gqa_flash(x.double(), x.double(), x.double())
    with pytest.raises(TypeError):
        gqa_flash(x, x.to(torch.bfloat16), x)
    y = torch.randn((1, 64, 2, 12), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        gqa_flash(y, y, y)
    t = torch.randn((1, 64, 16, 2), generator=gen, device="cuda").transpose(2, 3)
    with pytest.raises(ValueError, match="strides"):
        gqa_flash(t, t, t)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "command-r-plus-104b",
                                  "gemma3-4b", "stablelm-12b"])
def test_serve_on_the_card_matches_cpu(gen, arch):
    """The reduced model's prefill logits within rtol 1e-3, atol 5e-4 of
    the CPU path (cache against recompute's tolerance in
    tests/test_models_smoke.py) and the same greedy tokens; every prefill
    layer launches the flash-attention kernel, decode none."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.factory import build_model
    from repro_torch.serve.loop import ServeSession, generate
    from repro_torch.sharding.rules import init_from_defs, tree_map

    cfg = reduced_config(arch)
    on_card, on_cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    params = init_from_defs(torch.Generator().manual_seed(0),
                            on_cpu.param_defs)
    card_params = tree_map(lambda t: t.cuda(), params)
    batch = {"tokens": prng.randint(prng.PRNGKey(0), (2, 40), 0,
                                    cfg.vocab_size)}
    logits = {}
    for name, bundle, p in (("card", on_card, card_params),
                            ("cpu", on_cpu, params)):
        logits[name] = ServeSession(bundle, p, 48).prefill(batch).cpu()
    torch.testing.assert_close(logits["card"], logits["cpu"], rtol=1e-3,
                               atol=5e-4)
    before = gqa_flash.launches
    out = generate(on_card, card_params, batch, 6, 48)
    assert gqa_flash.launches == before + cfg.num_layers
    assert torch.equal(out.cpu(), generate(on_cpu, params, batch, 6, 48))


# ---------------------------------------------------------------------------
# The training slice on the card
# ---------------------------------------------------------------------------

def test_flash_kernel_raises_under_autograd(gen):
    """K4 has no backward: q, k or v that need a gradient make gqa_flash
    raise on the card, before any launch; under no_grad it launches."""
    q, k, v = _flash_inputs(gen, 1, 64, 4, 2, 32, torch.float32)
    before = gqa_flash.launches
    for needs in ("q", "k", "v"):
        args = [t.clone().requires_grad_(name == needs)
                for name, t in zip("qkv", (q, k, v))]
        with pytest.raises(RuntimeError, match="no backward"):
            gqa_flash(*args, causal=True, window=0)
    assert gqa_flash.launches == before
    with torch.no_grad():
        gqa_flash(q.requires_grad_(), k, v, causal=True, window=0)
    assert gqa_flash.launches == before + 1


def test_apply_tree_equals_plain_bit_for_bit(gen):
    """One svrg_update launch per leaf (0-d, 1-d, 2-d and 4-d leaves, float32
    and bfloat16), a 0-d device step size, equal to the plain version."""
    from repro_torch.kernels.svrg_update.ops import apply_tree
    from repro_torch.utils.tree import tree_leaves, tree_map

    shapes = {"s": (), "v": (33,), "m": (7, 40), "t": (2, 5, 3, 16)}
    trees = [{k: torch.randn(s, generator=gen, device="cuda")
              for k, s in shapes.items()} for _ in range(4)]
    for tree in trees:
        tree["h"] = torch.randn((3, 24), generator=gen,
                                device="cuda").to(torch.bfloat16)
    lr = torch.tensor(0.3, device="cuda")
    before = svrg_update.launches
    out = apply_tree(*trees, lr, 0.01)
    assert svrg_update.launches == before + len(tree_leaves(trees[0]))
    want = tree_map(lambda u, g, g0, gf: svrg_update_ref(u, g, g0, gf, lr,
                                                         0.01), *trees)
    for key in out:
        assert out[key].shape == trees[0][key].shape
        assert torch.equal(out[key], want[key]), key


def test_two_layer_fused_step_equals_unfused(gen):
    """The reduced gemma3-4b at 2 layers, float32, on the card: each fused
    SVRG step (K1, one launch per leaf) against the unfused step from the
    same state, clip active: params rtol 1e-5, atol 1e-6; metrics equal;
    no flash-attention launch in training."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic_lm import SyntheticLMDataset
    from repro_torch.models.factory import build_model
    from repro_torch.config import TrainConfig
    from repro_torch.train.loop import device_batch
    from repro_torch.train.state import (init_train_state, make_snapshot_fns,
                                         make_train_step)
    from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("gemma3-4b").with_overrides(num_layers=2,
                                                     global_every=2)
    bundle = build_model(cfg, "cuda")
    tcfg = TrainConfig(steps=3, learning_rate=0.05, warmup_steps=1,
                       grad_clip=0.05,
                       svrg=SVRGConfig(snapshot_batches=2))
    ds = SyntheticLMDataset(cfg.vocab_size, 32, 8)
    state = init_train_state(gen, bundle, tcfg)
    begin, accum, fin = make_snapshot_fns(bundle, tcfg)
    state = begin(state)
    for j in range(2):
        state = accum(state, device_batch(ds.batch_at(j), "cuda"))
    state = fin(state)
    fused = make_train_step(bundle, tcfg, use_fused_update=True)
    unfused = make_train_step(bundle, tcfg)
    leaves = len(tree_leaves(state.params))
    flash = gqa_flash.launches
    for i in range(3):
        b = device_batch(ds.batch_at(i + 1), "cuda")
        before = svrg_update.launches
        sf, mf = fused(state, b)
        assert svrg_update.launches == before + leaves
        state, mu = unfused(state, b)
        assert float(mu["v_norm"]) > tcfg.grad_clip
        for key in mu:
            assert torch.equal(mf[key], mu[key]), (key, i)
        for (k, a), (_, c) in zip(tree_flatten_with_path(sf.params),
                                  tree_flatten_with_path(state.params)):
            torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6,
                                       msg=f"{k} step {i}")
    assert gqa_flash.launches == flash


def _moe_steps(bundle, params, toks, monkeypatch):
    """Prefill of 32 tokens and 2 decode steps: (logits on the CPU, each MoE
    routing, flash_attention launches)."""
    from repro_torch.models import moe

    seen, real = [], moe.route

    def spy(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(moe, "route", spy)
    before = gqa_flash.launches
    toks = toks.to(bundle.device)
    logits, cache = bundle.prefill_fn(params, {"tokens": toks[:, :32]}, 40)
    out = [logits]
    for step in range(2):
        logits, cache = bundle.decode_fn(params, cache, toks[:, 32 + step],
                                         32 + step)
        out.append(logits)
    monkeypatch.setattr(moe, "route", real)
    return [x.cpu() for x in out], seen, gqa_flash.launches - before


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_moe_serve_on_the_card_matches_cpu(gen, arch, monkeypatch):
    """The reduced MoE models in float32 (the CUDA-core attention route):
    one `flash_attention` launch per layer at prefill, none in decode, and
    prefill and 2 decode steps on the card against the CPU from the same
    weights: logits rtol 1e-3, atol 5e-4, the chosen experts equal."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.rules import init_from_defs, tree_map

    cfg = reduced_config(arch)
    card, cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    params = init_from_defs(gen, card.param_defs)
    toks = prng.randint(prng.PRNGKey(3), (2, 40), 0, cfg.vocab_size)
    got, got_routes, launches = _moe_steps(card, params, toks, monkeypatch)
    want, want_routes, _ = _moe_steps(
        cpu, tree_map(lambda t: t.cpu(), params), toks, monkeypatch)
    assert launches == cfg.num_layers
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=5e-4)
    assert len(got_routes) == len(want_routes) > 0
    for a, b in zip(got_routes, want_routes):
        assert torch.equal(a.topi.cpu(), b.topi)


# ---------------------------------------------------------------------------
# The recurrent families on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,prompt,attention_layers",
                         [("recurrentgemma-2b", 13, 1),
                          ("falcon-mamba-7b", 24, 0)])
def test_recurrent_serve_on_the_card_matches_cpu(gen, arch, prompt,
                                                 attention_layers):
    """The reduced hybrid (window 8: the prompt of 13 wraps the ring) and
    SSM models in float32: prefill and 4 decode steps on the card against
    the CPU from the same weights, logits and every cache leaf within rtol
    1e-3, atol 5e-4 (of the leaf's scale for the caches); one
    `flash_attention` launch per attention layer at prefill, none in
    decode or for the SSM; a 3-chunk scan under grad gives finite
    gradients (the loss's backward rematerialises each chunk)."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.distributed import value_and_grad
    from repro_torch.models import mamba, rglru
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.rules import init_from_defs, tree_map
    from repro_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch)
    card, cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    params = init_from_defs(gen, card.param_defs)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    toks = prng.randint(prng.PRNGKey(5), (2, prompt + 4), 0, cfg.vocab_size)
    out = {}
    for name, bundle, p in (("card", card, params), ("cpu", cpu, cpu_params)):
        t = toks.to(bundle.device)
        before = gqa_flash.launches
        logits, cache = bundle.prefill_fn(p, {"tokens": t[:, :prompt]},
                                          prompt + 4)
        launches = gqa_flash.launches - before
        seen = [logits.cpu()]
        for step in range(4):
            logits, cache = bundle.decode_fn(p, cache, t[:, prompt + step],
                                             prompt + step)
            seen.append(logits.cpu())
        out[name] = (seen, {k: v.cpu() for k, v in cache.items()}, launches,
                     gqa_flash.launches - before - launches)
    (card_logits, card_cache, prefill_n, decode_n), (cpu_logits, cpu_cache,
                                                    _, _) = out["card"], out["cpu"]
    assert (prefill_n, decode_n) == (attention_layers, 0)
    for a, b in zip(card_logits, cpu_logits):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=5e-4)
    for key in cpu_cache:
        scale = float(cpu_cache[key].abs().max())
        torch.testing.assert_close(card_cache[key], cpu_cache[key], rtol=1e-3,
                                   atol=5e-4 * max(1.0, scale), msg=key)
    mod = rglru if cfg.family == "hybrid" else mamba
    old = mod.CHUNK
    mod.CHUNK = 8
    try:
        batch = card.make_inputs(2, 24, gen)
        loss, grad = value_and_grad(card.loss_fn)(params, batch)
    finally:
        mod.CHUNK = old
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in tree_leaves(grad))


# ---------------------------------------------------------------------------
# The encoder-decoder and vision families on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,overrides,launches", [
    ("whisper-large-v3", dict(encoder_layers=2, num_layers=2, encoder_seq=13),
     6),
    ("llama-3.2-vision-11b", {}, 5)])
def test_encdec_vlm_prefill_on_the_card_matches_cpu(gen, arch, overrides,
                                                    launches):
    """The reduced models at 2 layers' worth (whisper: 2 encoder + 2
    decoder layers over 13 frames padded to 16; the vision model: one
    group of 5) in float32, every zero-initialised leaf (biases, gates,
    norm scales) drawn: prefill logits within rtol 1e-3, atol 5e-4 of the
    CPU path and every cache leaf within 5e-4 of its scale; K4 launched
    once per encoder layer and per attention of the decoder (the CUDA-core
    route, a key length of its own where it is the encoder's or a
    cross-attention), none in decode; greedy tokens equal."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.factory import _modality_extra, build_model
    from repro_torch.serve.loop import ServeSession, generate
    from repro_torch.sharding.rules import init_from_defs, tree_map

    def draw_zero_leaves(params, defs, gen):
        for key, d in defs.items():
            if isinstance(d, dict):
                draw_zero_leaves(params[key], d, gen)
            elif d.init == "zeros":
                params[key].copy_(0.5 * torch.randn(params[key].shape,
                                                    generator=gen))

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch).with_overrides(**overrides)
    card, cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    params = init_from_defs(torch.Generator().manual_seed(0), cpu.param_defs)
    draw_zero_leaves(params, cpu.param_defs, torch.Generator().manual_seed(3))
    card_params = tree_map(lambda t: t.cuda(), params)
    batch = {"tokens": prng.randint(prng.PRNGKey(1), (2, 11), 0,
                                    cfg.vocab_size)}
    for name, shape in _modality_extra(cfg).items():
        batch[name] = torch.randn((2, *shape), generator=torch.Generator()
                                  .manual_seed(2))
    out = {}
    for name, bundle, p in (("card", card, card_params), ("cpu", cpu, params)):
        sess = ServeSession(bundle, p, 16)
        before = gqa_flash.launches_by_route["simt"]
        logits = sess.prefill(batch)
        out[name] = (logits.cpu(), {k: v.cpu() for k, v in sess.cache.items()},
                     gqa_flash.launches_by_route["simt"] - before)
    (card_logits, card_cache, n), (cpu_logits, cpu_cache, _) = \
        out["card"], out["cpu"]
    assert n == launches
    torch.testing.assert_close(card_logits, cpu_logits, rtol=1e-3, atol=5e-4)
    for key in cpu_cache:
        scale = float(cpu_cache[key].abs().max())
        torch.testing.assert_close(card_cache[key], cpu_cache[key], rtol=1e-3,
                                   atol=5e-4 * max(1.0, scale), msg=key)
    before = gqa_flash.launches
    toks = generate(card, card_params, batch, 4, 16)
    assert gqa_flash.launches == before + launches
    assert torch.equal(toks.cpu(), generate(cpu, params, batch, 4, 16))


def test_flash_attention_simt_at_whisper_encoder_shape(gen):
    """K4's float32 CUDA-core route at whisper-large-v3's encoder shape:
    1504 queries over the first 1500 rows of the 1504-row key buffer, MHA
    N = K = 20, h 64, against the plain attention on the same CUDA
    inputs; the 4 padded rows hold large values that must not leak in."""
    q = torch.randn((2, 1504, 20, 64), generator=gen, device="cuda")
    k_pad, v_pad = (torch.randn((2, 1504, 20, 64), generator=gen,
                                device="cuda") for _ in range(2))
    k_pad[:, 1500:] = 30.0
    v_pad[:, 1500:] = 1e3
    k, v = k_pad[:, :1500], v_pad[:, :1500]
    before = _launches()
    out = gqa_flash(q, k, v, causal=False, window=0)
    torch.cuda.synchronize()
    _assert_one_launch(before, "simt")
    torch.testing.assert_close(out, _flash_plain(q, k, v, False, 0),
                               atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# The sweep service and the ledger on the card
# ---------------------------------------------------------------------------

def _service_obj(gen):
    n, p = 512, 256
    X = torch.randn((n, p), generator=gen, device="cuda") / p ** 0.5
    y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5,
                    -1.0, 1.0)
    return LogisticRegression(X, y, 1e-4)


def _service_specs(mode):
    return [SweepSpec(seed=s, scheme=scheme, step_size=0.5, num_threads=4,
                      engine_mode=mode)
            for s, scheme in ((0, "inconsistent"), (1, "unlock"))]


def test_service_warm_flush_constructs_and_builds_nothing(gen):
    """Two tenants, fused and batched requests: a flush demuxes each to a
    standalone run_sweep (fused bits equal, batched allclose), and a second
    flush of the same shapes constructs no runner and builds no kernel."""
    from repro_torch.kernels import _build
    from repro_torch.service import SweepService, cache_stats

    obj = _service_obj(gen)
    svc = SweepService(obj, epochs=2)
    for _ in range(2):
        base, built = cache_stats(), _build.builds()
        a = svc.submit(_service_specs("fused"), tenant="a")
        b = svc.submit(_service_specs("vmap"), tenant="b")
        svc.flush()
    warm = cache_stats().since(base)
    assert (warm.misses, warm.compiles, _build.builds() - built) == (0, 0, 0)
    fused, batched = svc.result(a), svc.result(b)
    alone = run_sweep(obj, 2, _service_specs("fused"))
    assert np.array_equal(fused.histories, alone.histories)
    assert np.array_equal(fused.final_w, alone.final_w)
    alone = run_sweep(obj, 2, _service_specs("vmap"))
    np.testing.assert_allclose(batched.histories, alone.histories,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(batched.final_w, alone.final_w, rtol=1e-5,
                               atol=1e-6)


def test_ledger_wall_covers_the_device_work(gen, monkeypatch):
    """The ledger's wall time of a fused group is not shorter than a
    CUDA-event pair around the same runner call: the bracket ends after
    the results reached the host, not when the launches were queued."""
    from repro_torch.obs import ledger
    from repro_torch.service import cache

    obj = _service_obj(gen)
    specs = [SweepSpec(seed=0, step_size=0.5, num_threads=4, inner_steps=4096,
                       engine_mode="fused")]
    run_sweep(obj, 2, specs)                     # runner and kernels warm
    fetch, pairs = cache.get_group_runner, []

    def timed_fetch(*args, **kwargs):
        runner = fetch(*args, **kwargs)

        def call(*call_args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = runner(*call_args)
            stop.record()
            pairs.append((start, stop))
            return out
        return call

    monkeypatch.setattr(cache, "get_group_runner", timed_fetch)
    led = ledger.enable_ledger()
    led.clear()
    try:
        run_sweep(obj, 2, specs)
        (entry,) = led.snapshot().values()
    finally:
        ledger.disable_ledger(clear=True)
    (start, stop), = pairs
    device_ms = start.elapsed_time(stop)
    assert device_ms > 1.0
    assert 1e3 * entry["wall_s_total"] >= device_ms
    assert entry["flops_source"] == "analytic" and entry["attained_frac"] > 0


def test_sinusoid_table_is_the_cpu_table(gen):
    """whisper's sinusoid table is built on the CPU for CUDA positions too
    (the card's float32 exp and sin round apart from the CPU's), so the
    card and the CPU path add the same bits."""
    from repro_torch.models import encdec

    pos = torch.arange(1504, dtype=torch.int32)[None].expand(2, 1504)
    table = encdec._sinusoid(pos.cuda(), 1280)
    assert torch.equal(table.cpu(), encdec._sinusoid(pos, 1280))
    resident = encdec._sinusoid_table(1504, 1280, "cuda")
    assert resident.is_cuda
    assert torch.equal(resident.cpu(),
                       encdec._sinusoid_table(1504, 1280, "cpu"))


@pytest.mark.parametrize("method", ["topk", "randk", "int8"])
def test_compression_on_the_card_matches_cpu(gen, method):
    """The compression operators on the card against the CPU: rand-k keeps
    the same indices and int8 draws the same noise (the card's
    `prng.permutation` sort and `prng.uniform`), top-k the same mask."""
    from repro_torch.core.compression import compressed_update, \
        init_error_feedback

    cpu = {"a": torch.randn(300, generator=gen, device="cuda").cpu(),
           "b": torch.randn((64, 33), generator=gen, device="cuda").cpu()}
    card = {k: v.cuda() for k, v in cpu.items()}
    key = prng.PRNGKey(7)
    got, ef_card = compressed_update(card, init_error_feedback(card), method,
                                     0.1, key.cuda())
    want, ef_cpu = compressed_update(cpu, init_error_feedback(cpu), method,
                                     0.1, key)
    for k in cpu:
        assert torch.equal(got[k].cpu() != 0, want[k] != 0)
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(ef_card.residual[k].cpu(),
                                   ef_cpu.residual[k], rtol=1e-6, atol=1e-6)
    if method == "randk":
        for n in (300, 2112, 5000):
            assert torch.equal(prng.permutation(key.cuda(), n).cpu(),
                               prng.permutation(key, n))
