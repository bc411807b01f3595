"""repro_torch.launch.dryrun and what it needs, against the JAX package.

- The analytic count (`count_params`, `attention_flops`, `model_flops`)
  equals the JAX package's for every dry-run architecture and shape: both
  read only the ParamDef trees, no compile.
- The batch specs (`input_specs`, `lm_batch_specs`) have the JAX package's
  shapes and dtypes, and each leaf's rank-0 shard (`sharding.rules.
  local_shape`) is the shard of the JAX package's PartitionSpec on the
  (16, 16) and (2, 16, 16) meshes: exact where the axes divide the dim, the
  ceiling (XLA pads, ``DTensor`` chunks unevenly; rank 0's is the largest
  either way) where they do not.
- At `HOST_MESH` the traced arguments of a 2-layer narrow dense model's
  train, prefill and decode cells take exactly the bytes XLA's
  ``memory_analysis().argument_size_in_bytes`` gives on the one CPU
  device. Peaks are not compared across the packages: XLA's buffer
  assignment (fusion, donation, rematerialisation) is not eager
  allocation, and the port's peak is held against the card's
  ``max_memory_allocated`` instead (``chip_smoke.py`` phase ``dryrun``).
- The flash-attention kernel's fake path gives the plain version's shape
  and dtype and launches nothing; its FLOP formula's pair count equals the
  unmasked entries of the kernel's mask.
- Every model module names the JAX package's sharding constraints on as
  many lines.
- The sharding helpers the train cells lean on (`grad_placed`, `settle`,
  `embed_lookup`, `logsumexp_last`, `take_along_last`) give the placements
  and shard shapes of the JAX lowering's layout on a fake world of 4 ranks.
- A reduced grid (2-layer gemma3-4b and deepseek-moe-16b, three shapes, both
  fake production meshes) traces in a subprocess under a deadline: the
  fake world is made in a process of its own, as the dry-run makes it.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, Mesh, NamedSharding as JNamedSharding
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import config as jconfig
from repro.configs import get_config as jget_config
from repro.launch import roofline as jroofline
from repro.models import factory as jfactory
from repro.sharding import rules as jrules
from repro.sharding.context import mesh_context as jmesh_context
from repro.train import state as jstate
from repro_torch import config
from repro_torch.configs import get_config
from repro_torch.data.synthetic_lm import lm_batch_specs
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.launch import dryrun, roofline
from repro_torch.models import factory
from repro_torch.sharding import rules
from repro_torch.utils.tree import tree_flatten_with_path

REPO = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_defs(arch):
    return jfactory.build_model(jget_config(arch)).param_defs


def _port_bundle(arch, **cut):
    cfg = get_config(arch).with_overrides(**cut) if cut else get_config(arch)
    return factory.build_model(cfg, "cpu")


def test_grid_constants_equal_the_reference():
    assert dryrun.ARCHS == ["whisper-large-v3", "chatglm3-6b", "stablelm-12b",
                            "gemma3-4b", "command-r-plus-104b",
                            "qwen3-moe-235b-a22b", "deepseek-moe-16b",
                            "llama-3.2-vision-11b", "recurrentgemma-2b",
                            "falcon-mamba-7b"]
    assert {n: (s.kind, s.seq_len, s.global_batch)
            for n, s in config.SHAPE_GRID.items()} == \
        {n: (s.kind, s.seq_len, s.global_batch)
         for n, s in jconfig.SHAPE_GRID.items()}
    for name in ("SINGLE_POD", "MULTI_POD", "HOST_MESH"):
        mine, ref = getattr(config, name), getattr(jconfig, name)
        assert (mine.shape, mine.axes, mine.num_devices, mine.multi_pod) == \
            (ref.shape, ref.axes, ref.num_devices, ref.multi_pod)
    for arch in dryrun.ARCHS:
        for name, shape in config.SHAPE_GRID.items():
            want = name == "long_500k" and arch not in (
                "recurrentgemma-2b", "falcon-mamba-7b")
            assert (dryrun.cell_skip_reason(arch, shape) is not None) == want


@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_analytic_count_equals_reference(arch):
    jcfg, jdefs = jget_config(arch), _jax_defs(arch)
    bundle = _port_bundle(arch)
    assert roofline.count_params(bundle.cfg, bundle.param_defs) == \
        jroofline.count_params(jcfg, jdefs)
    for name, shape in config.SHAPE_GRID.items():
        jshape = jconfig.SHAPE_GRID[name]
        for decode in (False, True):
            assert roofline.attention_flops(
                bundle.cfg, shape.seq_len, shape.global_batch, decode) == \
                jroofline.attention_flops(jcfg, jshape.seq_len,
                                          jshape.global_batch, decode)
        assert roofline.model_flops(bundle.cfg, shape, bundle.param_defs) == \
            jroofline.model_flops(jcfg, jshape, jdefs)


def _jax_shard(shape, pspec, amesh):
    """The JAX package's per-device shard: `shard_shape` where the axes
    divide the dim, else the padded ceiling."""
    try:
        return tuple(JNamedSharding(amesh, pspec).shard_shape(tuple(shape)))
    except ValueError:
        out = list(shape)
        for d, entry in enumerate(pspec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            ways = int(np.prod([amesh.shape[a] for a in axes]))
            out[d] = -(-out[d] // ways)
        return tuple(out)


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_specs_and_shards_equal_reference(arch, mesh_kind):
    sizes, axes = MESHES[mesh_kind]
    amesh = AbstractMesh(sizes, axes)
    mesh = dict(zip(axes, sizes))
    jbundle = jfactory.build_model(jget_config(arch))
    bundle = _port_bundle(arch)
    # the batch of every shape, shapes and dtypes, and its shards
    for name, shape in config.SHAPE_GRID.items():
        want = jbundle.input_specs(jconfig.SHAPE_GRID[name], None)
        got = bundle.input_specs(shape)
        assert sorted(got) == sorted(want)
        placed = bundle.input_specs(shape, mesh)
        jspec = jrules.batch_pspec(amesh)
        for key, spec in got.items():
            assert spec.shape == tuple(want[key].shape), key
            assert _dtype_name(spec.dtype) == str(want[key].dtype), key
            assert spec.sharding is None
            assert rules.local_shape(spec.shape, placed[key].sharding) == \
                _jax_shard(spec.shape, jspec, amesh), (name, key)
    # every parameter leaf's shard
    jleaves = jax.tree_util.tree_flatten_with_path(
        jbundle.param_defs, is_leaf=jrules.is_param_def)[0]
    specs = rules.defs_to_specs(bundle.param_defs, mesh)
    leaves = dict(tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(
        x, rules.TensorSpec)))
    assert len(leaves) == len(jleaves)
    for path, d in jleaves:
        key = "/".join(str(p.key) for p in path)
        spec = leaves[key]
        pspec = jrules.logical_to_pspec(d.shape, d.axes, amesh)
        assert rules.local_shape(spec.shape, spec.sharding) == \
            _jax_shard(d.shape, pspec, amesh), key


def test_lm_batch_specs_equal_reference():
    from repro.data.synthetic_lm import lm_batch_specs as jlm_batch_specs

    want = jlm_batch_specs(32, 64)
    got = lm_batch_specs(32, 64)
    assert sorted(got) == sorted(want)
    for key, spec in got.items():
        assert (spec.shape, _dtype_name(spec.dtype)) == \
            (tuple(want[key].shape), str(want[key].dtype))
    placed = lm_batch_specs(32, 64, {"data": 16, "model": 16})
    assert rules.local_shape(placed["tokens"].shape,
                             placed["tokens"].sharding) == (2, 64)


def test_single_device_mesh_gives_plain_fake_tensors():
    fm = FakeTensorMode()
    defs = _port_bundle("gemma3-4b", num_layers=2).param_defs
    tree = rules.defs_to_shape_structs(defs, {"data": 1, "model": 1}, fm,
                                       dtype="bfloat16", device="cpu")
    leaves = [x for _, x in tree_flatten_with_path(tree)]
    assert leaves and all(type(x).__name__ == "FakeTensor" for x in leaves)
    assert all(x.dtype == torch.bfloat16 for x in leaves)
    assert tree["tok_embed"].shape == (262144, 2560)


# a narrow 2-layer gemma3-4b (local:global attention, GQA, tied head)
TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
            head_dim=32, d_ff=128, vocab_size=256, local_window=8)
TINY_SHAPES = {"train": ("train", 16, 4), "prefill": ("prefill", 16, 2),
               "decode": ("decode", 16, 2)}


def _jax_argument_bytes(kind, seq, batch):
    """The JAX package's dry-run lowering of one cell (as its
    ``lower_cell``, at the tiny config) on the one CPU device:
    ``argument_size_in_bytes``."""
    cfg = jget_config("gemma3-4b").with_overrides(**TINY)
    bundle = jfactory.build_model(cfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    shape = jconfig.ShapeConfig(kind, kind, seq, batch)
    with jmesh_context(mesh):
        if kind == "train":
            tcfg = jconfig.TrainConfig(optimizer="svrg", learning_rate=1e-3,
                                       microbatches=1,
                                       svrg=jconfig.SVRGConfig())
            sd = jstate.make_train_state_defs(bundle, tcfg)
            lowered = jax.jit(jstate.make_train_step(bundle, tcfg),
                              donate_argnums=(0,)).lower(
                jrules.defs_to_shape_structs(sd, mesh),
                bundle.input_specs(shape, mesh))
        else:
            params = jrules.defs_to_shape_structs(bundle.param_defs, mesh,
                                                  dtype=cfg.dtype)
            if kind == "prefill":
                lowered = jax.jit(lambda p, b: bundle.prefill_fn(p, b, seq)
                                  ).lower(params, bundle.input_specs(shape,
                                                                     mesh))
            else:
                lowered = jax.jit(bundle.decode_fn, donate_argnums=(1,)).lower(
                    params, jrules.defs_to_shape_structs(
                        bundle.cache_defs(batch, seq), mesh),
                    jax.ShapeDtypeStruct((batch,), jnp.int32),
                    jax.ShapeDtypeStruct((), jnp.int32))
    return lowered.compile().memory_analysis().argument_size_in_bytes


@pytest.mark.parametrize("kind", sorted(TINY_SHAPES))
def test_host_mesh_argument_bytes_equal_xla(kind):
    kind_, seq, batch = TINY_SHAPES[kind]
    cfg = get_config("gemma3-4b").with_overrides(**TINY)
    shape = config.ShapeConfig(kind, kind_, seq, batch)
    launches = gqa_flash.launches
    rec = dryrun.trace_cell(cfg, shape, dryrun.cell_mesh("host"),
                            microbatches=1)
    assert gqa_flash.launches == launches
    mem = rec["memory"]
    assert mem["argument_bytes"] == _jax_argument_bytes(kind_, seq, batch)
    assert mem["peak_per_device_bytes"] == (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        - mem["alias_bytes"])
    assert mem["peak_per_device_bytes"] >= mem["argument_bytes"]
    assert rec["op_cost"]["flops"] > 0
    assert rec["collectives"]["count"] == 0
    if kind == "decode":     # the cache is written in place
        cache = 2 * 2 * batch * 1 * seq * 32 * 2
        assert mem["alias_bytes"] == cache


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_flash_attention_fake_path(device):
    """Fake tensors take the kernel's fake op: the plain version's shape and
    dtype, no launch, and the kernel's FLOPs to a flop counter."""
    from torch.utils.flop_counter import FlopCounterMode

    gen = np.random.default_rng(0)
    q = torch.tensor(gen.standard_normal((2, 12, 4, 16)), dtype=torch.float32)
    k = torch.tensor(gen.standard_normal((2, 12, 2, 16)), dtype=torch.float32)
    want = gqa_flash(q, k, k, causal=True, window=5)
    launches = gqa_flash.launches
    with FakeTensorMode() as fm:
        fq = torch.empty(q.shape, dtype=torch.bfloat16, device=device)
        fk = torch.empty(k.shape, dtype=torch.bfloat16, device=device)
        with FlopCounterMode(display=False) as counter:
            out = gqa_flash(fq, fk, fk, causal=True, window=5)
    assert tuple(out.shape) == tuple(want.shape)
    assert out.dtype == fq.dtype and out.device.type == device
    assert gqa_flash.launches == launches
    pairs = 5 * 6 // 2 + (12 - 5) * 5
    assert counter.get_total_flops() == 4 * 2 * 4 * 16 * pairs
    del fm


@pytest.mark.parametrize("sq,sk,causal,window", [
    (12, 12, True, 0), (12, 12, True, 5), (12, 12, True, 12),
    (12, 12, True, 40), (1, 1, True, 3), (7, 19, False, 0)])
def test_attention_pairs_counts_the_mask(sq, sk, causal, window):
    """The pair count behind the kernel's FLOP formula equals the unmasked
    entries of the mask it applies (query i sees key j when j <= i and,
    with a window, i - j < window)."""
    from repro_torch.kernels.flash_attention.ops import attention_pairs

    i, j = np.arange(sq)[:, None], np.arange(sk)[None, :]
    seen = np.ones((sq, sk), dtype=bool)
    if causal:
        seen &= j <= i
        if window:
            seen &= i - j < window
    assert attention_pairs(sq, sk, causal, window) == int(seen.sum())


def _constrain_lines(path):
    """Lines outside imports that name the sharding constraints, comments
    and docstrings included."""
    return sum(1 for line in path.read_text().splitlines()
               if "constrain" in line
               and not re.match(r"\s*(from|import)\s", line))


@pytest.mark.parametrize("module", ["transformer", "moe", "layers", "mamba",
                                    "rglru", "encdec", "vlm"])
def test_constraint_sites_match_reference(module):
    want = _constrain_lines(REPO / "src" / "repro" / "models" / f"{module}.py")
    got = _constrain_lines(REPO / "src" / "repro_torch" / "models"
                           / f"{module}.py")
    assert want > 0 and got == want


# the sharding helpers' placements on a fake world of 4 ranks, a (2, 2)
# mesh; the fake backend moves no data, so placements and shard shapes are
# what is checked
_HELPERS = """
import json
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.launch.dryrun import fake_world
from repro_torch.sharding import context as ctx

fake_world(4)
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))

def dt(shape, placements, dtype=torch.float32, grad=False):
    full = torch.zeros(shape, dtype=dtype)
    x = distribute_tensor(full, mesh, [Replicate(), Replicate()]).redistribute(mesh, placements)
    return x.detach().requires_grad_(grad) if grad else x

out = {}
with ctx.mesh_context(mesh):
    # a weight's gradient: a pending sum over data without grad_placed
    w = dt((8, 4), [Replicate(), Shard(1)], grad=True)
    x = dt((4, 8), [Shard(0), Replicate()])
    g, = torch.autograd.grad((x @ ctx.grad_placed(w)).sum(), [w])
    out["grad_placed"] = [str(p) for p in g.placements]
    # settle: the batch sharding of the gradient kept on the data dim
    p = dt((4, 8), [Shard(0), Shard(1)], grad=True)
    y = p @ dt((8, 4), [Replicate(), Shard(0)])
    out["partial"] = [str(q) for q in y.placements]
    mask = dt((4, 4), [Shard(0), Replicate()])
    g, = torch.autograd.grad((ctx.settle(y) * mask).sum(), [p])
    out["settle"] = [str(q) for q in g.placements]
    # embed_lookup: rows a pending sum over the vocab's dim, placed as the
    # tokens on the other; rank 0's rows alone in the gradient
    table = dt((16, 4), [Replicate(), Shard(0)], grad=True)
    tokens = dt((4, 3), [Shard(0), Replicate()], dtype=torch.int64)
    rows = ctx.embed_lookup(tokens, ctx.grad_placed(table))
    g, = torch.autograd.grad(ctx.settle(rows).sum(), [table])
    out["embed_lookup"] = [[str(q) for q in rows.placements], list(rows.shape),
                           [str(q) for q in g.placements],
                           list(g.to_local().shape)]
    # logsumexp over a sharded last dim: no gather of the last dim
    logits = dt((4, 16), [Shard(0), Shard(1)], grad=True)
    with CommDebugMode() as comm:
        lse = ctx.logsumexp_last(logits)
    out["logsumexp_last"] = [list(lse.shape), comm.get_comm_counts().get(
        torch.ops.c10d_functional.all_gather_into_tensor, 0)]
    # take_along_last with the last dim whole: the gather's gradient is
    # the shard's
    logits = dt((4, 16), [Shard(0), Replicate()], grad=True)
    idx = dt((4,), [Shard(0), Replicate()], dtype=torch.int64)
    picked = ctx.take_along_last(logits, idx)
    picked.sum().backward()
    out["take_along_last"] = [list(picked.shape), list(logits.grad.to_local().shape)]
    pl = lambda t: [str(q) for q in t.placements]
    local = lambda t: list(t.to_local().shape)
    # local_einsum, the MoE dispatch: two batch dims sharded stay sharded
    disp = dt((4, 2, 3, 4, 2), [Shard(0), Shard(1)])
    xg = dt((4, 2, 3, 8), [Shard(0), Shard(1)])
    xin = ctx.local_einsum("bnsec,bnsd->ebncd", disp, xg)
    out["local_einsum_dispatch"] = [pl(xin), local(xin)]
    # local_einsum, an expert product: the weight gathered over data (its
    # fsdp dim), its gradient a pending sum there, reduce-scattered back to
    # the weight's layout
    xin = dt((4, 4, 2, 2, 8), [Shard(1), Shard(0)])
    for name, wpl in (("gathered", [Replicate(), Shard(0)]),
                      ("fsdp", [Shard(1), Shard(0)])):
        w = dt((4, 8, 6), wpl, grad=True)
        y = ctx.local_einsum("ebncd,edf->ebncf", xin, w)
        with CommDebugMode() as comm:
            g, = torch.autograd.grad(y.sum(), [w])
        counts = comm.get_comm_counts()
        out["local_einsum_" + name] = [pl(y), local(y), pl(g), local(g), [
            counts.get(op, 0) for op in (
                torch.ops.c10d_functional.all_reduce,
                torch.ops.c10d_functional.reduce_scatter_tensor)]]
    # chunk_last: each part and the gradient keep the last dim's sharding
    x = dt((4, 8, 16), [Shard(0), Shard(2)], grad=True)
    a, b = ctx.chunk_last(x, 2)
    g, = torch.autograd.grad((a * b).sum(), [x])
    out["chunk_last"] = [pl(a), local(a), pl(b), pl(g), local(g)]
    # rows_matmul, an fsdp weight: gathered over data, its gradient back on
    # the weight's layout
    x = dt((4, 8, 16), [Shard(0), Replicate()], grad=True)
    w = dt((16, 8), [Shard(0), Shard(1)], grad=True)
    y = ctx.rows_matmul(x, w)
    gx, gw = torch.autograd.grad(y.sum(), [x, w])
    out["rows_matmul_fsdp"] = [pl(y), local(y), pl(gw), local(gw), pl(gx)]
    # rows_matmul, contraction and output over one mesh dim, the output the
    # wider: the rows gathered there, no pending sum
    x = dt((4, 8, 8), [Shard(0), Shard(2)], grad=True)
    w = dt((8, 32), [Replicate(), Shard(1)], grad=True)
    y = ctx.rows_matmul(x, w)
    gx, = torch.autograd.grad(y.sum(), [x])
    out["rows_matmul_wide_out"] = [pl(y), local(y), pl(gx)]
    # rows_matmul, the contraction the wider: the output's gradient, which
    # comes back sharded on its channels, is gathered there (`_GatherGrad`)
    x = dt((4, 8, 32), [Shard(0), Shard(2)], grad=True)
    w = dt((32, 8), [Replicate(), Shard(0)], grad=True)
    y = ctx.rows_matmul(x, w)
    gx, = torch.autograd.grad(y, [x], grad_outputs=[
        dt((4, 8, 8), [Shard(0), Shard(2)])])
    out["rows_matmul_wide_in"] = [pl(y), pl(gx), local(gx)]
    # _GatherGrad: the gradient's last dim gathered on the flagged mesh dims
    for name, apl, dims in (("model", [Shard(0), Shard(1)], (False, True)),
                            ("data", [Shard(1), Shard(0)], (True, False))):
        a = dt((4, 8), apl, grad=True)
        g, = torch.autograd.grad(ctx._GatherGrad.apply(a, dims), [a],
                                 grad_outputs=[dt((4, 8), apl)])
        out["gather_grad_" + name] = pl(g)
print("HELPERS", json.dumps(out))
"""

HELPER_CHECKS = {
    # a weight's gradient placed as the weight (else a pending sum over data)
    "grad_placed": ["R", "S(1)"],
    # the pending sum `settle` reduces; its gradient keeps the batch's data
    # sharding (else gathered there)
    "partial": ["S(0)", "P(sum)"],
    "settle": ["S(0)", "S(1)"],
    # rows a pending sum over the vocab's mesh dim, placed as the tokens on
    # the other; the table's gradient rank 0's 8 rows alone
    "embed_lookup": [["S(0)", "P(sum)"], [4, 3, 4], ["R", "S(0)"], [8, 4]],
    # no all-gather of the sharded last dim
    "logsumexp_last": [[4], 0],
    # the gather's gradient is rank 0's [2, 16] shard, not the global shape
    "take_along_last": [[4], [2, 16]],
    # the dispatch keeps both batch dims sharded: rank 0 holds its own
    # [4, 2, 1, 2, 8] slots of the [4, 4, 2, 2, 8] whole
    "local_einsum_dispatch": [["S(1)", "S(2)"], [4, 2, 1, 2, 8]],
    # an expert product on rank 0's tokens and experts; a weight replicated
    # over data gets its gradient all-reduced there (the pending sum the
    # local product leaves), an fsdp weight gathered over data gets it
    # reduce-scattered back to its own [2, 4, 6] shard
    "local_einsum_gathered": [["S(1)", "S(0)"], [2, 2, 2, 2, 6],
                              ["R", "S(0)"], [2, 8, 6], [1, 0]],
    "local_einsum_fsdp": [["S(1)", "S(0)"], [2, 2, 2, 2, 6],
                          ["S(1)", "S(0)"], [2, 4, 6], [0, 1]],
    # both parts and the gradient keep the channels' sharding over model
    "chunk_last": [["S(0)", "S(2)"], [2, 8, 4], ["S(0)", "S(2)"],
                   ["S(0)", "S(2)"], [2, 8, 8]],
    # an fsdp weight: the output on the batch and the weight's columns, the
    # weight's gradient on its own [8, 4] shard, the rows' on theirs
    "rows_matmul_fsdp": [["S(0)", "S(2)"], [2, 8, 4], ["S(0)", "S(1)"],
                         [8, 4], ["S(0)", "R"]],
    # a wider output: the rows gathered over model, the output sharded
    # there (no pending sum as wide as the product)
    "rows_matmul_wide_out": [["S(0)", "S(2)"], [2, 8, 16], ["S(0)", "S(2)"]],
    # a wider contraction: the output a pending sum over model; the rows'
    # gradient on the rows' channels
    "rows_matmul_wide_in": [["S(0)", "P(sum)"], ["S(0)", "S(2)"], [2, 8, 16]],
    # the gradient's last dim gathered on the flagged mesh dim alone
    "gather_grad_model": ["S(0)", "R"],
    "gather_grad_data": ["R", "S(0)"],
}


@pytest.fixture(scope="module")
def helper_placements():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _HELPERS], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=GRID_DEADLINE_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("HELPERS ")][0]
    return json.loads(line[8:])


@pytest.mark.parametrize("check", sorted(HELPER_CHECKS))
def test_sharding_helpers_place_as_the_reference_layout(helper_placements,
                                                        check):
    """Each helper the dry-run's train cells lean on keeps the layout the
    JAX lowering gives: gradients on their parameters' placements, a batch
    sharding kept through a reduction's backward, vocab-parallel lookups,
    log-sum-exps and gathers on rank 0's shard, the MoE einsums on each
    rank's own shards, a sharded split, and the fsdp weight gathers and
    narrow-side gathers of the row products."""
    assert helper_placements[check] == HELPER_CHECKS[check]


# the all-to-all's count on a fake world of 4 ranks
# (`tools/all_to_all_peak.py --estimate`, the cases that tool runs on 4
# cards): bytes of rank 0's input shard, its peak above the input in
# shards as 4 H100s under NCCL measured it (torch 2.11: the input laid out
# piece by piece unless already so, the receive buffer, and a copy where
# the join along the old shard dim is not a view), the new shard's shape
ALL_TO_ALL = {
    "rows_to_cols": (512 * 1024 * 4 // 4, 2, [512, 256]),
    "cols_to_rows": (512 * 1024 * 4 // 4, 2, [128, 1024]),
    "channels_to_seq": (8 * 1024 * 768 * 2 // 4, 3, [4, 512, 768]),
    "seq_to_channels": (8 * 1024 * 768 * 2 // 4, 3, [4, 1024, 384]),
    "rows_to_channels": (64 * 32 * 256 * 4 // 4, 2, [64, 32, 64]),
    "seq_to_channels_one_row": (512 * 1024 * 4 // 4, 2, [1, 512, 256]),
}


@pytest.fixture(scope="module")
def all_to_all_counts():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "tools/all_to_all_peak.py",
                           "--estimate"], cwd=REPO, env=env,
                          capture_output=True, text=True,
                          timeout=GRID_DEADLINE_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("ESTIMATE ")][0]
    return json.loads(line[len("ESTIMATE "):])


@pytest.mark.parametrize("case", sorted(ALL_TO_ALL))
def test_all_to_all_counts_the_cards_buffers(all_to_all_counts, case):
    """A shard moved from one tensor dim to another is one all-to-all of
    the new shard's bytes (no all-gather of the whole dim, gloo's way on
    a CPU mesh); rank 0 peaks above its input at the bytes the cards did,
    then holds the new shard alone."""
    shard, peak, local = ALL_TO_ALL[case]
    got = all_to_all_counts[case]
    assert got == {"peak": peak * shard, "held": shard, "all_to_all": shard,
                   "all_gather": 0, "shard": local}


_GRID = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.config import SHAPE_GRID
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.launch import dryrun
mesh_kind, arch = sys.argv[1:3]
mesh = dryrun.cell_mesh(mesh_kind)
out = []
cfg = get_config(arch).with_overrides(num_layers=2)
for shape in ("train_4k", "prefill_32k", "decode_32k"):
    rec = dryrun.trace_cell(cfg, SHAPE_GRID[shape], mesh, variant="sgd",
                            microbatches=1)
    out.append([mesh_kind, arch, shape, mesh.size(),
                rec["memory"]["peak_per_device_bytes"],
                sum(v for k, v in rec["collectives"].items()
                    if k != "count")])
print("GRID", json.dumps([out, gqa_flash.launches]))
"""

GRID_DEADLINE_S = 120


def test_reduced_grid_traces_on_fake_worlds():
    """Two 2-layer models, three shapes, both fake production meshes: one
    process per mesh and model, each making its own fake world, run side
    by side under a deadline (plain SGD and one microbatch, the cheapest
    train step, to keep the traces short)."""
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _GRID, kind, arch],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for kind in ("single", "multi")
             for arch in ("gemma3-4b", "deepseek-moe-16b")]
    cells = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=GRID_DEADLINE_S)
            assert proc.returncode == 0, stderr[-3000:]
            line = [x for x in stdout.splitlines() if x.startswith("GRID ")][0]
            got, launches = json.loads(line[5:])
            assert launches == 0
            cells += got
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    assert len(cells) == 12
    peak = {}
    for mesh_kind, arch, shape, ranks, peak_b, coll_b in cells:
        assert ranks == (256 if mesh_kind == "single" else 512)
        assert peak_b > 0
        if shape == "train_4k":
            assert coll_b > 0, (mesh_kind, arch)
        peak[mesh_kind, arch, shape] = peak_b
    for arch in ("gemma3-4b", "deepseek-moe-16b"):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            assert peak["multi", arch, shape] < peak["single", arch, shape], \
                (arch, shape)


_MAMBA_TRAIN = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.config import SHAPE_GRID
from repro_torch.launch import dryrun
from repro_torch.models import mamba
mesh = dryrun.cell_mesh(sys.argv[1])
cfg = get_config("falcon-mamba-7b").with_overrides(num_layers=2)
shape = SHAPE_GRID["train_4k"]
mamba.CHUNK = shape.seq_len   # one scan chunk: no loop over 16 chunks
rec = dryrun.trace_cell(cfg, shape, mesh, variant="sgd", microbatches=1)
print("CELL", json.dumps([mesh.size(), rec["memory"]["peak_per_device_bytes"],
                          sum(v for k, v in rec["collectives"].items()
                              if k != "count")]))
"""


# the 2-layer falcon-mamba cell's processes: the (2, 16, 16) mesh's trace
# alone takes ~57 s on one core (`DTensor`'s strategies over three mesh dims),
# twice the reduced grid's per-process work, so its deadline is doubled. The
# scan runs in one chunk: in its 16 chunks, as the CLI and `chip_smoke.py`
# trace it, the pair took ~70 s alone and up to 239 s beside the whole
# suite; with one chunk the (2, 16, 16) trace fails on the same
# `S(1) to P(sum)` error without the repair.
MAMBA_DEADLINE_S = 2 * GRID_DEADLINE_S


def test_mamba_train_cell_traces_on_fake_worlds():
    """falcon-mamba-7b's train_4k step at 2 layers (plain SGD, one
    microbatch, the selective scan in one chunk) on both fake production
    meshes, one process each: its channel-sharded residual makes the
    scan's projection a pending sum, which must be reduced before the scan
    (a pending sum written into the scan's slices cannot take its gradient
    back); with the scan's input and gate on the channels' sharding the
    (2, 16, 16) mesh peaks below the (16, 16) one."""
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    procs = {kind: subprocess.Popen([sys.executable, "-c", _MAMBA_TRAIN, kind],
                                    cwd=REPO, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for kind in ("single", "multi")}
    cells = {}
    try:
        for kind, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=MAMBA_DEADLINE_S)
            assert proc.returncode == 0, stderr[-3000:]
            line = [x for x in stdout.splitlines() if x.startswith("CELL ")][0]
            cells[kind] = json.loads(line[5:])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    assert cells["single"][0] == 256 and cells["multi"][0] == 512
    for ranks, peak_b, coll_b in cells.values():
        assert peak_b > 0 and coll_b > 0
    # the scan's channels stay sharded over `model` on the (2, 16, 16) mesh:
    # it peaks lower than (16, 16), as the dense and MoE train cells do
    assert cells["multi"][1] < cells["single"][1], cells

