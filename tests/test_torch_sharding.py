"""repro_torch.sharding and repro_torch.launch.mesh against the JAX
package's rules, on the CPU.

`logical_to_pspec` is held against the JAX package's for every `ParamDef`
leaf of all eleven configs' bundles (params, and caches at batch 4,
sequence 2048) at the production layouts (16, 16) ``("data", "model")``
and (2, 16, 16) ``("pod", "data", "model")``, planned from plain
``{axis: size}`` mappings: the JAX function gets an object whose
``.shape`` is that mapping, which is all it reads. Then `layer_axes_strs`,
`batch_pspec`, `defs_to_shardings`' placements, the ambient mesh, the
fingerprint, and the factories in a world of one (made in memory by
`make_host_mesh(device_type="cpu")` and destroyed at the module's end).
"""
import types

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import get_config as jax_get_config
from repro.models.factory import build_model as jax_build_model
from repro.sharding import rules as jrules
from repro_torch.configs.registry import get_config, list_configs
from repro_torch.launch import mesh as pmesh
from repro_torch.models.factory import build_model
from repro_torch.sharding import context, rules
from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.sharding.rules import ParamDef, is_param_def
from repro_torch.utils.tree import tree_leaves, tree_map

LAYOUTS = {"pod": {"data": 16, "model": 16},
           "multi_pod": {"pod": 2, "data": 16, "model": 16}}


def _leaves(defs, is_leaf):
    out = []
    tree_map(lambda d: out.append(d), defs, is_leaf=is_leaf)
    return out


@pytest.fixture(scope="module")
def all_defs():
    """(name, port leaves, JAX leaves) of every config's params and caches."""
    out = []
    for name in list_configs():
        b = build_model(get_config(name), device="cpu")
        jb = jax_build_model(jax_get_config(name))
        trees = [(b.param_defs, jb.param_defs)]
        if b.cache_defs is not None:
            trees.append((b.cache_defs(4, 2048), jb.cache_defs(4, 2048)))
        for pt, jt in trees:
            out.append((name, _leaves(pt, is_param_def),
                        _leaves(jt, jrules.is_param_def)))
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_logical_to_pspec_matches_jax_on_every_config(all_defs, layout):
    shape = LAYOUTS[layout]
    jmesh = types.SimpleNamespace(shape=shape)
    names = set()
    for name, leaves, jleaves in all_defs:
        names.add(name)
        assert len(leaves) == len(jleaves) > 0
        for d, jd in zip(leaves, jleaves):
            assert (tuple(d.shape), tuple(d.axes)) == \
                (tuple(jd.shape), tuple(jd.axes))
            got = rules.logical_to_pspec(d.shape, d.axes, shape)
            assert isinstance(got, rules.PartitionSpec)
            assert tuple(got) == tuple(
                jrules.logical_to_pspec(jd.shape, jd.axes, jmesh)), (name, d)
    assert len(names) == 11


def test_pspec_fallbacks():
    mesh = LAYOUTS["pod"]
    assert rules.logical_to_pspec((16, 32), ("embed", "mlp"), mesh) == \
        P("data", "model")
    # 24 does not divide by 16; a second "model" dim replicates
    assert rules.logical_to_pspec((24, 32, 32), ("embed", "mlp", "heads"),
                                  mesh) == P(None, "model", None)
    assert rules.logical_to_pspec((8,), ("pod_only_axis",), mesh) == P(None)
    assert rules.logical_to_pspec((32, 32), ("embed", "mlp"),
                                  LAYOUTS["multi_pod"]) == \
        P(("pod", "data"), "model")


def test_layer_axes_strs_and_batch_pspec_match_jax(all_defs):
    defs = {"w": ParamDef((12, 4, 8), ("layers", "embed", "mlp")),
            "s": ParamDef((12, 4), ("layers", None))}
    jdefs = {k: jrules.ParamDef(d.shape, d.axes) for k, d in defs.items()}
    assert rules.layer_axes_strs(defs) == jrules.layer_axes_strs(jdefs)
    for layout, shape in LAYOUTS.items():
        jmesh = types.SimpleNamespace(shape=shape)
        for seq_axis in (None, "seq", "seq_shard"):
            assert tuple(rules.batch_pspec(shape, seq_axis=seq_axis)) == \
                tuple(jrules.batch_pspec(jmesh, seq_axis=seq_axis))


def test_defs_to_shardings_placements():
    mesh = LAYOUTS["multi_pod"]
    defs = {"w": ParamDef((64, 32), ("embed", "mlp")),
            "n": {"b": ParamDef((5,), ("mlp",))}}
    sh = rules.defs_to_shardings(defs, mesh)
    assert sh["w"] == rules.NamedSharding(mesh, (Shard(0), Shard(0),
                                                 Shard(1)))
    assert sh["n"]["b"].placements == (Replicate(),) * 3
    assert len(tree_leaves(sh)) == 2


def test_mesh_context_nests():
    assert context.current_mesh() is None
    outer, inner = LAYOUTS["pod"], LAYOUTS["multi_pod"]
    custom = {"batch": "data"}
    with context.mesh_context(outer):
        assert context.current_mesh() is outer
        assert context.current_rules() is rules.DEFAULT_RULES
        with context.mesh_context(inner, custom):
            assert context.current_mesh() is inner
            assert context.current_rules() is custom
        assert context.current_mesh() is outer
        assert context.current_rules() is rules.DEFAULT_RULES
    assert context.current_mesh() is None


def test_constrain_is_identity_on_plain_tensors():
    x = torch.ones(4, 4)
    assert context.constrain(x, ("embed", "mlp")) is x
    with context.mesh_context(LAYOUTS["pod"]):
        assert context.constrain(x, ("embed", "mlp")) is x
        assert context.constrain_heads_or_seq(torch.ones(2, 4, 16, 8)).shape \
            == (2, 4, 16, 8)
        tree = {"w": x}
        assert context.constrain_tree(tree, {"w": "embed|mlp"})["w"] is x
    assert rules.act_sharding_constraint(x, None, P(None, None)) is x


def test_factories_need_their_world():
    """No process group: a world larger than one is refused with the
    torchrun command that makes it, and the card is not replaced by the
    CPU quietly."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 256"):
        pmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 512"):
        pmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        pmesh.make_sweep_mesh(2, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            pmesh.make_host_mesh()
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def host_mesh():
    mesh = pmesh.make_host_mesh(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


def test_world_of_one(host_mesh):
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert rules.mesh_shape(host_mesh) == {"data": 1, "model": 1}
    again = pmesh.make_host_mesh(device_type="cpu")
    assert again is not host_mesh
    assert context.mesh_fingerprint(again) == \
        context.mesh_fingerprint(host_mesh) == \
        (("data", "model"), (1, 1), (0,), "cpu")
    assert context.mesh_fingerprint(None) is None
    sweep = pmesh.make_sweep_mesh(device_type="cpu")
    assert pmesh.make_sweep_mesh(1, device_type="cpu") is sweep
    assert context.mesh_fingerprint(sweep) == (("data",), (1,), (0,), "cpu")
    assert context.collective_device() == torch.device("cpu")
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        pmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        pmesh.make_sweep_mesh(2, device_type="cpu")
    # the rules read a DeviceMesh as they read a mapping
    assert rules.logical_to_pspec((16, 32), ("embed", "mlp"), host_mesh) == \
        P("data", "model")
    assert rules.defs_to_shardings(
        {"w": ParamDef((4, 8), ("embed", "mlp"))}, host_mesh)["w"] \
        .placements == (Shard(0), Shard(1))
