"""Logical-axis sharding rules and the ParamDef system, the port of the JAX
package's ``sharding/rules.py``.

Models declare parameters as :class:`ParamDef` trees: shape + logical axis
names + initializer. `init_from_defs` draws them; the rule table maps the
logical names onto the axes of a mesh (`logical_to_pspec`), so the same
declarations plan a one-card run, a (16, 16) ``("data", "model")`` layout
or a (2, 16, 16) ``("pod", "data", "model")`` one.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims (`repro_torch.launch.mesh`), or a plain ``{axis: size}`` mapping: the
rule functions read only the axis names and sizes, so a 256-rank layout
can be planned in a process of one. A `PartitionSpec` is the JAX one's
tuple (``None``, an axis name or a tuple of axis names per tensor dim);
`defs_to_shardings` turns each into `torch.distributed.tensor`
placements on the mesh (`NamedSharding`).

Sharding strategy (defaults):
  * ``embed``-tagged dims (the fsdp dim of most weights) shard over
    ("pod", "data");
  * ``mlp`` / ``heads`` / ``vocab`` / ``expert`` dims shard over "model";
  * batch shards over ("pod", "data"); sequence optionally over "model".
A dim whose size does not divide the assigned mesh axes is replicated.

`TensorSpec` is a tensor's shape, dtype and placements without its data
(the counterpart of ``jax.ShapeDtypeStruct``); `defs_to_shape_structs`
and `fake_tensor` turn ParamDefs and specs into fake tensors
(``torch._subclasses.fake_tensor``), `DTensor`s over a mesh of more than
one rank, for the dry-run (`repro_torch.launch.dryrun`). A dim that the
mesh axes do not divide is chunked unevenly, as ``DTensor`` chunks it;
the JAX package pads it to the ceiling. `local_shape` is rank 0's
shard, the largest either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.utils.tree import tree_map


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis name per dim (None = replicated)
    init: str = "normal"                 # normal | zeros | ones | scaled | embed
    scale: float = 1.0
    dtype: str = "float32"

    def __repr__(self):  # compact for debugging
        return f"ParamDef({self.shape}, {self.axes}, {self.init})"


def is_param_def(x) -> bool:
    return isinstance(x, ParamDef)


def _init_one(gen: torch.Generator, d: ParamDef) -> torch.Tensor:
    dt = getattr(torch, d.dtype)
    device = gen.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    # scaled in place, then cast: the bits of ``(normal * scale).to(dt)``
    # with one float32 buffer of the leaf's size fewer (deepseek-moe-16b's
    # expert leaves are 19.9 GB each in float32)
    normal = torch.randn(d.shape, generator=gen, device=device)
    if d.init == "normal":
        # fan_in is shape[0], which is the layer count L for stacked layer
        # weights: the JAX package's rule, kept as it is
        fan_in = d.shape[0] if d.shape else 1
        return normal.mul_(d.scale / math.sqrt(max(1, fan_in))).to(dt)
    if d.init in ("embed", "scaled"):
        return normal.mul_(d.scale).to(dt)
    raise ValueError(f"unknown init {d.init}")


def init_from_defs(gen: torch.Generator, defs):
    """Draw every ParamDef of a nested dict, in the JAX package's tree order,
    from ``gen`` on its device (a seeded ``torch.Generator``; the numbers
    differ from ``jax.random``'s, the rules do not)."""
    return tree_map(lambda d: _init_one(gen, d), defs, is_leaf=is_param_def)


# ---------------------------------------------------------------------------
# Logical axes -> mesh axes
# ---------------------------------------------------------------------------

# Logical axis name -> mesh axis (or tuple of mesh axes). None = replicated.
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "model",          # sequence-parallel KV cache (long context)
    "vocab": "model",
    "embed": ("pod", "data"),      # fsdp dim of most weights
    "embed_no_fsdp": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "expert": "model",
    "expert_mlp": None,
    "cache_kv": None,
    "layers": None,
    "conv": None,
    "state": None,
    "features": "model",           # logreg feature dim
}


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (replicated), a mesh axis name, or a tuple of
    axis names, as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a named `DeviceMesh` or of a plain mapping."""
    if isinstance(mesh, Mapping):
        return {str(a): int(n) for a, n in mesh.items()}
    names = mesh.mesh_dim_names
    if not names:
        raise ValueError("the mesh needs named dims (mesh_dim_names)")
    return dict(zip(names, (int(n) for n in mesh.shape)))


def _axis_size(mesh, mesh_axes) -> int:
    if mesh_axes is None:
        return 1
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    shape = mesh_shape(mesh)
    n = 1
    for a in mesh_axes:
        n *= shape.get(a, 1)
    return n


def _present(mesh, mesh_axes):
    """Filter a rule target down to axes that exist in this mesh."""
    if mesh_axes is None:
        return None
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    shape = mesh_shape(mesh)
    kept = tuple(a for a in mesh_axes if a in shape)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def logical_to_pspec(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    mesh,
    rules: Optional[Dict[str, Any]] = None,
) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec, with divisibility fallback:
    a dim the assigned mesh axes do not divide, or whose axes an earlier dim
    took, is replicated."""
    rules = rules or DEFAULT_RULES
    spec = []
    used = set()
    for dim, name in zip(shape, axes):
        if name is None:
            spec.append(None)
            continue
        target = _present(mesh, rules.get(name))
        if target is None:
            spec.append(None)
            continue
        t_axes = (target,) if isinstance(target, str) else tuple(target)
        if dim % _axis_size(mesh, target) != 0 or used & set(t_axes):
            spec.append(None)        # replicate rather than pad/conflict
        else:
            used.update(t_axes)
            spec.append(target)
    return PartitionSpec(*spec)


def layer_axes_strs(defs):
    """ParamDef tree (stacked layer params) -> tree of axis-name STRINGS with
    the leading "layers" dim dropped, e.g. "embed|mlp": one leaf per param,
    for `sharding.context.constrain_tree`."""
    def enc(d: ParamDef) -> str:
        axes = d.axes[1:] if d.axes and d.axes[0] == "layers" else d.axes
        return "|".join(a or "" for a in axes)

    return tree_map(enc, defs, is_leaf=is_param_def)


def spec_to_placements(spec: PartitionSpec, mesh) -> tuple:
    """`torch.distributed.tensor` placements of a spec, one per mesh dim: a
    tensor dim ``d`` mapped to mesh axes gives ``Shard(d)`` on each of those
    mesh dims, in order, and every other mesh dim is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            placements[names.index(a)] = Shard(d)
    return tuple(placements)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and the placements of a tensor on it (the counterpart of
    ``jax.sharding.NamedSharding``; a leaf of the port's trees)."""
    mesh: Any
    placements: Tuple[Any, ...]


def defs_to_shardings(defs, mesh, rules=None):
    """ParamDef tree -> `NamedSharding` tree."""
    return tree_map(
        lambda d: NamedSharding(mesh, spec_to_placements(
            logical_to_pspec(d.shape, d.axes, mesh, rules), mesh)),
        defs, is_leaf=is_param_def)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape, dtype and placements, without data (the counterpart
    of ``jax.ShapeDtypeStruct``); ``sharding`` None means one device."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Optional[NamedSharding] = None


def spec_on(shape, dtype: torch.dtype, spec: PartitionSpec, mesh=None
            ) -> TensorSpec:
    """`TensorSpec` of ``shape`` placed by ``spec`` on ``mesh`` (no
    sharding without a mesh)."""
    sharding = (None if mesh is None else
                NamedSharding(mesh, spec_to_placements(spec, mesh)))
    return TensorSpec(tuple(int(d) for d in shape), dtype, sharding)


def local_shape(shape: Sequence[int], sharding: Optional[NamedSharding]
                ) -> Tuple[int, ...]:
    """Rank 0's shard of a tensor of ``shape``: each mesh dim that shards
    tensor dim d cuts it to the ceiling of its size over the mesh dim's
    (in mesh-dim order, as ``DTensor`` chunks it). Where the size divides
    this is every rank's shard; where it does not, rank 0's is the largest,
    the size the JAX package pads every shard to."""
    from torch.distributed.tensor import Shard

    out = [int(d) for d in shape]
    if sharding is None:
        return tuple(out)
    sizes = list(mesh_shape(sharding.mesh).values())
    for n, p in zip(sizes, sharding.placements):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // n)
    return tuple(out)


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """Row-major strides of ``shape`` (no tensor made: under a fake mode
    even a meta tensor would count as an allocation)."""
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(d), 1)
    return tuple(reversed(stride))


def _mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def fake_tensor(spec: TensorSpec, fake_mode, device="cuda"):
    """A fake tensor (no data, no device memory) of ``spec`` made in
    ``fake_mode``: rank 0's shard wrapped as a `DTensor` on the spec's mesh
    with its placements, or a plain fake tensor where there is no mesh or
    the mesh has one rank."""
    with fake_mode:
        if spec.sharding is None or _mesh_size(spec.sharding.mesh) == 1:
            return torch.empty(spec.shape, dtype=spec.dtype, device=device)
        from torch.distributed.tensor import DTensor

        local = torch.empty(local_shape(spec.shape, spec.sharding),
                            dtype=spec.dtype, device=device)
        return DTensor.from_local(local, spec.sharding.mesh,
                                  spec.sharding.placements, run_check=False,
                                  shape=torch.Size(spec.shape),
                                  stride=contiguous_stride(spec.shape))


def defs_to_specs(defs, mesh=None, rules=None, dtype=None):
    """ParamDef tree -> `TensorSpec` tree, each placed as `defs_to_shardings`
    places it (in ``dtype`` where given, else the def's own)."""
    return tree_map(
        lambda d: spec_on(d.shape, getattr(torch, dtype or d.dtype),
                          logical_to_pspec(d.shape, d.axes, mesh, rules)
                          if mesh is not None else PartitionSpec(), mesh),
        defs, is_leaf=is_param_def)


def defs_to_shape_structs(defs, mesh, fake_mode, rules=None, dtype=None,
                          device="cuda"):
    """ParamDef tree -> tree of fake tensors (`fake_tensor`) placed by
    `defs_to_shardings`: the dry-run's parameters, train state and caches,
    for which no device memory is ever allocated. A mesh of one rank (or
    None) gives plain fake tensors."""
    return tree_map(lambda spec: fake_tensor(spec, fake_mode, device),
                    defs_to_specs(defs, mesh, rules, dtype),
                    is_leaf=lambda x: isinstance(x, TensorSpec))


def batch_pspec(mesh, *, seq_axis: Optional[str] = None) -> PartitionSpec:
    """PartitionSpec for (batch, seq, ...) activations."""
    batch = _present(mesh, DEFAULT_RULES["batch"])
    seq = _present(mesh, DEFAULT_RULES.get(seq_axis)) if seq_axis else None
    return PartitionSpec(batch, seq)


def act_sharding_constraint(x, mesh, spec: PartitionSpec):
    """``x`` redistributed to ``spec`` on ``mesh`` when it is a `DTensor`;
    anything else (a plain tensor, no mesh) is returned unchanged."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, spec_to_placements(spec, mesh))
