"""The ambient mesh and rule table, the port of the JAX package's
``sharding/context.py``.

A launcher installs a mesh (`repro_torch.launch.mesh`) and a rule table
with :func:`mesh_context`; code under it calls :func:`constrain` with
LOGICAL axis names. Outside a mesh, or on a plain tensor, the calls return
their input unchanged; a `DTensor` inside one is redistributed to the
rule's placements. The context is thread-local, as the JAX package's.

The sweep engine reads the same ambient mesh: `repro_torch.core.sweep.
run_sweep` (and the sweep service at each flush) picks up
:func:`current_mesh` when no explicit ``mesh=`` is passed and shards its
config rows over the mesh's ``data`` axis.

:func:`collective_device` is the one placement rule of the slice's
collectives: a process group's backend says where its tensors live.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import (DEFAULT_RULES, logical_to_pspec,
                                        mesh_shape, spec_to_placements)
from repro_torch.utils.tree import tree_map

_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules():
    return getattr(_state, "rules", DEFAULT_RULES)


def mesh_fingerprint(mesh):
    """Hashable identity of a mesh's layout (None for no mesh): its axis
    names, shape, ranks and device type. Two `DeviceMesh` objects over the
    same ranks and axes (repeated factory calls, the ambient mesh and an
    explicit ``mesh=``) fingerprint equal. It names no process group, so it
    is no key for anything that holds one."""
    if mesh is None:
        return None
    return (tuple(mesh.mesh_dim_names or ()), tuple(int(s) for s in mesh.shape),
            tuple(int(r) for r in mesh.mesh.flatten().tolist()),
            mesh.device_type)


@contextlib.contextmanager
def mesh_context(mesh, rules=None):
    prev_mesh = getattr(_state, "mesh", None)
    prev_rules = getattr(_state, "rules", DEFAULT_RULES)
    _state.mesh = mesh
    _state.rules = rules or DEFAULT_RULES
    try:
        yield
    finally:
        _state.mesh = prev_mesh
        _state.rules = prev_rules


def collective_device(group=None) -> torch.device:
    """The device a collective over ``group`` takes its tensors on, from the
    group's backend: the rank's card for ``nccl``, the host for ``gloo``
    (whose collectives run on host copies)."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"no placement rule for the {backend!r} backend "
                     "(nccl: the card, gloo: the host)")


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (one shape on all ranks), in group-rank order, on
    ``x``'s device; the gather runs on `collective_device`."""
    buf = x.to(collective_device(group)).contiguous()
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return [part.to(x.device) for part in parts]


def mesh_barrier(mesh) -> None:
    """Wait until every rank of ``mesh`` has arrived: a barrier over each
    mesh axis's group in turn. A rank leaves the barrier over axis k only
    after every rank of its axis-k group has left the barriers over the
    axes before k, so after the last axis every rank has waited for every
    other rank's arrival."""
    for axis in mesh.mesh_dim_names:
        dist.barrier(group=mesh.get_group(axis))


def _dtensor_mesh(x):
    """The ambient mesh when ``x`` is a `DTensor` inside one, else None."""
    mesh = current_mesh()
    if mesh is None:
        return None
    from torch.distributed.tensor import DTensor

    return mesh if isinstance(x, DTensor) else None


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """Redistribute a `DTensor` to the placements its logical axes map to on
    the ambient mesh; ``x`` unchanged outside a mesh or for a plain
    tensor."""
    mesh = _dtensor_mesh(x)
    if mesh is None:
        return x
    spec = logical_to_pspec(x.shape, logical_axes, mesh, current_rules())
    return x.redistribute(mesh, spec_to_placements(spec, mesh))


def constrain_heads_or_seq(x, head_axis: str = "heads"):
    """Attention q/k/v [B, S, N, h]: shard heads over `model` when the head
    count divides it, else fall back to sequence sharding."""
    mesh = _dtensor_mesh(x)
    if mesh is None or x.ndim != 4:
        return x
    target = current_rules().get(head_axis)
    target = (target,) if isinstance(target, str) else (target or ())
    shape = mesh_shape(mesh)
    size = 1
    for a in target:
        size *= shape.get(a, 1)
    if size > 1 and x.shape[2] % size == 0:
        return constrain(x, ("batch", None, head_axis, None))
    return constrain(x, ("batch", "seq_shard", None, None))


def constrain_tree(tree, axes_strs):
    """Constrain every leaf by its "a|b|c" axis string (from
    `rules.layer_axes_strs`); a leaf whose rank differs from its string's
    is left as it is."""
    if current_mesh() is None:
        return tree

    def one(x, s: str):
        axes = tuple(a if a else None for a in s.split("|")) if s else ()
        if len(axes) != x.ndim:
            return x
        return constrain(x, axes)

    return tree_map(one, tree, axes_strs)
