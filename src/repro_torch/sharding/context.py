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

The rest serves the models under the dry-run's fake world
(`repro_torch.launch.dryrun`), where the tensors are `DTensor`s of fake
shards: :func:`placed` and :func:`zeros` put tensors a model makes
(positions, caches, routing buffers) on the mesh, :func:`write` writes a
cache in place, :func:`settle` reduces a pending sum, :func:`gather_seq` gathers a
sharded sequence, :func:`grad_placed` places a parameter's gradient as the
parameter, :func:`row_block` splits a batch into microbatches,
and :func:`rows_matmul`,
:func:`unflatten` / :func:`merge`, :func:`split_heads`, :func:`chunk_last`,
:func:`local_len` / :func:`follow_seq`, :func:`by_query_shard`,
:func:`take_along_last`, :func:`logsumexp_last`, :func:`embed_lookup` and
:func:`local_einsum` reshape, reduce,
multiply and gather where ``DTensor``'s own rules would refuse or plan
too slowly. On plain tensors each is the op the model used before.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import (DEFAULT_RULES, contiguous_stride,
                                        logical_to_pspec,
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


@contextlib.contextmanager
def observe_sites(observer):
    """Call ``observer(x, placements)`` at every constraint site (`constrain`,
    `propagate_back`) with the `DTensor` that reaches it and the placements
    the site's logical axes give: the JAX package's layout for that value
    (the dry-run's attribution of a peak)."""
    prev = getattr(_state, "observer", None)
    _state.observer = observer
    try:
        yield
    finally:
        _state.observer = prev


def _to_site(x, mesh, logical_axes):
    """``x`` moved to the placements of a constraint site's logical axes."""
    spec = logical_to_pspec(x.shape, logical_axes, mesh, current_rules())
    placements = spec_to_placements(spec, mesh)
    observer = getattr(_state, "observer", None)
    if observer is not None:
        observer(x, placements)
    # a pending sum is reduced first (`settle`): ``DTensor`` cannot carry
    # the gradient of a partial-to-shard move back
    return settle(x).redistribute(mesh, placements)


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """Redistribute a `DTensor` to the placements its logical axes map to on
    the ambient mesh; ``x`` unchanged outside a mesh or for a plain
    tensor."""
    mesh = _dtensor_mesh(x)
    if mesh is None:
        return x
    return _to_site(x, mesh, logical_axes)


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


# the logical axis of the weights' fsdp dim (ZeRO-3 sharding over the data
# axes), gathered where a layer uses its weights
FSDP_AXIS = "embed"


def constrain_tree(tree, axes_strs):
    """Constrain every leaf of one layer's weights by its "a|b|c" axis
    string (from `rules.layer_axes_strs`) to the layout its matmuls use:
    the fsdp dim (``embed``) gathered, the tensor-parallel dims kept. The
    JAX package constrains the weights to their stored layout here and
    XLA gathers the fsdp dim for each matmul; `DTensor` would instead pick
    each matmul's layout by its own cost model, so the gather is made
    explicit (its backward reduce-scatters the gradient, as XLA's
    does). A leaf whose rank differs from its string's is left as it
    is."""
    if current_mesh() is None:
        return tree

    def one(x, s: str):
        axes = tuple(None if a in ("", FSDP_AXIS) else a
                     for a in s.split("|")) if s else ()
        if len(axes) != x.ndim:
            return x
        return constrain(x, axes)

    return tree_map(one, tree, axes_strs)


class _PlaceGrad(torch.autograd.Function):
    """Identity whose backward places the gradient as the input is placed:
    a pending sum reduce-scattered (or all-reduced where the input is
    replicated), a replicated gradient cut to the input's shard."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) == ctx.placements:
            return grad
        return grad.redistribute(grad.device_mesh, ctx.placements)


def grad_placed(x):
    """``x``; under a mesh, a `DTensor` that needs a gradient is passed
    through an identity whose backward places that gradient as ``x`` is
    placed, the moment it is complete. The JAX package pins the train
    step's output state to the parameters' layout (``out_shardings``) and
    XLA places each gradient so; without it a gradient comes back a
    pending sum over the data axes, the size of the unsharded leaf."""
    if _dtensor_mesh(x) is None or not x.requires_grad:
        return x
    return _PlaceGrad.apply(x)


def row_block(x, parts: int, i: int):
    """Block ``i`` of ``parts`` equal blocks of ``x``'s rows (dim 0): rows
    [i·B/parts, (i+1)·B/parts) of a plain tensor; of a `DTensor` sharded
    over its rows, block ``i`` of each rank's own rows, as data-parallel
    accumulation splits a batch (no data moves; the blocks together hold
    every row once, as the plain split's do)."""
    from torch.distributed.tensor import DTensor, Shard

    n = x.shape[0] // parts
    if not (isinstance(x, DTensor) and Shard(0) in x.placements):
        return x[i * n:(i + 1) * n]
    local = x.to_local()
    m = local.shape[0] // parts
    shape = (n,) + tuple(x.shape[1:])
    return DTensor.from_local(local[i * m:(i + 1) * m], x.device_mesh,
                              x.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def take_along_last(x, idx):
    """``x[..., idx[...]]``: x [..., V], idx [...] integer, as
    ``torch.gather(x, -1, idx[..., None])[..., 0]``. For a `DTensor` of
    fake shards (the dry-run) the gather runs on rank 0's shard, so its
    backward builds the gradient of that shard alone (``DTensor``'s own
    gather backward allocates a zero gradient of the global shape). Where
    the last dim is sharded (vocab-parallel logits), the shard gathers the
    indices it holds, zero elsewhere, and the results are summed over that
    mesh dim (the masked gather that ``DTensor``'s own gather strategy
    means to do, whose mask does not fit a gather's output)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    last = x.ndim - 1
    x = settle(x)
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, idx[..., None].to(torch.int64))[..., 0]
    mesh = x.device_mesh
    lead = [p if isinstance(p, Shard) and p.dim < last else Replicate()
            for p in x.placements]
    il = idx.redistribute(mesh, lead).to_local().to(torch.int64)
    local = x.to_local()
    if Shard(last) in x.placements:
        n = local.shape[-1]             # rank 0's vocab shard is [0, n)
        inside = (il >= 0) & (il < n)
        picked = torch.gather(local, -1, il.clamp(0, n - 1)[..., None])[..., 0]
        picked = picked * inside.to(picked.dtype)
    else:
        picked = torch.gather(local, -1, il[..., None])[..., 0]
    shape = tuple(x.shape[:-1])
    out = DTensor.from_local(
        picked, mesh, [Partial() if p == Shard(last) else p
                       for p in x.placements],
        run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape))
    return out.redistribute(mesh, [Replicate() if p == Shard(last) else p
                                   for p in x.placements])


def logsumexp_last(x):
    """``torch.logsumexp(x, dim=-1)``. For a `DTensor` whose last dim is
    sharded (vocab-parallel logits) the max and the sum of exponentials are
    reduced across the shards (an all-reduce of one value per row each),
    where ``DTensor``'s own rule gathers the whole last dim first."""
    from torch.distributed.tensor import DTensor, Shard

    if not (isinstance(x, DTensor) and Shard(x.ndim - 1) in x.placements):
        return torch.logsumexp(x, dim=-1)
    top = settle(x.detach().amax(dim=-1, keepdim=True))
    return settle((x - top).exp().sum(dim=-1)).log() + top[..., 0]


def embed_lookup(tokens, table):
    """``F.embedding(tokens, table)``: tokens [...] integer, table [V, D].
    For a `DTensor` table sharded over its rows (the vocab) on some mesh
    dims and replicated on the others, rank 0's shard looks up the tokens
    it holds, zero elsewhere: the rows come out a pending sum over the
    vocab's mesh dims and placed as the tokens on the others, and the
    backward builds the gradient of rank 0's rows alone (``DTensor``'s own
    embedding backward builds it for the whole vocab, then reduces it).
    Anything else is the plain lookup."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not (isinstance(table, DTensor) and isinstance(tokens, DTensor)
            and Shard(0) in table.placements
            and all(p in (Shard(0), Replicate()) for p in table.placements)):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    vocab = [p == Shard(0) for p in table.placements]
    ids = tokens.redistribute(mesh, [
        Replicate() if v else p for p, v in zip(tokens.placements, vocab)])
    il = ids.to_local().to(torch.int64)
    # the gradient of rank 0's rows: a sum over the mesh dims the tokens
    # are split on
    grads = [Shard(0) if v else Partial() if isinstance(p, Shard) else p
             for p, v in zip(ids.placements, vocab)]
    local = table.to_local(grad_placements=grads)
    n = local.shape[0]                  # rank 0's rows are [0, n)
    inside = (il >= 0) & (il < n)
    rows = F.embedding(il.clamp(0, n - 1), local)
    rows = rows * inside[..., None].to(rows.dtype)
    shape = tuple(tokens.shape) + (table.shape[1],)
    return DTensor.from_local(
        rows, mesh, [Partial() if v else p
                     for p, v in zip(ids.placements, vocab)],
        run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape))


def _dtensor_world():
    """The ambient `DeviceMesh` when it spans more than one rank (the
    dry-run's fake world), else None."""
    mesh = current_mesh()
    if mesh is None or isinstance(mesh, dict) or mesh.size() == 1:
        return None
    return mesh


def placed(x, logical_axes: Sequence[Optional[str]]):
    """A tensor the model made (positions, their masks), placed on the
    ambient mesh by its logical axes: taken as replicated, then each
    sharded dim cut to this rank's block, which moves no data. ``x``
    unchanged outside a mesh of more than one rank, or when it is a
    `DTensor` already."""
    mesh = _dtensor_world()
    from torch.distributed.tensor import DTensor, Replicate

    if mesh is None or isinstance(x, DTensor):
        return x
    spec = logical_to_pspec(x.shape, logical_axes, mesh, current_rules())
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(
        mesh, spec_to_placements(spec, mesh))


def zeros(shape, dtype, device, logical_axes: Sequence[Optional[str]]):
    """``torch.zeros(shape)``; inside a mesh of more than one rank a
    `DTensor` placed by the logical axes, of which only this rank's shard
    is allocated (rank 0's, the largest, where the axes do not divide:
    the dry-run's fake world)."""
    mesh = _dtensor_world()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import NamedSharding, local_shape

    spec = logical_to_pspec(shape, logical_axes, mesh, current_rules())
    placements = spec_to_placements(spec, mesh)
    local = torch.zeros(local_shape(shape, NamedSharding(mesh, placements)),
                        dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def write(dst, index: tuple, value) -> None:
    """``dst[index] = value`` in place, ``index`` a tuple of ints and
    slices over dst's leading dims (the caches' writes). For a `DTensor`
    of fake shards (the dry-run's cache) the write goes to rank 0's shard:
    each sharded dim of dst holds [0, n) there, so an int index past n
    writes nothing on rank 0 and a slice is cut to [0, n); ``value`` is
    first placed as dst's remaining dims are (replicated where dst's dim is
    indexed or cut)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(dst, DTensor):
        dst[index] = value
        return
    from repro_torch.sharding.rules import NamedSharding, local_shape

    mesh = dst.device_mesh
    index = tuple(index) + (slice(None),) * (dst.ndim - len(index))
    kept = [d for d, ix in enumerate(index) if isinstance(ix, slice)]
    n_local = local_shape(dst.shape, NamedSharding(mesh, dst.placements))
    local_ix, value_ix = [], []
    for d, ix in enumerate(index):
        n = n_local[d]
        if isinstance(ix, int):
            if ix >= n:
                return                     # another rank holds it
            local_ix.append(ix)
            continue
        a, b, _ = ix.indices(dst.shape[d])
        lo, hi = min(a, n), min(b, n)
        local_ix.append(slice(lo, hi))
        value_ix.append(slice(lo - a, hi - a))
    full = {d for d, ix in zip(range(dst.ndim), index)
            if isinstance(ix, slice) and ix.indices(dst.shape[d])[:2]
            == (0, dst.shape[d])}
    placements = [Shard(kept.index(p.dim))
                  if isinstance(p, Shard) and p.dim in full else Replicate()
                  for p in dst.placements]
    if not isinstance(value, DTensor):
        value = placed(value, ())
    local = value.redistribute(mesh, placements).to_local()
    sharded = {p.dim for p in dst.placements if isinstance(p, Shard)}
    value_ix = [ix if d in sharded and d not in full else slice(None)
                for d, ix in zip(kept, value_ix)]
    dst.to_local()[tuple(local_ix)] = local[tuple(value_ix)]


def unflatten(x, dim: int, sizes: Sequence[int]):
    """``x.unflatten(dim, sizes)``. A `DTensor` sharded on ``dim`` over more
    ranks than ``sizes[0]`` splits into is gathered on that dim first (a
    reshape that cannot keep the sharding, which ``DTensor`` refuses)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(x, DTensor):
        mesh_sizes = list(x.device_mesh.shape)
        ways = math.prod(n for n, p in zip(mesh_sizes, x.placements)
                         if p == Shard(dim))
        if ways > 1 and sizes[0] % ways:
            x = x.redistribute(x.device_mesh,
                               [Replicate() if p == Shard(dim) else p
                                for p in x.placements])
    return x.unflatten(dim, sizes)


def _via_seq(x, dim: int, groups: Optional[int] = None):
    """``x`` with its sharding on ``dim`` moved onto its sequence (dim 1, an
    all-to-all), where ``x`` is a `DTensor` sharded on ``dim`` over more
    than one rank, its sequence is not sharded and divides among those
    ranks, and ``groups``, where given (the groups ``dim`` is split into),
    does not (they would keep the sharding); else None."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor) or Shard(1) in x.placements:
        return None
    ways = math.prod(n for n, p in zip(x.device_mesh.shape, x.placements)
                     if p == Shard(dim))
    if ways == 1 or x.shape[1] % ways or (groups is not None
                                          and groups % ways == 0):
        return None
    return x.redistribute(x.device_mesh, [Shard(1) if p == Shard(dim) else p
                                          for p in x.placements])


def split_heads(q, kv_heads: int):
    """q [B, S, N, h] -> [B, S, K, N/K, h] (``q.unflatten(2, (K, N/K))``).
    A `DTensor` whose heads are sharded over more ranks than K splits
    into moves that sharding onto its sequence first where the sequence
    divides (`_via_seq`), so each rank keeps 1/ways of the queries
    instead of gathering all heads (`unflatten`'s way, left for a single
    query)."""
    moved = _via_seq(q, 2, kv_heads)
    q = q if moved is None else moved
    return unflatten(q, 2, (kv_heads, q.shape[2] // kv_heads))


def chunk_last(x, parts: int):
    """``x.chunk(parts, dim=-1)``. A `DTensor` sharded on its last dim over
    more than one rank moves that sharding onto its sequence where the
    sequence divides (`_via_seq`), is cut there, and each part moves back
    (XLA's reshuffle of a sharded split): ``DTensor``'s own chunk gathers
    the whole last dim, and its gradient comes back whole."""
    seq = _via_seq(x, x.ndim - 1)
    if seq is None:
        return x.chunk(parts, dim=-1)
    return tuple(part.redistribute(x.device_mesh, x.placements)
                 for part in seq.chunk(parts, dim=-1))


def local_len(x, dim: int) -> int:
    """The length of ``x``'s dim on this rank: its shard's where ``x`` is
    a `DTensor`, else the dim's."""
    from torch.distributed.tensor import DTensor

    return (x.to_local() if isinstance(x, DTensor) else x).shape[dim]


def propagate_back(x, logical_axes: Sequence[Optional[str]]):
    """``x`` placed by the logical axes of a layout that a later site sets
    for what ``x`` feeds: XLA's sharding propagation carries such a layout
    back to the tensors a site consumes, `DTensor` carries layouts forward
    only. Moves only what that layout moves there; ``x`` unchanged outside
    a mesh or for a plain tensor."""
    mesh = _dtensor_mesh(x)
    if mesh is None:
        return x
    return _to_site(x, mesh, logical_axes)


def follow_seq(x, ref):
    """``x`` [B, S, ...] sharded on its sequence dim as `DTensor` ``ref``
    [B, S, ...] is (a local cut: no data moves); anything else as it
    is."""
    from torch.distributed.tensor import DTensor, Shard

    if not (isinstance(x, DTensor) and isinstance(ref, DTensor)):
        return x
    return x.redistribute(x.device_mesh, [
        Shard(1) if r == Shard(1) else p
        for p, r in zip(x.placements, ref.placements)])


def by_query_shard(fn, q, k, v, bias, *rest):
    """``fn(q, k, v, bias, *rest)`` (an attention block: q [B, Q, ...], k
    and v [B, S, ...], bias [B, 1, 1, Q, S]). Where `DTensor` q is sharded
    on its queries, each rank runs ``fn`` on its own shards (every key is
    local: k and v are replicated on those mesh dims, placed as q on the
    others) and the result is placed as q; the gradients of k and v are
    summed over the query shards. ``DTensor``'s own rules would flatten
    the sharded query dim into a product, which some of its versions
    refuse."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(q, DTensor) or Shard(1) not in q.placements:
        return fn(q, k, v, bias, *rest)
    mesh = q.device_mesh
    kv = [Replicate() if p == Shard(1) else p for p in q.placements]
    grads = [Partial() if p == Shard(1) else p for p in q.placements]
    k_l, v_l = (t.redistribute(mesh, kv).to_local(grad_placements=grads)
                for t in (k, v))
    bias = bias.redistribute(mesh, [Shard(3) if p == Shard(1) else p
                                    for p in q.placements]).to_local()
    # contiguous: the plain path's merge of the heads copies it the same
    out = fn(q.to_local(), k_l, v_l, bias, *rest).contiguous()
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=q.shape, stride=contiguous_stride(q.shape))


def local_einsum(eq: str, *xs):
    """``torch.einsum(eq, *xs)``. Where every operand is a `DTensor` and the
    first one's sharded dims are all subscripts of the output, each rank
    runs the einsum on its own shards: an operand that carries such a
    subscript is sharded on it as the first one is, one that does not (a
    weight) is gathered on that mesh dim (XLA's fsdp gather; its gradient
    comes back a pending sum there), and the output is placed on the same
    subscripts. ``DTensor``'s own einsum flattens the batch dims into one,
    which cannot keep two of them sharded (the MoE dispatch and combine
    would hold every group of a rank's rows), and may shard a weight's
    contraction instead of gathering it (every rank then holds the whole
    batch's product as a pending sum). Anything else is the plain
    einsum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ref = xs[0]
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    if not all(isinstance(x, DTensor) for x in xs) or not all(
            isinstance(p, (Shard, Replicate)) for p in ref.placements):
        return torch.einsum(eq, *xs)
    letters = [subs[0][p.dim] if isinstance(p, Shard) else None
               for p in ref.placements]
    if any(a is not None and a not in out for a in letters):
        return torch.einsum(eq, *xs)
    mesh = ref.device_mesh
    sizes, parts = {}, []
    for x, sub in zip(xs, subs):
        sizes.update(zip(sub, x.shape))
        on = [Shard(sub.index(a)) if a and a in sub else Replicate()
              for a in letters]
        grads = [Partial() if a and a not in sub else p
                 for a, p in zip(letters, on)]
        x = settle(x).redistribute(mesh, on)
        parts.append(x.to_local(grad_placements=grads))
    shape = tuple(sizes[a] for a in out)
    # contiguous, as the output's global stride says (the plain path's next
    # reshape copies it the same)
    return DTensor.from_local(
        torch.einsum(eq, *parts).contiguous(), mesh,
        [Shard(out.index(a)) if a else Replicate() for a in letters],
        run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape))


class _Merge(torch.autograd.Function):
    """``x.flatten(dim, dim + 1)`` whose backward splits the gradient with
    `unflatten` (gathering a sharding the split cannot keep)."""

    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + 2])
        return x.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, grad):
        return unflatten(grad, ctx.dim, ctx.sizes), None


def merge(x, dim: int):
    """``x.flatten(dim, dim + 1)``: the inverse of `unflatten`, for a
    `DTensor` with a backward that can split its gradient."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _Merge.apply(x, dim)
    return x.flatten(dim, dim + 1)


class _Settle(torch.autograd.Function):
    """Partial -> Replicate; on the mesh dims that held the pending sum the
    gradient of each partial term is the whole gradient, which is taken
    replicated there (``DTensor`` cannot turn a shard into a partial); on
    the other mesh dims it keeps its placement (a batch sharded over the
    data axes stays so)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Partial, Replicate

        ctx.partial = [isinstance(p, Partial) for p in x.placements]
        return x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in x.placements])

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate

        return grad.redistribute(grad.device_mesh, [
            Replicate() if partial else p
            for p, partial in zip(grad.placements, ctx.partial)])


def settle(x):
    """A `DTensor` with a pending reduction (``Partial`` placements: a
    vocab-sharded embedding lookup's rows, a product over a sharded
    contraction) reduced now, to ``Replicate`` on those mesh dims: a masked
    partial can be reduced only once, so it must be before its first of
    several uses. Anything else is returned as it is."""
    from torch.distributed.tensor import DTensor, Partial

    if not isinstance(x, DTensor) or not any(
            isinstance(p, Partial) for p in x.placements):
        return x
    return _Settle.apply(x)


def gather_seq(x):
    """An activation [B, S, ...] with its sequence dim (dim 1) gathered
    where a `DTensor` has it sharded (sequence parallelism's all-gather;
    the backward reduce-scatters); anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor) or Shard(1) not in x.placements:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p == Shard(1) else p for p in x.placements])


class _FlatRows(torch.autograd.Function):
    """[B, S, ...] -> [B·S, ...] of a `DTensor` sharded over its batch only;
    the gradient is placed back so before it is unflattened (no strided
    shard reaches ``DTensor``'s planner)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Shard

        ctx.rows = x.shape[:2]
        ctx.placements = [Shard(p.dim - 1) if isinstance(p, Shard)
                          and p.dim >= 2 else p for p in x.placements]
        return x.flatten(0, 1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad.unflatten(0, ctx.rows)


class _UnflatRows(torch.autograd.Function):
    """[B·S, ...] -> [B, S, ...]; the gradient's sequence dim (and any
    strided shard) is gathered before it is flattened back."""

    @staticmethod
    def forward(ctx, y, rows):
        return y.unflatten(0, rows)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate, Shard

        grad = settle(grad)
        grad = grad.redistribute(grad.device_mesh, [
            Replicate() if isinstance(p, Shard)
            and (type(p) is not Shard or p.dim == 1) else p
            for p in grad.placements])
        return grad.flatten(0, 1), None


class _GatherGrad(torch.autograd.Function):
    """Identity whose backward gathers the gradient's last dim on the mesh
    dims flagged in ``dims``."""

    @staticmethod
    def forward(ctx, y, dims):
        ctx.dims = dims
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate, Shard

        last = grad.ndim - 1
        return grad.redistribute(grad.device_mesh, [
            Replicate() if d and p == Shard(last) else p
            for d, p in zip(ctx.dims, grad.placements)]), None


def rows_matmul(x, w, linear: bool = False):
    """``x @ w`` (or ``F.linear(x, w)`` with ``linear``) for x [B, S, K]. On
    a `DTensor` the rows are flattened with the sequence gathered and the
    batch alone sharded, in the forward and the backward pass alike: a
    batch and a sequence both sharded would flatten into a strided shard,
    whose redistributions ``DTensor`` plans by a search that takes minutes
    a layer on a three-dim mesh. A `DTensor` weight is gathered on each
    mesh dim the rows are sharded over (the fsdp gather XLA's partitioner
    makes for a data-parallel product; its backward reduce-scatters the
    gradient): left sharded there, ``DTensor`` may move the rows' shard
    onto the contraction instead, and every rank then holds the whole
    batch's product as a pending sum. Where the rows' contraction and the
    weight's output are sharded over one mesh dim and the output is the
    wider, the rows are gathered there."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return F.linear(x, w) if linear else x.matmul(w)
    rows = tuple(x.shape[:2])
    x = _FlatRows.apply(gather_seq(settle(x)))
    if isinstance(w, DTensor):
        w = w.redistribute(w.device_mesh, [
            Replicate() if r == Shard(0) and isinstance(p, Shard) else p
            for r, p in zip(x.placements, w.placements)])
        # where the contraction and the output are sharded over one mesh
        # dim, the narrower side is gathered, as XLA does: the rows in the
        # forward pass, the output's gradient in the backward (a pending
        # sum of the product would be as wide as the product)
        out, k = (0, 1) if linear else (1, 0)
        if w.shape[out] > w.shape[k]:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p == Shard(1) and q == Shard(out) else p
                for p, q in zip(x.placements, w.placements)])
        back = tuple(q == Shard(k) and w.shape[k] > w.shape[out]
                     for q in w.placements)
    y = F.linear(x, w) if linear else x.matmul(w)
    if isinstance(w, DTensor) and any(back):
        y = _GatherGrad.apply(y, back)
    return _UnflatRows.apply(y, rows)
