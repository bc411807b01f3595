"""The dry-run: each (architecture × input shape × mesh) cell traced once on
fake tensors, the port of the JAX package's ``launch/dryrun.py``.

For every cell:
  1. build the production mesh, (16, 16) or (2, 16, 16), over a fake
     world of 256 or 512 ranks (a ``fake`` process group made in this
     process: `fake_world`), or take `HOST_MESH`'s one device;
  2. make the cell's train state, parameters, caches and batch as fake
     tensors (``torch._subclasses.fake_tensor``): `DTensor`s of rank 0's
     shards, placed by the logical-axis rules (`sharding.rules.
     defs_to_shape_structs`, the factory's ``input_specs``). NO device
     memory is allocated and no kernel is launched, at any size;
  3. run the cell's step once (``train_step`` / prefill / decode step)
     under the ambient mesh, so the models' ``constrain`` calls place the
     activations as the JAX package's do, with a `Recorder` on the
     dispatch stack. What the JAX lowering's ``out_shardings`` does is
     done here too: each gradient is placed as its parameter
     (`sharding.context.grad_placed`), and the step's returned state and
     cache are placed as its arguments' (or, for the prefill's new cache,
     as the cache's defs place it);
  4. write what the recorder saw on rank 0 into
     ``experiments/dryrun_torch/*.json``, with the JAX record's file names
     and keys.

The recorder stands in for XLA's compiled artifacts. It sees every
operation rank 0 runs on its shards (`DTensor` ops reach it as the local
ops they become, and the global-shape ops of `DTensor`'s sharding
propagation are kept out), and counts:
  * ``memory``: ``argument_bytes`` are the storages of the arguments the
    step reads or returns (XLA drops the parameters a jitted step does not
    use: the prefill's targets and mask); the peak counts the bytes of the
    storages
    alive at each op, from the arguments' (read or not) to the last
    output's; ``peak_per_device_bytes`` is their
    maximum, the arguments included (what ``max_memory_allocated`` reads
    on the card when the peak counter is reset with the arguments alive);
    ``peak_allocator_bytes`` the same with each storage rounded up to the
    CUDA caching allocator's 512-byte blocks. ``alias_bytes`` are the
    arguments' storages the step's outputs reuse (the SVRG state the train
    step passes on, the cache the decode step writes in place).
    ``temp_bytes`` = peak − arguments − outputs + aliases, as XLA's sum.
  * ``op_cost``: FLOPs (``torch.utils.flop_counter``'s formulas, and the
    flash-attention kernel's) and the bytes each op reads and writes,
    summed on rank 0, so PER DEVICE by definition (the JAX package's
    ``jaxpr_cost`` is global); ``cost`` holds the same two under the JAX
    record's names.
  * ``collectives``: bytes per kind of the ``c10d_functional`` ops
    ``DTensor`` issues and of its all-to-all (`_all_to_all_moves`), per
    device, as the JAX package's HLO parse counts them (an all-gather's
    operand, the other kinds' output), and their ``count``. Eager mode
    runs every layer, so these are totals, and ``collectives_trips`` (the
    JAX package's loop-multiplied parse) equals ``collectives``.
  * with ``attribute`` (`trace_cell`), ``attribution``: every storage
    alive at the peak, with the op and the line that made it, its shapes
    and placements, and the dims a constraint site's layout shards that
    rank 0 holds whole.

Usage (the whole grid, on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
      --shape all --mesh single multi --out experiments/dryrun_torch

The fake world lives in the dry-run's own process; nothing that serves,
trains or sweeps makes one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import sys
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.config import (HOST_MESH, SHAPE_GRID, SVRGConfig,
                                ShapeConfig, TrainConfig)
from repro_torch.configs import get_config
from repro_torch.launch.roofline import count_params, model_flops
from repro_torch.models.factory import build_model
from repro_torch.sharding.context import mesh_context
from repro_torch.sharding.rules import (TensorSpec, defs_to_shape_structs,
                                        defs_to_specs, fake_tensor,
                                        logical_to_pspec, spec_on)
from repro_torch.train.state import make_train_state_defs, make_train_step
from repro_torch.utils.misc import log
from repro_torch.utils.tree import (tree_flatten_with_path, tree_leaves,
                                    tree_unflatten_like)

ARCHS = [
    "whisper-large-v3", "chatglm3-6b", "stablelm-12b", "gemma3-4b",
    "command-r-plus-104b", "qwen3-moe-235b-a22b", "deepseek-moe-16b",
    "llama-3.2-vision-11b", "recurrentgemma-2b", "falcon-mamba-7b",
]

SUBQUADRATIC = {"recurrentgemma-2b", "falcon-mamba-7b"}


def cell_skip_reason(arch: str, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and arch not in SUBQUADRATIC:
        return "full-attention arch: 500k decode is quadratic (DESIGN.md §5)"
    return None


# gradient-accumulation splits for train_4k, the JAX package's (sized there
# so activations fit 16 GB a chip)
MICROBATCHES = {
    "command-r-plus-104b": 8,
    "qwen3-moe-235b-a22b": 8,
    "llama-3.2-vision-11b": 8,
    "deepseek-moe-16b": 4,
    "stablelm-12b": 4,
    "chatglm3-6b": 2,
    "recurrentgemma-2b": 2,
    "gemma3-4b": 2,
    "falcon-mamba-7b": 2,
    "whisper-large-v3": 1,
}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# collective op (namespace, name) -> (kind, which bytes the JAX package's
# HLO parse counts: the all-gather's operand, the output of the others)
_COLLECTIVE_OPS = {
    ("_c10d_functional", "all_reduce"): ("all-reduce", "out"),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", "out"),
    ("_c10d_functional", "all_reduce_coalesced"): ("all-reduce", "out"),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", "in"),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"):
        ("all-gather", "in"),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", "out"),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        ("reduce-scatter", "out"),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", "out"),
    ("_dtensor", "shard_dim_alltoall"): ("all-to-all", "out"),
}

ALLOCATOR_BLOCK = 512      # the CUDA caching allocator's rounding, bytes


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rounded(n: int) -> int:
    return -(-n // ALLOCATOR_BLOCK) * ALLOCATOR_BLOCK


class _Held:
    """What the attribution keeps of one live storage: the op that made it
    (``argument`` for the step's arguments), where (`_where`), its bytes
    and rank 0's shape, and, once a `DTensor` holds it, the global shape
    and placements; ``ref`` the placements of the constraint site it
    reached, if any, and ``ref_site`` where that site is."""

    __slots__ = ("op", "site", "nbytes", "local", "dtype", "shape",
                 "placements", "ref", "ref_site", "mesh")

    def __init__(self, op: str, site: str, t: torch.Tensor, nbytes: int):
        self.op, self.site, self.nbytes = op, site, nbytes
        self.local, self.dtype = tuple(t.shape), str(t.dtype)
        self.shape = self.placements = self.ref = self.ref_site = None
        self.mesh = None

    def whole(self):
        """The dims the constraint site's layout shards over a mesh axis and
        rank 0 holds whole there (replicated or a pending sum), as
        ``"dim d over axis"``; [] with no site or no `DTensor`."""
        if self.ref is None or self.placements is None:
            return []
        from torch.distributed.tensor import Shard

        names = self.mesh.mesh_dim_names or range(self.mesh.ndim)
        return [f"dim {r.dim} over {name}"
                for name, n, p, r in zip(names, self.mesh.shape,
                                         self.placements, self.ref)
                if n > 1 and isinstance(r, Shard) and not isinstance(p, Shard)]

    def record(self) -> Dict:
        return {"bytes": self.nbytes, "op": self.op, "site": self.site,
                "local_shape": list(self.local), "dtype": self.dtype,
                "global_shape": None if self.shape is None else list(self.shape),
                "placements": None if self.placements is None
                else [str(p) for p in self.placements],
                "site_layout": None if self.ref is None
                else [str(p) for p in self.ref],
                "constrained_at": self.ref_site, "whole": self.whole()}


_PORT = os.sep + "repro_torch" + os.sep
_TORCH = os.path.dirname(torch.__file__)
_NOT_A_SITE = (os.path.join("launch", "dryrun.py"),
               os.path.join("sharding", "context.py"))
_FRAME = re.compile(r'File "([^"]+)", line (\d+)')
_CHECKPOINT = os.path.join("torch", "utils", "checkpoint.py")


def _site_of(name: str) -> bool:
    return not (name.startswith(_TORCH) or name.endswith(_NOT_A_SITE))


def _named(name: str, line) -> str:
    name = name.split(_PORT)[1] if _PORT in name else os.path.basename(name)
    return f"{name}:{line}"


def _where() -> str:
    """The innermost frame outside torch, the dry-run and the sharding
    helpers (``file:line``, relative to the package inside the port),
    marked ``recomputed`` where a backward reruns a checkpointed forward;
    in a backward op, the autograd node's name and the forward frame that
    made the node (anomaly mode's record)."""
    node = torch._C._current_autograd_node()
    frames, rerun = [], False
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        rerun = rerun or name.endswith(_CHECKPOINT)
        if _site_of(name):
            frames.append(_named(name, f.f_lineno))
        f = f.f_back
    if node is None:
        return frames[0] if frames else "?"
    if rerun and frames:
        return f"{frames[0]} recomputed"
    trace = "".join(node.metadata.get("traceback_", []))
    made = [m for m in _FRAME.findall(trace) if _site_of(m[0])]
    return f"{node.name()} of {_named(*made[-1]) if made else '?'}"


class Recorder(TorchDispatchMode):
    """Counts what rank 0 runs: live storages and their peak, FLOPs, bytes
    read and written, collective bytes. Ops on `DTensor`s are handed back
    (``NotImplemented``) so ``DTensor`` runs them as local ops, which come
    here in turn; while `quiet` is entered (``DTensor``'s sharding
    propagation, whose global-shape ops run nowhere) nothing counts.

    With ``attribute`` it also keeps, for each live storage, a `_Held`
    (the op and the line that made it, rank 0's shape and the global one,
    the placements, and the layout of the constraint site the value
    reached), and `at_peak` lists those alive at the peak."""

    def __init__(self, attribute: bool = False):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.collectives["count"] = 0
        self.live = self.peak = 0
        self.live_rounded = self.peak_rounded = 0
        self._storages: Dict[int, tuple] = {}
        self._quiet = 0
        self.watched: Dict[int, int] = {}   # argument storages: bytes
        self.read = set()                   # those an op has taken
        self.attribute = attribute
        self.at_peak = []                   # `_Held`s alive at the peak

    @contextlib.contextmanager
    def quiet(self):
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def track(self, t: torch.Tensor, op: str = "argument") -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        r = _rounded(n)
        held = (_Held(op, None if op == "argument" else _where(), _local(t),
                      n) if self.attribute else None)
        self._storages[key] = (weakref.ref(st, lambda _, k=key: self._free(k)),
                               n, r, held)
        self.live += n
        self.live_rounded += r
        if self.live > self.peak and self.attribute:
            self.at_peak = [entry[3] for entry in self._storages.values()]
        self.peak = max(self.peak, self.live)
        self.peak_rounded = max(self.peak_rounded, self.live_rounded)

    def _free(self, key: int) -> None:
        _, n, r, _ = self._storages.pop(key)
        self.live -= n
        self.live_rounded -= r

    def _held(self, t: torch.Tensor) -> Optional[_Held]:
        entry = self._storages.get(_local(t).untyped_storage()._cdata)
        return entry and entry[3]

    def place(self, dt) -> None:
        """Note a `DTensor`'s global shape and placements on the storage of
        its local tensor (attribution)."""
        held = self._held(dt._local_tensor)
        if held is not None and held.shape is None:
            held.shape, held.placements = tuple(dt.shape), tuple(dt.placements)
            held.mesh = dt.device_mesh

    def at_site(self, x, placements) -> None:
        """Note the layout of the constraint site ``x`` reached on its
        storage (attribution)."""
        held = self._held(x)
        if held is not None:
            held.shape, held.placements = tuple(x.shape), tuple(x.placements)
            held.mesh = x.device_mesh
            held.ref, held.ref_site = tuple(placements), _where()

    def attribution(self) -> list:
        """The storages alive at the peak, largest first, as records."""
        return [h.record() for h in sorted(self.at_peak, key=lambda h:
                                           -h.nbytes)]

    def storages(self, tree) -> Dict[int, int]:
        """{storage key: bytes} of the tensors of ``tree``."""
        out = {}
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            out[st._cdata] = st.nbytes()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._quiet:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # eager waits hand back their input; the fake op makes a copy
            return args[0]
        out = func(*args, **kwargs)
        collective = _COLLECTIVE_OPS.get((func.namespace, packet.__name__))
        scratch = []
        if collective is not None and func.namespace == "_dtensor":
            # the all-to-all's fake kernel cuts the new shard from a
            # gathered whole and may hand back a view of it; the card's
            # kernel joins the shard from its pieces
            out = out.clone()
            scratch = _all_to_all_pieces(*args[:3], out)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        for t in ins:
            key = t.untyped_storage()._cdata
            if key in self.watched:
                self.read.add(key)
        for t in scratch + outs:
            self.track(t, str(packet))
        del scratch
        formula = flop_counter.flop_registry.get(packet)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if collective is not None:
            kind, which = collective
            self.collectives[kind] += sum(map(_nbytes,
                                              ins if which == "in" else outs))
            self.collectives["count"] += 1
        elif not func.is_view and outs:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return out


def _all_to_all_pieces(x, gather_dim: int, shard_dim: int, out) -> list:
    """Empty tensors as large as the buffers the card's all-to-all
    (``_dtensor.shard_dim_alltoall`` under NCCL) holds beside its input
    while it makes ``out``: ``x`` laid out piece by piece for the ranks (a
    copy, unless the pieces along ``shard_dim`` are contiguous already),
    and the buffer the pieces are received into, where joining them along
    ``gather_dim`` takes a copy (where every dim before ``gather_dim`` has
    one row, the join is a view and that buffer is the output).
    `tools/all_to_all_peak.py` holds this against four H100s."""
    pieces = []
    if not (x.is_contiguous() and math.prod(x.shape[:shard_dim]) == 1):
        pieces.append(x.new_empty(x.shape))
    if math.prod(out.shape[:gather_dim]) != 1:
        pieces.append(out.new_empty(out.shape))
    return pieces


@contextlib.contextmanager
def _attributed(recorder: Recorder):
    """While a trace runs with attribution: each `DTensor` made notes its
    placements on its local storage, each constraint site its layout, and
    autograd keeps each backward node's forward frames (anomaly mode, no
    NaN checks)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.context import observe_sites

    original = DTensor.__dict__["__init__"]

    def init(self, *args, **kwargs):
        original(self, *args, **kwargs)
        recorder.place(self)

    DTensor.__init__ = init
    try:
        with observe_sites(recorder.at_site), \
                torch.autograd.detect_anomaly(check_nan=False):
            yield
    finally:
        DTensor.__init__ = original


@contextlib.contextmanager
def _shard_arithmetic_on_host():
    """Run ``_StridedShard``'s shard-size arithmetic (which builds index
    tensors and reads them back) outside the fake mode: under it those
    tensors would be fake and could not be read."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types

    cls = placement_types._StridedShard
    original = cls.__dict__["local_shard_size_and_offset"]
    fn = getattr(original, "__func__", original)

    memo = {}

    def on_host(*args, **kwargs):
        # pure in its arguments, and it builds index tensors as long as the
        # sharded dim: remembered, each layer's ops ask it the same again
        try:
            key = (args, tuple(sorted(kwargs.items())))
            hit = memo.get(key)
        except TypeError:              # an argument that does not hash
            key = hit = None
        if hit is None:
            with unset_fake_temporarily():
                hit = fn(*args, **kwargs)
            if key is not None:
                memo[key] = hit
        size, offsets = hit
        return size, list(offsets) if isinstance(offsets, list) else offsets

    cls.local_shard_size_and_offset = (
        staticmethod(on_host) if isinstance(original, staticmethod)
        else on_host)
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = original


def _move_cost(current, target) -> float:
    """A price of moving a tensor from one placement spec to another, for
    ranking an op's candidate layouts: per mesh dim, the bytes the
    collective of that dim's change moves (an all-gather the gathered
    shard, an all-reduce twice the tensor, a reduce-scatter or an
    all-to-all the shard), a sum that ignores the order of the dims."""
    from torch.distributed.tensor.placement_types import Partial, Shard

    if current.mesh != target.mesh:
        return float("inf")
    meta = current.tensor_meta
    n = 1
    for d in (meta.shape if meta is not None else ()):
        n *= int(d)
    ways = 1
    for size, p in zip(current.mesh.shape, current.placements):
        if isinstance(p, Shard):
            ways *= int(size)
    shard = n / ways
    total = 0.0
    for size, a, b in zip(current.mesh.shape, current.placements,
                          target.placements):
        if a == b:
            continue
        if isinstance(a, Shard):
            if isinstance(b, Partial):
                return float("inf")
            total += shard * (size if not isinstance(b, Shard) else 1) + 1.0
        elif isinstance(a, Partial):
            if isinstance(b, Partial):
                return float("inf")
            total += shard * (2 if not isinstance(b, Shard) else 1)
    return total


@contextlib.contextmanager
def _plain_move_costs():
    """Let ``DTensor`` rank each op's candidate layouts by `_move_cost`. Its
    own price plans every move, and a move that holds a strided shard (a
    batch and a sequence sharded, then flattened) or a dim sharded over
    several mesh dims it plans by a graph search over the mesh's states:
    seconds a move on the (2, 16, 16) mesh, for every candidate. The price
    only ranks the candidates; the move an op takes is still planned by
    ``DTensor`` in full."""
    from torch.distributed.tensor._ops import utils

    original = utils.redistribute_cost
    utils.redistribute_cost = _move_cost
    try:
        yield
    finally:
        utils.redistribute_cost = original


@contextlib.contextmanager
def _all_to_all_moves():
    """Move a shard from one tensor dim to another by ``DTensor``'s
    all-to-all op whatever the fake tensors' device. On a CPU mesh
    ``DTensor`` gathers the whole dim and cuts the new shard from it
    instead (gloo has no all-to-all), a transient as large as the
    unsharded dim that the card's NCCL all-to-all never holds; the
    `Recorder` counts the op as the card runs it (`_all_to_all_pieces`)."""
    from torch.distributed._functional_collectives import _resolve_group_name
    from torch.distributed.tensor import placement_types

    original = placement_types.__dict__["shard_dim_alltoall"]
    op = torch.ops._dtensor.shard_dim_alltoall

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        return op(input, gather_dim, shard_dim,
                  _resolve_group_name((mesh, mesh_dim)))

    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = original


@contextlib.contextmanager
def _quiet_sharding_propagation(recorder: Recorder):
    """Enter ``recorder.quiet()`` around ``DTensor``'s computation of its
    outputs' global metadata (it runs the op on global-shape fake tensors
    in the same fake mode)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = ("_propagate_tensor_meta_non_cached"
            if "_propagate_tensor_meta_non_cached" in ShardingPropagator.__dict__
            else "_propagate_tensor_meta")
    original = ShardingPropagator.__dict__[name]

    def quiet(self, *args, **kwargs):
        with recorder.quiet():
            return original(self, *args, **kwargs)

    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, original)


# ---------------------------------------------------------------------------
# The fake world and the meshes
# ---------------------------------------------------------------------------

def fake_world(size: int) -> None:
    """Make this process rank 0 of a fake world of ``size`` ranks (the
    ``fake`` backend: collectives return at once and move nothing),
    replacing any fake world it had; refuses to replace a real one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("fake_world: a real process group exists; the "
                               "dry-run runs in a process of its own")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def fake_device() -> str:
    """The device type of the fake tensors and the meshes: the card's where
    torch is built for CUDA, else the CPU (a CPU-only build cannot index a
    fake CUDA tensor). No count depends on it: the fake tensors hold no
    memory, and the flash-attention kernel takes fake tensors of either
    device through its fake op."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def cell_mesh(mesh_kind: str):
    """``"single"`` / ``"multi"``: the production mesh over a fake world of
    256 / 512 ranks; ``"host"``: `HOST_MESH`'s axes as a mapping (one
    device, plain fake tensors)."""
    if mesh_kind == "host":
        return dict(zip(HOST_MESH.axes, HOST_MESH.shape))
    from repro_torch.launch.mesh import make_production_mesh

    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi, device_type=fake_device())


def _mesh_devices(mesh) -> int:
    """Ranks of a `DeviceMesh`, or of a ``{axis: size}`` mapping."""
    if isinstance(mesh, dict):
        return math.prod(mesh.values())
    return mesh.size()


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _train_config(arch: str, variant: str, microbatches: int) -> TrainConfig:
    return TrainConfig(optimizer=variant, learning_rate=1e-3,
                       microbatches=microbatches or MICROBATCHES.get(arch, 1),
                       svrg=SVRGConfig())


def _placements(tree):
    """The placements of each `DTensor` leaf of ``tree`` (None for a plain
    one), in leaf order."""
    from torch.distributed.tensor import DTensor

    return [tuple(x.placements) if isinstance(x, DTensor) else None
            for x in tree_leaves(tree)]


def _placed_as(tree, placements):
    """``tree`` with each `DTensor` leaf moved to its entry of
    ``placements`` (the JAX lowering's ``out_shardings``); a leaf already
    there is returned as it is."""
    from torch.distributed.tensor import DTensor

    leaves = [x.redistribute(x.device_mesh, p) if isinstance(x, DTensor)
              and p is not None and tuple(x.placements) != p else x
              for x, p in zip(tree_leaves(tree), placements)]
    return tree_unflatten_like(tree, leaves)


def cell_inputs(cfg, shape: ShapeConfig, mesh, fake_mode, variant="svrg",
                microbatches: int = 0):
    """(step, args, read): the cell's step function, its fake arguments
    (on `fake_device`), and those of them it reads though no op takes them
    (the decode position, a Python int to the port's step and an int32
    argument to the JAX package's). ``cfg`` is the model's config
    (``get_config(arch)``, or a cut one). The step returns its state or
    cache placed as the JAX lowering's ``out_shardings`` place them."""
    device = fake_device()
    bundle = build_model(cfg, "cpu")      # the step reads its device from
    if shape.kind == "train":             # the fake tensors
        tcfg = _train_config(cfg.name, variant, microbatches)
        state = defs_to_shape_structs(make_train_state_defs(bundle, tcfg),
                                      mesh, fake_mode, device=device)
        batch = {name: fake_tensor(spec, fake_mode, device) for name, spec
                 in bundle.input_specs(shape, mesh).items()}
        train_step, like = make_train_step(bundle, tcfg), _placements(state)

        def train(s, b):
            new, metrics = train_step(s, b)
            return _placed_as(new, like), metrics

        return train, (state, batch), []

    params = defs_to_shape_structs(bundle.param_defs, mesh, fake_mode,
                                   dtype=cfg.dtype, device=device)
    cache_defs = bundle.cache_defs(shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        batch = {name: fake_tensor(spec, fake_mode, device) for name, spec
                 in bundle.input_specs(shape, mesh).items()}
        like = [spec.sharding and tuple(spec.sharding.placements)
                for _, spec in tree_flatten_with_path(
                    defs_to_specs(cache_defs, mesh),
                    is_leaf=lambda x: isinstance(x, TensorSpec))]

        def prefill(p, b):
            logits, cache = bundle.prefill_fn(p, b, shape.seq_len)
            return logits, _placed_as(cache, like)

        return prefill, (params, batch), []

    cache = defs_to_shape_structs(cache_defs, mesh, fake_mode, device=device)
    like = _placements(cache)
    B = shape.global_batch
    tokens = fake_tensor(spec_on((B,), torch.int32, logical_to_pspec(
        (B,), ("batch",), mesh), mesh), fake_mode, device)
    # the position: a 4-byte int32 argument in the JAX package's step; the
    # port's decode step takes it as a Python int
    position = fake_tensor(spec_on((), torch.int32, (), None), fake_mode,
                           device)

    def decode(p, c, t, pos):
        logits, out = bundle.decode_fn(p, c, t, shape.seq_len - 1)
        return logits, _placed_as(out, like)

    return decode, (params, cache, tokens, position), [position]


@contextlib.contextmanager
def recording(rec: Recorder, mesh, fake_mode):
    """Run what the body runs as rank 0 of ``mesh`` (a `DeviceMesh` of the
    fake world, or `cell_mesh("host")`'s mapping) in ``fake_mode``, under
    ``rec``: the ambient mesh installed for the models' constraint sites,
    and ``DTensor``'s internals patched as a trace needs (see each
    patch)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(fake_mode)
        if not isinstance(mesh, dict):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack.enter_context(implicit_replication())
            stack.enter_context(_quiet_sharding_propagation(rec))
            stack.enter_context(_shard_arithmetic_on_host())
            stack.enter_context(_plain_move_costs())
            stack.enter_context(_all_to_all_moves())
        if rec.attribute:
            stack.enter_context(_attributed(rec))
        stack.enter_context(mesh_context(mesh))
        stack.enter_context(rec)
        yield


def trace_cell(cfg, shape: ShapeConfig, mesh, variant: str = "svrg",
               microbatches: int = 0, attribute: bool = False) -> Dict:
    """Run one cell's step once on fake tensors under ``mesh`` with a
    `Recorder`; returns the record's ``memory``, ``cost``, ``op_cost`` and
    ``collectives`` (per device: rank 0's). Allocates no device memory and
    launches no kernel. With ``attribute`` the record also holds
    ``attribution``: every storage alive at the peak, largest first (see
    `Recorder`); the trace is then slower (anomaly mode)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake_mode = FakeTensorMode()
    step, args, read = cell_inputs(cfg, shape, mesh, fake_mode, variant,
                                   microbatches)
    rec = Recorder(attribute)
    for t in _tensors(args):
        rec.track(t)
    rec.watched = rec.storages(args)
    rec.read.update(rec.storages(read))
    with recording(rec, mesh, fake_mode):
        out = step(*args)
    outputs = rec.storages(out)
    # the arguments the step reads or hands back: XLA drops a jitted step's
    # unused ones
    arg_b = sum(n for key, n in rec.watched.items()
                if key in rec.read or key in outputs)
    out_b = sum(outputs.values())
    alias_b = sum(n for key, n in outputs.items() if key in rec.watched)
    return {
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": rec.peak - arg_b - out_b + alias_b,
            "alias_bytes": alias_b,
            "peak_per_device_bytes": rec.peak,
            "peak_allocator_bytes": rec.peak_rounded,
        },
        "cost": {"flops": float(rec.flops), "bytes accessed": float(rec.bytes)},
        "op_cost": {"flops": float(rec.flops), "bytes": float(rec.bytes)},
        "collectives": dict(rec.collectives),
        **({"attribution": rec.attribution()} if attribute else {}),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             variant: str = "svrg") -> Dict:
    """One cell's record, written to ``out_dir``; a failure is recorded as
    ``failed`` with its error, and the sweep goes on."""
    shape = SHAPE_GRID[shape_name]
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant, "status": "ok",
    }
    skip = cell_skip_reason(arch, shape)
    if skip:
        record["status"] = "skipped"
        record["reason"] = skip
        _write(record, out_dir)
        return record

    t0 = time.perf_counter()
    try:
        cfg = get_config(arch)
        mesh = cell_mesh(mesh_kind)
        record["num_devices"] = _mesh_devices(mesh)
        record.update(trace_cell(cfg, shape, mesh, variant))
        record["collectives_trips"] = dict(record["collectives"])
        defs = build_model(cfg, "cpu").param_defs
        total, active = count_params(cfg, defs)
        record["params_total"] = total
        record["params_active"] = active
        record["model_flops"] = model_flops(cfg, shape, defs)
        record["t_trace_s"] = round(time.perf_counter() - t0, 2)
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        record["status"] = "failed"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        record["t_trace_s"] = round(time.perf_counter() - t0, 2)
    _write(record, out_dir)
    return record


def _write(record: Dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{record['mesh']}__{record['arch']}__{record['shape']}"
        + (f"__{record['variant']}" if record.get("variant", "svrg") != "svrg" else "")
        + ".json")
    slim = {k: v for k, v in record.items() if k != "traceback"}
    with open(path, "w") as f:
        json.dump(slim, f, indent=1)
    status = record["status"]
    extra = ""
    if status == "ok":
        peak = record["memory"]["peak_per_device_bytes"] / 2**30
        extra = (f" peak={peak:.2f}GiB/dev flops/dev={record['cost'].get('flops', 0):.3g}"
                 f" colls={record['collectives'].get('count', 0)}"
                 f" trace={record['t_trace_s']}s")
    elif status == "failed":
        extra = " " + record["error"][:200]
    log(f"[{status}] {record['mesh']} {record['arch']} {record['shape']}{extra}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"],
                    choices=["single", "multi"])
    ap.add_argument("--variant", default="svrg",
                    help="train-step optimizer variant (svrg|sgd|adamw)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == ["all"] else args.arch
    shapes = list(SHAPE_GRID) if args.shape == ["all"] else args.shape

    n_ok = n_skip = n_fail = 0
    for mesh_kind in args.mesh:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_kind, args.out, args.variant)
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                n_fail += rec["status"] == "failed"
    log(f"dry-run done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
