"""The ``shard_map`` backend's mesh and collectives, over
``torch.distributed`` (port of ``repro.parallel.util``: ``worker_map``,
``all_gather_deltas``, ``constrain`` and ``constrain_batch``), and the
LM mesh's ambient context and parameter gathering.

In JAX one process drives a mesh of devices through ``shard_map``; in
PyTorch the idiom is SPMD over processes: every rank calls the same
function, holds ``W / M`` of the ``W`` workers (rank ``r`` the block
``[r·W/M, (r+1)·W/M)``, as ``P("workers")`` splits the worker axis), runs
them stacked as the ``vmap`` backend runs all ``W``, and meets the other
ranks in collectives.  Every rank returns the same result.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with one
dimension named ``"workers"`` (:func:`workers_mesh`, the counterpart of
``jax.make_mesh((M,), ("workers",))``), made over a process group the
caller has initialised with its own store, world size and rank.  Its
device type is the device of the tensors it carries: a CUDA mesh with CPU
tensors raises, and so does the opposite.

Every all-gather here returns the ranks' bytes exactly, in rank order
(:func:`all_gather`): never an ``all_reduce`` of zero-padded blocks, whose
``-0.0 + 0.0`` comes back ``+0.0``.  Gloo takes CUDA tensors (it copies
them through the host): with torch 2.11 on an H100 it ran
``all_gather``, ``all_reduce`` (sum, max), ``broadcast`` and ``barrier``
on them, so several ranks sharing one card run the same code over gloo.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AXIS = "workers"
AxisLike = Union[None, str, Tuple[str, ...]]


def workers_mesh(M: int, device="cuda"):
    """A one-dimensional ``DeviceMesh`` named ``"workers"`` over the ``M``
    ranks of the default process group, which the caller initialises on
    every rank (``torch.distributed.init_process_group`` with its store,
    world size ``M`` and rank; NCCL for CUDA tensors across GPUs, gloo on
    the CPU or for several ranks sharing one GPU); the mesh reuses that
    group and creates no other.  ``device`` names the device type of the
    tensors the mesh carries."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "workers_mesh needs an initialised torch.distributed process "
            "group: call init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) on every rank first")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("workers_mesh(device='cuda') on a rank that "
                           "cannot reach a CUDA device")
    if dist.get_world_size() != M:
        raise ValueError(f"a mesh of {M} ranks over a process group of "
                         f"{dist.get_world_size()}")
    return DeviceMesh.from_group(dist.group.WORLD, dev.type,
                                 mesh_dim_names=(AXIS,))


def check_mesh(mesh, device=None, n_workers: Optional[int] = None) -> None:
    """Raise unless ``mesh`` is a ``DeviceMesh`` with a ``"workers"``
    dimension, of the device type of ``device`` (when given), over which
    ``n_workers`` (when given) divides."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed.device_mesh.DeviceMesh with "
            f"a {AXIS!r} dimension (parallel.util.workers_mesh), got "
            f"{type(mesh).__name__}")
    if mesh.mesh_dim_names is None or AXIS not in mesh.mesh_dim_names:
        raise ValueError(
            f"mesh has dimensions {mesh.mesh_dim_names}, not {AXIS!r}")
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(
            f"tensors on {torch.device(device).type!r} over a "
            f"{mesh.device_type!r} mesh: the mesh's device type must be "
            "the tensors'")
    if n_workers is not None:
        M = mesh_size(mesh)
        if n_workers % M != 0:
            raise ValueError(
                f"worker axis of size {n_workers} does not divide over mesh "
                f"axis {AXIS!r} of size {M}")


def mesh_size(mesh) -> int:
    """M, the number of ranks along ``"workers"``."""
    return mesh.size(mesh.mesh_dim_names.index(AXIS))


def mesh_rank(mesh) -> int:
    """This rank's position along ``"workers"``."""
    return mesh.get_local_rank(AXIS)


def local_workers(mesh, n_workers: int) -> tuple:
    """``(lo, hi)``: the global ids of this rank's block of workers."""
    check_mesh(mesh, n_workers=n_workers)
    per = n_workers // mesh_size(mesh)
    lo = mesh_rank(mesh) * per
    return lo, lo + per


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order, the
    ranks' bytes exactly (the counterpart of ``all_gather(...,
    tiled=True)``; a ``(W/M, ...)`` block per rank gives ``(W, ...)``).
    A bool ``x`` travels as uint8."""
    group = mesh.get_group(AXIS)
    M = dist.get_world_size(group)
    dtype = x.dtype
    x = x.contiguous()
    if dtype == torch.bool:
        x = x.to(torch.uint8)
    parts = [torch.empty_like(x) for _ in range(M)]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts) if x.dim() else torch.stack(parts)
    return out.to(dtype) if dtype == torch.bool else out


def all_reduce(x: torch.Tensor, mesh, op: str = "sum",
               axis: str = AXIS) -> torch.Tensor:
    """The ranks' ``x`` reduced elementwise over the mesh dimension
    ``axis`` (``op``: 'sum', 'max' or 'min'), out of place; the sum adds
    in the backend's order."""
    out = x.clone().contiguous()
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    dist.all_reduce(out, op=ops[op], group=mesh.get_group(axis))
    return out


def barrier(mesh) -> None:
    """Every rank of the mesh waits for the others here."""
    group = mesh.get_group(AXIS)
    if mesh.device_type == "cuda" and dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def tree_map(fn: Callable, tree):
    """``fn`` over the tensor leaves of a dict / tuple / list tree;
    ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def all_gather_deltas(packed, mesh):
    """All-gather each rank's packed sparse-delta buffers (every leaf of
    the tree, e.g. ``merge.pack_delta``'s ``(idx, vals, cnt, lss)`` with a
    leading ``(W/M, ...)`` worker axis) into ``(W, ...)`` in rank order:
    the sparse transport's only cross-worker traffic, O(W·C·k) bytes a
    table instead of the dense Reduce's O(W·N·k)."""
    return tree_map(lambda x: all_gather(x, mesh), packed)


def worker_map(fn: Callable, *, backend: str, mesh=None) -> Callable:
    """Lift ``fn(broadcast, *per_worker)`` over a leading worker axis:
    ``run(broadcast, *sharded)`` calls ``fn`` once per worker ``w`` with
    ``x[w]`` of every ``sharded`` argument (tensors or numpy arrays with a
    leading ``W`` axis) and returns its outputs (a tensor, or a dict /
    tuple tree of tensors) stacked along a new leading ``W`` axis.
    ``vmap`` runs all W workers here; ``shard_map`` runs this rank's
    block of ``W / M`` and all-gathers the stacked outputs in rank order,
    so every rank returns the same ``(W, ...)`` outputs, the vmap ones'
    bits.  A ``W`` that does not divide over the mesh raises."""
    def stack(outs):
        first = outs[0]
        if isinstance(first, dict):
            return {k: stack([o[k] for o in outs]) for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(stack([o[i] for o in outs])
                               for i in range(len(first)))
        return torch.stack(outs)

    if backend == "vmap":
        def run(broadcast, *sharded):
            W = len(sharded[0])
            return stack([fn(broadcast, *(x[w] for x in sharded))
                          for w in range(W)])
        return run
    if backend != "shard_map":
        raise ValueError(f"bad backend {backend!r}")
    if mesh is None:
        raise ValueError("shard_map backend needs a mesh")

    def run(broadcast, *sharded):
        lo, hi = local_workers(mesh, len(sharded[0]))
        outs = stack([fn(broadcast, *(x[w] for x in sharded))
                      for w in range(lo, hi)])
        return tree_map(lambda t: all_gather(t, mesh), outs)
    return run


# ---------------------------------------------------------------------------
# the LM mesh: an ambient (data, model) / (pod, data, model) DeviceMesh
# ---------------------------------------------------------------------------
#
# The reference traces the LM under ``with mesh:`` and lets GSPMD place
# every activation.  The port runs SPMD over ranks: every rank runs the
# model on its own shard of the batch (``data_shardings``), as a
# ``shard_map`` body would.  Parameters rest as DTensors placed by
# ``param_shardings``; :func:`local_params` all-gathers a module's
# parameters where they are used (within a layer, so under
# ``torch.utils.checkpoint`` the backward gathers them again) into local
# tensors whose gradients flow back to the resting placements: partial
# sums over the mesh dims the batch is cut over (a reduce-scatter into a
# sharded parameter), whole over the others.  A MoE FFN's routed experts
# stay cut over ``model`` for the expert-parallel dispatch
# (``models/moe._apply_moe_shardmap``).

@dataclasses.dataclass(frozen=True)
class MeshContext:
    mesh: object
    batch_axes: Tuple[str, ...] = ()   # mesh dims the rank's batch is cut over
    profile: str = "dp"


_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh, batch_axes: Sequence[str] = (), profile: str = "dp"):
    """Make ``mesh`` the ambient LM mesh inside the block (the reference's
    ``with mesh:``): ``batch_axes`` names the mesh dims this rank's batch
    is cut over, ``profile`` the config's sharding profile."""
    token = _MESH.set(MeshContext(mesh, tuple(batch_axes), profile))
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def mesh_context() -> Optional[MeshContext]:
    return _MESH.get()


def ambient_mesh():
    """The ambient LM ``DeviceMesh``, or None."""
    ctx = _MESH.get()
    return None if ctx is None else ctx.mesh


def mesh_axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _under(ctx: MeshContext, fn, *args, **kw):
    token = _MESH.set(ctx)
    try:
        return fn(*args, **kw)
    finally:
        _MESH.reset(token)


def remat(fn, *args, **kw):
    """``torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
    **kw)``, its recompute run under the ambient mesh of the forward: the
    backward that recomputes may run on autograd's device thread, where
    the forward's context is not set."""
    from torch.utils.checkpoint import checkpoint

    ctx = _MESH.get()
    if ctx is not None:
        fn = functools.partial(_under, ctx, fn)
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def constrain_batch(x: torch.Tensor, profile: str) -> torch.Tensor:
    """Pin dim0 (batch) of an activation to the data-parallel axes."""
    axes = ("pod", "data", "model") if profile == "dp" else ("pod", "data")
    return constrain(x, (axes,) + (None,) * (x.dim() - 1))


def constrain(x: torch.Tensor, axes: Sequence[AxisLike]) -> torch.Tensor:
    """Redistribute a DTensor activation to ``axes`` (one entry a dim),
    keeping only the mesh's axes and, of a group, the longest prefix that
    divides the dim.  The identity without an ambient mesh, and on a plain
    tensor: under the port's mesh a plain activation is already this
    rank's shard of the batch."""
    from torch.distributed.tensor import DTensor

    mesh = ambient_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    from repro_torch.parallel.sharding import placements

    names = set(mesh.mesh_dim_names)
    spec = []
    for dim, ax in zip(x.shape, tuple(axes) + (None,) * (x.dim() - len(axes))):
        if ax is None:
            spec.append(None)
            continue
        group = tuple(a for a in ((ax,) if isinstance(ax, str) else ax)
                      if a in names)
        kept, size = [], 1
        for a in group:
            nxt = size * mesh_axis_size(mesh, a)
            if dim % nxt != 0:
                break
            kept.append(a)
            size = nxt
        spec.append(tuple(kept) if kept and size > 1 else None)
    return x.redistribute(mesh, placements(tuple(spec), mesh))


def keeps_model_shard(owner, name: str, placement_on_model) -> bool:
    """Whether :func:`local_params` leaves ``owner.name`` cut over
    ``model``: a MoE FFN's routed-expert tensor resting as ``Shard(0)``
    over ``model`` (its padded experts divide the axis), under a ``tp`` or
    ``fsdp_tp`` profile, where the batch is cut over every data-parallel
    axis and they number more than one: the reference's condition for
    its ``shard_map`` dispatch (``moe.apply_moe``)."""
    from torch.distributed.tensor import Shard

    from repro_torch.models.moe import MoEParams

    ctx = _MESH.get()
    if (ctx is None or ctx.profile == "dp"
            or not isinstance(owner, MoEParams)
            or name not in ("wi", "wg", "wo")
            or placement_on_model != Shard(0)):
        return False
    dp = [a for a in ("pod", "data") if a in ctx.mesh.mesh_dim_names]
    return (all(a in ctx.batch_axes for a in dp)
            and math.prod(mesh_axis_size(ctx.mesh, a) for a in dp) > 1)


def _gather(p, owner, name: str, ctx: MeshContext) -> torch.Tensor:
    from torch.distributed.tensor import Partial, Replicate

    target, grads = [], []
    for axis, pl in zip(ctx.mesh.mesh_dim_names, p.placements):
        if axis == "model" and keeps_model_shard(owner, name, pl):
            target.append(pl)
            grads.append(pl)
            continue
        target.append(Replicate())
        grads.append(Partial() if axis in ctx.batch_axes else Replicate())
    return p.redistribute(ctx.mesh, target).to_local(
        grad_placements=grads)


@contextlib.contextmanager
def local_params(*modules, exclude=()):
    """Inside the block, every DTensor parameter held directly by
    ``modules`` or their submodules (not under ``exclude``) reads as this
    rank's local working copy: all-gathered, or its block of experts (see
    :func:`keeps_model_shard`).  A no-op without an ambient mesh."""
    from torch.distributed.tensor import DTensor

    ctx = _MESH.get()
    if ctx is None:
        yield
        return
    skip = {id(m) for e in exclude for m in e.modules()}
    swapped = []
    try:
        for module in modules:
            for mod in module.modules():
                if id(mod) in skip:
                    continue
                for name, p in list(mod._parameters.items()):
                    if isinstance(p, DTensor):
                        mod._parameters[name] = _gather(p, mod, name, ctx)
                        swapped.append((mod, name, p))
        yield
    finally:
        for mod, name, p in reversed(swapped):
            mod._parameters[name] = p


def distribute_module(module: torch.nn.Module, specs, mesh) -> None:
    """Replace every parameter of ``module`` by a DTensor placed on
    ``mesh`` by its spec (``specs[name]``); each rank keeps its own block
    of the tensor it holds, with no communication (every rank holds the
    same full values)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel.sharding import placements

    for mod_name, mod in module.named_modules():
        for name, p in list(mod._parameters.items()):
            full = f"{mod_name}.{name}" if mod_name else name
            dt = distribute_tensor(p.detach(), mesh,
                                   placements(specs[full], mesh),
                                   src_data_rank=None)
            mod._parameters[name] = torch.nn.Parameter(
                dt, requires_grad=p.requires_grad)


def distribute_tree(tree, specs, mesh):
    """A tree of tensors placed on ``mesh`` by a tree of specs of the same
    structure (each rank keeps its block, no communication)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel.sharding import placements

    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, placements(specs, mesh),
                             src_data_rank=None)


def full_tree(tree):
    """Every DTensor of a tree all-gathered into a whole local tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def batch_shards(ctx: Optional[MeshContext]) -> int:
    """How many distinct shards the batch is cut into on the mesh."""
    if ctx is None:
        return 1
    return math.prod(mesh_axis_size(ctx.mesh, a) for a in ctx.batch_axes)


# ---------------------------------------------------------------------------
# collectives with gradients (the MoE dispatch's, inside one mesh dim)
# ---------------------------------------------------------------------------

def _sum(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _SumBoth(torch.autograd.Function):
    """Sum over the group forward; the cotangents summed backward (each
    rank's value feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _SumForward(torch.autograd.Function):
    """Sum over the group forward, the identity backward: the sum is
    whole on every rank and the loss counts it once (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """The identity forward, the cotangents summed backward: a whole
    tensor entering a computation cut over the group (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def psum(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``jax.lax.psum`` over the mesh dims ``axes`` (one dim after the
    other) of a value every rank feeds into its own loss: a sum forward
    and backward."""
    for a in axes:
        x = _SumBoth.apply(x, mesh.get_group(a))
    return x


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over ``axis`` of partial results into a value whole on every
    rank of it (gradient: the identity)."""
    return _SumForward.apply(x, mesh.get_group(axis))


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``, whole on every rank of ``axis``, entering work cut over it
    (gradient: summed over ``axis``)."""
    return _SumBackward.apply(x, mesh.get_group(axis))
