"""The ``shard_map`` backend's mesh and collectives, over
``torch.distributed`` (port of ``repro.parallel.util``'s ``worker_map``
and ``all_gather_deltas``).

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

from typing import Callable, Optional

import torch
import torch.distributed as dist

AXIS = "workers"


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


def all_reduce(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """The ranks' ``x`` reduced elementwise (``op``: 'sum', 'max' or
    'min'), out of place; the sum adds in the backend's order."""
    out = x.clone().contiguous()
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    dist.all_reduce(out, op=ops[op], group=mesh.get_group(AXIS))
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
