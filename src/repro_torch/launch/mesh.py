"""Production mesh construction.  A port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group.  Each builds a ``torch.distributed.device_mesh.DeviceMesh``
over the default process group, which the caller has initialised on
every rank with its own store, world size and rank
(``init_process_group``; the dry-run's is a fake group of 256 or 512
ranks).

Mesh semantics:
  * ``pod``   — the paper's Map-worker axis: MapReduce/local-SGD merges
                cross this axis every H steps (``core/local_sgd.py``);
  * ``data``  — intra-pod data parallelism, the paper's BGD Reduce
                (gradients summed every step), and the FSDP shard axis;
  * ``model`` — tensor/expert parallelism.
"""
from __future__ import annotations

import math

import torch.distributed as dist


def _mesh(shape, names, device: str):
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    ready = dist.is_available() and dist.is_initialized()
    have = dist.get_world_size() if ready else 1
    if have != need:
        raise ValueError(
            f"a {tuple(shape)} mesh needs {need} ranks (the product of its "
            f"shape); the process group has {have}"
            + ("" if have > need else
               f": start {need} ranks, each calling init_process_group"))
    if not ready:
        raise RuntimeError(
            "the mesh needs an initialised torch.distributed process group: "
            "call init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) first")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") with ``multi_pod``; raises ``ValueError`` unless the
    process group has exactly 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_mesh_for_devices(n: int, model_parallel: int = 1,
                          device: str = "cuda"):
    """Small-scale helper for tests and examples: (n / model_parallel,
    model_parallel) over ("data", "model"), on a process group of ``n``
    ranks."""
    if n % model_parallel != 0:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"{n} ranks")
    return _mesh((n // model_parallel, model_parallel), ("data", "model"),
                 device)
