"""Per-device cost of one traced step: FLOPs, bytes and collective wire
bytes over the aten ops one rank runs.  The counterpart of
``repro.roofline.hlo_cost``, which parses XLA's optimized HLO.

The dry-run traces a step on the ``meta`` device (shapes, no memory)
over a fake process group: every op is this rank's, on its local
shards, so the counts are per device.  :class:`CostMode` (a
``TorchDispatchMode``) records, for each op:

  * FLOPs, from ``torch.utils.flop_counter``'s formulas (matrix products,
    convolutions, attention) on the local shapes;
  * bytes: every input read once and every output written once, as an
    eager op moves them (views and metadata ops move none; an op on a
    DTensor counts its local tensors);
  * collectives (``_c10d_functional`` and ``c10d`` ops): buffer bytes,
    group size and link, weighted by the reference's ring factors
    (``analysis._WIRE_FACTOR``); a reduce-scatter counts its input;
  * live bytes: every storage an op creates, held until it is freed, for
    the step's peak.

A collective that a DTensor op issues inside its own dispatch (a partial
sum its arithmetic forces, e.g. the optimizer's global gradient norm) is
not seen by the mode: only scalars here.  There is no loop to multiply
through: the trace runs every layer's ops.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline.analysis import H100_SXM, _WIRE_FACTOR, link_of

_COLL_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute",
}
_FREE = {"wait_tensor", "device", "empty_like", "detach", "alias"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _group_ranks(args, kwargs) -> Optional[List[int]]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(
                    _resolve_process_group(a))
            except (KeyError, ValueError, RuntimeError):
                continue
        if isinstance(a, torch.ScriptObject):
            try:
                a = dist.ProcessGroup.unbox(a)
            except (RuntimeError, TypeError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
    return None


@dataclasses.dataclass
class HLOCost:
    flops: float                   # per-device FLOPs
    bytes_accessed: float          # per-device bytes read and written
    coll_wire_bytes: float         # per-device collective wire bytes
    coll_by_op: Dict[str, float]
    coll_counts: Dict[str, float]
    coll_by_link: Dict[str, float] = dataclasses.field(default_factory=dict)

    def row(self):
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "coll_wire_bytes": self.coll_wire_bytes,
            **{f"{k}_bytes": v for k, v in self.coll_by_op.items()},
            **{f"{k}_count": v for k, v in self.coll_counts.items()},
            **{f"{k}_wire_bytes": v for k, v in self.coll_by_link.items()},
        }


class CostMode(TorchDispatchMode):
    """Records the cost of every aten op dispatched inside it (see the
    module docstring).  ``collectives`` holds (op, buffer bytes, group
    size, link) records; ``peak_live`` the largest sum of live storages
    the ops created."""

    def __init__(self, hw: dict = H100_SXM):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.hw = hw
        self.registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[tuple] = []
        self.buffers: List[tuple] = []     # (bytes, op name) of outputs
        self._refs: Dict[int, int] = {}
        self._size: Dict[int, int] = {}
        self._held: set = set()
        self.live = 0
        self.peak_live = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def hold(self, tensors) -> int:
        """Count ``tensors`` (the step's arguments: parameters, optimizer
        state, batch, caches) as resting, never as the step's own live
        bytes; returns their local bytes."""
        from torch.multiprocessing.reductions import StorageWeakRef

        total = 0
        for t in _tensors(list(tensors)):
            st = _local(t).untyped_storage()
            key = StorageWeakRef(st).cdata
            if key not in self._held:
                self._held.add(key)
                total += st.nbytes()
        return total

    def _record(self, func, args, kwargs, out):
        name = func._overloadpacket.__name__
        if name in _FREE:
            self._track(out, name)
            return
        coll = _COLL_OPS.get(name)
        if coll is not None:
            ins = [_nbytes(t) for t in _tensors(args)]
            outs = [_nbytes(t) for t in _tensors(out)]
            nbytes = sum(ins) if coll in ("reduce-scatter", "all-reduce") \
                else sum(outs) or sum(ins)
            ranks = _group_ranks(args, kwargs) or []
            size = len(ranks) or 1
            link = link_of(ranks, self.hw) if ranks else "network"
            self.collectives.append((coll, nbytes, size, link))
            self._track(out, name)
            return
        if _is_view(func):
            self._track(out, name)
            return
        fn = self.registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += float(fn(*args, **kwargs, out_val=out))
        self.bytes += sum(_nbytes(t) for t in _tensors(args)) + \
            sum(_nbytes(t) for t in _tensors(out))
        self._track(out, name)

    def _track(self, out, name: str):
        """Count the storages behind ``out`` live until the last tensor an
        op returned on each is freed (views included)."""
        from torch.multiprocessing.reductions import StorageWeakRef

        for t in _tensors(out):
            t = _local(t)
            st = t.untyped_storage()
            key = StorageWeakRef(st).cdata
            if key in self._held:
                continue
            n = self._refs.get(key, 0)
            if n == 0:
                size = st.nbytes()
                self._size[key] = size
                self.live += size
                self.buffers.append((size, name))
            self._refs[key] = n + 1
            weakref.finalize(t, self._release, key)
        self.peak_live = max(self.peak_live, self.live)

    def _release(self, key: int):
        n = self._refs[key] - 1
        self._refs[key] = n
        if n == 0:
            self.live -= self._size.pop(key)
            del self._refs[key]

    def sweep(self):
        """Note the peak (the counts are kept exact as tensors die)."""
        self.peak_live = max(self.peak_live, self.live)

    def cost(self) -> HLOCost:
        by_op: Dict[str, float] = {}
        counts: Dict[str, float] = {}
        by_link: Dict[str, float] = {}
        for op, nbytes, size, link in self.collectives:
            wire = _WIRE_FACTOR[op](max(size, 1)) * nbytes
            by_op[op] = by_op.get(op, 0.0) + wire
            counts[op] = counts.get(op, 0.0) + 1
            by_link[link] = by_link.get(link, 0.0) + wire
        return HLOCost(flops=self.flops, bytes_accessed=self.bytes,
                       coll_wire_bytes=sum(by_op.values()), coll_by_op=by_op,
                       coll_counts=counts, coll_by_link=by_link)


def analyze(mode: CostMode) -> HLOCost:
    """The per-device cost a :class:`CostMode` recorded."""
    return mode.cost()


def top_buffers(mode: CostMode, n: int = 12):
    """The largest single buffers the step created (GB)."""
    top = sorted(mode.buffers, key=lambda b: -b[0])[:n]
    return [(f"{name}:{i}", b / 2**30) for i, (b, name) in enumerate(top)]
