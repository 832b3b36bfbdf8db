"""Reduce-phase merge strategies (paper §3.1.2), port of the dense stacked
half of ``repro.core.merge``.

After the Map phase, W workers hold W inconsistent copies of each
embedding table.  The paper Reduces the W vectors of each key by:

  * ``random``            — one worker's vector, picked at random,
  * ``average``           — the mean,
  * ``miniloss``          — the vector of the worker with the smallest loss.

Each comes in the reference's two refinements: per-key *touch-aware*
variants, in which only the workers whose subset updated the key take
part (``random``, ``average``, ``miniloss_perkey``), and the literal global
ones (``average_all``: plain mean over all workers; ``miniloss_global``:
the worker with the smallest mean loss wins every key).

Tables carry a leading worker axis, ``(W, N, k)``, with per-key stats
``counts`` / ``losses`` ``(W, N)`` and ``worker_loss`` ``(W,)``.  Sums over
workers run in worker order (:func:`worker_sum`), so a merge gives the
same bits on the CPU and the card.

Transport (``MapReduceConfig.merge_transport``)
-----------------------------------------------

``dense`` (the default) merges whole ``(W, N, k)`` tables.  ``sparse``
merges compact per-worker *delta buffers* and gives the same bits:

  * **pack** (:func:`pack_delta`): each worker gathers the rows its touch
    stats mark updated (``count > 0``) into ``(C, k)`` values and ``(C,)``
    counts and losses, with their sorted ``(C,)`` row ids.
  * **capacity** (:func:`touched_capacity`): ``C`` is a static bound on
    the rows a round touches, ``min(n_rows, f · batch_size ·
    steps_per_epoch · merge_every)`` with ``f = 4`` for entity-role tables
    (positive and corrupted heads and tails) and ``f = 1`` for
    relation-role ones.  Unused slots hold the pad id ``n_rows`` (values
    0), which every gather fills (:func:`take_fill`) and every scatter
    drops (:func:`put_drop_`).  A round touching more than ``C`` rows
    would lose the overflow's updates, so the engine counts touched rows
    on the device (:func:`delta_overflow`) and the training drivers raise
    on a positive count at the Reduce boundary.
  * **merge** (:func:`merge_sparse_stacked`): only the union of the
    workers' touched ids (:func:`sparse_candidates`) is merged.  A worker
    that did not touch a candidate row holds its *virgin* value there —
    the round-input row put through the model's ``normalize_rows`` once
    per merged epoch (``normalize="epoch"``), once per merged step
    (``"step"``) or never (``"none"``) — which is exactly its dense copy.
    The dense formulas then run on the ``(W, U, k)`` candidate slices
    (every one is per row, so the slices give the dense rows' bits), and
    the merged rows are scattered into the untouched rows' merged value
    (:func:`sparse_untouched_base`).

Every sized set here has a static size and is built without a host sync:
:func:`sized_unique` sorts, marks each run's first element, takes its
slot from a cumulative sum and scatters into a buffer prefilled with the
pad id, with one dump slot past the end for everything else.  So the
device pipeline's blocks stay free of host syncs under either transport.

Sharded tables (``table_sharding="sharded"``)
---------------------------------------------

Shard ``s`` owns rows ``[s·R, min((s+1)·R, N))``, ``R = shard_rows(N,
W)``.  The sparse Reduce splits the candidate union into the shards'
blocks (:func:`own_candidates`) and merges each block on its own
(:func:`merge_sparse_sharded_stacked`); every strategy's math is per row,
so the blocks reassemble the replicated merge bitwise.  On one device the
W shards run one after another, each holding one block's transient
buffers.

Bounded staleness (``MapReduceConfig.staleness > 0``)
-----------------------------------------------------

Workers then start a round from their own stale copies, not from one
shared round input, so the stale merges are *participation-masked*
(:func:`merge_candidates_stale`): per row only the workers that touched
it this round take part, under every strategy, and a row nobody touched
keeps the global view exactly (it is not re-normalized).  The dense
(:func:`merge_stacked_stale`), sparse (:func:`merge_sparse_stale`) and
sharded sparse (:func:`merge_sparse_stale_sharded_stacked`) forms give
the same bits.

The ``shard_map`` backend (``parallel/util.py``: each rank holds ``W/M``
of the W workers) Reduces by collectives: :func:`merge_allgather` gathers
the full stacks and gives the stacked merge's bits;
:func:`merge_collective` (``reduce_impl="psum"``) sums each rank's own
workers, then all-reduces, and agrees within tolerance (bitwise at M =
1).  The sharded and the stale sparse merges over a mesh
(:func:`merge_sparse_sharded_collective`,
:func:`merge_sparse_stale_collective`) take the all-gathered packed
buffers; each rank merges only the candidate blocks its workers own and
the merged blocks are all-gathered, which returns them exactly, so they
give the stacked forms' bits.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.parallel import util as par
from repro_torch.util import exact_div

STRATEGIES = (
    "random",
    "average",
    "average_all",
    "miniloss_perkey",
    "miniloss_global",
)

_BIG = 1e30


def worker_sum(stacked: torch.Tensor) -> torch.Tensor:
    """Sum over the leading worker axis, taken ``((x_0 + x_1) + x_2) + …``."""
    acc = stacked[0]
    for w in range(1, stacked.shape[0]):
        acc = acc + stacked[w]
    return acc


def worker_mean(stacked: torch.Tensor) -> torch.Tensor:
    """Mean over the leading worker axis: :func:`worker_sum` over W."""
    return exact_div(worker_sum(stacked), stacked.shape[0])


def _select_by_priority_stacked(
    stacked: torch.Tensor, priority: torch.Tensor
) -> torch.Tensor:
    """Per key, the row of the worker with the highest priority (the lowest
    worker id among ties).  ``stacked``: (W, N, k); ``priority``: (W, N)
    -> (N, k)."""
    winner = torch.argmax(priority, dim=0)                      # (N,)
    index = winner[None, :, None].expand(1, *stacked.shape[1:])
    return stacked.gather(0, index)[0]


def merge_average_all_stacked(stacked: torch.Tensor) -> torch.Tensor:
    return worker_mean(stacked)


def merge_average_stacked(
    stacked: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """Touch-count-weighted mean; keys untouched everywhere keep the plain
    mean (all copies are identical there, so it is the anchor value)."""
    w = counts[..., None]                                       # (W, N, 1)
    total = worker_sum(w)
    weighted = worker_sum(stacked * w)
    plain = worker_mean(stacked)
    return torch.where(total > 0, weighted / torch.clamp_min(total, 1.0),
                       plain)


def random_priorities(
    generator: torch.Generator, W: int, N: int, device=None
) -> torch.Tensor:
    """Per-worker uniform priorities ``(W, N)`` for the ``random``
    strategy, drawn on the CPU from ``generator`` (the reference draws
    them from worker-folded ``jax.random`` keys; tests pass those in)."""
    return torch.rand((W, N), generator=generator).to(device)


def merge_random_stacked(
    stacked: torch.Tensor, counts: torch.Tensor, priorities: torch.Tensor
) -> torch.Tensor:
    """Per key, a uniform choice among the workers that touched it: the
    toucher with the highest priority wins."""
    touched = counts > 0
    priority = torch.where(touched, priorities, -_BIG)
    # no toucher anywhere -> all copies identical; any worker will do
    priority = torch.where(touched.any(0)[None, :], priority, priorities)
    return _select_by_priority_stacked(stacked, priority)


def merge_miniloss_perkey_stacked(
    stacked: torch.Tensor, counts: torch.Tensor, losses: torch.Tensor
) -> torch.Tensor:
    """Per key: the worker with the smallest mean per-touch loss wins."""
    mean_loss = torch.where(counts > 0,
                            losses / torch.clamp_min(counts, 1.0), _BIG)
    return _select_by_priority_stacked(stacked, -mean_loss)


def merge_miniloss_global_stacked(
    stacked: torch.Tensor, worker_loss: torch.Tensor
) -> torch.Tensor:
    """The single worker with the smallest epoch loss wins every key (an
    index kernel, not a host read of the winner)."""
    return stacked.index_select(0, torch.argmin(worker_loss).reshape(1))[0]


def merge_stacked(
    strategy: str,
    stacked: torch.Tensor,
    counts: torch.Tensor,
    losses: Optional[torch.Tensor],
    worker_loss: torch.Tensor,
    priorities: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reduce one ``(W, N, k)`` table to ``(N, k)`` with ``strategy``;
    ``random`` needs ``priorities`` (:func:`random_priorities`),
    ``miniloss_perkey`` the per-key ``losses`` (no other strategy reads
    them)."""
    if strategy == "average":
        return merge_average_stacked(stacked, counts)
    if strategy == "average_all":
        return merge_average_all_stacked(stacked)
    if strategy == "random":
        if priorities is None:
            raise ValueError("'random' strategy needs priorities")
        return merge_random_stacked(stacked, counts, priorities)
    if strategy == "miniloss_perkey":
        if losses is None:
            raise ValueError("'miniloss_perkey' strategy needs losses")
        return merge_miniloss_perkey_stacked(stacked, counts, losses)
    if strategy == "miniloss_global":
        return merge_miniloss_global_stacked(stacked, worker_loss)
    raise ValueError(f"unknown strategy {strategy!r}; want one of {STRATEGIES}")


# ---------------------------------------------------------------------------
# Collective path: this rank's (W/M, N, k) block over the mesh's ranks
# ---------------------------------------------------------------------------

def _select_by_priority_collective(
    local: torch.Tensor, priority: torch.Tensor, mesh, lo: int, W: int
) -> torch.Tensor:
    """Winner-take-all across ranks with O(N) + O(N·k) all-reduces instead
    of an O(W·N·k) all-gather: (1) each rank's best priority per key and
    its first worker reaching it; (2) the max over ranks (an operand
    returned exactly, so the equality test is well defined); (3) among
    workers at the best priority the lowest global id wins (the stacked
    ``argmax``'s tie-break); (4) one all-reduce sum of the winner's rows,
    every other rank adding ``+0.0``."""
    win = torch.argmax(priority, dim=0)                          # (N,)
    mine = priority.gather(0, win[None])[0]
    best = par.all_reduce(mine, mesh, "max")
    claim = torch.where(mine == best, win + lo, W)
    winner = par.all_reduce(claim, mesh, "min")
    rows = _select_by_priority_stacked(local, priority)
    keep = (claim == winner)[:, None]
    return par.all_reduce(torch.where(keep, rows, torch.zeros_like(rows)),
                          mesh, "sum")


def merge_collective(
    strategy: str,
    local: torch.Tensor,                  # (W/M, N, k) this rank's workers
    counts: torch.Tensor,                 # (W/M, N)
    losses: Optional[torch.Tensor],       # (W/M, N)
    worker_loss: torch.Tensor,            # (W/M,)
    mesh,
    priorities: Optional[torch.Tensor] = None,   # (W/M, N) this rank's
    *,
    n_workers: int,
    lo: int,
) -> torch.Tensor:
    """The ``psum`` Reduce (``reduce_impl="psum"``): each rank first sums
    its own workers in worker order (:func:`worker_sum`), then one
    all-reduce adds the ranks' partial sums in the backend's order; the
    selection strategies pick their winner by all-reduced max / min
    (:func:`_select_by_priority_collective`).  ``lo`` is the global id of
    this rank's first worker.

    At M = 1 every sum is the stacked merge's and the all-reduce returns
    its operand, so the result is :func:`merge_stacked`'s bits; at M > 1
    the averages add in another order and agree within the reference's
    tolerance (rtol 1e-4, atol 1e-5), and a selected ``-0.0`` comes back
    ``+0.0``."""
    if strategy == "average_all":
        return exact_div(par.all_reduce(worker_sum(local), mesh), n_workers)
    if strategy == "average":
        w = counts[..., None]
        total = par.all_reduce(worker_sum(w), mesh)
        weighted = par.all_reduce(worker_sum(local * w), mesh)
        plain = exact_div(par.all_reduce(worker_sum(local), mesh), n_workers)
        return torch.where(total > 0,
                           weighted / torch.clamp_min(total, 1.0), plain)
    if strategy == "random":
        if priorities is None:
            raise ValueError("'random' strategy needs priorities")
        touched = counts > 0
        any_touch = par.all_reduce(touched.any(0).to(torch.int32), mesh,
                                   "max") > 0
        pri = torch.where(touched, priorities, -_BIG)
        pri = torch.where(any_touch[None, :], pri, priorities)
    elif strategy == "miniloss_perkey":
        if losses is None:
            raise ValueError("'miniloss_perkey' strategy needs losses")
        pri = -torch.where(counts > 0,
                           losses / torch.clamp_min(counts, 1.0), _BIG)
    elif strategy == "miniloss_global":
        pri = (-worker_loss)[:, None].expand(counts.shape)
    else:
        raise ValueError(
            f"unknown strategy {strategy!r}; want one of {STRATEGIES}")
    return _select_by_priority_collective(local, pri, mesh, lo, n_workers)


def merge_allgather(
    strategy: str,
    local: torch.Tensor,                  # (W/M, N, k)
    counts: torch.Tensor,                 # (W/M, N)
    losses: Optional[torch.Tensor],       # (W/M, N)
    worker_loss: torch.Tensor,            # (W/M,)
    mesh,
    priorities: Optional[torch.Tensor] = None,   # (W, N) every worker's
) -> torch.Tensor:
    """The paper-literal Reduce (``reduce_impl="allgather"``): all-gather
    the ranks' ``(W/M, N, k)`` copies and stats into the full ``(W, ...)``
    stacks, in rank order, then :func:`merge_stacked` — the vmap Reduce's
    bits, at O(W·N·k) collective bytes."""
    gather = lambda x: None if x is None else par.all_gather(x, mesh)
    return merge_stacked(strategy, gather(local), gather(counts),
                         gather(losses), gather(worker_loss), priorities)


# ---------------------------------------------------------------------------
# Sparse delta transport (merge_transport="sparse") — see module docstring
# ---------------------------------------------------------------------------

def sized_unique(ids: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The sorted distinct values of ``ids`` along its last axis, in a
    buffer of static length ``size`` padded with ``fill`` (``jnp.unique(...,
    size=, fill_value=)``, batched over leading axes), with no host sync:
    sort, mark each run's first element, take its slot from a cumulative
    sum, scatter into the prefilled buffer.  Elements past ``size``
    distinct values and the repeats of a run all go to one dump slot past
    the end, which is cut off."""
    s = torch.sort(ids, dim=-1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    slot = torch.cumsum(first, -1) - 1
    slot = torch.where(first & (slot < size), slot, size)
    out = torch.full(ids.shape[:-1] + (size + 1,), fill, dtype=ids.dtype,
                     device=ids.device)
    return out.scatter_(-1, slot, s)[..., :size].contiguous()


def take_fill(x: torch.Tensor, ids: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` gathered along ``dim`` at ``ids``, with zeros where an id is
    ``x.shape[dim]`` or more (``jnp.take(..., mode="fill",
    fill_value=0)``).  ``ids`` is one ``(U,)`` vector for every index of
    the leading axes, or shaped ``x.shape[:dim] + (U,)``: each leading
    index its own ids (a worker's rows of a stacked table)."""
    n = x.shape[dim]
    safe = ids.long().clamp(max=n - 1)
    tail = (1,) * (x.dim() - dim - 1)
    if ids.dim() == 1:
        out = x.index_select(dim, safe)
        valid = (ids < n).reshape((1,) * dim + ids.shape + tail)
    else:
        index = safe.reshape(safe.shape + tail).expand(
            safe.shape + x.shape[dim + 1:])
        out = x.gather(dim, index)
        valid = (ids < n).reshape(ids.shape + tail)
    return torch.where(valid, out, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def take_mask(mask: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The ``(N,)`` bool ``mask`` gathered at ``ids`` (any shape), False
    where an id is ``N`` or more (``jnp.take(..., mode="fill",
    fill_value=False)``), with no host sync."""
    n = mask.shape[0]
    got = mask.index_select(0, ids.reshape(-1).long().clamp(max=n - 1))
    return got.reshape(ids.shape) & (ids < n)


def put_drop_(x: torch.Tensor, ids: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """In place, ``x[ids[i]] = rows[i]`` for every id below ``n_rows =
    x.shape[ids.dim() - 1]``; pad ids (``n_rows`` and up) write nothing
    (``.at[ids].set(rows, mode="drop")``).  ``x`` is ``(N, k)`` with ids
    ``(U,)``, or stacked ``(W, N, k)`` with each worker's ids ``(W, U)``;
    the ids are distinct and sorted, pads last.

    Without a host sync and deterministically: a pad is redirected to the
    first id with the first id's row, so it repeats that write with the
    same bytes (or, when every id is a pad, to row 0 with row 0's own
    value).  Returns ``x``."""
    n = x.shape[ids.dim() - 1]
    head = ids[..., :1]
    real = head < n
    cur = x.narrow(ids.dim() - 1, 0, 1)
    pad_id = torch.where(real, head, torch.zeros_like(head))
    pad_row = torch.where(real[..., None], rows[..., :1, :], cur)
    pad = ids >= n
    tgt = torch.where(pad, pad_id, ids)
    vals = torch.where(pad[..., None], pad_row, rows)
    flat = x.view(-1, x.shape[-1])
    if ids.dim() == 2:
        tgt = tgt + torch.arange(ids.shape[0], device=ids.device)[:, None] * n
    flat.index_copy_(0, tgt.reshape(-1).long(),
                     vals.reshape(-1, x.shape[-1]))
    return x


def touched_capacity(
    n_rows: int, batch_size: int, steps_per_epoch: int, merge_every: int,
    role: str,
) -> int:
    """Static per-worker delta-buffer capacity for one Reduce round: one
    SGD step touches at most ``4 * batch_size`` entity rows (positive and
    corrupted heads and tails) and ``batch_size`` relation rows (a
    corruption keeps the relation), so ``f·B·S·K`` bounds a round of K
    local epochs of S steps; never more than the table."""
    per_step = (4 if role == "ent" else 1) * batch_size
    return int(min(n_rows, per_step * steps_per_epoch * merge_every))


def pack_delta(
    table: torch.Tensor, count: torch.Tensor, loss: Optional[torch.Tensor],
    capacity: int, n_rows: int,
) -> tuple:
    """Each worker's padded delta buffer: the rows its touch stats mark
    updated.  ``table`` ``(W, N, k)``, ``count`` / ``loss`` ``(W, N)``
    (``loss`` may be ``None``: only ``miniloss_perkey`` reads it).
    Returns ``(idx, vals, cnt, lss)``: ``idx`` ``(W, capacity)`` the
    sorted touched row ids padded with ``n_rows``, the others their
    ``(W, capacity, k)`` / ``(W, capacity)`` gathers, zero at pads.

    A cumulative sum gives each touched row its slot and one scatter puts
    the row ids there (untouched rows, and touched rows past
    ``capacity``, into a dump slot past the end): one linear pass, the
    same ascending ids as a sized ``nonzero`` without its host sync."""
    mask = count > 0
    slot = torch.cumsum(mask, -1) - 1
    slot = torch.where(mask & (slot < capacity), slot, capacity)
    rows = torch.arange(n_rows, device=count.device).expand(mask.shape)
    idx = torch.full(mask.shape[:-1] + (capacity + 1,), n_rows,
                     dtype=torch.int64, device=count.device)
    idx = idx.scatter_(-1, slot, rows)[..., :capacity].contiguous()
    d = idx.dim() - 1
    return (idx, take_fill(table, idx, d), take_fill(count, idx, d),
            None if loss is None else take_fill(loss, idx, d))


def delta_overflow(count: torch.Tensor, capacity: int) -> torch.Tensor:
    """How many touched rows :func:`pack_delta` would drop this round:
    ``max(touched - capacity, 0)``, maxed over the worker axis, an int64
    device scalar.  Zero under the analytic :func:`touched_capacity`
    bound; the training drivers raise on a positive value."""
    touched = (count > 0).sum(-1)
    return torch.clamp_min(touched - capacity, 0).max()


def sparse_candidates(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The union of every worker's touched row ids: ``idx`` is the stacked
    ``(W, C)`` id vectors; returns the sorted distinct ids in a vector of
    static size ``min(n_rows, W·C) + 1`` padded with ``n_rows`` (the +1
    slot takes the pad id itself when a buffer is underfull)."""
    W, C = idx.shape
    return sized_unique(idx.reshape(-1), int(min(n_rows, W * C)) + 1,
                        n_rows)


def _found(idx: torch.Tensor, cand: torch.Tensor, n_rows: int) -> tuple:
    """Per worker, where each candidate sits in its sorted ``idx`` (``(W,
    C)``) and whether it is there: ``(pos (W, U), found (W, U))``."""
    C = idx.shape[-1]
    query = cand.expand(idx.shape[:-1] + cand.shape).contiguous()
    pos = torch.searchsorted(idx, query.to(idx.dtype)).clamp(0, C - 1)
    return pos, (idx.gather(-1, pos) == cand) & (cand < n_rows)


def _at(vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``vals`` ``(W, C, k)`` gathered at ``pos`` ``(W, U)``."""
    return vals.gather(-2, pos[..., None].expand(pos.shape + vals.shape[-1:]))


def lookup_rows(
    idx: torch.Tensor, vals: torch.Tensor, cand: torch.Tensor,
    virgin: torch.Tensor, n_rows: int,
) -> torch.Tensor:
    """Each worker's rows at the candidate ids, ``(W, U, k)``: its packed
    value where ``cand`` is in its sorted ``idx``, the shared ``virgin``
    row ``(U, k)`` otherwise."""
    pos, found = _found(idx, cand, n_rows)
    return torch.where(found[..., None], _at(vals, pos), virgin)


def lookup_delta(
    idx: torch.Tensor, vals: torch.Tensor, cnt: torch.Tensor,
    lss: Optional[torch.Tensor], cand: torch.Tensor, virgin: torch.Tensor,
    n_rows: int,
) -> tuple:
    """Each worker's table slice and touch stats at the candidate rows,
    ``(W, U, k)`` and ``(W, U)``: packed values where the worker touched
    the row, the shared ``virgin`` value and zero count and loss (as the
    dense stats hold) where it did not.  ``idx`` sorted, as
    :func:`pack_delta` gives it; ``lss`` may be ``None``."""
    pos, found = _found(idx, cand, n_rows)
    zero = torch.zeros((), dtype=cnt.dtype, device=cnt.device)
    val = torch.where(found[..., None], _at(vals, pos), virgin)
    c = torch.where(found, cnt.gather(-1, pos), zero)
    l = None if lss is None else torch.where(found, lss.gather(-1, pos),
                                             zero)
    return val, c, l


def virgin_rows(rows: torch.Tensor, normalize_row_fn: Callable,
                repeats: int) -> torch.Tensor:
    """The value every worker's copy of a row it did *not* touch holds at
    Reduce time: ``repeats`` chained applications of the model's row-local
    projection to the round-input row (repeats = epochs merged for
    ``normalize="epoch"``, steps merged for ``"step"``, 0 for
    ``"none"``).  Each application is the projection's own operations on
    the rows, so the chain gives the dense copies' bits."""
    for _ in range(repeats):
        rows = normalize_row_fn(rows)
    return rows


def sparse_untouched_base(strategy: str, local: torch.Tensor,
                          W: int) -> torch.Tensor:
    """The merged value of rows *no* worker touched, from one worker's
    copy (all copies agree there).  A selection strategy picks one of the
    identical copies: the copy itself.  The averaging strategies replay
    the dense :func:`worker_mean` on W views of the copy, for every W: the
    in-order sum ``((x + x) + x) + …`` divided by W is ``x`` for W = 1, 2
    and 4, but not for 3, nor for 8 (about 47 % of float32 values come
    back one ulp off), so only the replay gives the dense bits."""
    if strategy not in ("average", "average_all"):
        return local
    return worker_mean(local.expand((W,) + local.shape))


def merge_candidates(
    strategy: str,
    cand: torch.Tensor,                   # (U,) sorted ids, pads n_rows
    svals: torch.Tensor,                  # (W, U, k) rows per worker
    scnt: torch.Tensor,                   # (W, U)
    sloss: Optional[torch.Tensor],        # (W, U)
    worker_loss: torch.Tensor,            # (W,)
    n_rows: int,
    priorities: Optional[torch.Tensor] = None,   # (W, n_rows)
) -> torch.Tensor:
    """:func:`merge_stacked` on the candidate rows: the dense formulas run
    on the ``(W, U, k)`` slices, and every one of them is per row (sums in
    worker order, ``exact_div``, ``clamp_min``, argmax over the worker
    axis), so the result is the dense output's candidate rows, bitwise.
    ``random`` takes its full ``(W, n_rows)`` priorities and gathers the
    candidate columns (zero at pads)."""
    if priorities is not None:
        priorities = take_fill(priorities, cand, 1)
    return merge_stacked(strategy, svals, scnt, sloss, worker_loss,
                         priorities)


def apply_delta(base: torch.Tensor, cand: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """A copy of ``base`` with the merged candidate rows scattered in; pad
    candidates (id ``n_rows``) drop out."""
    return put_drop_(base.clone(), cand, rows)


def merge_sparse_stacked(
    strategy: str,
    idx: torch.Tensor,                    # (W, C) packed row ids
    vals: torch.Tensor,                   # (W, C, k)
    cnts: torch.Tensor,                   # (W, C)
    losses: Optional[torch.Tensor],       # (W, C)
    worker_loss: torch.Tensor,            # (W,)
    local: torch.Tensor,                  # (N, k) any one worker's table
    base: torch.Tensor,                   # (N, k) the round-input table
    normalize_row_fn: Callable,
    repeats: int,
    priorities: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Merge the W workers' packed delta buffers into the full table,
    bit-identical to :func:`merge_stacked` on the dense copies.  ``local``
    gives the untouched rows (any worker's copy: they agree there);
    ``base``, ``normalize_row_fn`` and ``repeats`` rebuild what a
    candidate row a worker did not touch evolved into
    (:func:`virgin_rows`)."""
    W = idx.shape[0]
    n_rows = base.shape[0]
    cand = sparse_candidates(idx, n_rows)
    virgin = virgin_rows(take_fill(base, cand, 0), normalize_row_fn, repeats)
    svals, scnt, sloss = lookup_delta(idx, vals, cnts, losses, cand, virgin,
                                      n_rows)
    rows = merge_candidates(strategy, cand, svals, scnt, sloss, worker_loss,
                            n_rows, priorities)
    return apply_delta(sparse_untouched_base(strategy, local, W), cand, rows)


# ---------------------------------------------------------------------------
# Sharded tables: shard-routed merge (table_sharding="sharded")
# ---------------------------------------------------------------------------

def shard_rows(n_rows: int, n_shards: int) -> int:
    """The row-block size of a shard: shard ``s`` owns rows ``[s·R,
    min((s+1)·R, n_rows))`` with ``R = ceil(n_rows / n_shards)``.  Every
    table is cut by this rule, so a row's owner is a pure function of its
    id."""
    return -(-n_rows // n_shards)


def own_candidates(cand: torch.Tensor, lo: int, block: int,
                   n_rows: int) -> torch.Tensor:
    """One shard's slice of the candidate union: the (still sorted) ids in
    ``[lo, lo + block)``, compacted into a static ``min(block, U-1) + 1``
    buffer padded with ``n_rows``, by a cumulative sum and a scatter (no
    host sync).  A shard owns at most ``block`` real rows and ``cand``
    holds at most ``U - 1`` real ids, so the buffer never overflows."""
    U = cand.shape[0]
    cap = int(min(block, U - 1)) + 1
    mask = (cand >= lo) & (cand < lo + block) & (cand < n_rows)
    slot = torch.where(mask, torch.cumsum(mask, 0) - 1, cap)
    out = torch.full((cap + 1,), n_rows, dtype=cand.dtype,
                     device=cand.device)
    return out.scatter_(0, slot, cand)[:cap].contiguous()


def _merge_own_block(
    strategy, idx, vals, cnts, losses, worker_loss, base, normalize_row_fn,
    repeats, lo, block, cand, priorities,
) -> tuple:
    """``(own, rows)``: the candidates shard ``[lo, lo + block)`` owns and
    their merged rows, each computed exactly as
    :func:`merge_sparse_stacked` computes that row (``random`` gathers the
    owned columns of the same full priorities)."""
    n_rows = base.shape[0]
    own = own_candidates(cand, lo, block, n_rows)
    virgin = virgin_rows(take_fill(base, own, 0), normalize_row_fn, repeats)
    svals, scnt, sloss = lookup_delta(idx, vals, cnts, losses, own, virgin,
                                      n_rows)
    return own, merge_candidates(strategy, own, svals, scnt, sloss,
                                 worker_loss, n_rows, priorities)


def scatter_blocks(out: torch.Tensor, blocks: list) -> torch.Tensor:
    """``out`` with every shard's ``(own, rows)`` scattered in, pads
    dropped, in one :func:`put_drop_`: the owned id sets are disjoint, and
    a pad rewrites the first id with its own row (or row 0 with itself
    when shard 0 owns nothing, since then no shard owns row 0)."""
    owns = torch.cat([own for own, _ in blocks])
    rows = torch.cat([r for _, r in blocks])
    return put_drop_(out, owns, rows)


def own_blocks_collective(block_fn, n_workers: int, mesh) -> tuple:
    """``(owns, rows)`` of every shard, in shard order, on every rank:
    this rank merges the blocks of its workers ``[lo, hi)`` in worker
    order (``block_fn(s)`` gives shard ``s``'s ``(own, rows)``), and the
    concatenated blocks are all-gathered in rank order, the ranks' bytes
    exactly.  At M = W each rank merges one block, as in the
    reference."""
    lo, hi = par.local_workers(mesh, n_workers)
    blocks = [block_fn(s) for s in range(lo, hi)]
    owns = torch.cat([own for own, _ in blocks])
    rows = torch.cat([r for _, r in blocks])
    return par.all_gather(owns, mesh), par.all_gather(rows, mesh)


def merge_sparse_sharded_stacked(
    strategy: str,
    idx: torch.Tensor,                    # (W, C) packed row ids
    vals: torch.Tensor,                   # (W, C, k)
    cnts: torch.Tensor,                   # (W, C)
    losses: Optional[torch.Tensor],       # (W, C)
    worker_loss: torch.Tensor,            # (W,)
    local: torch.Tensor,                  # (N, k) any one worker's table
    base: torch.Tensor,                   # (N, k) the round-input table
    normalize_row_fn: Callable,
    repeats: int,
    priorities: Optional[torch.Tensor] = None,
    *,
    n_shards: int,
) -> torch.Tensor:
    """Shard-routed :func:`merge_sparse_stacked`: the candidate union is
    cut into ``n_shards`` contiguous row blocks and each block is merged
    on its own, one shard after another — bit-identical to the monolithic
    merge, since the blocks partition the union and every strategy is per
    row."""
    W = idx.shape[0]
    n_rows = base.shape[0]
    R = shard_rows(n_rows, n_shards)
    cand = sparse_candidates(idx, n_rows)
    blocks = [_merge_own_block(strategy, idx, vals, cnts, losses,
                               worker_loss, base, normalize_row_fn, repeats,
                               s * R, R, cand, priorities)
              for s in range(n_shards)]
    return scatter_blocks(
        sparse_untouched_base(strategy, local, W).clone(), blocks)


# ---------------------------------------------------------------------------
# Bounded staleness: participation-masked merges (staleness > 0)
# ---------------------------------------------------------------------------

def merge_candidates_stale(
    strategy: str,
    cand: torch.Tensor,                   # (U,) sorted ids, pads n_rows
    svals: torch.Tensor,                  # (W, U, k) worker rows
    scnt: torch.Tensor,                   # (W, U) this-round touch counts
    sloss: Optional[torch.Tensor],        # (W, U)
    worker_loss: torch.Tensor,            # (W,)
    bcand: torch.Tensor,                  # (U, k) the global view there
    n_rows: int,
    priorities: Optional[torch.Tensor] = None,   # (W, n_rows)
) -> torch.Tensor:
    """The bounded-staleness Reduce of the candidate rows: per row only
    the workers whose round touched it take part (a non-toucher holds an
    arbitrary stale value, not a shared round input), under every
    strategy, and a row nobody touched keeps the global view ``bcand``
    exactly.  ``average_all`` averages the touchers; ``random`` gives
    non-touchers priority ``-1e30``; ``miniloss_global`` lets the best
    *toucher* of each row win.  Per row over the worker axis (sums in
    worker order), so the dense and the packed forms give the same
    bits."""
    touched = scnt > 0
    any_touch = touched.any(0)                                  # (U,)
    if strategy in ("average", "average_all"):
        w = (scnt if strategy == "average"
             else touched.to(svals.dtype))[..., None]
        merged = worker_sum(svals * w) / torch.clamp_min(worker_sum(w), 1.0)
    elif strategy == "random":
        if priorities is None:
            raise ValueError("'random' strategy needs priorities")
        u = take_fill(priorities, cand, 1)
        merged = _select_by_priority_stacked(
            svals, torch.where(touched, u, -_BIG))
    elif strategy == "miniloss_perkey":
        if sloss is None:
            raise ValueError("'miniloss_perkey' strategy needs losses")
        mean_loss = torch.where(touched, sloss / torch.clamp_min(scnt, 1.0),
                                _BIG)
        merged = _select_by_priority_stacked(svals, -mean_loss)
    elif strategy == "miniloss_global":
        merged = _select_by_priority_stacked(
            svals, torch.where(touched, -worker_loss[:, None], -_BIG))
    else:
        raise ValueError(
            f"unknown strategy {strategy!r}; want one of {STRATEGIES}")
    return torch.where(any_touch[:, None], merged, bcand)


def merge_stacked_stale(
    strategy: str,
    stacked: torch.Tensor,                # (W, N, k) copies after the round
    counts: torch.Tensor,                 # (W, N) this-round touch counts
    losses: Optional[torch.Tensor],       # (W, N)
    worker_loss: torch.Tensor,            # (W,)
    base: torch.Tensor,                   # (N, k) the global view
    priorities: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The dense bounded-staleness Reduce: :func:`merge_candidates_stale`
    over every row of the table."""
    N = counts.shape[1]
    cand = torch.arange(N, device=counts.device)
    return merge_candidates_stale(strategy, cand, stacked, counts, losses,
                                  worker_loss, base, N, priorities)


def _stale_block(strategy, idx, vals, cnts, losses, worker_loss, base,
                 cand, priorities) -> torch.Tensor:
    """The stale merge of the rows ``cand``: no virgin rows are rebuilt,
    because a worker that did not touch a row has count 0 there and takes
    no part (its zero placeholder never counts)."""
    n_rows = base.shape[0]
    placeholder = torch.zeros((), dtype=base.dtype, device=base.device)
    svals, scnt, sloss = lookup_delta(idx, vals, cnts, losses, cand,
                                      placeholder, n_rows)
    return merge_candidates_stale(strategy, cand, svals, scnt, sloss,
                                  worker_loss, take_fill(base, cand, 0),
                                  n_rows, priorities)


def merge_sparse_stale(
    strategy: str,
    idx: torch.Tensor,                    # (W, C) packed row ids
    vals: torch.Tensor,                   # (W, C, k)
    cnts: torch.Tensor,                   # (W, C)
    losses: Optional[torch.Tensor],       # (W, C)
    worker_loss: torch.Tensor,            # (W,)
    base: torch.Tensor,                   # (N, k) the global view
    priorities: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The sparse-transport bounded-staleness Reduce: the union of the
    workers' touched rows merged into the global view, bit-identical to
    :func:`merge_stacked_stale` on the dense copies."""
    cand = sparse_candidates(idx, base.shape[0])
    rows = _stale_block(strategy, idx, vals, cnts, losses, worker_loss,
                        base, cand, priorities)
    return apply_delta(base, cand, rows)


def _merge_own_block_stale(strategy, idx, vals, cnts, losses, worker_loss,
                           base, lo, block, cand, priorities) -> tuple:
    """``(own, rows)`` of one shard's block under the stale merge."""
    own = own_candidates(cand, lo, block, base.shape[0])
    return own, _stale_block(strategy, idx, vals, cnts, losses, worker_loss,
                             base, own, priorities)


def merge_sparse_stale_sharded_stacked(
    strategy: str,
    idx: torch.Tensor,
    vals: torch.Tensor,
    cnts: torch.Tensor,
    losses: Optional[torch.Tensor],
    worker_loss: torch.Tensor,
    base: torch.Tensor,
    priorities: Optional[torch.Tensor] = None,
    *,
    n_shards: int,
) -> torch.Tensor:
    """Shard-routed :func:`merge_sparse_stale`: each shard stale-merges
    the candidates it owns, one shard after another — bit-identical to
    the monolithic stale merge."""
    n_rows = base.shape[0]
    R = shard_rows(n_rows, n_shards)
    cand = sparse_candidates(idx, n_rows)
    blocks = [_merge_own_block_stale(strategy, idx, vals, cnts, losses,
                                     worker_loss, base, s * R, R, cand,
                                     priorities)
              for s in range(n_shards)]
    return scatter_blocks(base.clone(), blocks)


def merge_sparse_sharded_collective(
    strategy: str,
    idx: torch.Tensor,                    # (W, C) all-gathered packed ids
    vals: torch.Tensor,                   # (W, C, k)
    cnts: torch.Tensor,                   # (W, C)
    losses: Optional[torch.Tensor],       # (W, C)
    worker_loss: torch.Tensor,            # (W,)
    local: torch.Tensor,                  # (N, k) any one worker's table
    base: torch.Tensor,                   # (N, k) the round-input table
    normalize_row_fn: Callable,
    repeats: int,
    priorities: Optional[torch.Tensor] = None,
    *,
    mesh,
) -> torch.Tensor:
    """The shard-routed merge over a mesh (port of the reference's
    ``merge_sparse_sharded_collective``): the packed buffers are already
    all-gathered, each rank merges only the candidate blocks its workers
    own (``lo = s · R`` for its shards ``s``), the merged blocks are
    all-gathered — O(W·cap·k) bytes, never a whole table — and every rank
    scatters them into the untouched rows' value.  The result is
    :func:`merge_sparse_sharded_stacked`'s bits on every rank."""
    W = idx.shape[0]
    n_rows = base.shape[0]
    R = shard_rows(n_rows, W)
    cand = sparse_candidates(idx, n_rows)
    owns, rows = own_blocks_collective(
        lambda s: _merge_own_block(strategy, idx, vals, cnts, losses,
                                   worker_loss, base, normalize_row_fn,
                                   repeats, s * R, R, cand, priorities),
        W, mesh)
    return put_drop_(sparse_untouched_base(strategy, local, W).clone(), owns,
                     rows)


def merge_sparse_stale_collective(
    strategy: str,
    idx: torch.Tensor,                    # (W, C) all-gathered packed ids
    vals: torch.Tensor,
    cnts: torch.Tensor,
    losses: Optional[torch.Tensor],
    worker_loss: torch.Tensor,
    base: torch.Tensor,                   # (N, k) the global view
    priorities: Optional[torch.Tensor] = None,
    *,
    mesh,
    sharded: bool = False,
) -> torch.Tensor:
    """The bounded-staleness Reduce over a mesh (port of the reference's
    ``merge_sparse_stale_collective``): on the all-gathered packed
    buffers every rank replays :func:`merge_sparse_stale`, or, with
    ``sharded=True``, merges only its workers' candidate blocks and
    all-gathers the merged blocks, as
    :func:`merge_sparse_sharded_collective` does.  The vmap forms' bits
    either way."""
    if not sharded:
        return merge_sparse_stale(strategy, idx, vals, cnts, losses,
                                  worker_loss, base, priorities)
    W = idx.shape[0]
    n_rows = base.shape[0]
    R = shard_rows(n_rows, W)
    cand = sparse_candidates(idx, n_rows)
    owns, rows = own_blocks_collective(
        lambda s: _merge_own_block_stale(strategy, idx, vals, cnts, losses,
                                         worker_loss, base, s * R, R, cand,
                                         priorities),
        W, mesh)
    return put_drop_(base.clone(), owns, rows)
