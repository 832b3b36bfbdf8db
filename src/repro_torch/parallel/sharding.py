"""Where the KG engine's tables rest over a ``shard_map`` mesh (port of the
KG half of ``repro.parallel.sharding``: ``KGPartitions``,
``kg_partitions`` and ``kg_table_shardings``).

In JAX these name ``PartitionSpec``s that XLA lays out; in PyTorch every
rank is a process holding its own tensors, so the same rules say which
rows of which table a rank keeps between the device pipeline's blocks.
Rank ``r`` of M holds the ``W / M`` workers ``[lo, hi)``
(``parallel/util.local_workers``), and worker ``w`` owns the row block
``[w·R, (w+1)·R)`` of an entity-role table, ``R = merge.shard_rows(N,
W)``, the rule by which the sharded Reduce routes rows
(``core/merge.py``).  Under ``table_sharding="sharded"`` an entity-role
table whose row count divides W rests as the blocks of the rank's own
workers, rows ``[lo·R, hi·R)``; relation-role tables (small, and not
shard-routed) and tables that do not divide stay whole on every rank, as
the reference's ``kg_table_shardings`` replicates them.  The layout
changes no bit of the training: a block all-gathers the resting blocks
into whole tables before its Map runs.

The LM half of the reference's file is ROADMAP.md item 16f.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.parallel import util as par

ROW, WHOLE = "row", "whole"


@dataclasses.dataclass(frozen=True)
class KGPartitions:
    """The layout of the KG engine's tables under one ``table_sharding``
    profile: every embedding table ``(N, k)`` takes ``table`` on its row
    axis (``"row"``: cut into the workers' row blocks, ``"whole"``: kept
    whole).  The partitioned triplets ``(W, N_w, 3)`` are always split on
    the worker axis (each rank holds its workers' rows)."""

    table: str


def kg_partitions(table_sharding: str) -> KGPartitions:
    """The profile of the ``table_sharding`` knob: ``"replicated"`` keeps
    every table whole on every rank; ``"sharded"`` rests the tables in
    the row blocks of the rank's workers, the blocks the sharded Reduce
    assigns them, so the rank that merges a block stores it.  Which
    tables the ``table`` rule reaches is :func:`kg_table_shardings`'s
    choice."""
    if table_sharding == "sharded":
        return KGPartitions(table=ROW)
    if table_sharding == "replicated":
        return KGPartitions(table=WHOLE)
    raise ValueError(
        f"bad table_sharding {table_sharding!r}; "
        "want 'replicated' or 'sharded'")


def kg_table_shardings(roles: Dict[str, str], n_rows: Dict[str, int],
                       n_workers: int,
                       table_sharding: str) -> Dict[str, str]:
    """``{name: "row" | "whole"}`` for KG tables of ``n_rows[name]`` rows:
    under ``"sharded"`` only entity-role tables whose row count divides
    ``n_workers`` rest in row blocks; relation-role tables and tables
    that do not divide stay whole (the reference's ``assign``)."""
    row = kg_partitions(table_sharding).table

    def assign(name, rows) -> str:
        if (row == ROW and roles.get(name) == "ent"
                and rows % n_workers == 0):
            return ROW
        return WHOLE

    return {name: assign(name, rows) for name, rows in n_rows.items()}


def resting_rows(n_rows: int, n_workers: int, mesh) -> tuple:
    """``(lo, hi)``: the rows of a row-blocked table this rank keeps, the
    blocks of its workers."""
    R = n_rows // n_workers
    w_lo, w_hi = par.local_workers(mesh, n_workers)
    return w_lo * R, w_hi * R


def place(params, layout: Dict[str, str], n_workers: int, mesh):
    """The tables as this rank rests them: a ``"row"`` table cut to its
    workers' blocks (a copy, so the whole table's storage can go), a
    ``"whole"`` one as it is."""
    out = {}
    for name, t in params.items():
        if layout[name] == ROW:
            lo, hi = resting_rows(t.shape[0], n_workers, mesh)
            t = t[lo:hi].clone()
        out[name] = t
    return out


def gather(params, layout: Dict[str, str], mesh):
    """Whole tables from every rank's resting ones: a ``"row"`` table's
    blocks all-gathered in rank order (the ranks' bytes exactly), a
    ``"whole"`` one as it is."""
    return {name: par.all_gather(t, mesh) if layout[name] == ROW else t
            for name, t in params.items()}


def resident_bytes(params) -> int:
    """Bytes of the storage behind the tables a rank holds (a view counts
    its whole storage)."""
    return sum(t.untyped_storage().nbytes() for t in params.values())
