"""Device-resident batched evaluation engine (port of
``repro.core.eval_device``, replicated tables).

Each task keeps the test split on the device and walks it in chunks of
``C`` queries; only the final rank vectors return to the host.

  * **Entity inference + relation prediction** — one pass
    (``entity_ranks_device(relations=True)``): per chunk, both entity
    sides are ranked, either from the model's ``(C, E)`` candidate score
    matrix or, when ``fused`` (TransE on CUDA tables by default), through
    the CUDA rank kernel, which never forms that matrix.  Filtering
    gathers the candidate scores at the graph's padded known-candidate
    masks (``KG.eval_filter_candidates``); pad ids (``== E``) read +inf.
    The same chunk also ranks the gold relation among all relations.
  * **Triplet classification** — the four energy vectors (valid/test,
    pos/neg) in one call; the per-relation threshold fit is the host
    engine's (``eval._threshold_accuracy``).

Parity contract: with ``fused=False`` the engine reads gold and candidate
scores out of the same ``candidate_energies`` matrix the host engine
uses, so ranks — and metrics — are identical to ``engine="host"``.  The
fused path takes the gold distance in a second form and may differ where
a candidate lies within an ulp of the gold.

``table_sharding="sharded"`` shards the *candidate* axis over
``n_workers`` shards (:func:`_entity_ranks_sharded`): each shard scores
only its block of entity rows (``candidate_slice_energies``), and the
partial results combine exactly, so ranks are the replicated scan's,
bitwise.  On one device the shards run one after another; over a mesh
each rank scores its workers' blocks for every query, and the parts
combine by all-reduces: a split of compute, not of memory, since every
rank holds the whole (padded) entity table.

Both backends walk the queries through one path
(``parallel/util.worker_map`` over ``shard_chunks``): the queries are
padded to ``W · S`` chunks of the same ``C`` rows and worker ``w`` ranks
chunks ``[w·S, (w+1)·S)`` through the same chunk function (the fused
``rank_counts`` chunk unchanged inside).  On ``backend="shard_map"`` with
``mesh=`` (every rank of the mesh calls the engine) the W workers spread
over the ranks and the ranks' grids are all-gathered in rank order; on
``vmap`` the query axis is one worker (``query_workers``), since the
reference's W-way split of it only pads on one device.  A query's rank
depends on nothing else in its chunk, so every rank returns the vmap
engine's ranks exactly.  The sharded scan over a mesh does not split
the query axis: every rank walks every chunk and meets the others in each
chunk's all-reduces.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import eval as host_eval
from repro_torch.core import merge as merge_lib
from repro_torch.core.models import KGModel, Params, get_model
from repro_torch.parallel import util as par

DEFAULT_CHUNK = 256


# ---------------------------------------------------------------------------
# Layout: pad the query axis and split it into chunks
# ---------------------------------------------------------------------------

def shard_layout(n: int, chunk: int, n_workers: int) -> Tuple[int, int, int]:
    """(S, C, padded_n) for ``n`` queries over ``n_workers`` query workers:
    chunks of ``C`` rows, ``S`` chunks a worker, ``W · S · C >= n`` (the
    reference's layout; ``n_workers=1`` is one worker's walk)."""
    C = max(1, chunk)
    S = max(1, -(-n // (C * n_workers)))
    return S, C, n_workers * S * C


def _pad_rows(arr: np.ndarray, padded_n: int) -> np.ndarray:
    """Pad axis 0 to ``padded_n`` by repeating row 0 (valid ids, scored
    harmlessly, sliced off after the ranks come back)."""
    if len(arr) == padded_n:
        return arr
    reps = np.broadcast_to(arr[:1], (padded_n - len(arr),) + arr.shape[1:])
    return np.concatenate([arr, reps], axis=0)


def shard_chunks(arr: np.ndarray, n_workers: int, chunk: int,
                 n: int) -> np.ndarray:
    """Host ids padded and cut for :func:`shard_layout`: ``(W, S, C,
    ...)`` int64 (each worker moves only its own rows to its device)."""
    S, C, padded = shard_layout(n, chunk, n_workers)
    return np.asarray(_pad_rows(np.asarray(arr), padded), np.int64).reshape(
        (n_workers, S, C) + np.shape(arr)[1:])


def query_workers(n_workers: int, backend: str) -> int:
    """How many workers the query axis is split over: the ``shard_map``
    backend's ``W``, which spreads the chunks over the mesh's ranks; one
    on the ``vmap`` backend, where a split would run the same chunks one
    after another on one device and only add padding."""
    return n_workers if backend == "shard_map" else 1


def query_walk(backend: str, mesh, table_sharding: str) -> tuple:
    """``(backend, mesh)`` the query axis is walked on: the engine's own,
    except that sharded tables split the entity axis over a mesh instead
    of the queries, so every rank walks every query, as on ``vmap``."""
    if table_sharding == "sharded":
        return "vmap", None
    return backend, mesh


def check_layout(table_sharding: str, n_workers: int, backend: str,
                 mesh, device=None) -> None:
    """Validate an engine's layout keywords (the reference's names): a bad
    ``table_sharding``, ``backend`` or ``n_workers`` raises ``ValueError``;
    ``shard_map`` without a mesh raises ``ValueError``; a ``mesh`` that
    is no ``DeviceMesh`` raises ``TypeError``, one of another device type than
    ``device`` or over which ``n_workers`` does not divide ``ValueError``
    (``parallel.util.check_mesh``)."""
    if table_sharding not in ("replicated", "sharded"):
        raise ValueError(
            f"table_sharding must be 'replicated' or 'sharded', got "
            f"{table_sharding!r}")
    if backend not in ("vmap", "shard_map"):
        raise ValueError(f"bad backend {backend!r}")
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if backend == "shard_map" and mesh is None:
        raise ValueError("backend='shard_map' needs a mesh")
    if mesh is not None:
        par.check_mesh(mesh, device,
                       n_workers if backend == "shard_map" else None)


def _pad_ent_tables(model: KGModel, params: Params, padded_E: int) -> Params:
    """Every entity-role table zero-padded to ``padded_E`` rows, so the
    shards' equal row blocks of the sharded scan tile it exactly.  Pad
    rows never count: the rank and top-k scans mask candidates by ``id <
    n_entities``."""
    roles = model.param_roles()
    out = dict(params)
    for name, t in params.items():
        if roles.get(name) == "ent" and t.shape[0] < padded_E:
            out[name] = torch.cat([t, t.new_zeros(
                (padded_E - t.shape[0],) + t.shape[1:])])
    return out


# ---------------------------------------------------------------------------
# Entity inference
# ---------------------------------------------------------------------------

def _entity_chunk(
    model: KGModel,
    params: Params,
    chunk: torch.Tensor,     # (C, 3)
    cands: torch.Tensor,     # (C, P) padded candidate ids (pad id = E)
    side: str,
    norm: str,
    fused: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw, filtered) ranks for one chunk, on the device.

    The filtered rank subtracts known candidates (other than the gold)
    scoring strictly better than the gold — the host engine's predicate,
    evaluated as one gather over the padded mask.  Pad ids read +inf, so
    they never count."""
    E = params["ent"].shape[0]
    gold_ids = chunk[:, 2] if side == "tail" else chunk[:, 0]
    clamped = cands.clamp(max=E - 1)
    if fused:
        raw = 1 + model.fused_rank_counts(params, chunk, side, norm=norm)
        # candidate scores via substituted-triplet energies (the kernel
        # never forms the (C, E) matrix); gold recomputed the same way
        col = 2 if side == "tail" else 0
        subst = chunk[:, None, :].repeat(1, cands.shape[1], 1)
        subst[:, :, col] = clamped
        cvals = model.energy(params, subst, norm)
        gold = model.energy(params, chunk, norm)
    else:
        scores = model.candidate_energies(params, chunk, side, norm)
        gold = scores.gather(1, gold_ids[:, None])[:, 0]
        raw = 1 + (scores < gold[:, None]).sum(dim=1)
        cvals = scores.gather(1, clamped)
    cvals = torch.where(cands >= E, torch.inf, cvals)
    better = (cvals < gold[:, None]) & (cands != gold_ids[:, None])
    filt = raw - better.sum(dim=1)
    # the fused path recomputes distances and can disagree with the raw
    # count in the last ulp; ranks are >= 1 by construction on the exact path
    return raw.int(), filt.clamp(min=1).int()


def _relation_chunk(model: KGModel, params: Params, q: torch.Tensor,
                    norm: str) -> torch.Tensor:
    """Rank of the gold relation of each query among all relations."""
    scores = model.relation_energies(params, q, norm)
    gold = scores.gather(1, q[:, 1:2])
    return (1 + (scores < gold).sum(dim=1)).int()


# ---------------------------------------------------------------------------
# Sharded tables: shard-local candidate scan + exact cross-shard combine
# ---------------------------------------------------------------------------

def _shard_slice_parts(model: KGModel, params: Params, q: torch.Tensor,
                       side: str, norm: str, gold_ids: torch.Tensor,
                       lo: int, n: int) -> tuple:
    """One shard's ``(C, n)`` score slice over candidate rows ``[lo, lo +
    n)`` and its part of the gold score: the owning shard reads it out of
    its slice, every other shard gives +inf, so the min over shards is
    the gold score of the full matrix, bitwise."""
    s = model.candidate_slice_energies(params, q, side, norm, lo=lo, n=n)
    off = gold_ids - lo
    own = (off >= 0) & (off < n)
    gp = s.gather(1, off.clamp(0, n - 1)[:, None])[:, 0]
    return s, torch.where(own, gp, torch.inf)


def _entity_ranks_sharded(
    model: KGModel,
    params: Params,          # entity-role tables padded to n_shards * R
    chunk: torch.Tensor,     # (C, 3)
    cands: torch.Tensor,     # (C, P) padded candidate ids (pad id = E)
    side: str,
    norm: str,
    n_shards: int,
    n_entities: int,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_entity_chunk` with the candidate axis sharded (the
    reference's ``_entity_ranks_sharded``): each of ``n_shards`` shards
    scores only its block of ``R = shard_rows(E, W)`` entity rows, and the
    parts combine exactly —

      * the gold score: the min over the shards' parts (the owner's value;
        every other shard holds +inf), an operand returned bit-exactly;
      * the raw rank: 1 + an *integer* sum of each shard's strictly-better
        count, pad rows masked by ``id < E``;
      * the filtered rank: each known candidate is owned by exactly one
        shard, which checks it against the combined gold; counts summed
        as integers.

    Without a ``mesh`` (vmap) the shards run one after another on one
    device.  Over a mesh every rank holds the same chunk and scores only
    the blocks of its workers ``[lo, hi)``; the min is an all-reduce MIN
    and the counts integer all-reduce sums.  So the ranks are the
    replicated scan's, bitwise, either way; no rank kernel runs here, as
    in the reference."""
    E, W = n_entities, n_shards
    R = merge_lib.shard_rows(E, W)
    lo, hi = (0, W) if mesh is None else par.local_workers(mesh, W)
    gold_ids = chunk[:, 2] if side == "tail" else chunk[:, 0]
    cols = torch.arange(R, device=chunk.device)
    parts = [(s * R,) + _shard_slice_parts(model, params, chunk, side, norm,
                                           gold_ids, s * R, R)
             for s in range(lo, hi)]
    gold = torch.stack([gp for *_, gp in parts]).amin(0)
    if mesh is not None:
        gold = par.all_reduce(gold, mesh, "min")
    raw = 0
    better = 0
    for start, sc, _ in parts:
        raw = raw + ((sc < gold[:, None])
                     & (start + cols < E)[None, :]).sum(1)
        off = cands - start
        inr = (off >= 0) & (off < R) & (cands < E)
        cv = sc.gather(1, off.clamp(0, R - 1))
        better = better + (inr & (cv < gold[:, None])
                           & (cands != gold_ids[:, None])).sum(1)
    if mesh is not None:
        raw, better = par.all_reduce(torch.stack([raw, better]), mesh, "sum")
    raw = 1 + raw
    return raw.int(), (raw - better).clamp(min=1).int()


def entity_ranks_device(
    params: Params,
    test: np.ndarray,
    norm: str = "l1",
    cand_masks: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    *,
    model: "str | KGModel" = "transe",
    chunk: int = DEFAULT_CHUNK,
    n_workers: int = 1,
    backend: str = "vmap",
    mesh=None,
    fused: Optional[bool] = None,
    relations: bool = False,
    table_sharding: str = "replicated",
) -> Dict[str, object]:
    """Per-query entity-inference ranks in test order:
    ``{"raw_ranks": {"tail", "head"}, "filtered_ranks": {...}}`` — the
    arrays ``eval.entity_inference(return_ranks=True)`` produces
    (``filtered_ranks`` only with ``cand_masks``).  ``relations=True``
    also returns ``"relation_ranks"``, computed in the same pass.
    ``fused`` forces the rank kernel on or off (default: on for models
    with a kernel and CUDA tables).

    ``table_sharding="sharded"`` scans the candidate axis in
    ``n_workers`` shards (:func:`_entity_ranks_sharded`; over a mesh
    every rank walks every query),
    with the same ranks bitwise; it takes no rank kernel (``fused=True``
    raises, and ``fused=None`` picks the plain scan), as in the
    reference, whose kernel streams the whole table."""
    model = get_model(model)
    check_layout(table_sharding, n_workers, backend, mesh,
                 params["ent"].device)
    sharded = table_sharding == "sharded"
    if sharded:
        if fused:
            raise ValueError(
                "fused=True is incompatible with table_sharding='sharded' "
                "(the rank kernel streams the full entity table)")
        fused = False
    else:
        fused = _resolve_fused(model, fused, params)
    test = np.asarray(test, np.int32)
    Q = len(test)
    E = params["ent"].shape[0]
    if cand_masks is None:
        # pad-only masks: zero filtering work, filtered == raw (dropped
        # from the returned dict below)
        empty = np.full((Q, 1), E, np.int32)
        tails, heads = empty, empty
    else:
        tails, heads = cand_masks
    dev = params["ent"].device
    walk, walk_mesh = query_walk(backend, mesh, table_sharding)
    if sharded:
        scan = _pad_ent_tables(
            model, params, n_workers * merge_lib.shard_rows(E, n_workers))
        on_mesh = mesh if backend == "shard_map" else None
        entity_chunk = lambda chunk, cands, side: _entity_ranks_sharded(
            model, scan, chunk, cands, side, norm, n_workers, E, on_mesh)
    else:
        entity_chunk = lambda chunk, cands, side: _entity_chunk(
            model, params, chunk, cands, side, norm, fused)

    def per_worker(_, q_w, tc_w, hc_w):
        q_w, tc_w, hc_w = (torch.as_tensor(x, device=dev)
                           for x in (q_w, tc_w, hc_w))
        outs = {name: [] for name in (
            "tail_raw", "tail_filtered", "head_raw", "head_filtered")}
        if relations:
            outs["relation"] = []
        with torch.no_grad():
            for s in range(q_w.shape[0]):
                for side, cands in (("tail", tc_w[s]), ("head", hc_w[s])):
                    raw, filt = entity_chunk(q_w[s], cands, side)
                    outs[f"{side}_raw"].append(raw)
                    outs[f"{side}_filtered"].append(filt)
                if relations:
                    outs["relation"].append(
                        _relation_chunk(model, params, q_w[s], norm))
        return {name: torch.stack(v) for name, v in outs.items()}

    grid = lambda a: shard_chunks(
        a, query_workers(n_workers, walk), chunk, Q)
    grids = par.worker_map(per_worker, backend=walk, mesh=walk_mesh)(
        None, grid(test), grid(np.asarray(tails, np.int32)),
        grid(np.asarray(heads, np.int32)))
    host = lambda name: grids[name].reshape(-1).cpu().numpy()[:Q]
    out: Dict[str, object] = {"raw_ranks": {
        "tail": host("tail_raw"), "head": host("head_raw")}}
    if cand_masks is not None:
        out["filtered_ranks"] = {
            "tail": host("tail_filtered"), "head": host("head_filtered")}
    if relations:
        out["relation_ranks"] = host("relation")
    return out


def entity_inference_device(
    params: Params,
    test: np.ndarray,
    norm: str = "l1",
    cand_masks: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    *,
    model: "str | KGModel" = "transe",
    chunk: int = DEFAULT_CHUNK,
    n_workers: int = 1,
    backend: str = "vmap",
    mesh=None,
    fused: Optional[bool] = None,
    table_sharding: str = "replicated",
) -> Dict[str, "host_eval.RankMetrics"]:
    """Device-engine entity inference: raw (and, with ``cand_masks``,
    filtered) metrics identical to the host engine's."""
    ranks = entity_ranks_device(
        params, test, norm, cand_masks, model=model, chunk=chunk,
        n_workers=n_workers, backend=backend, mesh=mesh, fused=fused,
        table_sharding=table_sharding)
    raw = ranks["raw_ranks"]
    out = {"raw": host_eval._metrics_from_ranks(
        np.concatenate([raw["tail"], raw["head"]]))}
    if cand_masks is not None:
        filt = ranks["filtered_ranks"]
        out["filtered"] = host_eval._metrics_from_ranks(
            np.concatenate([filt["tail"], filt["head"]]))
    return out


def _resolve_fused(model: KGModel, fused: Optional[bool],
                   params: Params) -> bool:
    """``fused=None`` -> the rank kernel iff the model has one and its
    tables are CUDA tensors (kernels/ops dispatch rule).  An explicit
    ``fused=True`` is a hard request: models without a kernel raise
    instead of silently downgrading.  On CPU tables ``fused=True`` runs
    the kernel's plain version."""
    if fused is None:
        from repro_torch.kernels import ops

        return ops.fused_eval_available(model, params)
    if fused and not model.supports_fused_kernel:
        raise ValueError(
            f"fused=True but model {model.name!r} has no fused rank kernel "
            "(supports_fused_kernel is False) — drop fused or implement "
            "fused_rank_counts")
    return bool(fused)


# ---------------------------------------------------------------------------
# Relation prediction
# ---------------------------------------------------------------------------

def relation_prediction_device(
    params: Params,
    test: np.ndarray,
    norm: str = "l1",
    *,
    model: "str | KGModel" = "transe",
    chunk: int = 512,
    n_workers: int = 1,
    backend: str = "vmap",
    mesh=None,
    return_ranks: bool = False,
):
    """Rank the gold relation among all relations, chunked on the
    device; ``backend="shard_map"`` splits the queries over the mesh as
    :func:`entity_ranks_device` does (the reference's
    ``_relation_ranks_device``)."""
    model = get_model(model)
    check_layout("replicated", n_workers, backend, mesh,
                 params["ent"].device)
    test = np.asarray(test, np.int32)
    Q = len(test)
    dev = params["ent"].device

    def per_worker(_, q_w):
        q_w = torch.as_tensor(q_w, device=dev)
        with torch.no_grad():
            return torch.stack([_relation_chunk(model, params, q_w[s], norm)
                                for s in range(q_w.shape[0])])

    ranks = par.worker_map(per_worker, backend=backend, mesh=mesh)(
        None, shard_chunks(test, query_workers(n_workers, backend), chunk,
                           Q))
    ranks = ranks.reshape(-1).cpu().numpy()[:Q]
    metrics = host_eval._metrics_from_ranks(ranks)
    return (metrics, ranks) if return_ranks else metrics


# ---------------------------------------------------------------------------
# Triplet classification
# ---------------------------------------------------------------------------

def triplet_classification_device(
    params: Params,
    valid: np.ndarray,
    test: np.ndarray,
    n_entities: int,
    norm: str = "l1",
    seed: int = 0,
    model: "str | KGModel" = "transe",
    negatives: Optional[tuple] = None,
) -> float:
    """Triplet classification with the four energy vectors computed in one
    call over the concatenated arrays; corruption draws and threshold
    fitting are the host engine's (``_tc_negatives`` /
    ``_threshold_accuracy``)."""
    model = get_model(model)
    valid_neg, test_neg = (
        negatives if negatives is not None
        else host_eval._tc_negatives(valid, test, n_entities, seed))
    sections = np.cumsum([len(valid), len(valid_neg), len(test)])
    allt = np.concatenate([valid, valid_neg, test, test_neg], axis=0)
    with torch.no_grad():
        scores = model.energy(
            params, host_eval._on(params, allt), norm).cpu().numpy()
    sv_pos, sv_neg, st_pos, st_neg = np.split(scores, sections)
    return host_eval._threshold_accuracy(
        sv_pos, sv_neg, st_pos, st_neg, valid, valid_neg, test, test_neg,
        int(params["rel"].shape[0]))


# ---------------------------------------------------------------------------
# The full protocol
# ---------------------------------------------------------------------------

def evaluate_all_device(
    params: Params,
    kg,
    norm: str = "l1",
    filtered: bool = True,
    model: "str | KGModel" = "transe",
    *,
    chunk: int = DEFAULT_CHUNK,
    n_workers: int = 1,
    backend: str = "vmap",
    mesh=None,
    fused: Optional[bool] = None,
    max_fanout: Optional[int] = None,
    table_sharding: str = "replicated",
) -> Dict[str, object]:
    """All three paper tasks on the device engine — the host
    ``evaluate_all``'s output dict.  The two ranking tasks run as ONE pass
    over the test queries (``entity_ranks_device(relations=True)``).
    ``chunk`` queries are scored per step; ``fused`` forces the rank
    kernel on or off (default: auto); ``max_fanout`` caps the padded
    filter-mask width (``KG.eval_filter_candidates``);
    ``table_sharding="sharded"`` scans the entity table in ``n_workers``
    shards, with the same metrics bitwise (:func:`entity_ranks_device`)."""
    model = get_model(model)
    masks = kg.eval_filter_candidates(max_fanout) if filtered else None
    ranks = entity_ranks_device(
        params, kg.test, norm, masks, model=model, chunk=chunk,
        n_workers=n_workers, backend=backend, mesh=mesh, fused=fused,
        relations=True, table_sharding=table_sharding)
    raw = ranks["raw_ranks"]
    rp = host_eval._metrics_from_ranks(ranks["relation_ranks"])
    tc = triplet_classification_device(
        params, kg.valid, kg.test, kg.n_entities, norm, model=model,
        negatives=kg.tc_negatives(0),
    )
    out = {
        "entity_raw": host_eval._metrics_from_ranks(
            np.concatenate([raw["tail"], raw["head"]])).row(),
        "relation_prediction": rp.row(),
        "triplet_classification_acc": tc,
    }
    if filtered:
        filt = ranks["filtered_ranks"]
        out["entity_filtered"] = host_eval._metrics_from_ranks(
            np.concatenate([filt["tail"], filt["head"]])).row()
    return out
