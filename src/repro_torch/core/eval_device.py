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

The reference's W-worker split of the query axis has no counterpart on
one GPU; ``table_sharding="sharded"`` is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import eval as host_eval
from repro_torch.core.models import KGModel, Params, get_model

DEFAULT_CHUNK = 256


# ---------------------------------------------------------------------------
# Layout: pad the query axis and split it into chunks
# ---------------------------------------------------------------------------

def _layout(n: int, chunk: int) -> Tuple[int, int, int]:
    """(S, C, padded_n) for ``n`` queries: ``S`` chunks of ``C`` rows,
    ``S * C >= n`` (the reference's layout with one worker)."""
    C = max(1, chunk)
    S = max(1, -(-n // C))
    return S, C, S * C


def _pad_rows(arr: np.ndarray, padded_n: int) -> np.ndarray:
    """Pad axis 0 to ``padded_n`` by repeating row 0 (valid ids, scored
    harmlessly, sliced off after the ranks come back)."""
    if len(arr) == padded_n:
        return arr
    reps = np.broadcast_to(arr[:1], (padded_n - len(arr),) + arr.shape[1:])
    return np.concatenate([arr, reps], axis=0)


def _chunks(arr: np.ndarray, S: int, C: int, device) -> torch.Tensor:
    """(padded_n, ...) host ids -> (S, C, ...) int64 tensor on ``device``."""
    return torch.as_tensor(
        np.asarray(arr, np.int64).reshape((S, C) + arr.shape[1:]),
        device=device)


def _check_replicated(table_sharding: str) -> None:
    if table_sharding == "sharded":
        raise NotImplementedError(
            "table_sharding='sharded' is not ported to repro_torch yet "
            "(ROADMAP.md queue 1, item 12: multi-GPU backend and table "
            "sharding)")
    if table_sharding != "replicated":
        raise ValueError(
            f"table_sharding must be 'replicated' or 'sharded', got "
            f"{table_sharding!r}")


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


def entity_ranks_device(
    params: Params,
    test: np.ndarray,
    norm: str = "l1",
    cand_masks: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    *,
    model: "str | KGModel" = "transe",
    chunk: int = DEFAULT_CHUNK,
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
    with a kernel and CUDA tables)."""
    model = get_model(model)
    _check_replicated(table_sharding)
    fused = _resolve_fused(model, fused, params)
    test = np.asarray(test, np.int32)
    Q = len(test)
    E = params["ent"].shape[0]
    S, C, Qp = _layout(Q, chunk)
    if cand_masks is None:
        # pad-only masks: zero filtering work, filtered == raw (dropped
        # from the returned dict below)
        empty = np.full((Q, 1), E, np.int32)
        tails, heads = empty, empty
    else:
        tails, heads = cand_masks
    dev = params["ent"].device
    q = _chunks(_pad_rows(test, Qp), S, C, dev)
    tc = _chunks(_pad_rows(np.asarray(tails, np.int32), Qp), S, C, dev)
    hc = _chunks(_pad_rows(np.asarray(heads, np.int32), Qp), S, C, dev)

    outs = {name: [] for name in (
        "tail_raw", "tail_filtered", "head_raw", "head_filtered",
        "relation")}
    with torch.no_grad():
        for s in range(S):
            for side, cands in (("tail", tc[s]), ("head", hc[s])):
                raw, filt = _entity_chunk(
                    model, params, q[s], cands, side, norm, fused)
                outs[f"{side}_raw"].append(raw)
                outs[f"{side}_filtered"].append(filt)
            if relations:
                outs["relation"].append(
                    _relation_chunk(model, params, q[s], norm))

    def host(name):
        return torch.cat(outs[name]).cpu().numpy()[:Q]

    out: Dict[str, object] = {"raw_ranks": {
        "tail": host("tail_raw"), "head": host("head_raw")}}
    if cand_masks is not None:
        out["filtered_ranks"] = {
            "tail": host("tail_filtered"), "head": host("head_filtered")}
    if relations:
        out["relation_ranks"] = host("relation")
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
    return_ranks: bool = False,
):
    """Rank the gold relation among all relations, chunked on the
    device."""
    model = get_model(model)
    test = np.asarray(test, np.int32)
    Q = len(test)
    S, C, Qp = _layout(Q, chunk)
    q = _chunks(_pad_rows(test, Qp), S, C, params["ent"].device)
    with torch.no_grad():
        ranks = torch.cat([
            _relation_chunk(model, params, q[s], norm) for s in range(S)
        ]).cpu().numpy()[:Q]
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
    fused: Optional[bool] = None,
    max_fanout: Optional[int] = None,
    table_sharding: str = "replicated",
) -> Dict[str, object]:
    """All three paper tasks on the device engine — the host
    ``evaluate_all``'s output dict.  The two ranking tasks run as ONE pass
    over the test queries (``entity_ranks_device(relations=True)``).
    ``chunk`` queries are scored per step; ``fused`` forces the rank
    kernel on or off (default: auto); ``max_fanout`` caps the padded
    filter-mask width (``KG.eval_filter_candidates``)."""
    model = get_model(model)
    masks = kg.eval_filter_candidates(max_fanout) if filtered else None
    ranks = entity_ranks_device(
        params, kg.test, norm, masks, model=model, chunk=chunk, fused=fused,
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
