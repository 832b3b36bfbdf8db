"""Evaluation protocol of the paper — entity inference, relation
prediction, triplet classification — over the ``KGModel`` registry (port
of ``repro.core.eval``).

This is the **host** engine, the frozen reference protocol: candidates
are scored in chunks on the tables' device, the protocol walks them on
the host (per-query filtered candidate walks).  The device engine
(``core/eval_device.py``), which ``evaluate_all(engine="device")`` routes
to, must give identical ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import negative
from repro_torch.core.models import KGModel, Params, get_model


@dataclasses.dataclass
class RankMetrics:
    mean_rank: float
    mrr: float
    hits_at_1: float
    hits_at_10: float
    n: int

    def row(self) -> Dict[str, float]:
        return {
            "mean_rank": self.mean_rank,
            "mrr": self.mrr,
            "hits@1": self.hits_at_1,
            "hits@10": self.hits_at_10,
            "n": self.n,
        }


def _metrics_from_ranks(ranks: np.ndarray) -> RankMetrics:
    ranks = ranks.astype(np.float64)
    return RankMetrics(
        mean_rank=float(ranks.mean()),
        mrr=float((1.0 / ranks).mean()),
        hits_at_1=float((ranks <= 1).mean()),
        hits_at_10=float((ranks <= 10).mean()),
        n=len(ranks),
    )


def _on(params: Params, arr: np.ndarray) -> torch.Tensor:
    """Host id array -> int64 tensor on the tables' device."""
    return torch.as_tensor(np.asarray(arr, np.int64),
                           device=params["ent"].device)


def entity_inference(
    params: Params,
    test: np.ndarray,
    norm: str = "l1",
    known: Optional[set] = None,
    batch: int = 128,
    model: "str | KGModel" = "transe",
    known_index: Optional[tuple] = None,
    return_ranks: bool = False,
) -> Dict[str, object]:
    """Link prediction: for every test triplet, rank the gold tail among all
    entities substituted as tail, and the gold head likewise.  Returns raw
    and (if ``known`` given) filtered metrics over both sides.

    ``known_index`` is the prebuilt ``(by_hr, by_rt)`` from
    ``KG.known_index()``.  ``return_ranks=True`` also returns the
    per-query rank vectors (``"raw_ranks"`` / ``"filtered_ranks"``, each a
    dict of ``"tail"``/``"head"`` arrays in test order)."""
    model = get_model(model)
    if known is not None and known_index is None:
        known_index = _known_index(known)
    raw_ranks = {"tail": [], "head": []}
    filt_ranks = {"tail": [], "head": []}

    with torch.no_grad():
        for i in range(0, len(test), batch):
            chunk = np.asarray(test[i : i + batch])
            tchunk = _on(params, chunk)
            for side in ("tail", "head"):
                scores = model.candidate_energies(
                    params, tchunk, side, norm).cpu().numpy()
                gold = chunk[:, 2] if side == "tail" else chunk[:, 0]
                gold_scores = scores[np.arange(len(chunk)), gold]
                raw = 1 + (scores < gold_scores[:, None]).sum(axis=1)
                raw_ranks[side].append(raw)
                if known is not None:
                    by_hr, by_rt = known_index
                    filt = raw.copy()
                    for j, (hh, rr, tt) in enumerate(chunk.tolist()):
                        if side == "tail":
                            better = [
                                e for e in by_hr.get((hh, rr), ())
                                if e != tt and scores[j, e] < gold_scores[j]
                            ]
                        else:
                            better = [
                                e for e in by_rt.get((rr, tt), ())
                                if e != hh and scores[j, e] < gold_scores[j]
                            ]
                        filt[j] = raw[j] - len(better)
                    filt_ranks[side].append(filt)

    raw_cat = {s: np.concatenate(raw_ranks[s]) for s in ("tail", "head")}
    out: Dict[str, object] = {
        "raw": _metrics_from_ranks(
            np.concatenate([raw_cat["tail"], raw_cat["head"]]))
    }
    if known is not None:
        filt_cat = {s: np.concatenate(filt_ranks[s]) for s in ("tail", "head")}
        out["filtered"] = _metrics_from_ranks(
            np.concatenate([filt_cat["tail"], filt_cat["head"]]))
    if return_ranks:
        out["raw_ranks"] = raw_cat
        if known is not None:
            out["filtered_ranks"] = filt_cat
    return out


def _known_index(known: set) -> tuple:
    """``(by_hr, by_rt)`` over a bare ``known`` set (``evaluate_all``
    passes ``KG.known_index()`` instead, which is cached on the graph)."""
    by_hr: Dict[tuple, list] = {}
    by_rt: Dict[tuple, list] = {}
    for (h, r, t) in known:
        by_hr.setdefault((h, r), []).append(t)
        by_rt.setdefault((r, t), []).append(h)
    return by_hr, by_rt


def relation_prediction(
    params: Params,
    test: np.ndarray,
    norm: str = "l1",
    batch: int = 512,
    model: "str | KGModel" = "transe",
    return_ranks: bool = False,
):
    """Rank the gold relation among all relations for each test (h, ?, t).
    ``return_ranks=True`` also returns the per-query rank vector."""
    model = get_model(model)
    ranks = []
    with torch.no_grad():
        for i in range(0, len(test), batch):
            chunk = np.asarray(test[i : i + batch])
            scores = model.relation_energies(
                params, _on(params, chunk), norm).cpu().numpy()
            gold = scores[np.arange(len(chunk)), chunk[:, 1]]
            ranks.append(1 + (scores < gold[:, None]).sum(axis=1))
    ranks = np.concatenate(ranks)
    metrics = _metrics_from_ranks(ranks)
    return (metrics, ranks) if return_ranks else metrics


def triplet_classification(
    params: Params,
    valid: np.ndarray,
    test: np.ndarray,
    n_entities: int,
    norm: str = "l1",
    seed: int = 0,
    model: "str | KGModel" = "transe",
    negatives: Optional[tuple] = None,
) -> float:
    """Is <h,r,t> true?  Learn a per-relation energy threshold on valid
    (pos + corrupted neg), report accuracy on test (pos + corrupted neg).
    ``negatives`` is the prebuilt ``(valid_neg, test_neg)`` pair from
    ``KG.tc_negatives(seed)``; ``evaluate_all`` passes it."""
    model = get_model(model)
    valid_neg, test_neg = (
        negatives if negatives is not None
        else _tc_negatives(valid, test, n_entities, seed))

    def scores(tr):
        with torch.no_grad():
            return model.energy(params, _on(params, tr), norm).cpu().numpy()

    sv_pos, sv_neg = scores(valid), scores(valid_neg)
    st_pos, st_neg = scores(test), scores(test_neg)
    return _threshold_accuracy(
        sv_pos, sv_neg, st_pos, st_neg, valid, valid_neg, test, test_neg,
        int(params["rel"].shape[0]))


def _tc_negatives(
    valid: np.ndarray, test: np.ndarray, n_entities: int, seed: int
) -> tuple:
    """Corrupted valid/test counterparts for triplet classification — the
    single definition of the draw order (valid, then test, from one
    generator seeded with ``seed``) that both eval engines share."""
    gen = torch.Generator().manual_seed(seed)
    valid_neg = negative.corrupt_unif(
        torch.as_tensor(np.asarray(valid, np.int32)), n_entities,
        generator=gen).numpy()
    test_neg = negative.corrupt_unif(
        torch.as_tensor(np.asarray(test, np.int32)), n_entities,
        generator=gen).numpy()
    return valid_neg, test_neg


def _threshold_accuracy(
    sv_pos: np.ndarray,
    sv_neg: np.ndarray,
    st_pos: np.ndarray,
    st_neg: np.ndarray,
    valid: np.ndarray,
    valid_neg: np.ndarray,
    test: np.ndarray,
    test_neg: np.ndarray,
    n_rel: int,
) -> float:
    """Per-relation threshold fit on valid scores + accuracy on test
    scores — the host-side tail of triplet classification, shared by both
    eval engines."""
    thresholds = np.zeros((n_rel,), np.float64)
    global_scores = np.concatenate([sv_pos, sv_neg])
    global_labels = np.concatenate(
        [np.ones_like(sv_pos), np.zeros_like(sv_neg)]
    )
    global_thr = _best_threshold(global_scores, global_labels)
    for r in range(n_rel):
        m_pos = valid[:, 1] == r
        m_neg = valid_neg[:, 1] == r
        s = np.concatenate([sv_pos[m_pos], sv_neg[m_neg]])
        l = np.concatenate([np.ones(m_pos.sum()), np.zeros(m_neg.sum())])
        thresholds[r] = _best_threshold(s, l) if len(s) >= 4 else global_thr

    pred_pos = st_pos < thresholds[test[:, 1]]
    pred_neg = st_neg < thresholds[test_neg[:, 1]]
    correct = pred_pos.sum() + (~pred_neg).sum()
    return float(correct) / (len(test) + len(test_neg))


def _best_threshold(scores: np.ndarray, labels: np.ndarray) -> float:
    """Threshold minimizing classification error: score < thr => positive."""
    order = np.argsort(scores)
    s, l = scores[order], labels[order]
    # predicting positive for the first i items: correct = pos in prefix +
    # neg in suffix.
    pos_prefix = np.concatenate([[0], np.cumsum(l)])
    neg_suffix = np.concatenate([np.cumsum((1 - l)[::-1])[::-1], [0]])
    correct = pos_prefix + neg_suffix
    i = int(np.argmax(correct))
    if i == 0:
        return float(s[0]) - 1e-6 if len(s) else 0.0
    if i == len(s):
        return float(s[-1]) + 1e-6
    return float(0.5 * (s[i - 1] + s[i]))


def evaluate_all(
    params: Params,
    kg,
    norm: str = "l1",
    filtered: bool = True,
    model: "str | KGModel" = "transe",
    engine: str = "host",
    **engine_kw,
) -> Dict[str, object]:
    """The paper's full evaluation protocol — entity inference (raw +
    filtered, both sides), relation prediction and triplet classification
    — in one call.  ``engine="host"`` is this module's reference;
    ``engine="device"`` is ``core/eval_device.evaluate_all_device`` (its
    options ride in ``engine_kw``).  Both give identical numbers.  Returns
    metric rows keyed ``entity_raw``, ``entity_filtered`` (when
    ``filtered``), ``relation_prediction`` and
    ``triplet_classification_acc``."""
    if engine == "device":
        from repro_torch.core import eval_device

        return eval_device.evaluate_all_device(
            params, kg, norm=norm, filtered=filtered, model=model,
            **engine_kw)
    if engine != "host":
        raise ValueError(f"bad engine {engine!r}: 'host' or 'device'")
    if engine_kw:
        raise ValueError(
            f"engine options {sorted(engine_kw)} need engine='device' — the "
            "host reference has no chunk scheduling or kernel choice")
    model = get_model(model)
    known = kg.known_set() if filtered else None
    ent = entity_inference(
        params, kg.test, norm, known, model=model,
        known_index=kg.known_index() if filtered else None)
    rp = relation_prediction(params, kg.test, norm, model=model)
    tc = triplet_classification(
        params, kg.valid, kg.test, kg.n_entities, norm, model=model,
        negatives=kg.tc_negatives(0),
    )
    out = {
        "entity_raw": ent["raw"].row(),
        "relation_prediction": rp.row(),
        "triplet_classification_acc": tc,
    }
    if filtered:
        out["entity_filtered"] = ent["filtered"].row()
    return out
