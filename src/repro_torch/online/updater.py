"""Incremental ``kb.update()``: fold new triples into a trained artifact
(port of ``repro.online.updater``).

``OnlineUpdater.update`` runs four stages:

1. **Interning**: string triples get ids from the artifact's vocab through
   ``datasets.extend_vocab``, the same first-seen order ``load_tsv_dir``
   uses, so an updated artifact's ids are the ones a fresh load of
   base + delta would give.  Integer triples may name unseen ids; the
   tables grow to cover them.
2. **Table extension**: every table grows to the new entity and relation
   counts.  The appended rows come from one draw of the port's
   ``model.init_params`` at the new sizes, from a ``torch.Generator``
   seeded with ``seed`` (the reference draws them from
   ``jax.random.PRNGKey(seed)``, so these rows differ from its rows);
   a new entity row is then replaced by the mean of its old-entity
   neighbours in the delta, summed in float64 on the host as the
   reference does (the same bits), and ``model.normalize_rows`` projects
   the appended rows.
3. **Masked fine-tune**: a short ``mapreduce.train`` job over the delta
   triples on the device pipeline and the sparse transport, with an
   ``update_mask`` that freezes every row the delta does not free
   (``scope``).  Frozen rows stay bitwise; the result is bitwise a direct
   ``mapreduce.train`` call on :meth:`OnlineUpdater.plan`'s inputs.  It
   runs on the device that holds the artifact's tables.
4. **Assembly**: a new ``KnowledgeBase`` over the trained tables and the
   extended graph (``KG.extend`` returns a fresh graph, so its caches
   start cold and both fingerprints change, which invalidates a server's
   answer cache).  With ``delta_dir=`` the changed and appended rows are
   appended to a delta checkpoint chain.

``RefreshDaemon`` drives this into a live ``KGServer``: submitted triples
are drained by a background thread into ``update()`` and each refreshed
artifact is swapped in through the server's warmed ``swap()``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import kg as kg_api
from repro_torch.core import mapreduce
from repro_torch.core.models import KGConfig, Params
from repro_torch.data import datasets
from repro_torch.data.kg import KG
from repro_torch.kb import KnowledgeBase
from repro_torch.train import checkpoint as ckpt_lib

_EMPTY = np.zeros((0, 3), np.int32)


@dataclasses.dataclass
class UpdatePlan:
    """Everything the masked fine-tune consumes, so that ``update() ==
    mapreduce.train(plan)`` is a one-line check."""

    delta: np.ndarray              # (n, 3) int32 delta triples, new id space
    delta_kg: KG                   # train=delta, empty valid/test, new sizes
    params: Params                 # extended tables on the artifact's device
    update_mask: Dict[str, np.ndarray]   # per table, bool rows-may-move
    kcfg: KGConfig
    mcfg: mapreduce.MapReduceConfig
    epochs: int
    seed: int


class OnlineUpdater:
    """``update(new_triples) -> KnowledgeBase`` (module docstring).

    ``epochs`` fine-tune epochs (one block); ``n_workers``,
    ``batch_size``, ``merge_every`` and ``learning_rate`` are the engine's
    knobs for the fine-tune (workers and batch shrink for tiny deltas);
    ``seed`` drives the appended rows' draw and the fine-tune (same seed
    and delta, same bits); ``delta_dir`` appends each update to a delta
    checkpoint chain; ``vocab`` is ``(ent2id, rel2id)`` (or a dataset
    ``cache_dir``) for string triples, interned in place.

    ``scope``: ``"touched"`` (default) frees every row the delta names;
    ``"cold"`` frees only rows with no training signal in the base graph
    (ids its train split never names, and appended ids), so every trained
    row stays bitwise frozen.

    ``staleness`` must stay 0: an update fine-tunes against the one
    coherent artifact it extends, as a resume does."""

    def __init__(
        self,
        kb: KnowledgeBase,
        *,
        epochs: int = 8,
        n_workers: int = 2,
        batch_size: Optional[int] = None,
        merge_every: int = 1,
        learning_rate: float = 0.01,
        seed: int = 1,
        staleness: int = 0,
        scope: str = "touched",
        delta_dir: Optional[str] = None,
        vocab=None,
    ):
        if not isinstance(kb, KnowledgeBase):
            raise TypeError(
                f"OnlineUpdater takes a KnowledgeBase, got {type(kb)!r}")
        if scope not in ("touched", "cold"):
            raise ValueError(
                f"scope must be 'touched' or 'cold', got {scope!r}")
        if staleness != 0:
            raise ValueError(
                "staleness>0 gives workers deliberately stale views "
                "mid-run; an online update must fine-tune against the one "
                "coherent artifact it extends — like checkpoint/resume, "
                "updates require staleness=0")
        self.kb = kb
        self.epochs = int(epochs)
        self.n_workers = int(n_workers)
        self.batch_size = batch_size
        self.merge_every = int(merge_every)
        self.learning_rate = float(learning_rate)
        self.seed = int(seed)
        self.scope = scope
        self.delta_dir = delta_dir
        if isinstance(vocab, str):
            vocab = datasets.load_vocab(vocab)
        self.vocab = vocab

    # -- stage 1: interning ------------------------------------------------

    def _coerce(self, new_triples) -> np.ndarray:
        if new_triples is None:
            return _EMPTY
        arr = np.asarray(new_triples)
        if arr.size == 0:
            return _EMPTY
        if np.issubdtype(arr.dtype, np.integer):
            return arr.astype(np.int32).reshape(-1, 3)
        if self.vocab is None:
            raise ValueError(
                "string triples need vocab=(ent2id, rel2id) (or a dataset "
                "cache_dir) so unseen names intern to canonical ids — the "
                "same first-seen order load_tsv_dir uses")
        ent2id, rel2id = self.vocab
        return datasets.extend_vocab(arr.reshape(-1, 3), ent2id, rel2id)

    # -- stages 2 and 3 assembled: the plan --------------------------------

    def plan(self, new_triples) -> UpdatePlan:
        """The exact ``mapreduce.train`` inputs the fine-tune runs with
        (nothing is trained here)."""
        kb = self.kb
        delta = self._coerce(new_triples)
        old_ent, old_rel = kb.n_entities, kb.n_relations
        n_ent, n_rel = old_ent, old_rel
        if len(delta):
            n_ent = max(n_ent, int(delta[:, (0, 2)].max()) + 1)
            n_rel = max(n_rel, int(delta[:, 1].max()) + 1)
        delta_kg = KG(n_entities=n_ent, n_relations=n_rel,
                      train=delta, valid=_EMPTY, test=_EMPTY)

        n_delta = max(1, len(delta))
        workers = max(1, min(self.n_workers, n_delta))
        per_worker = max(1, n_delta // workers)
        batch = self.batch_size or min(128, per_worker)
        batch = max(1, min(int(batch), per_worker))
        kcfg, mcfg = kg_api.make_configs(
            delta_kg, model=kb.model, paradigm="sgd",
            dim=kb.dim, norm=kb.norm, learning_rate=self.learning_rate,
            n_workers=workers, batch_size=batch, pipeline="device",
            merge_transport="sparse", backend="vmap",
            block_epochs=self.epochs, merge_every=self.merge_every)

        params = self._extend_tables(delta, kcfg, n_ent, n_rel)
        role_mask = self._touch_mask(delta, n_ent, n_rel, old_ent, old_rel)
        if self.scope == "cold":
            role_mask = self._restrict_to_cold(
                role_mask, n_ent, n_rel, old_ent, old_rel)
        roles = kb.model.param_roles()
        mask = {name: role_mask[roles[name]] for name in params}
        return UpdatePlan(delta=delta, delta_kg=delta_kg, params=params,
                          update_mask=mask, kcfg=kcfg, mcfg=mcfg,
                          epochs=self.epochs, seed=self.seed)

    def _extend_tables(self, delta, kcfg, n_ent, n_rel) -> Params:
        kb = self.kb
        roles = kb.model.param_roles()
        fresh = None
        params: Params = {}
        for name, old in kb.params.items():
            n_new = n_ent if roles[name] == "ent" else n_rel
            if n_new == old.shape[0]:
                params[name] = old
                continue
            if fresh is None:                         # one draw, all tables
                fresh = kb.model.init_params(
                    torch.Generator().manual_seed(self.seed), kcfg,
                    device=old.device)
            app = fresh[name][old.shape[0]:n_new].to(old.dtype)
            if name == "ent":
                app = torch.as_tensor(
                    self._warm_init(app.cpu().numpy(), old.cpu().numpy(),
                                    delta), device=old.device)
            app = kb.model.normalize_rows(name, app).to(old.dtype)
            params[name] = torch.cat([old, app])
        return params

    @staticmethod
    def _warm_init(app, old, delta) -> np.ndarray:
        """New-entity rows start at the mean embedding of their old-entity
        neighbours in the delta, summed in float64 (fallback: the fresh
        draw in ``app``); host numpy arrays in and out."""
        old_n = old.shape[0]
        if not len(delta) or not len(app):
            return app
        sums = np.zeros_like(app, dtype=np.float64)
        counts = np.zeros(len(app), np.int64)
        h, t = delta[:, 0], delta[:, 2]
        for e, other in ((h, t), (t, h)):
            sel = (e >= old_n) & (other < old_n)
            np.add.at(sums, e[sel] - old_n, old[other[sel]])
            np.add.at(counts, e[sel] - old_n, 1)
        have = counts > 0
        app = app.copy()
        app[have] = (sums[have] / counts[have, None]).astype(app.dtype)
        return app

    @staticmethod
    def _touch_mask(delta, n_ent, n_rel, old_ent, old_rel):
        ent = np.zeros(n_ent, bool)
        rel = np.zeros(n_rel, bool)
        if len(delta):
            ent[delta[:, (0, 2)].ravel()] = True
            rel[delta[:, 1]] = True
        ent[old_ent:] = True                          # appended rows are free
        rel[old_rel:] = True
        return {"ent": ent, "rel": rel}

    def _restrict_to_cold(self, role_mask, n_ent, n_rel, old_ent, old_rel):
        """``scope="cold"``: only touched rows with no training signal in
        the base artifact stay free — ids its *train* split never names
        (ids seen only in valid/test sit at init), plus appended ids.
        Without a graph only the appended rows count as cold."""
        cold_ent = np.ones(n_ent, bool)
        cold_rel = np.ones(n_rel, bool)
        if self.kb.graph is not None:
            train = self.kb.graph.train
            if len(train):
                cold_ent[train[:, (0, 2)].ravel()] = False
                cold_rel[train[:, 1]] = False
        else:
            cold_ent[:old_ent] = False
            cold_rel[:old_rel] = False
        return {"ent": role_mask["ent"] & cold_ent,
                "rel": role_mask["rel"] & cold_rel}

    # -- stage 4: run and assemble -----------------------------------------

    def update(self, new_triples) -> KnowledgeBase:
        """Fold ``new_triples`` in and return a NEW artifact on the base's
        device (the base is immutable by convention).  Zero triples is a
        bit-identical no-op: the same tables and graph, an equal
        fingerprint."""
        kb = self.kb
        p = self.plan(new_triples)
        if not len(p.delta):
            return KnowledgeBase(model=kb.model, params=kb.params,
                                 graph=kb.graph, norm=kb.norm,
                                 meta=dict(kb.meta))
        res = mapreduce.train(
            p.delta_kg, p.kcfg, p.mcfg, epochs=p.epochs, seed=p.seed,
            params=p.params, update_mask=p.update_mask, model=kb.model,
            device=kb.params["ent"].device)
        graph = None
        if kb.graph is not None:
            graph = kb.graph.extend(
                p.delta, n_entities=p.delta_kg.n_entities,
                n_relations=p.delta_kg.n_relations)
        meta = dict(kb.meta)
        meta["updates"] = int(meta.get("updates", 0)) + 1
        new_kb = KnowledgeBase(model=kb.model, params=res.params,
                               graph=graph, norm=kb.norm, meta=meta)
        if self.delta_dir is not None:
            self._save_delta(kb, new_kb, p.delta)
        return new_kb

    def _save_delta(self, base_kb: KnowledgeBase, new_kb: KnowledgeBase,
                    delta: np.ndarray):
        d = str(self.delta_dir)
        if not ckpt_lib.chain_steps(d):
            base_kb.save(d)                           # the chain's base
        rows = {}
        for name, new in new_kb.params.items():
            old = ckpt_lib._host(base_kb.params[name])
            new = ckpt_lib._host(new)
            old_n = old.shape[0]
            changed = np.nonzero(np.any(old != new[:old_n], axis=1))[0]
            idx = np.concatenate(
                [changed, np.arange(old_n, new.shape[0])]).astype(np.int32)
            rows[name] = {"idx": idx, "vals": new[idx]}
        graph = new_kb.graph
        extra = {
            "kind": ckpt_lib.DELTA_KIND,
            "delta": True,
            "model": new_kb.model.name,
            "norm": new_kb.norm,
            "dim": new_kb.dim,
            "base": base_kb.fingerprint(),
            "result": new_kb.fingerprint(),
            "n_entities": (graph.n_entities if graph is not None
                           else new_kb.n_entities),
            "n_relations": (graph.n_relations if graph is not None
                            else new_kb.n_relations),
            "tables": {name: list(arr.shape)
                       for name, arr in sorted(new_kb.params.items())},
            "meta": new_kb.meta,
        }
        tree = {"rows": rows, "graph": {"train": delta.astype(np.int32)}}
        ckpt_lib.save_delta(d, tree, extra)


class RefreshDaemon:
    """Serve while training: drain an update queue through
    ``OnlineUpdater`` and swap each refreshed artifact into a live
    ``KGServer`` (module docstring).

    The swap is the server's warmed double-buffer ``swap()``: waves
    admitted before the flip finish against the old artifact, later ones
    answer from the new one, and the warmed buckets keep
    ``steady_recompiles`` at 0 across refreshes.

    Use as a context manager (starts and stops the thread) or call
    :meth:`refresh` synchronously; :meth:`flush` blocks until every
    submitted triple has been folded in and swapped, and :meth:`stop`
    joins the thread.  An error in the thread is raised by the next
    :meth:`submit` or :meth:`flush`."""

    def __init__(self, server, kb: Optional[KnowledgeBase] = None,
                 tenant: str = "default", **updater_kw):
        self._server = server
        self._tenant = tenant
        self.kb = kb if kb is not None else server.tenant_kb(tenant)
        self._updater_kw = dict(updater_kw)
        self._queue: List[np.ndarray] = []
        self._cond = threading.Condition()
        self._stopping = False
        self._busy = False
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.refreshes = 0
        self.triples_applied = 0

    # -- queue -------------------------------------------------------------

    def _raise_error(self) -> None:
        """Raise (and clear) an error the thread left; call under the
        lock."""
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, triples):
        """Enqueue triples for the next refresh (thread-safe)."""
        with self._cond:
            self._raise_error()
            self._queue.append(np.asarray(triples))
            self._cond.notify_all()

    def refresh(self) -> KnowledgeBase:
        """One synchronous pass: drain whatever is queued (possibly
        nothing), fine-tune, swap.  Returns the now-live artifact."""
        return self._refresh(keep_error=False)

    def _refresh(self, keep_error: bool) -> KnowledgeBase:
        """:meth:`refresh`; with ``keep_error`` a failure is also kept for
        :meth:`submit` / :meth:`flush` (and the queue dropped) in the same
        critical section that ends the pass, so a ``flush`` woken by the
        pass's end cannot miss it."""
        with self._cond:
            batch, self._queue = self._queue, []
            self._busy = True
        error = None
        try:
            delta = (np.concatenate([b.reshape(-1, 3) for b in batch])
                     if batch else _EMPTY)
            new_kb = OnlineUpdater(self.kb, **self._updater_kw).update(delta)
            self._server.swap(new_kb, tenant=self._tenant)
            with self._cond:
                self.kb = new_kb
                self.refreshes += 1
                self.triples_applied += len(delta)
            return new_kb
        except Exception as e:
            error = e
            raise
        finally:
            with self._cond:
                if keep_error and error is not None:
                    self._error = error
                    self._queue = []
                self._busy = False
                self._cond.notify_all()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is drained and no refresh is in flight;
        False when ``timeout`` seconds pass first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._queue or self._busy:
                self._raise_error()
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._cond.wait(timeout=remaining)
            self._raise_error()
        return True

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._stopping = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> bool:
        """Let the thread finish what is queued, then join it; False when
        it is still running after ``timeout`` seconds (a later ``stop``
        joins it again)."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return False
            self._thread = None
        return True

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait()
                if self._stopping and not self._queue:
                    return
            try:
                self._refresh(keep_error=True)
            except Exception:               # kept for submit() / flush()
                pass
