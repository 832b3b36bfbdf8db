"""``KnowledgeBase``: the persistent, serveable KG-embedding artifact
(port of ``repro.kb``).

Model + embedding tables + graph metadata as one object:

    from repro_torch import kg

    kb = kg.KnowledgeBase.load("my_kb")        # tables on the GPU
    top = kb.query_tails(h, r, k=10, filtered=True)
    best = kb.query_relations(h, t, k=3)
    e = kb.score(h, r, t)
    metrics = kg.evaluate(kb, engine="device")  # the paper's protocol
    kb2 = kb.update(new_triples, delta_dir="chain")  # the online tier
    kb2 = kg.KnowledgeBase.load_chain("chain")  # base + deltas replayed

The on-disk format is the reference's (``train/checkpoint.py``), and
``fingerprint()`` hashes the same bytes the same way: an artifact or a
delta chain saved by either package loads in the other with the same
fingerprint.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import eval as kg_eval
from repro_torch.core import eval_device
from repro_torch.core.models import KGModel, Params, get_model
from repro_torch.data.kg import KG
from repro_torch.serve.kg_engine import KGQueryEngine, QueryResult
from repro_torch.train import checkpoint as ckpt_lib

ARTIFACT_KIND = "knowledge_base"


@dataclasses.dataclass
class KnowledgeBase:
    """A trained KG embedding as an artifact (module docstring).

    ``params`` are tensors on one device.  ``graph`` is optional: without
    it the artifact still scores and serves raw top-k, but filtered
    queries and ``evaluate`` need the splits."""

    model: KGModel
    params: Params
    graph: Optional[KG] = None
    norm: str = "l1"
    meta: Dict = dataclasses.field(default_factory=dict)
    _engines: Dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _fingerprint: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        self.model = get_model(self.model)
        missing = set(self.model.param_roles()) - set(self.params)
        if missing:
            raise ValueError(
                f"params are missing tables {sorted(missing)} for model "
                f"{self.model.name!r} (have {sorted(self.params)})")

    # -- identity ----------------------------------------------------------

    @property
    def n_entities(self) -> int:
        return int(self.params["ent"].shape[0])

    @property
    def n_relations(self) -> int:
        return int(self.params["rel"].shape[0])

    @property
    def dim(self) -> int:
        return int(self.params["ent"].shape[1])

    def fingerprint(self) -> str:
        """Content identity of this artifact: a short sha256 over the model
        name, norm, every table's bytes (as numpy arrays, dtype and shape
        included) and the graph's ``KG.fingerprint()`` digests — the
        reference's recipe, so equal tables give the equal digest in both
        packages (a bf16 table hashes as the dtype name ``bfloat16`` and
        its raw 2-byte values, as the reference's ``ml_dtypes`` array
        does).  Computed once and cached."""
        if self._fingerprint is None:
            h = hashlib.sha256()
            h.update(f"{self.model.name}:{self.norm}".encode())
            for name in sorted(self.params):
                table = self.params[name]
                arr = np.ascontiguousarray(ckpt_lib._host(table))
                dtype = ("bfloat16" if table.dtype == torch.bfloat16
                         else arr.dtype)
                h.update(f":{name}:{dtype}:{arr.shape}".encode())
                h.update(arr.tobytes())
            if self.graph is not None:
                for key, val in sorted(self.graph.fingerprint().items()):
                    h.update(f":{key}={val}".encode())
            self._fingerprint = h.hexdigest()[:16]
        return self._fingerprint

    # -- persistence -------------------------------------------------------

    def save(self, path: str, *, include_graph: bool = True,
             step: int = 0, keep: int = 3) -> str:
        """Persist atomically under ``path`` (checkpoint ``step_`` layout).
        Returns the committed directory.  The manifest records model name,
        per-table shapes, norm and the graph fingerprint; the graph splits
        ship with the tables unless ``include_graph=False``."""
        tree = {"params": self.params}
        graph_fp = None
        if include_graph and self.graph is not None:
            tree["graph"] = {
                "train": np.asarray(self.graph.train, np.int32),
                "valid": np.asarray(self.graph.valid, np.int32),
                "test": np.asarray(self.graph.test, np.int32),
            }
        if self.graph is not None:
            graph_fp = self.graph.fingerprint()
        extra = {
            "kind": ARTIFACT_KIND,
            "model": self.model.name,
            "norm": self.norm,
            "dim": self.dim,
            "n_entities": (self.graph.n_entities if self.graph is not None
                           else self.n_entities),
            "n_relations": (self.graph.n_relations if self.graph is not None
                            else self.n_relations),
            "tables": {
                name: list(arr.shape)
                for name, arr in sorted(self.params.items())
            },
            "graph": graph_fp,
            "fingerprint": self.fingerprint(),
            "meta": self.meta,
        }
        return ckpt_lib.save(str(path), step, tree, extra=extra, keep=keep)

    @classmethod
    def load(cls, path: str, step: Optional[int] = None,
             device=None) -> "KnowledgeBase":
        """Restore a saved artifact (either package's) with its tables on
        ``device`` (default: the GPU; raises without one unless ``device``
        is given).  Raises a clear error when the directory holds something
        else, the manifest names a model not ported, a stored table's shape
        disagrees with the manifest, a table is stored as raw bfloat16
        bytes (``|V2``: the reference loads those but cannot serve them),
        or the shipped graph fails its fingerprint."""
        device = resolve_device(device)
        _, tree, extra = ckpt_lib.restore(
            str(path), step=step, expect={"kind": ARTIFACT_KIND})
        model = get_model(extra["model"])
        stored = tree["params"]
        for name, shape in (extra.get("tables") or {}).items():
            if name not in stored:
                raise ValueError(
                    f"artifact at {path} is missing table {name!r} named "
                    "in its manifest — truncated or corrupted save?")
            if list(stored[name].shape) != list(shape):
                raise ValueError(
                    f"artifact table {name!r} has shape "
                    f"{tuple(stored[name].shape)} but the manifest records "
                    f"{tuple(shape)} — corrupted artifact?")
        for name, arr in sorted(stored.items()):
            if arr.dtype.kind == "V":
                raise ValueError(
                    f"artifact table {name!r} at {path} is stored as raw "
                    f"{arr.dtype.itemsize}-byte values ({arr.dtype.str}): a "
                    "bfloat16 table, which numpy saves without its type; "
                    "neither package can serve it after a save (the "
                    "reference loads it and fails at the first query)")
        params = {name: torch.as_tensor(arr, device=device)
                  for name, arr in stored.items()}
        graph = None
        if "graph" in tree:
            g = tree["graph"]
            graph = KG(int(extra["n_entities"]), int(extra["n_relations"]),
                       g["train"], g["valid"], g["test"])
            fp = extra.get("graph")
            if fp is not None and graph.fingerprint() != fp:
                raise ValueError(
                    f"graph splits stored at {path} do not match the "
                    "manifest fingerprint — corrupted artifact?")
        return cls(model=model, params=params, graph=graph,
                   norm=extra.get("norm", "l1"),
                   meta=extra.get("meta") or {})

    @classmethod
    def load_chain(cls, path: str, device=None) -> "KnowledgeBase":
        """Replay a delta chain onto ``device`` (default: the GPU, as
        :meth:`load`): load the base artifact at the chain's first step,
        then apply each delta in order — grow the tables, keep the
        surviving prefix, scatter the stored changed and appended rows,
        extend the graph with the delta's triples.  Every link is checked
        both ways: the delta's ``base`` fingerprint must be the artifact
        built so far, and the rebuilt artifact must hash to its
        ``result``, so a tampered or reordered chain raises."""
        steps = ckpt_lib.chain_steps(str(path))
        if not steps:
            raise FileNotFoundError(f"no chain (or artifact) in {path}")
        kb = cls.load(path, step=steps[0], device=device)
        for step in steps[1:]:
            tree, extra = ckpt_lib.load_tree(str(path), step)
            if not extra.get("delta"):
                raise ValueError(
                    f"chain step {step} in {path} is not a delta — "
                    "multiple base artifacts in one directory?")
            if extra.get("base") != kb.fingerprint():
                raise ValueError(
                    f"delta step {step} applies to fingerprint "
                    f"{extra.get('base')} but the chain so far builds "
                    f"{kb.fingerprint()} — corrupted or reordered chain")
            params = {}
            for name, shape in (extra.get("tables") or {}).items():
                old = kb.params[name]
                table = old.new_zeros((int(shape[0]), int(shape[1])))
                table[:old.shape[0]] = old
                rows = (tree.get("rows") or {}).get(name)
                if rows is not None and np.asarray(rows["idx"]).size:
                    idx = torch.as_tensor(
                        np.asarray(rows["idx"], np.int64), device=old.device)
                    table[idx] = torch.as_tensor(
                        np.asarray(rows["vals"]), device=old.device).to(
                            old.dtype)
                params[name] = table
            graph = kb.graph
            if graph is not None:
                gt = (tree.get("graph") or {}).get("train")
                if gt is None:
                    gt = np.zeros((0, 3), np.int32)
                graph = graph.extend(
                    gt, n_entities=int(extra["n_entities"]),
                    n_relations=int(extra["n_relations"]))
            kb = cls(model=kb.model, params=params, graph=graph,
                     norm=extra.get("norm", kb.norm),
                     meta=extra.get("meta") or dict(kb.meta))
            if kb.fingerprint() != extra.get("result"):
                raise ValueError(
                    f"replaying delta step {step} in {path} produced "
                    f"fingerprint {kb.fingerprint()} but the manifest "
                    f"records {extra.get('result')} — corrupted chain")
        return kb

    # -- online updates ----------------------------------------------------

    def update(self, new_triples, **updater_kw) -> "KnowledgeBase":
        """Fold ``new_triples`` into this artifact and return a NEW
        KnowledgeBase on the same device (this one is immutable by
        convention): grown tables for unseen ids, warm-initialised new
        rows, a fine-tune of the touched rows only, the graph extended —
        see ``repro_torch.online.OnlineUpdater`` for the knobs (epochs,
        seed, scope, delta_dir, vocab, ...)."""
        from repro_torch.online import OnlineUpdater
        return OnlineUpdater(self, **updater_kw).update(new_triples)

    # -- serving -----------------------------------------------------------

    def engine(self, *, n_workers: int = 1, backend: str = "vmap",
               mesh=None, chunk: Optional[int] = None,
               table_sharding: str = "replicated") -> KGQueryEngine:
        """The query engine over this artifact's tables, cached under the
        reference's key ``(n_workers, backend, chunk, mesh, table_sharding)``.
        On the vmap backend: ``table_sharding="sharded"`` scans the entity
        table in ``n_workers`` shards, with the replicated engine's
        answers bitwise.  ``backend="shard_map"`` with ``mesh`` (a
        ``DeviceMesh``, ``parallel.util.workers_mesh``) splits the
        queries over the mesh's ranks, each of which calls every query
        collectively, with the vmap engine's answers; sharded tables
        there raise (ROADMAP.md item 12d)."""
        eval_device.check_layout(table_sharding, n_workers, backend, mesh,
                                 self.params["ent"].device)
        key = (n_workers, backend, chunk, mesh, table_sharding)
        if key not in self._engines:
            kw = {} if chunk is None else {"chunk": chunk}
            self._engines[key] = KGQueryEngine(
                self.model, self.params, norm=self.norm, n_workers=n_workers,
                backend=backend, mesh=mesh, table_sharding=table_sharding,
                **kw)
        return self._engines[key]

    def _exclude(self, a, b, side: str) -> np.ndarray:
        if self.graph is None:
            raise ValueError(
                "filtered=True needs the graph (known-neighbor masks); "
                "this KnowledgeBase was loaded without one — re-save with "
                "include_graph=True or pass filtered=False")
        pairs = np.stack(np.broadcast_arrays(
            np.atleast_1d(np.asarray(a, np.int64)),
            np.atleast_1d(np.asarray(b, np.int64))), axis=1)
        return self.graph.known_candidate_masks(pairs, side)

    def query_tails(self, heads, rels, k: int = 10,
                    filtered: bool = False, **engine_kw) -> QueryResult:
        """Top-k tail completions of ``(h, r, ?)``.  ``filtered=True``
        excludes the graph's already-known tails of each pair (serve
        *new* links).  ``engine_kw`` (``n_workers``, ``backend``, ``mesh``,
        ``chunk``, ``table_sharding``) picks the engine."""
        exclude = self._exclude(heads, rels, "tail") if filtered else None
        return self.engine(**engine_kw).query_tails(
            heads, rels, k=k, exclude=exclude)

    def query_heads(self, tails, rels, k: int = 10,
                    filtered: bool = False, **engine_kw) -> QueryResult:
        """Top-k head completions of ``(?, r, t)`` (see query_tails)."""
        exclude = self._exclude(rels, tails, "head") if filtered else None
        return self.engine(**engine_kw).query_heads(
            tails, rels, k=k, exclude=exclude)

    def query_relations(self, heads, tails, k: int = 10,
                        **engine_kw) -> QueryResult:
        """Top-k relations linking ``(h, ?, t)``."""
        return self.engine(**engine_kw).query_relations(heads, tails, k=k)

    def score(self, heads, rels, tails, **engine_kw) -> np.ndarray:
        """Energies of fully-specified triplets (lower = more plausible)."""
        return self.engine(**engine_kw).score(heads, rels, tails)

    # -- evaluation --------------------------------------------------------

    def evaluate(self, *, filtered: bool = True, engine: str = "host",
                 **engine_kw) -> dict:
        """The paper's three-task protocol on this artifact's graph —
        exactly ``repro_torch.kg.evaluate(kb)``."""
        if self.graph is None:
            raise ValueError(
                "evaluate needs the graph's valid/test splits; this "
                "KnowledgeBase was loaded without a graph")
        return kg_eval.evaluate_all(
            self.params, self.graph, norm=self.norm, filtered=filtered,
            model=self.model, engine=engine, **engine_kw)
