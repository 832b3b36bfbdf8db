"""Top-level API of the port, built around the
:class:`~repro_torch.kb.KnowledgeBase` artifact (port of ``repro.kg``).

    from repro_torch import kg
    from repro_torch.data import kg as kg_lib

    graph = kg_lib.synthetic_kg(0)
    result = kg.fit(graph, model="transe", paradigm="sgd", epochs=50)
    kb = result.kb                        # the trained artifact, on the GPU
    kb.save("my_kb")
    kb = kg.KnowledgeBase.load("my_kb")   # saved by either package
    metrics = kg.evaluate(kb, engine="device")

``fit`` runs on the GPU by default and raises without one; pass
``device="cpu"`` to train on the CPU (the kernels' plain versions).
``paradigm`` is the paper's 'sgd' (local epochs + conflict-resolving
Reduce) or 'bgd' (gradient Reduce), on the host pipeline with simulated
workers; see ``repro_torch.core.mapreduce``.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch import kb as kb_lib
from repro_torch.core import eval as kg_eval
from repro_torch.core import mapreduce
from repro_torch.core.models import KGConfig, KGModel, available, get_model
from repro_torch.util import not_ported

TrainResult = mapreduce.TrainResult
EpochSchedule = mapreduce.EpochSchedule
KnowledgeBase = kb_lib.KnowledgeBase

# the reference's in-training evaluation and checkpoint/resume arguments
_ITEM_9_ARGS = (
    "eval_every", "eval_metric", "patience", "eval_engine", "eval_filtered",
    "eval_kw", "keep_best", "ckpt_dir", "checkpoint_every", "resume",
    "keep_checkpoints", "sync_checkpoints")


def models() -> tuple:
    """Names of all registered scoring models."""
    return available()


def make_configs(
    kg,
    model: "str | KGModel" = "transe",
    paradigm: str = "sgd",
    *,
    dim: int = 50,
    margin: float = 1.0,
    norm: str = "l1",
    learning_rate: float = 0.01,
    normalize: str = "epoch",
    sampling: str = "unif",
    n_workers: int = 4,
    strategy: str = "average",
    merge_transport: str = "dense",
    backend: str = "vmap",
    batch_size: int = 256,
    partition: str = "balanced",
    partitioner: Optional[str] = None,
    pipeline: str = "host",
    block_epochs: int = 1,
    merge_every: int = 1,
    repartition_every: Optional[int] = None,
    strict_batching: bool = False,
    table_sharding: str = "replicated",
    touched_capacity: Optional[int] = None,
    staleness: int = 0,
    negatives: str = "pertriplet",
    neg_candidates: int = 0,
) -> tuple:
    """The ``(KGConfig, MapReduceConfig)`` pair ``fit`` uses, exposed for
    callers that drive epochs by hand.  The defaults are the paper's TransE
    setting: dim 50, L1, margin 1, lr 0.01, per-epoch normalization,
    uniform negatives, 4 workers, batch 256, balanced split, the
    ``average`` Reduce.  ``partitioner`` is an alias of ``partition``.
    Options of the reference that are not ported raise, naming their
    ROADMAP.md item."""
    model = get_model(model)
    if partitioner is not None:
        partition = partitioner
    kcfg = KGConfig(
        n_entities=kg.n_entities,
        n_relations=kg.n_relations,
        dim=dim,
        margin=margin,
        norm=norm,
        learning_rate=learning_rate,
        normalize=normalize,
        sampling=sampling,
        negatives=negatives,
        neg_candidates=neg_candidates,
    )
    mcfg = mapreduce.MapReduceConfig(
        n_workers=n_workers,
        paradigm=paradigm,
        strategy=strategy,
        merge_transport=merge_transport,
        backend=backend,
        batch_size=batch_size,
        partition=partition,
        model=model.name,
        pipeline=pipeline,
        schedule=mapreduce.EpochSchedule(
            block_epochs=block_epochs, merge_every=merge_every,
            repartition_every=repartition_every),
        strict_batching=strict_batching,
        table_sharding=table_sharding,
        touched_capacity=touched_capacity,
        staleness=staleness,
    )
    return kcfg, mcfg


def fit(
    kg,
    model: "str | KGModel" = "transe",
    paradigm: str = "sgd",
    *,
    epochs: int = 50,
    seed: int = 0,
    params=None,
    callback: Optional[Callable[[int, float], None]] = None,
    device=None,
    draws=None,
    **config_kw,
) -> TrainResult:
    """Train ``model`` on the port ``KG`` ``kg`` with the MapReduce engine.

    ``config_kw`` forwards to :func:`make_configs` (dim, margin, norm,
    learning_rate, n_workers, strategy, batch_size, partition, ...).  The
    tables live on ``device``: the GPU by default (raises without one),
    ``"cpu"`` on request.  ``draws`` (``mapreduce.train``) replaces the
    port's own per-epoch random draws.  Returns a :class:`TrainResult`
    whose ``.kb`` is the trained :class:`KnowledgeBase`.

    The reference's in-training evaluation (``eval_every`` and its
    options) and checkpoint/resume (``ckpt_dir``, ``checkpoint_every``,
    ``resume``, ...) are not ported yet (ROADMAP.md item 9), nor is
    ``mesh=`` (item 12): passing any raises."""
    for name in _ITEM_9_ARGS:
        if name in config_kw:
            raise not_ported(f"kg.fit({name}=...)", 9)
    if "mesh" in config_kw:
        raise not_ported("kg.fit(mesh=...) (the shard_map backend)", 12)
    model = get_model(model)
    kcfg, mcfg = make_configs(kg, model, paradigm, **config_kw)
    res = mapreduce.train(
        kg, kcfg, mcfg, epochs=epochs, seed=seed, params=params,
        callback=callback, model=model, device=device, draws=draws)
    res.kb = kb_lib.KnowledgeBase(
        model=model, params=res.params, graph=kg, norm=kcfg.norm,
        meta={"paradigm": paradigm, "epochs": res.epochs_run, "seed": seed,
              "dim": kcfg.dim})
    return res


def evaluate(
    params,
    model: "str | KGModel | None" = None,
    kg=None,
    *,
    norm: Optional[str] = None,
    filtered: bool = True,
    engine: str = "host",
    **engine_kw,
) -> dict:
    """All three paper tasks (entity inference, relation prediction,
    triplet classification).

    Accepts a :class:`KnowledgeBase` (``evaluate(kb)`` — model, graph and
    norm come from the artifact; any explicitly passed value overrides) or
    the raw ``(params, model, kg)`` triple.  ``engine="host"`` is the
    reference protocol loop, ``engine="device"`` the device engine
    (identical numbers); its options (``chunk``, ``fused``,
    ``max_fanout``) ride in ``engine_kw`` — see
    ``repro_torch.core.eval_device.evaluate_all_device``."""
    if isinstance(params, kb_lib.KnowledgeBase):
        kb = params
        params = kb.params
        model = kb.model if model is None else model
        kg = kb.graph if kg is None else kg
        norm = kb.norm if norm is None else norm
        if kg is None:
            raise ValueError(
                "this KnowledgeBase carries no graph (loaded with "
                "include_graph=False?) — pass kg= explicitly")
    elif model is None or kg is None:
        raise TypeError(
            "evaluate(params, ...) needs model= and kg= when params is a "
            "raw table dict (or pass a KnowledgeBase)")
    return kg_eval.evaluate_all(
        params, kg, norm=norm or "l1", filtered=filtered, model=model,
        engine=engine, **engine_kw
    )
