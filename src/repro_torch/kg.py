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
Reduce) or 'bgd' (gradient Reduce), with simulated workers, on the host
pipeline (one epoch at a time) or the device pipeline (``pipeline=
"device"``: blocks of epochs drawn on the device, with ``merge_every``
local epochs between Reduces and ``repartition_every``); see
``repro_torch.core.mapreduce``.  ``fit(eval_every=K)`` traces quality
against epochs from inside the loop, and ``fit(ckpt_dir=,
checkpoint_every=, resume=True)`` checkpoints and resumes bit-identically.
``fit(merge_transport="sparse")`` trains on compact tables of the rows a
step references and Reduces packed deltas of the touched rows, with the
dense transport's bits.  ``update(kb, new_triples)`` folds new triples
into a trained artifact (the online tier, ``repro_torch.online``).
``fit(backend="shard_map", mesh=...)`` and ``evaluate(...,
backend="shard_map", mesh=...)`` run over the ranks of a
``torch.distributed`` mesh, every rank calling them
(``repro_torch.parallel.util``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import kb as kb_lib
from repro_torch import resolve_device
from repro_torch.core import eval as kg_eval
from repro_torch.core import mapreduce
from repro_torch.core import trace as trace_lib
from repro_torch.core.models import KGConfig, KGModel, available, get_model
from repro_torch.parallel import util as par
from repro_torch.train import checkpoint as checkpoint_lib

TrainResult = mapreduce.TrainResult
EpochSchedule = mapreduce.EpochSchedule
KnowledgeBase = kb_lib.KnowledgeBase
TrainingTrace = trace_lib.TrainingTrace


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
    reduce_impl: str = "psum",
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
    donate_params: Optional[bool] = None,
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

    ``pipeline='device'`` runs epochs in blocks of ``block_epochs`` with
    batches, negatives and merge priorities drawn on the device (the same
    bits for any block size); ``merge_every=K`` lets SGD workers take K
    local epochs between Reduces; ``repartition_every=M`` re-splits the
    triplets across workers on the device every M epochs;
    ``donate_params`` (default on) lets each block drop the tables it was
    given early (``MapReduceConfig.donate_params``).  ``pipeline='host'``
    (the default) runs one epoch at a time.

    ``merge_transport='sparse'`` makes every Reduce exchange only the rows
    the round's touch stats mark updated (static-capacity padded delta
    buffers) instead of whole tables, and every SGD step work on compact
    tables of the rows its batch references — bit-identical results on
    every strategy, paradigm and pipeline (see the transport section of
    ``core/merge.py``); 'dense' (the default) is the reference.
    ``touched_capacity`` overrides the analytic per-round touched-row
    bound of the sparse delta buffers (rows per worker per Reduce); an
    undersized override is rejected at config time and an overflow at run
    time raises instead of silently dropping updates.
    ``table_sharding='sharded'`` (which requires the sparse transport)
    routes every merged row to the shard that owns it; on the vmap
    backend the result is the replicated layout's, bitwise.
    ``staleness=S > 0`` (SGD on the device pipeline) lets each worker
    train on its own copy for up to S rounds between adoptions of the
    global view (``core/mapreduce.py``).  ``backend='shard_map'`` runs the
    workers over the ranks of a mesh (see :func:`fit`), its dense SGD
    Reduce by ``reduce_impl``: 'psum' (all-reduces) or 'allgather' (the
    vmap bits).  Options of the reference that are not ported raise,
    naming their ROADMAP.md item."""
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
        reduce_impl=reduce_impl,
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
        donate_params=donate_params,
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
    eval_every: Optional[int] = None,
    eval_metric: str = "entity_filtered.mean_rank",
    patience: Optional[int] = None,
    eval_engine: str = "device",
    eval_filtered: bool = True,
    eval_kw: Optional[dict] = None,
    keep_best: bool = True,
    ckpt_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
    keep_checkpoints: int = 3,
    sync_checkpoints: bool = False,
    device=None,
    draws=None,
    stale_offsets=None,
    mesh=None,
    **config_kw,
) -> TrainResult:
    """Train ``model`` on the port ``KG`` ``kg`` with the MapReduce engine.

    ``config_kw`` forwards to :func:`make_configs` (dim, margin, norm,
    learning_rate, n_workers, strategy, batch_size, partition, pipeline,
    block_epochs, merge_every, repartition_every, donate_params, ...).
    The tables live on ``device``: the GPU by default (raises without
    one), ``"cpu"`` on request; a resumed run restores onto it too.
    ``draws`` and ``stale_offsets`` (``mapreduce.train``) replace the
    port's own per-epoch random draws and staleness refresh phases.
    ``callback`` fires every epoch on the host pipeline and at block
    boundaries on the device pipeline.
    Returns a :class:`TrainResult` whose ``.kb`` is the trained
    :class:`KnowledgeBase`.

    In-training evaluation (``core/trace.py``): ``eval_every=K`` runs the
    full evaluation protocol after every K-th epoch and after the last
    (every epoch ends in a Reduce) and attaches a :class:`TrainingTrace`
    to the result; each entry's metrics are exactly what a later
    :func:`evaluate` of the same params returns.  ``eval_metric`` (a
    dotted spec, default the filtered mean rank) drives ``patience``
    early stopping (stop after that many consecutive non-improving
    evaluations) and, with ``keep_best``, the ``best_params`` /
    ``best_epoch`` of the result.  ``eval_engine`` defaults to the device
    engine; ``eval_kw`` forwards its options (``chunk``, ``fused``,
    ``max_fanout``).  Unlike the reference, ``fit`` adds no
    ``n_workers`` to them: the port's device engine has no worker axis
    (the reference's only splits the query axis, which changes no
    number).

    Checkpoint/resume: ``ckpt_dir`` + ``checkpoint_every=K`` save params
    and manifest every K epochs (``None``: the final state only; the last
    epoch, an early stop included, is always saved; saves are async
    unless ``sync_checkpoints``; the newest ``keep_checkpoints`` steps
    stay).  ``resume=True`` restores the latest checkpoint in ``ckpt_dir``
    after checking its model, seed, graph fingerprint and training config
    against this call, and continues to ``epochs`` in all, bit-identically
    to the unbroken run.  Checkpoints are the reference's format: either
    package resumes the other's.

    In-loop evaluations and checkpoints land on Reduce boundaries: on the
    device pipeline ``eval_every`` and ``checkpoint_every`` must be
    multiples of ``merge_every``, as must ``epochs``.

    ``merge_transport='sparse'`` and ``touched_capacity`` (see
    :func:`make_configs`) give the dense transport's bits, so a checkpoint
    of either transport resumes under the other.

    Bounded staleness (``staleness=S``) cannot checkpoint or resume;
    ``table_sharding`` is not part of a checkpoint's config, so a
    checkpoint moves between the layouts.

    ``backend='shard_map'`` with ``mesh=`` (a ``DeviceMesh`` with a
    ``"workers"`` dimension of M ranks, ``parallel.util.workers_mesh``):
    every rank calls ``fit`` with the same arguments, as under
    ``torchrun``, runs W/M of the W workers and returns the same result
    (``mapreduce.train``).  In-training evaluations on the device engine
    split the queries over the same mesh; only rank 0 writes checkpoints,
    and the ranks meet before a resume reads one.  Bounded staleness and
    sharded tables there are not ported yet (ROADMAP.md item 12d)."""
    if mesh is not None:
        par.check_mesh(mesh, device)
    device = resolve_device(device)
    model = get_model(model)
    kcfg, mcfg = make_configs(kg, model, paradigm, **config_kw)
    shard = mcfg.backend == "shard_map"
    if shard:
        mapreduce._check_mesh(mcfg, mesh, device)

    ckpt_cfg = None
    resume_kw: dict = {}
    if ckpt_dir is not None:
        ckpt_cfg = mapreduce.CheckpointConfig(
            ckpt_dir=ckpt_dir, every=checkpoint_every,
            keep=keep_checkpoints, synchronous=sync_checkpoints)
    else:
        ckpt_only = {
            "checkpoint_every": checkpoint_every is not None,
            "resume": resume,
            "keep_checkpoints": keep_checkpoints != 3,
            "sync_checkpoints": sync_checkpoints,
        }
        passed = sorted(k for k, hit in ckpt_only.items() if hit)
        if passed:
            raise ValueError(
                f"{passed} configure checkpointing and need ckpt_dir= "
                "to say where the checkpoints live")
    if resume:
        if params is not None:
            raise ValueError(
                "pass either resume=True (params come from the latest "
                "checkpoint) or params=, not both")
        template = model.init_params(torch.Generator(), kcfg, device="meta")
        if shard:               # rank 0 may have written the latest step
            par.barrier(mesh)
        _, params, extra = checkpoint_lib.restore(
            ckpt_dir, params_template=template,
            expect={"kind": "kg_train", "model": model.name,
                    "seed": seed, "graph": kg.fingerprint(),
                    "config": mapreduce.resume_config(kcfg, mcfg)})
        resume_kw = dict(
            start_epoch=int(extra["epoch"]),
            resume_fresh_init=bool(extra.get("fresh_init", True)),
            prior_history=list(extra.get("loss_history") or []),
        )
    eval_loop = None
    if eval_every is not None:
        engine_kw = dict(eval_kw or {})
        if shard and eval_engine == "device":
            engine_kw.update(backend="shard_map", mesh=mesh,
                             n_workers=mcfg.n_workers)
        eval_loop = trace_lib.EvalLoopConfig(
            eval_every=eval_every, metric=eval_metric, patience=patience,
            engine=eval_engine, filtered=eval_filtered,
            engine_kw=engine_kw, keep_best=keep_best)
    else:
        non_defaults = {
            "eval_metric": eval_metric != "entity_filtered.mean_rank",
            "patience": patience is not None,
            "eval_engine": eval_engine != "device",
            "eval_filtered": eval_filtered is not True,
            "eval_kw": eval_kw is not None,
            "keep_best": keep_best is not True,
        }
        passed = sorted(k for k, hit in non_defaults.items() if hit)
        if passed:
            raise ValueError(
                f"{passed} configure the in-training evaluation loop and "
                "would be silently ignored — pass eval_every=K to enable "
                "it")
    res = mapreduce.train(
        kg, kcfg, mcfg, epochs=epochs, seed=seed, params=params,
        callback=callback, model=model, device=device, draws=draws,
        eval_loop=eval_loop, checkpoint=ckpt_cfg,
        stale_offsets=stale_offsets, mesh=mesh, **resume_kw)
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
    ``max_fanout``, ``n_workers``, ``table_sharding``, and
    ``backend="shard_map"`` with ``mesh=``: every rank of the mesh calls
    ``evaluate`` and the query axis splits over them) ride in
    ``engine_kw`` — see
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


def update(kb, new_triples, **updater_kw) -> "kb_lib.KnowledgeBase":
    """Fold ``new_triples`` into a trained artifact and return a NEW
    :class:`KnowledgeBase`: ``kg.update(kb, triples)`` is
    ``kb.update(triples)``.  Unseen entities and relations get the ids a
    fresh ``load_tsv_dir`` would intern, the grown tables warm-start from
    their neighbours, and a short masked fine-tune moves only the rows the
    delta touches (``repro_torch.online.OnlineUpdater``)."""
    if not isinstance(kb, kb_lib.KnowledgeBase):
        raise TypeError(
            f"update() takes a KnowledgeBase artifact, got {type(kb)!r} — "
            "train one with kg.fit(...).kb or load one with "
            "KnowledgeBase.load")
    return kb.update(new_triples, **updater_kw)
