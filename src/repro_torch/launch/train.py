"""Training launcher of the port (port of ``repro.launch.train``'s KG path).

    PYTHONPATH=src python -m repro_torch.launch.train --kg transe \
        --kg-paradigm sgd --kg-workers 4 --kg-epochs 30

KG embedding runs route through the ``repro_torch.kg`` facade: any
registered scoring model on the synthetic KG (or a TSV dataset,
``--kg-dataset``), on the host or the device pipeline, with in-loop
evaluation, checkpoints and resume, a post-training evaluation, an online
update (``--kg-update``) and open-loop traffic through the live server
(``--kg-serve``).  Every ``--kg*`` flag keeps the reference launcher's
default, choices and help.  ``--device`` (default ``cuda``) places the
run; ``--device cpu`` runs it on the CPU, through the kernels' plain
versions.  The LM training path (``--arch`` and its flags) is ROADMAP.md
item 16e: its flags are accepted and refused.
"""
from __future__ import annotations

import argparse

from repro_torch.util import not_ported


def _run_kg(args):
    """KG-embedding path: any registered scoring model on the synthetic KG.
    Returns the fit's ``TrainResult`` (its ``.kb.graph`` the graph the
    flags named)."""
    from repro_torch import kg as kg_api
    from repro_torch.data import kg as kg_lib

    if args.kg_dataset is not None:
        from repro_torch.data import datasets

        graph = datasets.load_dataset(args.kg_dataset, seed=args.seed)
        print(f"loaded {args.kg_dataset}: {graph.n_entities} entities, "
              f"{graph.n_relations} relations, {len(graph.train)} train / "
              f"{len(graph.valid)} valid / {len(graph.test)} test triples")
    else:
        graph = kg_lib.synthetic_kg(
            args.seed, n_entities=args.kg_entities, n_relations=15,
            n_triplets=args.kg_triplets)
    schedule_kw = {}
    if args.kg_pipeline == "device":
        # one block per --kg-block-epochs (default: the whole run in a
        # single block); the progress callback fires per block
        block = (args.kg_block_epochs if args.kg_block_epochs is not None
                 else args.kg_epochs)
        schedule_kw = dict(
            pipeline="device", block_epochs=block,
            merge_every=args.kg_merge_every,
            repartition_every=args.kg_repartition_every)
    elif (args.kg_block_epochs is not None or args.kg_merge_every != 1
          or args.kg_repartition_every is not None):
        raise SystemExit(
            "--kg-block-epochs / --kg-merge-every / --kg-repartition-every "
            "schedule the device pipeline; add --kg-pipeline device (the "
            "host pipeline merges every epoch, one dispatch per epoch)")
    eval_kw = {}
    if args.kg_eval_every is not None:
        eval_kw = dict(
            eval_every=args.kg_eval_every, patience=args.kg_patience,
            eval_metric=args.kg_eval_metric,
            eval_engine=args.kg_eval_engine or "device")
    elif (args.kg_patience is not None or args.kg_trace_out is not None
          or args.kg_eval_metric != "entity_filtered.mean_rank"):
        raise SystemExit(
            "--kg-patience / --kg-trace-out / --kg-eval-metric configure "
            "the in-training evaluation loop; add --kg-eval-every K")
    ckpt_kw = {}
    if args.kg_ckpt_dir is not None:
        ckpt_kw = dict(
            ckpt_dir=args.kg_ckpt_dir,
            checkpoint_every=args.kg_checkpoint_every,
            resume=args.kg_resume)
    elif args.kg_checkpoint_every is not None or args.kg_resume:
        raise SystemExit(
            "--kg-checkpoint-every / --kg-resume configure checkpointing; "
            "add --kg-ckpt-dir DIR to say where the checkpoints live")
    if args.kg_staleness and args.kg_pipeline != "device":
        raise SystemExit(
            "--kg-staleness is the bounded-staleness device-pipeline "
            "schedule; add --kg-pipeline device")
    res = kg_api.fit(
        graph, model=args.kg, paradigm=args.kg_paradigm,
        n_workers=args.kg_workers, strategy=args.kg_strategy,
        merge_transport=args.kg_merge_transport,
        table_sharding=args.kg_table_sharding,
        partitioner=args.kg_partitioner,
        staleness=args.kg_staleness,
        negatives=args.kg_negatives,
        neg_candidates=args.kg_neg_candidates,
        backend="vmap", batch_size=256, dim=48,
        learning_rate=args.lr if args.lr is not None else 5e-2,
        epochs=args.kg_epochs, seed=args.seed, device=args.device,
        **schedule_kw, **eval_kw, **ckpt_kw,
        callback=lambda e, l: print(f"epoch {e + 1}: loss={l:.4f}", flush=True))
    print(f"[{res.model}/{args.kg_paradigm}/{args.kg_pipeline}] final loss: "
          f"{res.loss_history[-1]:.4f} (start {res.loss_history[0]:.4f}) "
          f"after {res.epochs_run} epochs")

    if res.trace is not None:
        tr = res.trace
        print(f"in-loop eval every {tr.eval_every} epochs "
              f"({len(tr.entries)} points, metric {tr.metric}):")
        for e, v in zip(tr.epochs(), tr.values()):
            print(f"  epoch {e + 1:4d}: {tr.metric}={v:.4f}")
        if tr.stopped_early:
            print(f"early-stopped (patience={args.kg_patience}); "
                  f"best epoch {tr.best_epoch + 1} "
                  f"({tr.metric}={tr.best_value:.4f})")
        if args.kg_trace_out:
            tr.to_jsonl(args.kg_trace_out)
            print(f"wrote trace to {args.kg_trace_out}")

    if args.kg_eval_engine:
        engine_kw = {}
        if args.kg_eval_engine == "device":
            # the reference splits the queries over the training workers
            engine_kw = dict(n_workers=args.kg_workers)
        metrics = kg_api.evaluate(
            res.params, res.model, graph, engine=args.kg_eval_engine,
            **engine_kw)
        print(f"eval ({args.kg_eval_engine} engine):")
        for task in ("entity_raw", "entity_filtered", "relation_prediction"):
            row = metrics.get(task)
            if row:
                print(f"  {task:20s} MR={row['mean_rank']:8.1f} "
                      f"MRR={row['mrr']:.4f} hits@10={row['hits@10']:.3f}")
        print(f"  triplet_classification_acc="
              f"{metrics['triplet_classification_acc']:.4f}")

    kb = res.kb
    delta = _read_delta(args.kg_update) if args.kg_update else None
    if args.kg_refresh_every is not None:
        if delta is None:
            raise SystemExit(
                "--kg-refresh-every streams an update delta through the "
                "serving tier; add --kg-update PATH to say which triples")
        if not args.kg_serve:
            raise SystemExit(
                "--kg-refresh-every refreshes a live server mid-stream; "
                "add --kg-serve (without it, --kg-update alone applies "
                "the delta once after training)")
    elif delta is not None:
        kb2 = kb.update(delta, epochs=8, n_workers=args.kg_workers,
                        learning_rate=args.lr if args.lr is not None
                        else 5e-2, seed=args.seed)
        print(f"applied --kg-update {args.kg_update}: {len(delta)} triples, "
              f"{kb.n_entities} -> {kb2.n_entities} entities, "
              f"{kb.n_relations} -> {kb2.n_relations} relations "
              f"[kb={kb2.fingerprint()}]")
        kb = kb2

    if args.kg_serve:
        _serve_traffic(args, kb, graph,
                       delta=delta if args.kg_refresh_every else None)
    return res


def _read_delta(path):
    """Int-id delta triples from one TSV file (``h<TAB>r<TAB>t``)."""
    import numpy as np

    from repro_torch.data import datasets

    rows = list(datasets.iter_triples(path))
    if not rows:
        raise SystemExit(f"--kg-update {path}: no triples")
    try:
        ids = [[int(h), int(r), int(t)] for h, r, t in rows]
    except ValueError:
        raise SystemExit(
            f"--kg-update {path} holds string names; the launcher takes "
            "int-id triples — intern names through the Python API "
            "(KnowledgeBase.update(..., vocab=(ent2id, rel2id)))")
    return np.asarray(ids, np.int32)


def _serve_traffic(args, kb, graph, delta=None) -> None:
    """Open-loop Poisson traffic through the live serving tier: single
    queries arrive at --kg-qps whether or not the server keeps up, the
    continuous batcher forms them into warmed bucket waves, and the
    printed stats are the latency distribution actually sustained.  With
    ``delta`` (--kg-update + --kg-refresh-every) the delta streams through
    a background RefreshDaemon in --kg-refresh-every-triple chunks while
    the traffic runs, each chunk hot-swapping a refreshed artifact into
    the server."""
    import time

    import numpy as np

    from repro_torch.serve import KGServer

    rng = np.random.default_rng(args.seed)
    n = args.kg_requests
    picks = graph.test[rng.integers(0, len(graph.test), size=n)]
    arrivals = rng.exponential(1.0 / args.kg_qps, size=n).cumsum()
    chunks = []
    if delta is not None:
        step = max(1, args.kg_refresh_every)
        chunks = [delta[i:i + step] for i in range(0, len(delta), step)]
        # spread the chunk submissions across the request stream
        submit_at = {max(1, n // (len(chunks) + 1)) * (i + 1): c
                     for i, c in enumerate(chunks)}
    with KGServer(kb, max_batch=16, max_wait_us=2000, default_k=5,
                  warm=True) as server:
        daemon = None
        if chunks:
            from repro_torch.online import RefreshDaemon

            daemon = RefreshDaemon(
                server, epochs=8, n_workers=args.kg_workers,
                learning_rate=args.lr if args.lr is not None else 5e-2,
                seed=args.seed)
            daemon.start()
        futures = []
        t0 = time.perf_counter()
        for i, ((h, r, _), t_arr) in enumerate(zip(picks, arrivals)):
            lag = t_arr - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
            if daemon is not None and i in submit_at:
                daemon.submit(submit_at[i])
            futures.append(server.submit("tails", h, r, filtered=True))
        answers = [f.result(timeout=120) for f in futures]
        span = time.perf_counter() - t0
        if daemon is not None:
            daemon.flush(timeout=600)
            daemon.stop()
            swapped = sum(1 for a in answers
                          if a.fingerprint != kb.fingerprint())
            print(f"refreshed {daemon.refreshes}x "
                  f"({daemon.triples_applied} triples) mid-stream; "
                  f"{swapped}/{n} answers served from a refreshed "
                  f"artifact [kb={daemon.kb.fingerprint()}]")
        st = server.stats()
        print(f"served {n} queries at {args.kg_qps:.0f} offered qps "
              f"(sustained {n / span:.0f} qps): "
              f"p50={st.p50_ms:.2f}ms p99={st.p99_ms:.2f}ms | "
              f"waves={st.waves} mean_batch={st.mean_wave:.1f} "
              f"cache_hits={st.cache_hits}/{st.requests} "
              f"warm_compiles={st.warm_compiles} "
              f"steady_recompiles={st.steady_recompiles}")
        for i in range(min(3, n)):
            h, r, t = picks[i]
            a = answers[i]
            cand = ", ".join(
                f"{e}:{s:.2f}" for e, s in zip(a.ids, a.energies)
                if s != float("inf"))
            print(f"  (h={h}, r={r}, ?) -> tails [{cand}]  gold={t}  "
                  f"[kb={a.fingerprint} cached={a.cached}]")


def build_parser() -> argparse.ArgumentParser:
    """The launcher's flags: the reference's, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM architecture (required unless --kg)")
    ap.add_argument("--kg", default=None, metavar="MODEL",
                    help="train a KG embedding model (transe|transh|distmult)"
                         " via repro.kg.fit instead of an LM arch")
    ap.add_argument("--kg-paradigm", default="sgd", choices=["sgd", "bgd"])
    ap.add_argument("--kg-workers", type=int, default=4)
    ap.add_argument("--kg-strategy", default="average")
    ap.add_argument("--kg-merge-transport", default="dense",
                    choices=["dense", "sparse"],
                    help="Reduce payload: full tables, or compact "
                         "touched-row deltas (bit-identical results; "
                         "sparse wins at large entity counts)")
    ap.add_argument("--kg-table-sharding", default="replicated",
                    choices=["replicated", "sharded"],
                    help="'sharded' keeps only this worker's entity-table "
                         "block resident between merge steps and reduces "
                         "sparse deltas shard-locally (bit-identical to "
                         "replicated; requires --kg-merge-transport sparse)")
    ap.add_argument("--kg-partitioner", default=None,
                    choices=["balanced", "stratified", "degree", "overlap"],
                    help="host-side triplet partitioner (default balanced; "
                         "'degree' = degree-stratified, 'overlap' = greedy "
                         "overlap-minimizing — see data/kg.PARTITIONERS)")
    ap.add_argument("--kg-staleness", type=int, default=0, metavar="S",
                    help="bounded-staleness Reduce: workers re-read the "
                         "merged tables only every 1..S+1 rounds (0 = "
                         "synchronous; needs --kg-pipeline device)")
    ap.add_argument("--kg-negatives", default="pertriplet",
                    choices=["pertriplet", "joint"],
                    help="negative sampling: one corruption per positive "
                         "(the reference) or a shared per-batch candidate "
                         "pool scored jointly (DGL-KE style)")
    ap.add_argument("--kg-neg-candidates", type=int, default=0, metavar="C",
                    help="cap the joint candidate pool at C (0 = the whole "
                         "batch's corruptions; needs --kg-negatives joint)")
    ap.add_argument("--kg-dataset", default=None, metavar="PATH",
                    help="train on a real TSV dataset (head<TAB>relation"
                         "<TAB>tail; a file or a dir with train/valid/"
                         "test.txt) instead of the synthetic graph; "
                         "--kg-entities/--kg-triplets are ignored")
    ap.add_argument("--kg-epochs", type=int, default=30)
    ap.add_argument("--kg-entities", type=int, default=2000)
    ap.add_argument("--kg-triplets", type=int, default=20000)
    ap.add_argument("--kg-pipeline", default="host",
                    choices=["host", "device"],
                    help="'device' runs epochs as compiled scan blocks with "
                         "on-device batching and negative sampling")
    ap.add_argument("--kg-block-epochs", type=int, default=None,
                    help="device pipeline: epochs per compiled block "
                         "(default: all epochs in one block)")
    ap.add_argument("--kg-merge-every", type=int, default=1,
                    help="device pipeline, sgd paradigm: local epochs "
                         "between Reduce merges")
    ap.add_argument("--kg-repartition-every", type=int, default=None,
                    help="device pipeline: re-split triplets across "
                         "workers on device every M epochs (kills residual "
                         "split bias)")
    ap.add_argument("--kg-eval-every", type=int, default=None,
                    help="run the eval protocol every K epochs from inside "
                         "fit (Reduce boundaries; device pipeline: multiple "
                         "of --kg-merge-every) and print the "
                         "quality-vs-epoch trace")
    ap.add_argument("--kg-eval-metric",
                    default="entity_filtered.mean_rank",
                    help="dotted spec into the eval output driving early "
                         "stopping / best-params selection (e.g. "
                         "entity_filtered.mean_rank, entity_raw.hits@10, "
                         "triplet_classification_acc)")
    ap.add_argument("--kg-patience", type=int, default=None,
                    help="early-stop after this many consecutive "
                         "non-improving in-loop evals (needs "
                         "--kg-eval-every)")
    ap.add_argument("--kg-trace-out", default=None, metavar="PATH",
                    help="write the in-loop eval trace as JSONL (one "
                         "boundary eval per line; needs --kg-eval-every)")
    ap.add_argument("--kg-ckpt-dir", default=None, metavar="DIR",
                    help="checkpoint directory for the KG run (atomic "
                         "step_N layout with a model/seed/graph manifest)")
    ap.add_argument("--kg-checkpoint-every", type=int, default=None,
                    help="snapshot params every K epochs (a Reduce "
                         "boundary; default: final state only; needs "
                         "--kg-ckpt-dir)")
    ap.add_argument("--kg-resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--kg-ckpt-dir and train to --kg-epochs total — "
                         "bit-identical to the unbroken run")
    ap.add_argument("--kg-update", default=None, metavar="PATH",
                    help="after training, fold a TSV of int-id delta "
                         "triples (h<TAB>r<TAB>t; new ids grow the "
                         "tables) into the artifact via kb.update() — "
                         "the masked online fine-tune, not a retrain")
    ap.add_argument("--kg-refresh-every", type=int, default=None,
                    metavar="N",
                    help="with --kg-serve + --kg-update: stream the delta "
                         "through a background RefreshDaemon in N-triple "
                         "chunks while traffic runs, hot-swapping each "
                         "refreshed artifact into the live server")
    ap.add_argument("--kg-serve", action="store_true",
                    help="after training, stand up the live serving tier "
                         "(serve.KGServer: continuous batching, bucket "
                         "warmup, answer cache) and drive open-loop "
                         "Poisson link-prediction traffic through it")
    ap.add_argument("--kg-qps", type=float, default=200.0,
                    help="offered open-loop arrival rate for --kg-serve "
                         "(requests fire on a Poisson clock whether or "
                         "not the server keeps up)")
    ap.add_argument("--kg-requests", type=int, default=500,
                    help="number of queries --kg-serve drives")
    ap.add_argument("--kg-eval-engine", default=None,
                    choices=["host", "device"],
                    help="run the three-task eval protocol after training: "
                         "'host' = reference loop, 'device' = compiled "
                         "batched engine sharded over --kg-workers.  With "
                         "--kg-eval-every it also selects the in-loop eval "
                         "engine (default 'device' there — 'host' makes "
                         "every boundary eval pay the reference loop)")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None,
                    help="default 3e-3 for LM archs, 5e-2 for --kg")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["sgd", "adamw", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "pod", "multi-pod"],
                    help="'none' = local devices unsharded")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the run's tensors live: 'cuda' (the "
                         "default) or 'cpu' (the kernels' plain versions)")
    return ap


def main(argv=None):
    """Run the launcher on ``argv``; a ``--kg`` run returns its
    ``TrainResult``."""
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.kg:
        return _run_kg(args)
    if not args.arch:
        ap.error("--arch is required unless --kg is given")
    raise not_ported("the LM launcher (LM training)", "16e")


if __name__ == "__main__":
    main()
