"""The paper's contribution end-to-end on the PyTorch port, via the
`repro_torch.kg` facade:
MapReduce-parallel KG embedding with all Reduce strategies, compared against
single-thread quality — for any registered scoring model (the paper's TransE
by default; --model transh|distmult runs the same experiment on the others).

    PYTHONPATH=src python examples/torch_train_mapreduce_kg.py \
        [--model transe] [--workers 4] [--epochs 200] \
        [--eval-every 20 --trace-out curves] [--device cuda|cpu]

With ``--eval-every K`` every setting also records its quality-vs-epoch
curve from inside ``fit`` (the in-training evaluation loop, run on the
device eval engine at Reduce boundaries), so the merge strategies can be
compared *during* training, not just at the end.

Each setting's result is handled through its ``KnowledgeBase`` artifact
(``res.kb``) — evaluation goes through it, and ``--save-prefix`` persists
every trained setting as a loadable/serveable artifact.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import kg as kg_api
from repro_torch.data import kg as kg_lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="transe", choices=kg_api.models())
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--entities", type=int, default=2000)
    ap.add_argument("--triplets", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=50)
    ap.add_argument("--pipeline", default="host", choices=["host", "device"],
                    help="'device' = scan-over-epochs engine (on-device "
                         "batching + negative sampling, one dispatch per run)")
    ap.add_argument("--merge-every", type=int, default=1,
                    help="device pipeline, sgd settings: local epochs "
                         "between Reduce merges")
    ap.add_argument("--eval-engine", default="host",
                    choices=["host", "device"],
                    help="'device' = compiled batched eval engine "
                         "(identical metrics, faster; query axis sharded "
                         "over --workers)")
    ap.add_argument("--eval-every", type=int, default=None,
                    help="evaluate every K epochs from inside fit and "
                         "print each setting's quality-vs-epoch curve "
                         "(device eval engine at Reduce boundaries; must "
                         "be a multiple of --merge-every on the device "
                         "pipeline)")
    ap.add_argument("--trace-out", default=None, metavar="PREFIX",
                    help="with --eval-every: write each setting's trace "
                         "as PREFIX.<setting>.jsonl")
    ap.add_argument("--save-prefix", default=None, metavar="PREFIX",
                    help="save each trained setting as a KnowledgeBase "
                         "artifact at PREFIX.<setting>/")
    ap.add_argument("--dataset", default=None, metavar="PATH",
                    help="run the experiment on a real TSV dataset (a "
                         "head<TAB>relation<TAB>tail file, or a dir with "
                         "train/valid/test.txt) instead of the synthetic "
                         "graph; --entities/--triplets are ignored")
    ap.add_argument("--merge-transport", default="dense",
                    choices=["dense", "sparse"],
                    help="Reduce payload: full tables or compact "
                         "touched-row deltas (bit-identical; sparse wins "
                         "on large entity counts)")
    ap.add_argument("--device", default="cuda",
                    help="where the tables live: 'cuda' (default) or 'cpu'")
    args = ap.parse_args()

    pipeline_kw = {}
    if args.pipeline == "device":
        pipeline_kw = dict(pipeline="device", block_epochs=args.epochs)

    if args.dataset is not None:
        from repro_torch.data import datasets

        graph = datasets.load_dataset(args.dataset)
        print(f"loaded {args.dataset}: {graph.n_entities} entities, "
              f"{graph.n_relations} relations, {len(graph.train)} train "
              f"triples", flush=True)
    else:
        graph = kg_lib.synthetic_kg(0, n_entities=args.entities,
                                    n_relations=15,
                                    n_triplets=args.triplets)

    results = {}
    for name, kw in [
        ("single-thread", dict(n_workers=1, paradigm="sgd", strategy="average")),
        (f"bgd-W{args.workers}",
         dict(n_workers=args.workers, paradigm="bgd")),
        (f"sgd-average-W{args.workers}",
         dict(n_workers=args.workers, paradigm="sgd", strategy="average")),
        (f"sgd-miniloss-W{args.workers}",
         dict(n_workers=args.workers, paradigm="sgd",
              strategy="miniloss_perkey")),
        (f"sgd-random-W{args.workers}",
         dict(n_workers=args.workers, paradigm="sgd", strategy="random")),
    ]:
        paradigm = kw.pop("paradigm")
        kw.update(pipeline_kw)
        if paradigm == "sgd" and args.pipeline == "device":
            kw["merge_every"] = args.merge_every
        if args.eval_every is not None:
            kw["eval_every"] = args.eval_every
        t0 = time.time()
        res = kg_api.fit(
            graph, model=args.model, paradigm=paradigm,
            backend="vmap", batch_size=256,
            merge_transport=args.merge_transport,
            dim=args.dim, margin=1.0, norm="l1", learning_rate=0.05,
            epochs=args.epochs, seed=0, device=args.device, **kw)
        eval_kw = ({"engine": "device", "n_workers": args.workers}
                   if args.eval_engine == "device" else {})
        m = kg_api.evaluate(res.kb, **eval_kw)
        ef = m["entity_filtered"]
        results[name] = (res.loss_history[-1], ef, time.time() - t0)
        print(f"{name:26s} loss={res.loss_history[-1]:.4f} "
              f"MR={ef['mean_rank']:7.1f} hits@10={ef['hits@10']:.3f} "
              f"({time.time()-t0:.0f}s)", flush=True)
        if args.save_prefix:
            path = f"{args.save_prefix}.{name}"
            res.kb.save(path)
            print(f"  saved KnowledgeBase artifact to {path}", flush=True)
        if res.trace is not None:
            curve = " ".join(
                f"{e + 1}:{mr:.1f}"
                for e, mr in zip(res.trace.epochs(), res.trace.values()))
            print(f"  {'MR curve (epoch:MR)':24s} {curve}", flush=True)
            if args.trace_out:
                path = f"{args.trace_out}.{name}.jsonl"
                res.trace.to_jsonl(path)
                print(f"  wrote {path}", flush=True)

    base = results["single-thread"][1]["hits@10"]
    print("\nhits@10 retention vs single-thread "
          "(the paper's success criterion):")
    for name, (_, ef, _) in results.items():
        keep = ef["hits@10"] / base if base else float("nan")
        print(f"  {name:26s} {keep * 100:6.1f}%")


if __name__ == "__main__":
    main()
