#!/usr/bin/env python3
"""Hits@10 retention of MapReduce training against single-thread training,
at several seeds, in either package.

The experiment is ``examples/train_mapreduce_kg.py``'s at its defaults
(a synthetic graph of 2,000 entities, 15 relations and 20,000 triplets;
TransE, dim 50, L1, margin 1, lr 0.05, batch 256, 200 epochs, W = 4 on
the vmap backend, filtered evaluation), with the seed of the graph and
of ``kg.fit`` set to each of ``--seeds`` where the example fixes both at
0.  Each seed trains single-thread and the ``--settings`` asked for, and
prints one JSON line: filtered mean rank, hits@10 and retention (hits@10
over single-thread's) for each.

    PYTHONPATH=src python tools/quality_seeds.py --package repro_torch \\
        --device cpu --seeds 1 2 3
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/quality_seeds.py \\
        --package repro --seeds 1 2 3

``--package`` names the package that is imported (``repro_torch``, the
PyTorch port, or ``repro``, the JAX package); only that one is loaded.
The two packages draw different random numbers, so their runs at one
seed are two samples of one experiment, not one run twice.
"""
import argparse
import importlib
import json
import time

SETTINGS = {
    "bgd": dict(paradigm="bgd"),
    "sgd-average": dict(paradigm="sgd", strategy="average"),
    "sgd-miniloss": dict(paradigm="sgd", strategy="miniloss_perkey"),
    "sgd-random": dict(paradigm="sgd", strategy="random"),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", required=True,
                    choices=["repro_torch", "repro"])
    ap.add_argument("--device", default="cuda",
                    help="repro_torch only: 'cuda' (default) or 'cpu'")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--settings", nargs="+", default=list(SETTINGS),
                    choices=list(SETTINGS))
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--entities", type=int, default=2000)
    ap.add_argument("--triplets", type=int, default=20000)
    args = ap.parse_args()

    kg_api = importlib.import_module(f"{args.package}.kg")
    kg_lib = importlib.import_module(f"{args.package}.data.kg")
    extra = {"device": args.device} if args.package == "repro_torch" else {}

    for seed in args.seeds:
        graph = kg_lib.synthetic_kg(seed, n_entities=args.entities,
                                    n_relations=15,
                                    n_triplets=args.triplets)
        rows = {}
        cells = [("single-thread",
                  dict(n_workers=1, paradigm="sgd", strategy="average"))]
        cells += [(f"{name}-W{args.workers}",
                   dict(SETTINGS[name], n_workers=args.workers))
                  for name in args.settings]
        for label, kw in cells:
            kw = dict(kw)
            paradigm = kw.pop("paradigm")
            t0 = time.time()
            res = kg_api.fit(graph, model="transe", paradigm=paradigm,
                             backend="vmap", batch_size=256, dim=50,
                             margin=1.0, norm="l1", learning_rate=0.05,
                             epochs=args.epochs, seed=seed, **kw, **extra)
            ef = kg_api.evaluate(res.kb)["entity_filtered"]
            rows[label] = {"mean_rank": float(ef["mean_rank"]),
                           "hits@10": float(ef["hits@10"]),
                           "s": time.time() - t0}
        base = rows["single-thread"]["hits@10"]
        for row in rows.values():
            row["retention"] = row["hits@10"] / base if base else None
        print(json.dumps({"package": args.package, "seed": seed,
                          "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
