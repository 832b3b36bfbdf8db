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

To take the init table out of that comparison, one package's init is
handed to both.  ``--save-init DIR`` (``repro_torch`` only) writes each
seed's init tables, the ones ``kg.fit(params=None)`` draws there, to
``DIR/seed{S}.npz`` before training; ``--init-from DIR`` (either package)
starts every cell of seed ``S`` from ``DIR/seed{S}.npz`` through
``kg.fit(params=...)``.  Each run still imports one package:

    PYTHONPATH=src python tools/quality_seeds.py --package repro_torch \
        --device cpu --settings sgd-miniloss --seeds 0 1 --save-init inits
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/quality_seeds.py \
        --package repro --settings sgd-miniloss --seeds 0 1 \
        --init-from inits
"""
import argparse
import importlib
import json
import os
import time

import numpy as np

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
    ap.add_argument("--save-init", metavar="DIR",
                    help="repro_torch only: write each seed's init tables "
                         "to DIR/seed{S}.npz")
    ap.add_argument("--init-from", metavar="DIR",
                    help="start every cell of seed S from DIR/seed{S}.npz")
    args = ap.parse_args()
    if args.save_init and args.package != "repro_torch":
        ap.error("--save-init writes the port's init: --package repro_torch")
    if args.save_init and args.init_from:
        ap.error("--save-init and --init-from exclude each other")

    kg_api = importlib.import_module(f"{args.package}.kg")
    kg_lib = importlib.import_module(f"{args.package}.data.kg")
    extra = {"device": args.device} if args.package == "repro_torch" else {}

    for seed in args.seeds:
        graph = kg_lib.synthetic_kg(seed, n_entities=args.entities,
                                    n_relations=15,
                                    n_triplets=args.triplets)
        params = None
        if args.save_init:
            params = save_port_init(graph, seed, args.save_init)
        elif args.init_from:
            with np.load(init_path(args.init_from, seed)) as z:
                params = {name: z[name] for name in z.files}
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
                             epochs=args.epochs, seed=seed, params=params,
                             **kw, **extra)
            ef = kg_api.evaluate(res.kb)["entity_filtered"]
            rows[label] = {"mean_rank": float(ef["mean_rank"]),
                           "hits@10": float(ef["hits@10"]),
                           "s": time.time() - t0}
        base = rows["single-thread"]["hits@10"]
        for row in rows.values():
            row["retention"] = row["hits@10"] / base if base else None
        init = ("own" if args.init_from is None
                else os.path.abspath(args.init_from))
        print(json.dumps({"package": args.package, "seed": seed,
                          "init": init, "rows": rows}), flush=True)


def init_path(directory: str, seed: int) -> str:
    return os.path.join(directory, f"seed{seed}.npz")


def save_port_init(graph, seed: int, directory: str) -> dict:
    """The port's init tables of ``seed`` for ``graph`` (what
    ``repro_torch.kg.fit(params=None, seed=seed)`` draws: the model's
    ``init_params`` from ``torch.Generator().manual_seed(seed)``), written
    to ``directory/seed{seed}.npz`` and returned as numpy arrays."""
    import torch
    from repro_torch.core.models import get_model
    from repro_torch.kg import make_configs

    kcfg, _ = make_configs(graph, "transe", "sgd", dim=50, margin=1.0,
                           norm="l1", learning_rate=0.05)
    tables = get_model("transe").init_params(
        torch.Generator().manual_seed(seed), kcfg, device="cpu")
    out = {name: t.numpy() for name, t in tables.items()}
    os.makedirs(directory, exist_ok=True)
    np.savez(init_path(directory, seed), **out)
    return out


if __name__ == "__main__":
    main()
