"""The online knowledge tier end-to-end on the PyTorch port (the GPU by
default, ``--device cpu`` on the CPU): train a base artifact once,
then keep it alive — fold new triples in with ``kb.update()`` (masked
fine-tune: only delta-touched rows move), persist every update as a
delta checkpoint chain, replay the chain into the exact same artifact,
and serve queries across a background refresh + hot swap.

    PYTHONPATH=src python examples/torch_online_update.py \
        [--model transe] [--epochs 60] [--update-epochs 8] [--scope touched]
        [--device cuda|cpu]

Stages:

  1. **fit** — a base ``KnowledgeBase`` on the synthetic graph.
  2. **update** — a delta of fresh triples, some naming brand-new
     entities: tables grow, new rows warm-start from their relation
     neighbors, and only delta-touched rows fine-tune (``--scope cold``
     restricts that further to rows with no training signal in the
     base).  The chain in ``--chain-dir`` gains one delta step per
     update (changed/new rows only, fingerprint-linked to its base).
  3. **replay** — ``KnowledgeBase.load_chain`` rebuilds the updated
     artifact from base + deltas, bit-identical (fingerprints printed).
  4. **serve** — a ``KGServer`` answers a query stream while a
     ``RefreshDaemon`` applies one more delta in the background and
     swaps the refreshed artifact in; every answer carries the
     fingerprint of the artifact that produced it.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import kg as kg_api
from repro_torch.data import kg as kg_lib
from repro_torch.kb import KnowledgeBase
from repro_torch.online import RefreshDaemon
from repro_torch.serve import KGServer


def make_delta(rng, n, n_entities, n_relations, n_new=0):
    """n triples over the known ids plus n_new triples introducing
    brand-new entity ids (first-seen order, like a TSV ingest would)."""
    known = np.stack([rng.integers(0, n_entities, n),
                      rng.integers(0, n_relations, n),
                      rng.integers(0, n_entities, n)], 1)
    fresh = np.stack([np.arange(n_entities, n_entities + n_new),
                      rng.integers(0, n_relations, n_new),
                      rng.integers(0, n_entities, n_new)], 1)
    return np.concatenate([known, fresh]).astype(np.int32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="transe", choices=kg_api.models())
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--update-epochs", type=int, default=8)
    ap.add_argument("--entities", type=int, default=500)
    ap.add_argument("--triplets", type=int, default=8000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--scope", default="touched",
                    choices=["touched", "cold"],
                    help="which delta rows may move: every touched row, "
                         "or only rows with no training signal in the "
                         "base (frozen-warm — avoids dragging converged "
                         "neighbors; see benchmarks/bench_online.py)")
    ap.add_argument("--chain-dir", default=None, metavar="DIR",
                    help="delta checkpoint chain directory (default: a "
                         "temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="where the tables live: 'cuda' (default) or 'cpu'")
    args = ap.parse_args()

    graph = kg_lib.synthetic_kg(0, n_entities=args.entities,
                                n_relations=12, n_triplets=args.triplets)
    chain = args.chain_dir or os.path.join(
        tempfile.mkdtemp(prefix="kb_chain_"), "chain")

    # 1. base artifact
    t0 = time.time()
    kb = kg_api.fit(graph, model=args.model, n_workers=args.workers,
                    paradigm="sgd", pipeline="device", backend="vmap",
                    batch_size=256, dim=args.dim, learning_rate=0.05,
                    block_epochs=args.epochs, epochs=args.epochs,
                    seed=0, device=args.device).kb
    print(f"base: {kb.n_entities} entities [kb={kb.fingerprint()}] "
          f"({time.time() - t0:.0f}s)", flush=True)

    # 2. two incremental updates, each a delta step in the chain
    rng = np.random.default_rng(1)
    for i, n_new in enumerate((5, 3)):
        delta = make_delta(rng, 200, kb.n_entities, kb.n_relations,
                           n_new=n_new)
        t0 = time.time()
        kb = kb.update(delta, epochs=args.update_epochs, seed=i + 1,
                       n_workers=args.workers, scope=args.scope,
                       delta_dir=chain)
        print(f"update {i + 1}: +{len(delta)} triples, +{n_new} entities "
              f"-> {kb.n_entities} [kb={kb.fingerprint()}] "
              f"({time.time() - t0:.0f}s)", flush=True)

    # 3. replay the chain: base + deltas == the artifact we just built
    replayed = KnowledgeBase.load_chain(chain, device=args.device)
    assert replayed.fingerprint() == kb.fingerprint()
    print(f"chain replay from {chain}: [kb={replayed.fingerprint()}] "
          f"(bit-identical)", flush=True)

    # 4. serve across a background refresh + hot swap
    delta = make_delta(rng, 150, kb.n_entities, kb.n_relations, n_new=2)
    with KGServer(kb, max_batch=8, default_k=5, warm=True) as server:
        with RefreshDaemon(server, epochs=args.update_epochs,
                           n_workers=args.workers, scope=args.scope,
                           seed=9) as daemon:
            futures = [server.submit(
                "tails", int(rng.integers(kb.n_entities)),
                int(rng.integers(kb.n_relations))) for _ in range(40)]
            daemon.submit(delta)                  # refresh mid-stream
            daemon.flush(timeout=600)
            futures += [server.submit(
                "tails", int(rng.integers(kb.n_entities)),
                int(rng.integers(kb.n_relations))) for _ in range(10)]
            answers = [f.result(timeout=120) for f in futures]
            swapped = sum(1 for a in answers
                          if a.fingerprint != kb.fingerprint())
            st = server.stats()
            print(f"served {len(answers)} queries across the refresh: "
                  f"{swapped} answered by the refreshed artifact "
                  f"[kb={daemon.kb.fingerprint()}], p99={st.p99_ms:.2f}ms, "
                  f"swaps={st.swaps}, "
                  f"steady_recompiles={st.steady_recompiles}", flush=True)


if __name__ == "__main__":
    main()
