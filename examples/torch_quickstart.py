"""Quickstart on the PyTorch port: the `repro_torch.kg` facade end to
end — train any registered scoring model (TransE / TransH / DistMult) with
the paper's MapReduce engine, evaluate it with the paper's protocol, then
treat the result as a persistent, serveable `KnowledgeBase`: save → load →
query.  Runs on the GPU; `--device cpu` runs it on the CPU.

    PYTHONPATH=src python examples/torch_quickstart.py [--model transe]
        [--save-dir DIR] [--device cuda|cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import kg as kg_api
from repro_torch.data import kg as kg_lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="transe", choices=kg_api.models())
    ap.add_argument("--save-dir", default=None,
                    help="where the trained KnowledgeBase artifact lands "
                         "(default: a temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="where the tables live: 'cuda' (default) or 'cpu'")
    args = ap.parse_args()

    print("building synthetic planted-translation KG ...")
    graph = kg_lib.synthetic_kg(0, n_entities=1000, n_relations=10,
                                n_triplets=10000)
    print(f"  entities={graph.n_entities} relations={graph.n_relations} "
          f"train/valid/test="
          f"{len(graph.train)}/{len(graph.valid)}/{len(graph.test)}")

    # n_workers=1 reproduces single-thread Algorithm 1 (the paper's baseline);
    # bump n_workers / pick paradigm="bgd" for the parallel variants.
    print(f"training single-thread {args.model} (Algorithm 1) ...")
    res = kg_api.fit(
        graph, model=args.model, paradigm="sgd",
        n_workers=1, backend="vmap", batch_size=256,
        dim=48, margin=1.0, norm="l1", learning_rate=0.05,
        epochs=60, seed=0, device=args.device,
        callback=lambda e, l: (e + 1) % 10 == 0 and print(
            f"  epoch {e + 1}: loss={l:.4f}"))

    print("evaluating: entity inference / relation prediction / "
          "triplet classification ...")
    m = kg_api.evaluate(res.kb)
    ef = m["entity_filtered"]
    print(f"  entity inference (filtered): mean_rank={ef['mean_rank']:.1f} "
          f"hits@10={ef['hits@10']:.3f}")
    rp = m["relation_prediction"]
    print(f"  relation prediction: hits@1={rp['hits@1']:.3f} "
          f"mean_rank={rp['mean_rank']:.2f}")
    print(f"  triplet classification acc={m['triplet_classification_acc']:.3f}")

    # --- the artifact round-trip: save -> load -> query -------------------
    save_dir = args.save_dir or os.path.join(
        tempfile.mkdtemp(prefix="repro_kb_"), "kb")
    print(f"saving the trained KnowledgeBase to {save_dir} ...")
    res.kb.save(save_dir)

    print("loading it back (as a serving process would) ...")
    kb = kg_api.KnowledgeBase.load(save_dir, device=args.device)
    print(f"  model={kb.model.name} entities={kb.n_entities} "
          f"relations={kb.n_relations} dim={kb.dim}")

    n = 3
    h, r, t = (graph.test[:n, i] for i in range(3))
    print(f"querying top-5 tail completions for {n} held-out (h, r) pairs "
          "(filtered: known links excluded — these are NEW-link "
          "candidates, so the held-out gold, itself a known triplet, is "
          "excluded too; its filtered rank is shown alongside):")
    top = kb.query_tails(h, r, k=5, filtered=True)
    # where the gold lands among all entities: the eval engine's filtered
    # rank, served for ad-hoc triplets through the same scan kg.evaluate
    # runs (bit-identical — see serve/kg_engine.rank)
    gold_rank = kb.engine().rank(
        graph.test[:n], "tail",
        cand_masks=graph.eval_filter_candidates()[0][:n])
    for i in range(n):
        cand = ", ".join(f"{int(e)}" for e in top.ids[i])
        print(f"  (h={h[i]}, r={r[i]}, ?) -> [{cand}]  "
              f"gold={t[i]} ranks #{gold_rank[i]}/{kb.n_entities}")
    rels = kb.query_relations(h, t, k=3)
    for i in range(n):
        print(f"  (h={h[i]}, ?, t={t[i]}) -> "
              f"{[int(x) for x in rels.ids[i]]}  gold={r[i]}")
    print(f"  score(h, r, t) energies: "
          f"{[round(float(s), 3) for s in kb.score(h, r, t)]}")


if __name__ == "__main__":
    main()
