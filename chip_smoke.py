#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA GPU.

    python3 chip_smoke.py

1. Builds every kernel of the port from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together) and prints the build time.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   same inputs — ``rank_counts``: exact counts, L1 and L2, fp32 and bf16, at
   the evaluation chunk (B = 256 queries, E = 14,951, k = 50) and at a
   Freebase-scale table (B = 4,096, E = 1,000,000) — and times the kernel,
   the plain version and one PyTorch library call computing the same
   function (``torch.cdist`` + compare + sum, split in two calls at
   E = 1e6, whose 4.1e9 outputs one call's grid cannot hold; timed only,
   never used by the port), beside the least time the card could take.
3. Main path, through the entry points a user calls: a TransE
   ``KnowledgeBase`` (dim 50, L1, seeded random tables) over a synthetic
   graph with FB15k's entity, relation and triplet counts; save -> load;
   filtered top-k tail/head queries, relation queries and scores for 1,024
   pairs; ``rank()``; ``kg.evaluate(kb, engine="device")``.  The kernels'
   launch counters are zeroed just before and read just after.  Checks:
   fingerprints survive the round trip, answers are well formed and agree
   with the host reference protocol on a slice of the test split, and the
   kernel path agrees with the plain-scorer path on the whole split.

Prints the card's name and power limit, one JSON line with the kernel table
and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device, outside a checkout of the repository, or when
any phase fails.  Details go to ``chiprun_out/chip_smoke.json``.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

FB15K = dict(n_entities=14951, n_relations=1345, n_triplets=592213)
DIM = 50
GRAPH_BUDGET_S = 60.0        # host seconds the graph may take, else cut it
PROBE_TRIPLETS = 60000
N_QUERY_PAIRS = 1024
HOST_CHECK_ROWS = 512
KERNEL_CASES = ((14951, 256), (1_000_000, 4096))   # (E, B)
DEVICE = "cuda"
# NVIDIA H100 data sheet, dense: fp32 outside the tensor cores, HBM rate
PEAKS = {"H100 PCIe": (51e12, 2.0e12), "H100": (67e12, 3.35e12)}


def fail(msg):
    raise RuntimeError(msg)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name):
    for key, rates in PEAKS.items():
        if key in name:
            return rates
    print(f"no peak rates on record for {name!r}: bounds use the H100 SXM's",
          flush=True)
    return PEAKS["H100"]


def cuda_ms(torch, fn, reps, warmup=1):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back runs
    (CUDA events), after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall(torch, fn):
    """(result, host seconds) of ``fn``, ending in a device synchronize."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rank_counts_bound(B, E, k, itemsize, norm, rates):
    """Least milliseconds for one rank_counts call: the larger of its
    bytes (each input read once, the output written once) over the memory
    rate and its fp32 operations over the fp32 rate."""
    flops, bw = rates
    nbytes = (B + E) * k * itemsize + B * 4 + B * 4
    if norm == "l1":                  # sub + add per element pair, compare
        ops = 2 * B * E * k + B * E
    else:                             # mul + add per pair, norms, epilogue
        ops = 2 * B * E * k + 2 * k * (B + E) + 6 * B * E
    t_bytes, t_ops = nbytes / bw, ops / flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, rates):
    from repro_torch.core.models import dissimilarity
    from repro_torch.kernels import rank_topk, ref

    cases = []
    for E, B in KERNEL_CASES:
        g = torch.Generator(device=DEVICE).manual_seed(E)
        bound = 6.0 / DIM ** 0.5           # the TransE init range
        table = (torch.rand(E, DIM, generator=g, device=DEVICE) * 2 - 1) \
            * bound
        rel = torch.randn(B, DIM, generator=g, device=DEVICE)
        rel = rel / rel.norm(dim=1, keepdim=True)
        heads = torch.randint(0, E, (B,), generator=g, device=DEVICE)
        golds = torch.randint(0, E, (B,), generator=g, device=DEVICE)
        small = E == KERNEL_CASES[0][0]
        for norm in ("l1", "l2"):
            for dtype in (torch.float32, torch.bfloat16):
                tab = table.to(dtype).contiguous()
                q = (table[heads] + rel).to(dtype).contiguous()
                gold = dissimilarity(
                    q.float() - tab[golds].float(), norm).contiguous()
                got = rank_topk.rank_counts(q, tab, gold, norm=norm)
                want = ref.rank_counts_ref(q, tab, gold, norm)
                torch.cuda.synchronize()
                mismatches = int((got != want).sum())
                max_err = int((got - want).abs().max())
                ms = cuda_ms(torch, lambda: rank_topk.rank_counts(
                    q, tab, gold, norm=norm), reps=50 if small else 5)
                plain_ms = cuda_ms(torch, lambda: ref.rank_counts_ref(
                    q, tab, gold, norm), reps=3 if small else 1, warmup=0)
                qf, tf = q.float(), tab.float()
                p = 1.0 if norm == "l1" else 2.0
                # cdist's grid holds < 2**31 outputs: one call per part
                parts = -(-B * E // 2**31)
                library_ms = cuda_ms(torch, lambda: sum(
                    (torch.cdist(qf, t, p=p) < gold[:, None]).sum(1)
                    for t in tf.chunk(parts)),
                    reps=5 if small else 1, warmup=1 if small else 0)
                bound_ms, bound_by = rank_counts_bound(
                    B, E, DIM, tab.element_size(), norm, rates)
                case = {
                    "B": B, "E": E, "k": DIM, "norm": norm,
                    "dtype": str(dtype).replace("torch.", ""),
                    "count_mismatches": mismatches, "max_abs_err": max_err,
                    "mean_count": float(want.float().mean()),
                    "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "library_calls": parts,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                }
                print("rank_counts " + json.dumps(case), flush=True)
                cases.append(case)
                del got, want, qf, tf
        del table
        torch.cuda.empty_cache()
    bad = [c for c in cases if c["count_mismatches"]]
    if bad:
        fail(f"rank_counts kernel disagrees with its plain version: {bad}")
    return cases


def build_graph():
    """The FB15k-size synthetic graph, its triplet count cut (and the cut
    printed) when the probe says the full size would take the host over
    GRAPH_BUDGET_S seconds."""
    from repro_torch.data import kg as kg_data

    t0 = time.perf_counter()
    kg_data.synthetic_kg(0, FB15K["n_entities"], FB15K["n_relations"],
                         PROBE_TRIPLETS)
    probe_s = time.perf_counter() - t0
    full = FB15K["n_triplets"]
    estimate = probe_s * full / PROBE_TRIPLETS
    n_triplets = full
    if estimate > GRAPH_BUDGET_S:
        n_triplets = int(PROBE_TRIPLETS * GRAPH_BUDGET_S / probe_s)
        n_triplets = max(PROBE_TRIPLETS, n_triplets - n_triplets % 1000)
        print(f"graph cut: n_triplets {full} -> {n_triplets} (a "
              f"{PROBE_TRIPLETS}-triplet probe took {probe_s:.2f} s, full "
              f"size estimated at {estimate:.1f} s > {GRAPH_BUDGET_S:.0f} s "
              "of host time)", flush=True)
    t0 = time.perf_counter()
    graph = kg_data.synthetic_kg(0, FB15K["n_entities"],
                                 FB15K["n_relations"], n_triplets)
    seconds = time.perf_counter() - t0
    return graph, {"n_triplets_asked": n_triplets, "probe_s": probe_s,
                   "build_s": seconds, "train": len(graph.train),
                   "valid": len(graph.valid), "test": len(graph.test)}


def check_topk(res, n, k, label, known=None):
    import numpy as np

    if res.ids.shape != (n, k) or res.energies.shape != (n, k):
        fail(f"{label}: shapes {res.ids.shape} {res.energies.shape}")
    if not np.all(np.isfinite(res.energies)):
        fail(f"{label}: non-finite energies")
    if np.any(np.diff(res.energies, axis=1) < 0):
        fail(f"{label}: energies not ascending")
    if known is not None:
        for i, row in enumerate(known):
            if set(res.ids[i].tolist()) & set(row.tolist()):
                fail(f"{label}: a known (excluded) id was served, query {i}")


def main_path(torch):
    import numpy as np

    from repro_torch import kg
    from repro_torch.core import eval as host_eval
    from repro_torch.core import eval_device
    from repro_torch.core.models import KGConfig, get_model
    from repro_torch.kernels import rank_topk

    info = {}
    graph, info["graph"] = build_graph()
    print("graph " + json.dumps(info["graph"]), flush=True)
    cfg = KGConfig(graph.n_entities, graph.n_relations, dim=DIM)
    params = get_model("transe").init_params(
        torch.Generator().manual_seed(0), cfg, device=DEVICE)
    test = graph.test
    tails_known, heads_known = graph.eval_filter_candidates()

    rank_topk.rank_counts.launches = 0                # --- main path ---
    t_start = time.perf_counter()
    kb = kg.KnowledgeBase(model="transe", params=params, graph=graph,
                          norm="l1", meta={"seed": 0})
    fp = kb.fingerprint()
    with tempfile.TemporaryDirectory() as tmp:
        kb.save(tmp)
        kb, info["load_s"] = wall(
            torch, lambda: kg.KnowledgeBase.load(tmp, device=DEVICE))
    if kb.fingerprint() != fp:
        fail(f"fingerprint changed across save/load: {fp} -> "
             f"{kb.fingerprint()}")
    pairs = test[:N_QUERY_PAIRS]
    h, r, t = pairs[:, 0], pairs[:, 1], pairs[:, 2]
    tails, info["query_tails_s"] = wall(
        torch, lambda: kb.query_tails(h, r, k=10, filtered=True))
    heads, info["query_heads_s"] = wall(
        torch, lambda: kb.query_heads(t, r, k=10, filtered=True))
    rels, info["query_relations_s"] = wall(
        torch, lambda: kb.query_relations(h, t, k=10))
    scores, info["score_s"] = wall(torch, lambda: kb.score(h, r, t))
    # the same calls again: the first of each pays one-time set-up
    for name, call in (
            ("query_tails", lambda: kb.query_tails(h, r, k=10,
                                                   filtered=True)),
            ("query_heads", lambda: kb.query_heads(t, r, k=10,
                                                   filtered=True)),
            ("query_relations", lambda: kb.query_relations(h, t, k=10)),
            ("score", lambda: kb.score(h, r, t))):
        info[f"{name}_warm_s"] = wall(torch, call)[1]
    n = len(pairs)
    check_topk(tails, n, 10, "query_tails",
               graph.known_candidate_masks(pairs[:, :2], "tail"))
    check_topk(heads, n, 10, "query_heads",
               graph.known_candidate_masks(pairs[:, 1:], "head"))
    check_topk(rels, n, 10, "query_relations")
    top1 = kb.score(h, r, tails.ids[:, 0])
    if not np.array_equal(top1, tails.energies[:, 0]):
        fail("query_tails energies disagree with score() of the same "
             "triplets")
    if scores.shape != (n,) or not np.all(np.isfinite(scores)):
        fail("score(): bad output")

    before = rank_topk.rank_counts.launches
    ranks, info["rank_s"] = wall(torch, lambda: kb.engine().rank(
        test, "tail", cand_masks=tails_known))
    info["rank_launches"] = rank_topk.rank_counts.launches - before
    if info["rank_launches"] == 0:
        fail("rank() did not go through the rank_counts kernel")

    before = rank_topk.rank_counts.launches
    metrics, info["evaluate_s"] = wall(
        torch, lambda: kg.evaluate(kb, engine="device"))
    info["evaluate_launches"] = rank_topk.rank_counts.launches - before
    if info["evaluate_launches"] == 0:
        fail("kg.evaluate did not go through the rank_counts kernel")
    print("metrics " + json.dumps(metrics), flush=True)
    main_launches = rank_topk.rank_counts.launches    # --- end ---
    info["main_path_s"] = time.perf_counter() - t_start
    info["metrics"] = metrics
    n_q = len(test)
    for key in ("entity_raw", "entity_filtered", "relation_prediction"):
        row = metrics[key]
        if row["n"] != (2 * n_q if key.startswith("entity") else n_q) or \
                not 1 <= row["mean_rank"] <= graph.n_entities:
            fail(f"metrics[{key}] malformed: {row}")
    if not 0 <= metrics["triplet_classification_acc"] <= 1:
        fail("triplet classification accuracy out of [0, 1]")

    # the kernel path against the plain-scorer path, whole test split
    masks = (tails_known, heads_known)
    fused, info["ranks_fused_s"] = wall(torch, lambda: (
        eval_device.entity_ranks_device(kb.params, test, "l1", masks)))
    plain, info["ranks_plain_s"] = wall(torch, lambda: (
        eval_device.entity_ranks_device(kb.params, test, "l1", masks,
                                        fused=False)))
    np.testing.assert_array_equal(ranks, fused["filtered_ranks"]["tail"])
    got = host_eval._metrics_from_ranks(np.concatenate(
        [fused["raw_ranks"]["tail"], fused["raw_ranks"]["head"]])).row()
    if got != metrics["entity_raw"]:
        fail("evaluate's raw metrics differ from the rank vectors'")
    diffs = {}
    for group in ("raw_ranks", "filtered_ranks"):
        for side in ("tail", "head"):
            d = np.abs(fused[group][side].astype(np.int64)
                       - plain[group][side])
            diffs[f"{group}.{side}"] = {"queries": int((d > 0).sum()),
                                        "max": int(d.max())}
    info["fused_vs_plain"] = diffs
    print("fused vs plain-scorer rank differences " + json.dumps(diffs),
          flush=True)
    for key, d in diffs.items():
        if d["queries"] >= 0.001 * n_q or d["max"] > 3:
            fail(f"fused ranks differ too much from the plain path: {key} "
                 f"{d}")

    # the device engine against the host reference protocol, on a slice
    rows = test[:HOST_CHECK_ROWS]
    host = host_eval.entity_inference(
        kb.params, rows, "l1", graph.known_set(),
        known_index=graph.known_index(), return_ranks=True)
    dev = eval_device.entity_ranks_device(
        kb.params, rows, "l1", (tails_known[:HOST_CHECK_ROWS],
                                heads_known[:HOST_CHECK_ROWS]), fused=False)
    for group in ("raw_ranks", "filtered_ranks"):
        for side in ("tail", "head"):
            if not np.array_equal(host[group][side], dev[group][side]):
                fail(f"device engine differs from the host protocol: "
                     f"{group}.{side}")
    return info, main_launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build   # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    rates = peaks(name)
    t0 = time.perf_counter()
    report = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s", flush=True)
    for lib, rep in report.items():
        print(f"nvcc {lib} ({rep['seconds']:.2f} s):\n{rep['nvcc']}",
              flush=True)

    cases = kernel_phase(torch, rates)
    info, launches = main_path(torch)
    info["build_s"] = build_s

    main_case = next(c for c in cases if c["E"] == FB15K["n_entities"]
                     and c["norm"] == "l1" and c["dtype"] == "float32")
    kernels = [{
        "name": "rank_counts", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rank_topk.cu",
        "replaces": "src/repro/kernels/rank_topk.py:65",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "count_mismatches": sum(c["count_mismatches"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "cases": cases,
    }]
    device = {"platform": "gpu", "kind": name,
              "count": torch.cuda.device_count()}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"nvidia_smi": smi, "device": device, "kernels": kernels,
                   "main_path": info}, f, indent=1)
    print(json.dumps({k: info[k] for k in info if k != "metrics"}),
          flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
