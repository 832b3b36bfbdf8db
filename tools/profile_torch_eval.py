#!/usr/bin/env python3
"""Where the time of the port's device evaluation goes, on one CUDA GPU.

    python3 tools/profile_torch_eval.py [--src DIR] [--graph-cache FILE]
                                        [--reps N] [--label NAME]

Builds the synthetic graph at FB15k's sizes (14,951 entities, 1,345
relations, 592,213 triplets; ``--graph-cache`` keeps its splits in an
``.npz`` so later runs skip the build) and a TransE ``KnowledgeBase``
(dim 50, L1, tables from ``torch.Generator`` seed 0) with the
``repro_torch`` found under ``--src`` (default: this checkout's ``src``).
Then, for the rank-kernel path (``fused=True``) and the plain-scorer path
(``fused=False``) of ``kg.evaluate(kb, engine="device")``, after one
warm-up call each:

  * host seconds of ``--reps`` calls, the two paths in turns;
  * one call under ``torch.profiler``: the device's busy time (the sum of
    kernel self times — one stream, so kernels never overlap), the idle
    share of that call's wall time and of the unprofiled median (the
    profiler slows the host, so the first overstates it), and the kernels
    that take the most device time, with their launch counts.

Prints one JSON object per path (with a digest of the metrics, so runs of
two trees can be checked for equal answers) and appends them to
``chiprun_out/profile_torch_eval.jsonl``.  Needs a CUDA device.  To compare
two trees, run it for each in turns (A, B, B, A) in one session.
"""
import argparse
import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FB15K = dict(n_entities=14951, n_relations=1345, n_triplets=592213)


def profile_once(torch, fn):
    from torch.profiler import ProfilerActivity, profile

    # device activity only: CPU-op events would carry their kernels' time
    # a second time, and recording them slows the host severalfold
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        self_us = getattr(ev, "self_device_time_total", None)
        if self_us is None:
            self_us = ev.self_cuda_time_total
        if self_us > 0:
            kernels.append((self_us, ev.count, ev.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels) / 1e6
    return {
        "wall_s": wall, "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall,
        "kernel_launches": sum(k[1] for k in kernels),
        "top": [{"kernel": key[:100], "launches": n, "ms": us / 1e3}
                for us, n, key in kernels[:12]],
    }


def load_graph(kg_data, cache):
    if cache and os.path.exists(cache):
        with np.load(cache) as z:
            return kg_data.KG(FB15K["n_entities"], FB15K["n_relations"],
                              z["train"], z["valid"], z["test"]), 0.0
    t0 = time.perf_counter()
    graph = kg_data.synthetic_kg(0, **FB15K)
    seconds = time.perf_counter() - t0
    if cache:
        np.savez(cache, train=graph.train, valid=graph.valid,
                 test=graph.test)
    return graph, seconds


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--graph-cache", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_eval: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import kg
    from repro_torch.core.models import KGConfig, get_model
    from repro_torch.data import kg as kg_data

    graph, graph_s = load_graph(kg_data, args.graph_cache)
    params = get_model("transe").init_params(
        torch.Generator().manual_seed(0),
        KGConfig(graph.n_entities, graph.n_relations, dim=50),
        device="cuda")
    kb = kg.KnowledgeBase(model="transe", params=params, graph=graph,
                          norm="l1")
    times = {True: [], False: []}
    digests = {}
    for rep in range(args.reps + 1):            # rep 0 warms up
        for fused in (True, False):
            t0 = time.perf_counter()
            metrics = kg.evaluate(kb, engine="device", fused=fused)
            torch.cuda.synchronize()
            if rep:
                times[fused].append(time.perf_counter() - t0)
            digests[fused] = hashlib.sha256(json.dumps(
                metrics, sort_keys=True).encode()).hexdigest()[:16]

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    for fused in (True, False):
        row = {
            "label": args.label or os.path.relpath(args.src, ROOT),
            "fused": fused, "device": torch.cuda.get_device_name(0),
            "graph_build_s": graph_s, "test_triplets": len(graph.test),
            "evaluate_s": times[fused],
            "evaluate_median_s": statistics.median(times[fused]),
            "metrics_digest": digests[fused],
            "profile": profile_once(torch, lambda: kg.evaluate(
                kb, engine="device", fused=fused)),
        }
        # the profiler slows the host, not the kernels: the idle share of
        # an unprofiled call is its busy time over the unprofiled median
        row["idle_share_unprofiled"] = 1.0 - (
            row["profile"]["device_busy_s"] / row["evaluate_median_s"])
        print(json.dumps(row), flush=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "profile_torch_eval.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
