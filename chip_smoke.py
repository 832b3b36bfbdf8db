#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA GPU.

    python3 chip_smoke.py

1. Builds every kernel of the port from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together) and prints the build time.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   same inputs, and times the kernel, the plain version and PyTorch library
   calls computing the same function (timed only, never used by the port)
   beside the least time the card could take.  ``rank_counts``: exact
   counts, L1 and L2, fp32 and bf16, at the evaluation chunk (B = 256
   queries, E = 14,951, k = 50) and at a Freebase-scale table (B = 4,096,
   E = 1,000,000), then on tie-stress inputs at the evaluation chunk (each
   gold row planted exactly and one ulp off, so counts hang on single
   ulps; under L2 the tensor-core screen must re-check some pairs in
   order).  Per case: the kernels' own time (``torch.profiler``; L2 is a
   per-row pre-pass and the main kernel), the wrapper call's (CUDA
   events), the share of pairs the L2 screen re-checked, and the main
   kernel's registers and shared memory; library call ``torch.cdist`` +
   compare + sum, split in two calls at E = 1e6, whose 4.1e9 outputs one
   call's grid cannot hold.
   ``transe_score`` forward and backward (kernel times from
   ``torch.profiler``, as the wrappers sync for their id checks; the
   backward's is the sum of its two kernels per call): equal
   bits (max_abs_err 0), L1 and
   L2, fp32 and bf16, at the training step's shape (4 workers x 256
   triplets over the stacked FB15k tables, 4 x 14,951 entity rows) and at
   2**20 triplets over a 1,000,000-row table; the backward run twice must
   give the same bits.  Library calls timed beside them: gathers +
   ``torch.linalg.vector_norm`` + ``clamp`` (forward) and autograd of the
   same (backward).
3. Training path, through ``kg.fit`` over a synthetic graph with FB15k's
   entity, relation and triplet counts: TransE at ``kg.make_configs``'
   defaults (dim 50, L1, margin 1, lr 0.01, per-epoch normalization,
   uniform negatives, 4 workers, batch 256, balanced split), SGD with the
   ``average`` Reduce and BGD, a few epochs each, from the seeded init.
   The ``transe_score`` counters are zeroed just before and read just
   after.  Checks: both kernels launched once per step, as the schedule
   predicts; each paradigm's loss fell; the SGD-trained filtered mean rank
   beats the init's; a same-seed rerun of one epoch gives the same bits;
   one SGD epoch on the CPU (plain versions) and on the card (kernels) from
   the same params and draws agree (tolerance below).
4. Serving path, on the SGD-trained artifact, through the entry points a
   user calls: save -> load; filtered top-k tail/head queries, relation
   queries and scores for 1,024 pairs; ``rank()``;
   ``kg.evaluate(kb, engine="device")``.  The ``rank_counts`` counter is
   zeroed just before and read just after.  Checks: fingerprints survive
   the round trip, answers are well formed and agree with the host
   reference protocol on a slice of the test split, and the kernel path
   agrees with the plain-scorer path on the whole split.
5. Training with evaluation and resume, at the training path's width,
   through ``kg.fit``: run A, SGD for 4 epochs with ``eval_every=2`` and
   async checkpoints every 2 epochs; run B, SGD for 2 epochs with a
   checkpoint, then ``resume=True`` to 4; BGD for 1 epoch with a
   checkpoint, then resumed to 3.  All three kernels' counters are zeroed
   just before and read just after.  Checks: A, resumed B and the
   untraced SGD run of the training path give the same bits (params and
   loss history), as do the resumed BGD run and the training path's; A's
   trace entries equal a later ``kg.evaluate`` exactly (the last entry,
   and the best entry against ``best_params``), at epochs [1, 3] and merge
   rounds [2, 4]; the steps on disk and each manifest's ``config``
   (``resume_config``); ``transe_score`` forward and backward launched
   once per step and ``rank_counts`` as two evaluations predict; a bf16
   cast of A's artifact answers ``query_tails`` and ``score`` as the CPU
   does and keeps its fingerprint off the card.  Reports epoch seconds,
   each boundary evaluation's seconds, the seconds the loop waits in
   ``save_async`` and in the final wait, and the resume's restore seconds.

6. The device pipeline (``pipeline="device"``), at the training path's
   width, through ``kg.fit``: (a) SGD ``average`` with ``merge_every=2``
   and ``repartition_every=2``, 4 epochs, ``block_epochs=4`` and then
   ``block_epochs=2``; (b) BGD, 3 epochs in one block; (c) one merge
   round of (a) (its first 2 epochs) on the CPU and on the card, from
   fit's seed-0 init and the port's own draws, and the counter-based draws
   (``core/keys.py``) alone on 2**20 counters on both; (d) one block of
   (a) through ``mapreduce.make_block_fn`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (its losses read after),
   the peak memory of a block with ``donate_params`` on and off
   (``torch.cuda.max_memory_allocated``), and a block under
   ``torch.profiler``; (e) (a) with ``eval_every=2`` and checkpoints every
   2 epochs, and a run of 2 epochs resumed to 4.  All three kernels'
   counters are zeroed just before and read just after.  Checks: (a)'s two
   block sizes, (e)'s traced run and its resumed run give the same bits,
   as do (c)'s CPU and card rounds (params and losses) and draws; the
   block under the sync check raises nothing and gives (a)'s first two
   losses; (e)'s trace entries lie at merge rounds [1, 2] and its last
   equals a later ``kg.evaluate``; the manifests carry
   ``pipeline="device"``; each loss fell; (f) ``transe_score`` forward and
   backward launched 520 times an epoch on the card and ``rank_counts``
   232 times an evaluation.  Reports epoch seconds, the block's idle
   share, launches and device→host copies a step beside the host
   pipeline's profile of the training path, and the peak memory.

7. The live server (``serve.KGServer``), at the training path's width, on
   the SGD-trained artifact saved and loaded fresh (its graph's known
   index cold), with the BGD-trained artifact as a second tenant and as
   the swap target, at the batching configs of
   ``benchmarks/bench_latency.py`` (``unbatched``, ``batch16_wait1ms``,
   ``batch64_wait2ms``; k = 10).  All three kernels' counters are zeroed
   just before and read just after (no kernel lies on this path: 0
   expected).  (a) Start-up: one wave filling each bucket, then one
   filtered query, on an unwarmed server, then ``KGServer(kb,
   warm=True)`` timed as its known-index build and its engine calls, and
   the same waves warm; the shapes the cold waves met plus those warm-up
   met are every warmed shape.  (b) Parity, on ``batch64_wait2ms`` with
   ``pause``/``resume`` composing exact waves: tails, heads and
   relations, unfiltered, filtered and with an explicit exclusion, waves
   of 1–64 (every bucket), each answer bitwise equal to the engine on the
   same single query at ``chunk=1``, and again from the cache.  (c)
   Capacity: 2,048 distinct ``tails`` queries submitted at once, per
   config.  (d) An open loop per config: 2,000 seeded Poisson arrivals at
   half of (c)'s capacity over 500 distinct pairs (repeats hit the
   cache): offered and sustained QPS, p50/p99 over all answers and over
   misses, hit rate, waves by bucket, the allocator's device allocations
   (``num_device_alloc``) across the stream, and no steady-state
   recompile.  (e) On ``batch16_wait1ms``: the second tenant answers with
   its own bits; then ``swap()`` to it halfway through an open loop:
   every answer carries one of the two fingerprints and equals that
   artifact's engine, the cache is invalidated once, and no shape is
   new; the swap, its warm-up and its exclusion width are timed.  Every
   served tenant's tables are on the card; every future's wait is
   bounded.

8. The model family and joint negatives (``model_family_path``), at the
   training path's width, through ``kg.fit``: (a) TransH, SGD
   ``average`` 2 epochs and BGD 1, host pipeline; (b) DistMult, the same;
   (c) TransE with ``negatives="joint"``: bench_async's joint-48 (SGD, L2,
   ``neg_candidates=48``, ``merge_every=2``) on the device pipeline, 4
   epochs in blocks of 4 and of 2, and the full pool (C = 256) under BGD,
   L1, 1 epoch, host pipeline; (d) each of the three SGD artifacts saved,
   loaded, queried (filtered tails and heads, relations, scores on 1,024
   pairs), ranked (``rank()``) and evaluated (``kg.evaluate(kb,
   engine="device")``), the device engine against the host protocol on a
   slice of the test split; (e) the DistMult artifact as a ``KGServer``
   tenant, waves of 1–64 (every bucket), each served answer bitwise equal
   to the engine at ``chunk=1``.  All three kernels' counters are zeroed
   just before and read just after: ``transe_score`` forward and backward
   0 (no kernel lies on these objectives), ``rank_counts`` 232 for each of
   the TransE artifact's ``rank()`` and evaluation.  Then, per model, a
   same-seed rerun of 20 steps of the engine's epoch function (same bits)
   and its profile (launches a step, idle share), and one SGD epoch on
   the CPU and on the card from the same params and draws (within 1e-5).
   Checks: each loss fell where its run took more than one epoch; the two
   block sizes give the same bits; every trained table is on the card.

9. The sparse delta transport (``sparse_transport_path``,
   ``merge_transport="sparse"``): the compact SGD step on the
   ``transe_score`` kernels, the packed-delta Reduce and sparse BGD, each
   run beside its dense twin.  (a) At phase 3's width and configuration
   (where the capacity clamps to the whole table, so only the compact
   step differs from dense): SGD ``average`` on the host pipeline, 2
   epochs; BGD, 1 epoch; the device pipeline's SGD ``merge_every=2``,
   ``repartition_every=2``, 4 epochs, dense in one block and sparse in
   blocks of 4 and 2; one sparse block under
   ``torch.cuda.set_sync_debug_mode("error")``, the peak memory of a
   sparse block with ``donate_params`` on and off, and a sparse block
   under ``torch.profiler``; the SGD and BGD sparse artifacts evaluated.
   (b) TransH and DistMult, 1 SGD epoch on the host pipeline, and joint-48
   TransE for one merge round on the device pipeline.  (c) The
   million-entity cell of ``benchmarks/bench_scale.py`` (``SIZES[1e6]``
   and ``task=roundtrip``): ``random_kg(1e6, 50,000, 100 relations, 16
   held out, seed 5)``, TransE dim 16, 4 workers, batch 4,096, SGD
   ``average``, lr 0.05, device pipeline, 2 epochs in one block per
   transport (twice each), its three byte counts per Reduce and the
   delta capacity, each run's peak memory, then ``kg.evaluate(kb,
   engine="device")`` of the sparse artifact against all 1e6 entities.
   All three kernels' counters are zeroed just before and read just
   after.  Checks: every sparse run gives its dense twin's bits, and the
   sparse runs give each other's across block sizes; the sync-checked
   block raises nothing and gives the dense run's first losses; the
   block makes no device→host copy; ``transe_score`` forward and backward
   launched once a step of every TransE run (none for TransH, DistMult
   and joint) and ``rank_counts`` as the evaluations' chunks predict; the
   1e6 evaluation's metrics are finite and in range.  Reports epoch
   seconds per transport, the profile (launches a step, idle share,
   device→host copies a step) and peak memory.

Prints the card's name and power limit, one JSON line with the kernel table
and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device, outside a checkout of the repository, or when
any phase fails.  Details go to ``chiprun_out/chip_smoke.json``.
"""
import json
import math
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
# transe_score cases: (W, B, E, R); W = 1 is one unstacked table.  The
# last is the sparse transport's compact step at the training step's
# shape: tables of the 4B entity and 2B relation rows a batch references
TRANSE_CASES = ((4, 256, FB15K["n_entities"], FB15K["n_relations"]),
                (1, 1 << 20, 1_000_000, FB15K["n_relations"]),
                (4, 256, 4 * 256, 2 * 256))
TRAIN = dict(n_workers=4, batch_size=256)   # kg.make_configs' defaults
SGD_EPOCHS, BGD_EPOCHS = 4, 3
# phase 6: the device pipeline's SGD configuration, and the counters its
# draws are held on, CPU against card
DEVICE_SGD = dict(strategy="average", pipeline="device", merge_every=2,
                  repartition_every=2)
DRAW_COUNTERS = 1 << 20
# One SGD epoch on the CPU (plain versions) against the card (kernels),
# from the same params and draws.  The kernels equal their plain versions
# bitwise, and every other operation of a step is an elementwise IEEE op,
# an in-order sum or a correctly rounded root (util.sqrt_rn) on both
# devices, and the epoch's loss a fixed-order tree (util.pairwise_mean),
# so params and loss are expected to agree bitwise.  The gates allow for
# one ulp somewhere flipping an L1 sign, which moves one entry by
# 2 * lr / B = 7.8e-5: params within 1e-4, loss within rtol 1e-5.  Phase 6
# holds the device pipeline's round to equal bits.
CPU_EPOCH_PARAM_TOL, CPU_EPOCH_LOSS_RTOL = 1e-4, 1e-5
# phase 7: the live server, at the batching configs of
# benchmarks/bench_latency.py (label, max_batch, max_wait_us)
LIVE_CONFIGS = (("unbatched", 1, 0), ("batch16_wait1ms", 16, 1000),
                ("batch64_wait2ms", 64, 2000))
LIVE_K = 10
LIVE_BURST, LIVE_ARRIVALS, LIVE_UNIQUE = 2048, 2000, 500
LIVE_SWAP_ARRIVALS = 1000
LIVE_TIMEOUT_S = 60         # every future's wait
# wave sizes that fill every bucket of 64, most of them partly
PARITY_SIZES = (1, 2, 3, 5, 9, 17, 33, 64)
PARITY_CELLS = (("tails", "plain"), ("tails", "filtered"),
                ("tails", "exclude"), ("heads", "plain"),
                ("heads", "filtered"), ("heads", "exclude"),
                ("relations", "plain"))
# phase 8: the model family and joint negatives, at phase 3's width; the
# joint objective's two cells are benchmarks/bench_async.py's joint-48
# (SGD, L2, merge_every=2, device pipeline) and the full pool under BGD
FAMILY_SGD_EPOCHS, FAMILY_BGD_EPOCHS, JOINT_EPOCHS = 2, 1, 4
FAMILY_RERUN_STEPS = 20
JOINT_SGD = dict(negatives="joint", neg_candidates=48, norm="l2",
                 pipeline="device", merge_every=2)
JOINT_BGD = dict(negatives="joint", norm="l1")
# (label, model, options) of the same-seed rerun and the CPU-against-card
# epoch (the joint cell on the host pipeline)
FAMILY_CELLS = (("transh", "transh", {}), ("distmult", "distmult", {}),
                ("transe_joint48", "transe", JOINT_SGD))
# One SGD epoch on the CPU and on the card from the same params and
# draws.  Autograd's backward sums a gather's duplicate rows and a
# broadcast's reduction in each device's own order, so the two may differ
# in the last bits of a few rows: within 1e-5.
FAMILY_CPU_TOL = 1e-5
# phase 9: the sparse transport; (c) is benchmarks/bench_scale.py's
# SIZES[1_000_000] row and its task=roundtrip (n_entities, n_triplets,
# batch, epochs; relations, held-out triples, graph seed, dim, lr)
SPARSE_DEVICE = dict(DEVICE_SGD, merge_transport="sparse")
SCALE_CELL = dict(n_entities=1_000_000, n_triplets=50_000, batch=4_096,
                  epochs=2, n_relations=100, n_eval=16, seed=5, dim=16,
                  learning_rate=0.05)
DEVICE = "cuda"
# the CUDA kernels of each transe_score wrapper call, timed as their sum
TRANSE_KERNELS = {"fwd": ("transe_score_fwd_kernel",),
                  "bwd": ("transe_score_bwd_grads_kernel",
                          "transe_score_bwd_rows_kernel")}
# NVIDIA H100 data sheet, dense rates.  "fp32" counts an FMA as two
# operations (SMs x 128 lanes x 2 x boost clock); "fp32_issue" is the FP32
# instruction rate, one per lane a clock (SMs x 128 x clock: 132 x 128 x
# 1.98 GHz on the SXM, 114 x 128 x 1.755 GHz on the PCIe card), the rate of
# work that cannot contract into FMAs; "tf32" and "bf16" are the tensor
# cores'; "bytes" the HBM rate.
PEAKS = {
    "H100 PCIe": {"fp32": 51e12, "fp32_issue": 25.6e12, "tf32": 378e12,
                  "bf16": 756e12, "bytes": 2.0e12},
    "H100": {"fp32": 67e12, "fp32_issue": 33.45e12, "tf32": 495e12,
             "bf16": 989e12, "bytes": 3.35e12},
}


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


def kernel_ms(torch, fn, reps, names, sessions=3):
    """Device milliseconds per call of ``fn`` in each CUDA kernel whose name
    holds one of ``names``, ``{name: ms}``, over ``reps`` calls
    (``torch.profiler``, device activity only; one warm-up call first):
    for each name the mean over the launches the profiler recorded (it has
    been seen to drop a few of 50 records, and once every record of one
    kernel in a session).  A session that recorded no launch of a name, or
    more than one per call, is run again, up to ``sessions`` in all; then
    it fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out, counts = {}, {}
        for name in names:
            us, count = 0.0, 0
            for ev in prof.key_averages():
                if ev.device_type == torch.autograd.DeviceType.CUDA and \
                        name in ev.key:
                    us += getattr(ev, "self_device_time_total", None) or \
                        ev.self_cuda_time_total
                    count += ev.count
            counts[name] = count
            out[name] = us / 1e3 / max(count, 1)
        if all(0 < n <= reps for n in counts.values()):
            return out
        print(f"the profiler saw {counts} launches in {reps} calls: "
              "profiling again", flush=True)
    fail(f"the profiler saw {counts} launches in {reps} calls, in each of "
         f"{sessions} sessions")


def profile_busy(torch, fn):
    """Wall seconds of ``fn`` (ending in a synchronize) under
    ``torch.profiler`` with device activity only, the device's busy
    seconds within it, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None) or \
                ev.self_cuda_time_total
            if us > 0:
                kernels.append((us, ev.count, ev.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels) / 1e6
    return {"wall_s": wall_s, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall_s,
            "launches": sum(k[1] for k in kernels),
            "dtoh_copies": sum(n for _, n, key in kernels
                               if "Memcpy DtoH" in key),
            "top": [{"kernel": key[:90], "launches": n, "ms": us / 1e3}
                    for us, n, key in kernels[:10]]}


def wall(torch, fn):
    """(result, host seconds) of ``fn``, ending in a device synchronize."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rank_counts_bound(B, E, k, itemsize, norm, rates):
    """Least milliseconds for one rank_counts call, ``(ms, "bytes"|
    "operations")``: the larger of its bytes (each input read once, the
    output written once) over the memory rate and its operations.

    L1 runs on the CUDA cores, two FP32 instructions per element pair
    (subtract, add of the absolute value: they cannot contract into an FMA)
    and a compare per pair, at the FP32 instruction rate.  L2 is the larger
    of the contraction ``2·B·E·k`` at the tensor cores' rate for the input
    type (TF32 for fp32, bf16) and its CUDA-core work at the instruction
    rate: at least 4 operations per pair of epilogue and the in-order sums
    of squares, ``2·k·(B + E)``."""
    nbytes = (B + E) * k * itemsize + B * 4 + B * 4
    issue = rates["fp32_issue"]
    if norm == "l1":
        t_ops = (2 * B * E * k + B * E) / issue
    else:
        tensor = rates["tf32" if itemsize == 4 else "bf16"]
        t_ops = max(2 * B * E * k / tensor,
                    (4 * B * E + 2 * k * (B + E)) / issue)
    t_bytes = nbytes / rates["bytes"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rank_inputs(torch, E, B, norm, dtype, seed=None):
    """The kernel phase's inputs: a TransE-range table, queries ``h + r``
    (unit-norm r), and gold distances to random rows, on the device."""
    from repro_torch.core.models import dissimilarity

    g = torch.Generator(device=DEVICE).manual_seed(E if seed is None
                                                   else seed)
    bound = 6.0 / DIM ** 0.5           # the TransE init range
    table = (torch.rand(E, DIM, generator=g, device=DEVICE) * 2 - 1) * bound
    rel = torch.randn(B, DIM, generator=g, device=DEVICE)
    rel = rel / rel.norm(dim=1, keepdim=True)
    heads = torch.randint(0, E, (B,), generator=g, device=DEVICE)
    golds = torch.randint(0, E, (B,), generator=g, device=DEVICE)
    tab = table.to(dtype).contiguous()
    q = (table[heads] + rel).to(dtype).contiguous()
    gold = dissimilarity(q.float() - tab[golds].float(), norm).contiguous()
    return q, tab, gold


def plain_distance(torch, q, rows, norm):
    """The plain version's distance of each query to its row (``(B, k)``
    each), its operations in its order: in-order sums, L2 expanded."""
    from repro_torch.kernels.ref import l2_distance

    q, rows = q.float(), rows.float()
    if norm == "l1":
        d = (q[:, 0] - rows[:, 0]).abs()
        for j in range(1, q.shape[1]):
            d = d + (q[:, j] - rows[:, j]).abs()
        return d
    qq, qe, ee = q[:, 0] * q[:, 0], q[:, 0] * rows[:, 0], \
        rows[:, 0] * rows[:, 0]
    for j in range(1, q.shape[1]):
        qq = qq + q[:, j] * q[:, j]
        qe = qe + q[:, j] * rows[:, j]
        ee = ee + rows[:, j] * rows[:, j]
    return l2_distance(qq, qe, ee)


def tie_stress_inputs(torch, E, B, norm, dtype, copies=8, seed=1):
    """Inputs whose counts hang on single ulps: each query's gold row is
    written into ``copies`` other rows of the table, half of them exact
    copies and half one ulp off in one coordinate (up or down), and the
    gold distance is the plain version's own arithmetic for the gold row.
    So ``copies`` pairs a query sit exactly at, or one ulp from, its
    threshold."""
    q, tab, _ = rank_inputs(torch, E, B, norm, dtype, seed=seed)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    perm = torch.randperm(E, generator=g, device=DEVICE)
    golds, slots = perm[:B], perm[B:B * (copies + 1)].view(B, copies)
    src = tab[golds]                                         # (B, k)
    rows = src[:, None, :].expand(B, copies, DIM).clone()
    half = copies // 2
    col = torch.randint(0, DIM, (B, copies - half), generator=g,
                        device=DEVICE)
    up = torch.rand(B, copies - half, generator=g, device=DEVICE) < 0.5
    off = rows[:, half:, :]
    ints = {2: torch.int16, 4: torch.int32}[tab.element_size()]
    bits = off.gather(2, col[..., None]).view(ints)
    # one ulp up or down in magnitude; a zero steps up only
    zero = (bits == 0) | (bits == torch.iinfo(ints).min)
    step = torch.where(up[..., None] | zero, 1, -1).to(ints)
    off.scatter_(2, col[..., None], (bits + step).view(tab.dtype))
    tab = tab.clone()
    tab[slots.reshape(-1)] = rows.reshape(-1, DIM)
    gold = plain_distance(torch, q, tab[golds], norm).contiguous()
    return q, tab.contiguous(), gold


def rank_case(torch, q, tab, gold, norm, rates, timed):
    """One rank_counts case: counts against the plain version, the share of
    pairs the L2 screen re-checked, the kernel's attributes and, if
    ``timed``, the kernel's, the plain version's and the library call's
    times beside the bound."""
    from repro_torch.kernels import rank_topk, ref

    (B, k), E = q.shape, tab.shape[0]
    rechecked = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    got = rank_topk.rank_counts(q, tab, gold, norm=norm,
                                recheck_counter=rechecked)
    want = ref.rank_counts_ref(q, tab, gold, norm)
    torch.cuda.synchronize()
    bound_ms, bound_by = rank_counts_bound(B, E, k, tab.element_size(), norm,
                                           rates)
    case = {
        "B": B, "E": E, "k": k, "norm": norm,
        "dtype": str(q.dtype).replace("torch.", ""),
        "count_mismatches": int((got != want).sum()),
        "max_abs_err": int((got - want).abs().max()),
        "mean_count": float(want.float().mean()),
        "rechecked_share": int(rechecked) / (B * E) if norm == "l2" else None,
        "kernel": rank_topk.kernel_info(q.dtype, norm, k, B, E),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if timed:
        small = B * E < 1e8
        call = lambda: rank_topk.rank_counts(q, tab, gold, norm=norm)
        reps = 50 if small else 5
        # the kernels' own device time per call (the profiler), and the
        # wrapper call's (CUDA events: at the evaluation chunk that is set
        # by the host's launch overhead, not the card)
        case["kernels_ms"] = kernel_ms(torch, call, reps,
                                       rank_topk.KERNELS[norm])
        case["ms"] = sum(case["kernels_ms"].values())
        case["call_ms"] = cuda_ms(torch, call, reps=reps)
        case["plain_ms"] = cuda_ms(torch, lambda: ref.rank_counts_ref(
            q, tab, gold, norm), reps=3 if small else 1, warmup=0)
        qf, tf = q.float(), tab.float()
        p = 1.0 if norm == "l1" else 2.0
        # cdist's grid holds < 2**31 outputs: one call per part
        parts = -(-B * E // 2**31)
        case["library_ms"] = cuda_ms(torch, lambda: sum(
            (torch.cdist(qf, t, p=p) < gold[:, None]).sum(1)
            for t in tf.chunk(parts)),
            reps=5 if small else 1, warmup=1 if small else 0)
        case["library_calls"] = parts
    return case


def kernel_phase(torch, rates):
    """rank_counts at every KERNEL_CASES shape, L1 and L2, fp32 and bf16,
    timed; then the tie-stress inputs at the evaluation chunk, checked."""
    cases = []
    for E, B in KERNEL_CASES:
        for norm in ("l1", "l2"):
            for dtype in (torch.float32, torch.bfloat16):
                case = rank_case(torch, *rank_inputs(torch, E, B, norm, dtype),
                                 norm, rates, timed=True)
                print("rank_counts " + json.dumps(case), flush=True)
                cases.append(case)
        torch.cuda.empty_cache()
    E, B = KERNEL_CASES[0]
    for norm in ("l1", "l2"):
        for dtype in (torch.float32, torch.bfloat16):
            case = rank_case(torch, *tie_stress_inputs(torch, E, B, norm,
                                                       dtype),
                             norm, rates, timed=False)
            case["tie_stress"] = True
            print("rank_counts " + json.dumps(case), flush=True)
            cases.append(case)
            if norm == "l2" and not case["rechecked_share"]:
                fail(f"the L2 screen re-checked no pair of the tie-stress "
                     f"inputs: {case}")
    bad = [c for c in cases if c["count_mismatches"]]
    if bad:
        fail(f"rank_counts kernel disagrees with its plain version: {bad}")
    return cases


def bits_equal(a, b):
    """Same dtype, shape and bits (NaN payloads and signed zeros too)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return bool(torch.equal(a.contiguous().view(ints),
                            b.contiguous().view(ints)))


def max_err(got, want):
    return max(float((a.float() - b.float()).abs().max()) if a.numel()
               else 0.0 for a, b in zip(got, want))


def transe_bounds(n, k, itemsize, norm, dense_rows, rates):
    """Least milliseconds of one transe_score forward and one backward
    kernel over ``n`` triplets: the larger of bytes over the memory rate
    and fp32 operations over the fp32 rate, each ``(ms, "bytes"|
    "operations")``.

    Forward bytes: five k-rows per triplet, the (n, 5) int32 ids, three
    fp32 outputs.  Operations: u and v (2 each per column), |x| or x² and
    the add into the sum (2 each per column), the hinge (3), and for L2
    two adds and two roots.  Backward bytes: the five rows, the ids, four
    fp32 per-triplet inputs (g, loss, d_pos, d_neg), the sorted scatter
    rows and their order (2 x 5n int32), and the dense gradient, each of
    its ``dense_rows`` rows written once (the kernel writes the untouched
    rows' zeros too).  Operations: u and v (4 per column), their signs or
    quotients (2), the scaling (2), gu + gv (1), one add per contribution
    (5), and the scale per triplet (1)."""
    flops, bw = rates["fp32"], rates["bytes"]
    row = k * itemsize
    out = []
    for nbytes, ops in (
            (n * (5 * row + 5 * 4 + 3 * 4),
             n * (8 * k + 3 + (4 if norm == "l2" else 0))),
            (n * (5 * row + 5 * 4 + 4 * 4 + 2 * 5 * 4) + dense_rows * row,
             n * (14 * k + 1))):
        t_bytes, t_ops = nbytes / bw, ops / flops
        out.append((max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations"))
    return out


def transe_library(torch, ent, rel, idx, norm):
    """One PyTorch formulation of the forward (gathers, vector_norm, clamp)
    on flat tables and worker-offset ids, and a closure timing autograd
    of it (the backward).  Timed only; the port never calls it."""
    from repro_torch.util import worker_offsets

    k = ent.shape[-1]
    flat_e = ent.detach().reshape(-1, k).requires_grad_()
    flat_r = rel.detach().reshape(-1, k).requires_grad_()
    ix = idx.long()
    if ent.dim() == 3:
        eo, ro = worker_offsets(ix, ent.shape[1], rel.shape[1])
        ix = ix + torch.stack([eo, ro, eo, eo, eo], dim=-1)
    ix = ix.reshape(-1, 5)
    p = 1 if norm == "l1" else 2

    def fwd():
        h, t, nh, nt = (flat_e[ix[:, c]].float() for c in (0, 2, 3, 4))
        r = flat_r[ix[:, 1]].float()
        d_pos = torch.linalg.vector_norm(h + r - t, ord=p, dim=-1)
        d_neg = torch.linalg.vector_norm(nh + r - nt, ord=p, dim=-1)
        return torch.clamp(1.0 + d_pos - d_neg, min=0.0)

    with torch.enable_grad():
        out = fwd()
    g = torch.full_like(out, 1.0 / idx.shape[-2])

    def bwd():
        return torch.autograd.grad(out, [flat_e, flat_r], grad_outputs=g,
                                   retain_graph=True)

    def nograd_fwd():
        with torch.no_grad():
            return fwd()

    return nograd_fwd, bwd


def transe_kernel_phase(torch, rates):
    """``transe_score`` forward and backward against their plain versions
    (equal bits), the backward twice (equal bits), and the times."""
    from repro_torch.kernels import ref, transe_score as ts

    cases = []
    for W, B, E, R in TRANSE_CASES:
        g = torch.Generator(device=DEVICE).manual_seed(E + B)
        lead = (W,) if W > 1 else ()
        bound = 6.0 / DIM ** 0.5           # the TransE init range
        ent32 = (torch.rand(*lead, E, DIM, generator=g, device=DEVICE)
                 * 2 - 1) * bound
        rel32 = torch.randn(*lead, R, DIM, generator=g, device=DEVICE)
        rel32 = rel32 / rel32.norm(dim=-1, keepdim=True)
        idx = torch.stack(
            [torch.randint(0, n, (*lead, B), generator=g, device=DEVICE)
             for n in (E, R, E, E, E)], dim=-1).to(torch.int32).contiguous()
        n = W * B
        small = n <= 4096
        for norm in ("l1", "l2"):
            for dtype in (torch.float32, torch.bfloat16):
                ent, rel = ent32.to(dtype), rel32.to(dtype)
                fwd = ts.transe_score(ent, rel, idx, margin=1.0, norm=norm)
                gs = torch.full(idx.shape[:-1], 1.0 / B, device=DEVICE)
                bwd = ts.transe_score_bwd(ent, rel, idx, gs, *fwd, norm=norm)
                bwd2 = ts.transe_score_bwd(ent, rel, idx, gs, *fwd,
                                           norm=norm)
                want_f = ref.transe_score_ref(ent, rel, idx, 1.0, norm)
                want_b = ref.transe_score_bwd_ref(ent, rel, idx, gs, *fwd,
                                                  norm)
                torch.cuda.synchronize()
                reps = 50 if small else 5
                lib_f, lib_b = transe_library(torch, ent, rel, idx, norm)
                (fb, fby), (bb, bby) = transe_bounds(
                    n, DIM, ent.element_size(), norm,
                    ent.shape[:-1].numel() + rel.shape[:-1].numel(), rates)
                case = {
                    "W": W, "B": B, "E": E, "R": R, "k": DIM, "norm": norm,
                    "dtype": str(dtype).replace("torch.", ""),
                    "active_hinges": float((fwd[0] > 0).float().mean()),
                    "fwd_max_abs_err": max_err(fwd, want_f),
                    "fwd_bitwise": all(map(bits_equal, fwd, want_f)),
                    "bwd_max_abs_err": max_err(bwd, want_b),
                    "bwd_bitwise": all(map(bits_equal, bwd, want_b)),
                    "bwd_repeat_bitwise": all(map(bits_equal, bwd, bwd2)),
                    "fwd_ms": sum(kernel_ms(torch, lambda: ts.transe_score(
                        ent, rel, idx, margin=1.0, norm=norm), reps,
                        TRANSE_KERNELS["fwd"]).values()),
                    # the backward's kernels, each per call, and their sum
                    "bwd_kernels_ms": kernel_ms(
                        torch, lambda: ts.transe_score_bwd(
                            ent, rel, idx, gs, *fwd, norm=norm), reps,
                        TRANSE_KERNELS["bwd"]),
                    # the wrappers' calls: id range checks (one host sync
                    # each) and the backward's sorts included
                    "fwd_call_ms": cuda_ms(torch, lambda: ts.transe_score(
                        ent, rel, idx, margin=1.0, norm=norm), reps),
                    "bwd_call_ms": cuda_ms(torch, lambda: ts.transe_score_bwd(
                        ent, rel, idx, gs, *fwd, norm=norm), reps),
                    "fwd_plain_ms": cuda_ms(torch, lambda: (
                        ref.transe_score_ref(ent, rel, idx, 1.0, norm)),
                        3 if small else 1, warmup=0),
                    "bwd_plain_ms": cuda_ms(torch, lambda: (
                        ref.transe_score_bwd_ref(ent, rel, idx, gs, *fwd,
                                                 norm)),
                        3 if small else 1, warmup=0),
                    "fwd_library_ms": cuda_ms(torch, lib_f, reps),
                    "bwd_library_ms": cuda_ms(torch, lib_b, reps),
                    "fwd_bound_ms": fb, "fwd_bound_by": fby,
                    "bwd_bound_ms": bb, "bwd_bound_by": bby,
                    # the backward's per-triplet (n, 2, k) fp32 gu, gv
                    "bwd_scratch_bytes": n * 2 * DIM * 4,
                }
                case["bwd_ms"] = sum(case["bwd_kernels_ms"].values())
                print("transe_score " + json.dumps(case), flush=True)
                cases.append(case)
                del fwd, bwd, bwd2, want_f, want_b, lib_f, lib_b
        del ent32, rel32, idx
        torch.cuda.empty_cache()
    bad = [c for c in cases if not (c["fwd_bitwise"] and c["bwd_bitwise"]
                                    and c["bwd_repeat_bitwise"])]
    if bad:
        fail(f"transe_score kernels disagree with their plain versions or "
             f"with themselves: {bad}")
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


def training_path(torch, graph):
    """The training main path (``kg.fit``, SGD then BGD), its checks, the
    same-seed rerun and the CPU-against-card epoch.  Returns the SGD and
    BGD results, the path's info, its kernel launches and the init's
    metrics."""
    from repro_torch import kg
    from repro_torch.core.models import KGConfig, get_model
    from repro_torch.data import kg as kg_data
    from repro_torch.kernels import transe_score as ts

    info = {}
    model = get_model("transe")
    cfg = KGConfig(graph.n_entities, graph.n_relations, dim=DIM)
    init = model.init_params(torch.Generator().manual_seed(0), cfg,
                             device=DEVICE)           # fit's seed-0 init
    init_kb = kg.KnowledgeBase(model="transe", params=init, graph=graph,
                               norm="l1")
    init_metrics, info["init_evaluate_s"] = wall(
        torch, lambda: kg.evaluate(init_kb, engine="device"))
    print("init metrics " + json.dumps(init_metrics), flush=True)
    steps = len(graph.train) // TRAIN["n_workers"] // TRAIN["batch_size"]
    epoch_s = {"sgd": [], "bgd": []}

    def timer(paradigm):
        last = [time.perf_counter()]

        def callback(epoch, loss):         # loss is a float: synchronized
            now = time.perf_counter()
            epoch_s[paradigm].append(now - last[0])
            last[0] = now
        return callback

    ts.transe_score.launches = 0                      # --- training path ---
    ts.transe_score_bwd.launches = 0
    t_start = time.perf_counter()
    sgd = kg.fit(graph, "transe", "sgd", strategy="average",
                 epochs=SGD_EPOCHS, seed=0, callback=timer("sgd"),
                 device=DEVICE, **TRAIN)
    bgd = kg.fit(graph, "transe", "bgd", epochs=BGD_EPOCHS, seed=0,
                 callback=timer("bgd"), device=DEVICE, **TRAIN)
    launches = (ts.transe_score.launches,
                ts.transe_score_bwd.launches)         # --- end ---
    info["train_path_s"] = time.perf_counter() - t_start
    info["steps_per_epoch"] = steps
    info["epoch_s"] = epoch_s
    info["loss_history"] = {"sgd": sgd.loss_history,
                            "bgd": bgd.loss_history}
    info["launches"] = dict(zip(("transe_score", "transe_score_bwd"),
                                launches))
    info["launches_per_epoch"] = {
        name: n / (SGD_EPOCHS + BGD_EPOCHS)
        for name, n in info["launches"].items()}
    print("training " + json.dumps(info), flush=True)
    predicted = steps * (SGD_EPOCHS + BGD_EPOCHS)
    if launches != (predicted, predicted):
        fail(f"transe_score launches {launches} on the training path; the "
             f"schedule predicts {predicted} each (one per step)")
    for name, res in (("sgd", sgd), ("bgd", bgd)):
        hist = res.loss_history
        if not all(map(math.isfinite, hist)) or not hist[-1] < hist[0]:
            fail(f"{name} loss did not fall: {hist}")

    # the same seed twice: the same bits
    a = kg.fit(graph, epochs=1, seed=0, device=DEVICE, **TRAIN)
    b = kg.fit(graph, epochs=1, seed=0, device=DEVICE, **TRAIN)
    info["rerun_bitwise"] = a.loss_history == b.loss_history and all(
        bits_equal(a.params[n], b.params[n]) for n in a.params)
    if not info["rerun_bitwise"]:
        fail("a same-seed rerun of one SGD epoch gave other bits")

    # one SGD epoch on the CPU (plain versions) and on the card (kernels),
    # from the same params and the same injected draws
    part = kg_data.PARTITIONERS["balanced"](0, graph.train,
                                            TRAIN["n_workers"])
    pos = kg_data.epoch_batches(0, 0, part, TRAIN["batch_size"])
    neg = model.make_negatives(torch.as_tensor(pos), cfg,
                               generator=torch.Generator().manual_seed(1))
    draws = lambda epoch: (neg.numpy(), None)
    card, info["card_epoch_s"] = wall(torch, lambda: kg.fit(
        graph, epochs=1, seed=0, params=init, draws=draws, device=DEVICE,
        **TRAIN))
    t0 = time.perf_counter()
    host = kg.fit(graph, epochs=1, seed=0, device="cpu", draws=draws,
                  params={n: t.cpu() for n, t in init.items()}, **TRAIN)
    info["cpu_epoch_s"] = time.perf_counter() - t0
    info["cpu_vs_card"] = {
        "param_max_abs_err": max_err(
            [card.params[n].cpu() for n in sorted(card.params)],
            [host.params[n] for n in sorted(host.params)]),
        "params_bitwise": all(bits_equal(card.params[n].cpu(),
                                         host.params[n])
                              for n in card.params),
        "loss": [card.loss_history[0], host.loss_history[0]],
        "param_tol": CPU_EPOCH_PARAM_TOL, "loss_rtol": CPU_EPOCH_LOSS_RTOL}
    print("cpu vs card epoch " + json.dumps(info["cpu_vs_card"]),
          flush=True)
    # where an SGD epoch's time goes: the device's busy share and kernels
    info["sgd_epoch_profile"] = profile_busy(torch, lambda: kg.fit(
        graph, epochs=1, seed=0, params=init, draws=draws, device=DEVICE,
        **TRAIN))
    prof = info["sgd_epoch_profile"]
    prof["dtoh_copies_per_step"] = prof["dtoh_copies"] / steps
    print("sgd epoch profile " + json.dumps(prof), flush=True)
    c = info["cpu_vs_card"]
    if c["param_max_abs_err"] > CPU_EPOCH_PARAM_TOL or abs(
            c["loss"][0] - c["loss"][1]) > CPU_EPOCH_LOSS_RTOL * abs(
                c["loss"][1]):
        fail(f"the CPU and card SGD epochs disagree: {c}")
    return sgd, bgd, info, launches, init_metrics


def serving_path(torch, graph, kb):
    """The serving main path on ``kb``: save/load, queries, rank(),
    evaluate, and the checks of the module docstring."""
    import numpy as np

    from repro_torch import kg
    from repro_torch.core import eval as host_eval
    from repro_torch.core import eval_device
    from repro_torch.kernels import rank_topk

    info = {}
    test = graph.test
    tails_known, heads_known = graph.eval_filter_candidates()

    rank_topk.rank_counts.launches = 0                # --- serving path ---
    t_start = time.perf_counter()
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
    info["serving_path_s"] = time.perf_counter() - t_start
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


def same_run(a, b):
    """Two TrainResults with the same loss history and the same bits."""
    return a.loss_history == b.loss_history and all(
        bits_equal(a.params[n], b.params[n]) for n in b.params)


class StepTimer:
    """Host seconds of each call to the methods named in ``targets``
    (``{label: (owner, attribute)}``), timed by wrapping them for the
    span of a ``with`` block; the calls themselves are unchanged."""

    def __init__(self, targets):
        self.targets = targets
        self.seconds = {label: [] for label in targets}
        self._saved = {}

    def __enter__(self):
        for label, (owner, attr) in self.targets.items():
            orig = getattr(owner, attr)
            self._saved[label] = orig

            def timed(*args, _orig=orig, _label=label, **kw):
                t0 = time.perf_counter()
                try:
                    return _orig(*args, **kw)
                finally:
                    self.seconds[_label].append(time.perf_counter() - t0)
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for label, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._saved[label])
        return False


def eval_resume_path(torch, graph, sgd, bgd):
    """Training with evaluation and resume (item 5 of the module
    docstring).  Returns the path's info and its launches of each
    kernel."""
    import numpy as np

    from repro_torch import kg
    from repro_torch.core import eval_device, mapreduce
    from repro_torch.core import trace as trace_lib
    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.train import checkpoint as ckpt_lib

    info = {"filter_index_cached_before": None in graph._filter_cands}
    steps = len(graph.train) // TRAIN["n_workers"] // TRAIN["batch_size"]
    marks = []                     # (epoch, perf_counter) per callback

    def callback(epoch, loss):     # loss is a float: synchronized
        marks.append((epoch, time.perf_counter()))

    timer = StepTimer({
        "record": (trace_lib.TraceRecorder, "record"),
        "save_async": (ckpt_lib.AsyncSaver, "save_async"),
        "finish": (mapreduce._CheckpointWriter, "finish"),
        "restore": (ckpt_lib, "restore"),
    })
    sgd_kw = dict(strategy="average", seed=0, device=DEVICE, **TRAIN)
    bgd_kw = dict(seed=0, device=DEVICE, **TRAIN)
    dirs = {name: tempfile.TemporaryDirectory() for name in "ABC"}
    t_phase = time.perf_counter()
    try:
        ts.transe_score.launches = 0          # --- eval/resume path ---
        ts.transe_score_bwd.launches = 0
        rank_topk.rank_counts.launches = 0
        with timer:
            t0 = time.perf_counter()
            a = kg.fit(graph, "transe", "sgd", epochs=SGD_EPOCHS,
                       eval_every=2, ckpt_dir=dirs["A"].name,
                       checkpoint_every=2, callback=callback, **sgd_kw)
            info["run_a_s"] = time.perf_counter() - t0
            a_marks, a_records = list(marks), len(timer.seconds["record"])
            a_saves = list(timer.seconds["save_async"])
            a_finish = list(timer.seconds["finish"])
            kg.fit(graph, "transe", "sgd", epochs=2, ckpt_dir=dirs["B"].name,
                   checkpoint_every=2, **sgd_kw)
            t0 = time.perf_counter()
            b = kg.fit(graph, "transe", "sgd", epochs=SGD_EPOCHS,
                       ckpt_dir=dirs["B"].name, resume=True, **sgd_kw)
            info["resume_b_s"] = time.perf_counter() - t0
            kg.fit(graph, "transe", "bgd", epochs=1, ckpt_dir=dirs["C"].name,
                   checkpoint_every=1, **bgd_kw)
            c = kg.fit(graph, "transe", "bgd", epochs=BGD_EPOCHS,
                       ckpt_dir=dirs["C"].name, resume=True, **bgd_kw)
        launches = {"rank_counts": rank_topk.rank_counts.launches,
                    "transe_score": ts.transe_score.launches,
                    "transe_score_bwd": ts.transe_score_bwd.launches}
        # --- end ---
        on_disk = {name: sorted(int(e.split("_")[1])
                                for e in os.listdir(d.name))
                   for name, d in dirs.items()}
        configs = {}
        for name, d in dirs.items():
            for step in on_disk[name]:
                _, _, extra = ckpt_lib.restore(d.name, step=step)
                configs[f"{name}{step}"] = extra["config"]
    finally:
        for d in dirs.values():
            d.cleanup()

    # epoch seconds of run A: between callbacks, less the evaluation and
    # the save that ran at the boundary in between
    rec, sav = timer.seconds["record"][:a_records], a_saves
    boundary = {1: rec[0] + sav[0], 3: rec[1] + sav[1]}
    epoch_s = []
    for (e0, t0), (e1, t1) in zip(a_marks, a_marks[1:]):
        epoch_s.append(t1 - t0 - boundary.get(e0, 0.0))
    walls = [e.wall_clock for e in a.trace.entries]
    info.update(
        steps_per_epoch=steps,
        epoch_s_after_first=epoch_s,
        eval_s=rec, eval_wall_clock=walls,
        eval_wall_clock_deltas=[walls[0]] + [
            y - x for x, y in zip(walls, walls[1:])],
        save_async_wait_s=sav, finish_wait_s=a_finish,
        restore_s=timer.seconds["restore"],
        steps_on_disk=on_disk, launches=launches,
        loss_history={"A": a.loss_history, "B": b.loss_history,
                      "C": c.loss_history},
        trace_epochs=a.trace.epochs(),
        merge_rounds=[e.merge_round for e in a.trace.entries],
        best_epoch=a.best_epoch)

    # checks: observing and resuming change nothing
    info["bitwise"] = {"A_vs_untraced": same_run(a, sgd),
                       "B_resumed_vs_untraced": same_run(b, sgd),
                       "bgd_resumed_vs_untraced": same_run(c, bgd)}
    print("eval/resume " + json.dumps(info), flush=True)
    if not all(info["bitwise"].values()):
        fail(f"a traced or resumed run gave other bits: {info['bitwise']}")
    if info["trace_epochs"] != [1, 3] or info["merge_rounds"] != [2, 4]:
        fail(f"trace epochs {info['trace_epochs']} and merge rounds "
             f"{info['merge_rounds']}, expected [1, 3] and [2, 4]")
    if on_disk != {"A": [2, 4], "B": [2, 4], "C": [1, 3]}:
        fail(f"checkpoint steps on disk {on_disk}")
    want_cfg = {
        "sgd": mapreduce.resume_config(*kg.make_configs(
            graph, "transe", "sgd", strategy="average", **TRAIN)),
        "bgd": mapreduce.resume_config(*kg.make_configs(
            graph, "transe", "bgd", **TRAIN))}
    for key, cfg in configs.items():
        if cfg != want_cfg["bgd" if key.startswith("C") else "sgd"]:
            fail(f"manifest {key} holds config {cfg}")
    info["runs_s"] = time.perf_counter() - t_phase
    per_eval = 2 * eval_device._layout(len(graph.test),
                                       eval_device.DEFAULT_CHUNK)[0]
    predicted = {"rank_counts": 2 * per_eval,
                 "transe_score": steps * (2 * SGD_EPOCHS + BGD_EPOCHS),
                 "transe_score_bwd": steps * (2 * SGD_EPOCHS + BGD_EPOCHS)}
    info["launches_predicted"] = predicted
    if launches != predicted:
        fail(f"launches {launches} on the eval/resume path; the schedule "
             f"predicts {predicted}")

    # the trace against later evaluations of the same params
    last, info["posthoc_evaluate_s"] = wall(
        torch, lambda: kg.evaluate(a.kb, engine="device"))
    best = kg.evaluate(a.best_params, "transe", graph, engine="device")
    info["trace_equals_evaluate"] = {
        "last": last == a.trace.entries[-1].metrics,
        "best": best == a.trace.best().metrics}
    if not all(info["trace_equals_evaluate"].values()):
        fail(f"trace entries differ from a later kg.evaluate: "
             f"{info['trace_equals_evaluate']}")

    # bf16 serving on the card, against the CPU
    kb16 = kg.KnowledgeBase(
        model="transe", graph=graph, norm="l1",
        params={n: t.to(torch.bfloat16) for n, t in a.params.items()})
    cpu16 = kg.KnowledgeBase(
        model="transe", graph=graph, norm="l1",
        params={n: t.cpu() for n, t in kb16.params.items()})
    pairs = graph.test[:N_QUERY_PAIRS]
    h, r, t = pairs[:, 0], pairs[:, 1], pairs[:, 2]
    tails, info["bf16_query_tails_s"] = wall(
        torch, lambda: kb16.query_tails(h, r, k=10))
    check_topk(tails, len(pairs), 10, "bf16 query_tails")
    scores = kb16.score(h, r, t)
    few = slice(0, 64)
    want = cpu16.query_tails(h[few], r[few], k=10)
    info["bf16"] = {
        "energies_dtype": str(tails.energies.dtype),
        "tails_equal_cpu": bool(
            np.array_equal(tails.ids[few], want.ids)
            and np.array_equal(tails.energies[few], want.energies)),
        "score_equal_cpu": bool(np.array_equal(
            scores, cpu16.score(h, r, t))),
        "fingerprint_equal_cpu": kb16.fingerprint() == cpu16.fingerprint(),
        "fingerprint_differs_from_fp32": kb16.fingerprint()
        != a.kb.fingerprint()}
    print("bf16 serving " + json.dumps(info["bf16"]), flush=True)
    if not (all(v for k, v in info["bf16"].items() if k != "energies_dtype")
            and tails.energies.dtype == np.float32
            and scores.dtype == np.float32
            and np.all(np.isfinite(scores))):
        fail(f"bf16 serving on the card: {info['bf16']}")
    info["phase_s"] = time.perf_counter() - t_phase
    return info, launches


def device_pipeline_path(torch, graph):
    """The device pipeline (item 6 of the module docstring).  Returns the
    path's info and its launches of each kernel."""
    from repro_torch import kg
    from repro_torch.core import eval_device, keys, mapreduce
    from repro_torch.core.models import get_model
    from repro_torch.data import kg as kg_data
    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.train import checkpoint as ckpt_lib

    info = {}
    steps = len(graph.train) // TRAIN["n_workers"] // TRAIN["batch_size"]
    sgd_kw = dict(seed=0, device=DEVICE, **TRAIN, **DEVICE_SGD)
    bgd_kw = dict(seed=0, device=DEVICE, pipeline="device", **TRAIN)
    marks = {}

    def timer(label):                   # loss is a float: synchronized
        marks[label] = [(None, time.perf_counter())]
        return lambda epoch, loss: marks[label].append(
            (epoch, time.perf_counter()))

    kcfg, mcfg = kg.make_configs(graph, "transe", "sgd", block_epochs=2,
                                 **TRAIN, **DEVICE_SGD)
    part = torch.as_tensor(kg_data.PARTITIONERS["balanced"](
        0, graph.train, TRAIN["n_workers"]), device=DEVICE)
    init = get_model("transe").init_params(
        torch.Generator().manual_seed(0), kcfg, device=DEVICE)
    dirs = {name: tempfile.TemporaryDirectory() for name in "DE"}
    card_epochs, n_evals = 0, 0
    t_phase = time.perf_counter()
    try:
        ts.transe_score.launches = 0          # --- device pipeline path ---
        ts.transe_score_bwd.launches = 0
        rank_topk.rank_counts.launches = 0
        # (a) block invariance on the card
        a4 = kg.fit(graph, "transe", "sgd", epochs=4, block_epochs=4,
                    callback=timer("a4"), **sgd_kw)
        a2 = kg.fit(graph, "transe", "sgd", epochs=4, block_epochs=2,
                    callback=timer("a2"), **sgd_kw)
        # (b) BGD
        b = kg.fit(graph, "transe", "bgd", epochs=3, block_epochs=3,
                   callback=timer("b"), **bgd_kw)
        # (c) one merge round on the card (the CPU's below)
        c_card = kg.fit(graph, "transe", "sgd", epochs=2, block_epochs=2,
                        **sgd_kw)
        card_epochs += 4 + 4 + 3 + 2
        # (d) one block with any host sync an error
        block_fn = mapreduce.make_block_fn(mcfg, kcfg, part, seed=0,
                                           donate=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            params, losses = block_fn(dict(init), range(2))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        info["sync_checked_block_losses"] = losses.tolist()
        # the peak memory of a block, donation on and off
        peaks_b = {}
        for label, donate in (("donate_on", True), ("donate_off", False)):
            fn = mapreduce.make_block_fn(mcfg, kcfg, part, seed=0,
                                         donate=donate)
            given = {n: t.clone() for n, t in init.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out, _ = fn(given, range(2))
            torch.cuda.synchronize()
            peaks_b[label] = {"before_bytes": before,
                              "peak_bytes": torch.cuda.max_memory_allocated(),
                              "tables_bytes": sum(t.numel() * t.element_size()
                                                  for t in init.values())}
            del given, out
        info["block_peak_memory"] = peaks_b
        # the same block under the profiler
        prof = profile_busy(torch, lambda: block_fn(dict(init), range(2)))
        prof.update(epochs=2, steps=2 * steps,
                    launches_per_epoch=prof["launches"] / 2,
                    dtoh_copies_per_step=prof["dtoh_copies"] / (2 * steps))
        info["block_profile"] = prof
        card_epochs += 2 + 2 + 2 + 2
        # (e) evaluation, checkpoints and resume
        e_traced = kg.fit(graph, "transe", "sgd", epochs=4, block_epochs=4,
                          eval_every=2, ckpt_dir=dirs["D"].name,
                          checkpoint_every=2, **sgd_kw)
        kg.fit(graph, "transe", "sgd", epochs=2, block_epochs=4,
               ckpt_dir=dirs["E"].name, checkpoint_every=2, **sgd_kw)
        e_resumed = kg.fit(graph, "transe", "sgd", epochs=4, block_epochs=4,
                           ckpt_dir=dirs["E"].name, resume=True, **sgd_kw)
        card_epochs += 4 + 2 + 2
        n_evals += 2
        launches = {"rank_counts": rank_topk.rank_counts.launches,
                    "transe_score": ts.transe_score.launches,
                    "transe_score_bwd": ts.transe_score_bwd.launches}
        # --- end ---
        on_disk = {name: sorted(int(e.split("_")[1])
                                for e in os.listdir(d.name))
                   for name, d in dirs.items()}
        manifests = {}
        for name, d in dirs.items():
            for step in on_disk[name]:
                _, _, extra = ckpt_lib.restore(d.name, step=step)
                manifests[f"{name}{step}"] = (extra["pipeline"],
                                              extra["config"])
    finally:
        for d in dirs.values():
            d.cleanup()
    info["runs_s"] = time.perf_counter() - t_phase

    # (c) the CPU's round, and the draws alone
    t0 = time.perf_counter()
    c_cpu = kg.fit(graph, "transe", "sgd", epochs=2, block_epochs=2,
                   **dict(sgd_kw, device="cpu"))
    info["cpu_round_s"] = time.perf_counter() - t0
    wkeys = keys.fold_in(keys.device_keys(0)[1], torch.arange(4))
    draws = {
        "bits": lambda d: keys.random_bits(wkeys.to(d), DRAW_COUNTERS, d),
        "uniform": lambda d: keys.uniform(wkeys.to(d), DRAW_COUNTERS, d),
        "randint": lambda d: keys.randint(wkeys.to(d), DRAW_COUNTERS, 1,
                                          graph.n_entities, d),
        "permutation": lambda d: keys.permutation(wkeys.to(d),
                                                  DRAW_COUNTERS, d)}
    info["draws_cpu_equal_card"] = {
        name: bool(torch.equal(fn(DEVICE).cpu(), fn("cpu")))
        for name, fn in draws.items()}
    info["cpu_vs_card_round"] = {
        "params_bitwise": all(bits_equal(c_card.params[n].cpu(),
                                         c_cpu.params[n])
                              for n in c_cpu.params),
        "param_max_abs_err": max_err(
            [c_card.params[n].cpu() for n in sorted(c_card.params)],
            [c_cpu.params[n] for n in sorted(c_cpu.params)]),
        "losses": [c_card.loss_history, c_cpu.loss_history],
        "losses_bitwise": c_card.loss_history == c_cpu.loss_history}

    def per_epoch(label, epochs_per_block):
        m = marks[label]
        return [(t1 - t0) / epochs_per_block
                for (_, t0), (_, t1) in zip(m, m[1:])]

    info.update(
        steps_per_epoch=steps, launches=launches,
        epoch_s={"sgd_block4": per_epoch("a4", 2),
                 "sgd_block2": per_epoch("a2", 2),
                 "bgd_block3": per_epoch("b", 3)},
        callback_epochs={k: [e for e, _ in v[1:]] for k, v in marks.items()},
        loss_history={"a": a4.loss_history, "b": b.loss_history},
        steps_on_disk=on_disk,
        trace_epochs=e_traced.trace.epochs(),
        merge_rounds=[e.merge_round for e in e_traced.trace.entries],
        bitwise={"block4_vs_block2": same_run(a4, a2),
                 "traced_vs_untraced": same_run(e_traced, a4),
                 "resumed_vs_unbroken": same_run(e_resumed, a4),
                 "sync_checked_block_vs_fit": info[
                     "sync_checked_block_losses"] == a4.loss_history[:2]})
    predicted = {"rank_counts": n_evals * 2 * eval_device._layout(
                     len(graph.test), eval_device.DEFAULT_CHUNK)[0],
                 "transe_score": steps * card_epochs,
                 "transe_score_bwd": steps * card_epochs}
    info["launches_predicted"] = predicted
    print("device pipeline " + json.dumps(info), flush=True)
    if not all(info["bitwise"].values()):
        fail(f"device-pipeline runs that should agree gave other bits: "
             f"{info['bitwise']}")
    c = info["cpu_vs_card_round"]
    if not (c["params_bitwise"] and c["losses_bitwise"]
            and all(info["draws_cpu_equal_card"].values())):
        fail(f"the CPU and the card disagree on a device-pipeline round or "
             f"its draws: {c} {info['draws_cpu_equal_card']}")
    if info["trace_epochs"] != [1, 3] or info["merge_rounds"] != [1, 2]:
        fail(f"trace epochs {info['trace_epochs']} and merge rounds "
             f"{info['merge_rounds']}, expected [1, 3] and [1, 2]")
    if info["callback_epochs"] != {"a4": [1, 3], "a2": [1, 3], "b": [2]}:
        fail(f"callbacks at {info['callback_epochs']}")
    if on_disk != {"D": [2, 4], "E": [2, 4]}:
        fail(f"checkpoint steps on disk {on_disk}")
    want_cfg = mapreduce.resume_config(kcfg, mcfg)
    for key, (pipeline, cfg) in manifests.items():
        if pipeline != "device" or cfg != want_cfg:
            fail(f"manifest {key}: pipeline {pipeline!r}, config {cfg}")
    for name, hist in info["loss_history"].items():
        if not all(map(math.isfinite, hist)) or not hist[-1] < hist[0]:
            fail(f"device pipeline {name}: loss did not fall: {hist}")
    if launches != predicted:
        fail(f"launches {launches} on the device pipeline path; the "
             f"schedule predicts {predicted}")
    if info["block_profile"]["dtoh_copies"] != 0:
        fail(f"a device-pipeline block made "
             f"{info['block_profile']['dtoh_copies']} device-to-host copies")
    last = kg.evaluate(e_traced.kb, engine="device")
    if last != e_traced.trace.entries[-1].metrics:
        fail("the device pipeline's last trace entry differs from a later "
             "kg.evaluate")
    info["phase_s"] = time.perf_counter() - t_phase
    return info, launches


def answer_bits(ans, ids, energies):
    """A served answer with the given ids and the same energy bits."""
    import numpy as np

    return np.array_equal(ans.ids, ids) and np.array_equal(
        ans.energies.view(np.uint32), np.asarray(energies).view(np.uint32))


def live_percentiles(lats):
    import numpy as np

    if not lats:
        return {"n": 0, "p50_ms": None, "p99_ms": None}
    arr = np.asarray(lats, np.float64) * 1e3
    return {"n": len(lats), "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99))}


def live_wave(srv, kind, queries):
    """Submit ``queries`` (``(a, b, options)`` triples) while admission is
    paused, then release them: the batcher admits exactly this set as one
    wave (the cache cleared first, so none of them is a hit)."""
    srv.clear_cache()
    srv.pause()
    futs = [srv.submit(kind, a, b, **kw) for a, b, kw in queries]
    srv.resume()
    return [f.result(timeout=LIVE_TIMEOUT_S) for f in futs]


def live_stream(srv, pairs, rate, n, seed, midway=None):
    """An open-loop stream: ``n`` single ``tails`` queries at Poisson
    arrivals of ``rate`` a second (seeded), each drawn from ``pairs``; the
    sender never waits for an answer.  ``midway`` runs on a thread of its
    own from the stream's half.  Returns the submitted pairs, the answers
    and the stream's rates."""
    import threading

    import numpy as np

    rng = np.random.default_rng(seed)
    at = np.cumsum(rng.exponential(1.0 / rate, n))
    pick = pairs[rng.integers(0, len(pairs), n)]
    futs, side = [], None
    t0 = time.perf_counter()
    for i in range(n):
        delay = at[i] - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        futs.append(srv.submit("tails", pick[i, 0], pick[i, 1]))
        if midway is not None and i == n // 2:
            side = threading.Thread(target=midway)
            side.start()
    sent = time.perf_counter() - t0
    answers = [f.result(timeout=LIVE_TIMEOUT_S) for f in futs]
    done = time.perf_counter() - t0
    if side is not None:
        side.join(timeout=LIVE_TIMEOUT_S)
        if side.is_alive():
            fail("the mid-stream call did not return")
    return pick, answers, {"offered_qps": n / sent,
                           "sustained_qps": n / done, "span_s": done}


def live_delta(before, after):
    """What the server did between two ``ServerStats``."""
    waves = after.waves - before.waves
    rows = after.cache_misses - before.cache_misses
    return {
        "waves": waves, "mean_wave": rows / waves if waves else 0.0,
        "bucket_waves": {b: n - before.bucket_waves.get(b, 0)
                         for b, n in after.bucket_waves.items()
                         if n != before.bucket_waves.get(b, 0)},
        "cache_hits": after.cache_hits - before.cache_hits,
        "cache_misses": rows,
        "steady_recompiles": after.steady_recompiles
        - before.steady_recompiles,
    }


def serving_live_path(torch, sgd, bgd):
    """The live server (item 7 of the module docstring).  Returns the
    path's info and its launches of each kernel."""
    import numpy as np

    from repro_torch import kg
    from repro_torch.data import kg as kg_data
    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.serve import KGServer, kg_engine

    info = {}
    t_phase = time.perf_counter()
    dirs = {name: tempfile.TemporaryDirectory() for name in ("sgd", "bgd")}
    config = {cfg[0]: cfg for cfg in LIVE_CONFIGS}
    servers = []

    def server(kb, label, **kw):
        _, max_batch, wait_us = config[label]
        srv = KGServer(kb, max_batch=max_batch, max_wait_us=wait_us,
                       default_k=LIVE_K, **kw)
        servers.append(srv)
        return srv

    def on_card(srv, *tenants):
        for name in tenants:
            if srv.tenant_kb(name).engine().device.type != "cuda":
                fail(f"tenant {name!r} is not served from the card")

    def bucket_waves(srv):
        """One unfiltered tails wave filling each bucket, then one
        filtered query: the seconds of each wave's service."""
        with StepTimer({"wave": (KGServer, "_execute")}) as timer:
            for bucket in srv.buckets:
                live_wave(srv, "tails",
                          [(h, r, {}) for h, r, _ in pairs[:bucket]])
            live_wave(srv, "tails", [(pairs[0, 0], pairs[0, 1],
                                      {"filtered": True})])
            # the timer records a wave after its futures resolve
            if not srv.drain(timeout=LIVE_TIMEOUT_S):
                fail("the server did not drain")
        seconds = timer.seconds["wave"]
        return dict(zip(map(str, srv.buckets), seconds)), seconds[-1]

    try:
        rank_topk.rank_counts.launches = 0      # --- live serving path ---
        ts.transe_score.launches = 0
        ts.transe_score_bwd.launches = 0
        sgd.kb.save(dirs["sgd"].name)
        bgd.kb.save(dirs["bgd"].name)

        def load(name):
            return kg.KnowledgeBase.load(dirs[name].name, device=DEVICE)

        kb_bgd = load("bgd")
        graph = kb_bgd.graph
        fp = {"sgd": sgd.kb.fingerprint(), "bgd": kb_bgd.fingerprint()}
        _, first = np.unique(graph.test[:, :2], axis=0, return_index=True)
        pairs = graph.test[np.random.default_rng(0).permutation(first)]

        # (a) start-up: cold waves on an unwarmed server first (nothing in
        # this process has run these shapes), then the warm server's
        # warm-up, split into the known index and the engine calls
        cold = server(load("sgd"), "batch64_wait2ms")
        on_card(cold, "default")
        shapes0 = kg_engine.shapes_seen()
        cold_waves, cold_filtered = bucket_waves(cold)
        cold_shapes = kg_engine.shapes_seen() - shapes0
        cold.stop()
        kb = load("sgd")
        if kb.fingerprint() != fp["sgd"]:
            fail("the SGD artifact's fingerprint changed across save/load")
        engine_calls = ("query_tails", "query_heads", "query_relations")
        with StepTimer({"known_index": (kg_data.KG, "known_index"),
                        **{name: (kg_engine.KGQueryEngine, name)
                           for name in engine_calls}}) as timer:
            t0 = time.perf_counter()
            live = server(kb, "batch64_wait2ms", warm=True)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        on_card(live, "default")
        st = live.stats()
        warm_waves, warm_filtered = bucket_waves(live)
        info["startup"] = {
            "warm_s": warm_s,
            "known_index_s": sum(timer.seconds["known_index"]),
            "engine_calls_s": sum(sum(timer.seconds[n])
                                  for n in engine_calls),
            "engine_calls": sum(len(timer.seconds[n])
                                for n in engine_calls),
            "warm_compiles": st.warm_compiles, "cold_shapes": cold_shapes,
            "ex_width": live._ex_width(live._tenants["default"]),
            "buckets": list(live.buckets),
            "cold_wave_s": cold_waves, "warm_wave_s": warm_waves,
            "cold_first_filtered_s": cold_filtered,
            "warm_first_filtered_s": warm_filtered}
        print("live start-up " + json.dumps(info["startup"]), flush=True)
        n_shapes = 5 * len(live.buckets)
        if st.warm_compiles + cold_shapes != n_shapes:
            fail(f"warm-up ran {st.warm_compiles} new shapes after the "
                 f"cold server's {cold_shapes}; {n_shapes} expected")

        # (b) parity: each served answer against the engine on the same
        # single query at chunk=1, at every bucket, fresh then cached
        eng, E = kb.engine(), kb.n_entities
        cols = {"tails": (0, 1), "heads": (2, 1), "relations": (0, 2)}
        cells, fresh, lo = {}, {}, 0
        for kind, mode in PARITY_CELLS:
            before = live.stats()
            queries, direct = [], []
            for size in PARITY_SIZES:
                wave_q = []
                for row in pairs[lo:lo + size]:
                    a, b = (int(row[c]) for c in cols[kind])
                    kw, ex = {}, None
                    if mode == "filtered":
                        kw = {"filtered": True}
                        ex = (graph.known_candidate_masks(
                            np.array([[a, b]]), "tail") if kind == "tails"
                            else graph.known_candidate_masks(
                                np.array([[b, a]]), "head"))
                    elif mode == "exclude":
                        kw = {"exclude": sorted({(a * 7 + j * 131) % E
                                                 for j in range(5)})}
                        ex = np.array([kw["exclude"]], np.int32)
                    if kind == "relations":
                        want = eng.query_relations([a], [b], k=LIVE_K,
                                                   chunk=1)
                    else:
                        call = (eng.query_tails if kind == "tails"
                                else eng.query_heads)
                        want = call([a], [b], k=LIVE_K, exclude=ex,
                                    chunk=1)
                    wave_q.append((a, b, kw))
                    direct.append((want.ids[0], want.energies[0]))
                lo += size
                for ans, (ids, en), (_, _, kw) in zip(
                        live_wave(live, kind, wave_q), direct[-size:],
                        wave_q):
                    if ans.cached or not answer_bits(ans, ids, en):
                        fail(f"a served {kind} answer ({mode}) differs "
                             f"from the engine's at wave size {size}")
                    if set(kw.get("exclude", ())) & set(ans.ids.tolist()):
                        fail(f"an excluded id was served ({kind})")
                queries += wave_q
            for _ in range(2):      # the cell again: the second pass hits
                futs = [live.submit(kind, a, b, **kw)
                        for a, b, kw in queries]
                answers = [f.result(timeout=LIVE_TIMEOUT_S) for f in futs]
            for ans, (ids, en) in zip(answers, direct):
                if not ans.cached or not answer_bits(ans, ids, en):
                    fail(f"a cached {kind} answer ({mode}) differs from "
                         "the engine's")
            cell = f"{kind}-{mode}"
            cells[cell] = len(queries)
            fresh[cell] = live_delta(before, live.stats())[
                "steady_recompiles"]
        info["parity"] = {"queries": cells, "sizes": list(PARITY_SIZES),
                          "new_shapes": fresh}
        print("live parity " + json.dumps(info["parity"]), flush=True)
        # explicit 5-id exclusions pad to width 8, a width warm-up does
        # not run (as in the reference): at most one new shape a bucket,
        # fewer where a direct call at chunk=1 met the shape first
        for cell, n in fresh.items():
            if n > (len(live.buckets) if cell.endswith("exclude") else 0):
                fail(f"the parity waves of {cell} met {n} new shapes")

        # (c) capacity and (d) an open loop at half of it, per config
        info["configs"] = {}
        hot = pairs[:LIVE_UNIQUE, :2]
        for label, _, _ in LIVE_CONFIGS:
            srv = live if label == "batch64_wait2ms" else server(
                kb, label, warm=True)
            on_card(srv, "default")
            srv.clear_cache()
            before = srv.stats()
            t0 = time.perf_counter()
            futs = [srv.submit("tails", h, r)
                    for h, r in pairs[:LIVE_BURST, :2]]
            for f in futs:
                f.result(timeout=LIVE_TIMEOUT_S)
            burst_s = time.perf_counter() - t0
            cap = {"completions_per_s": LIVE_BURST / burst_s,
                   "span_s": burst_s, **live_delta(before, srv.stats())}
            srv.clear_cache()
            before = srv.stats()
            allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
            _, answers, rates = live_stream(
                srv, hot, 0.5 * cap["completions_per_s"], LIVE_ARRIVALS,
                seed=1)
            allocs = torch.cuda.memory_stats().get(
                "num_device_alloc", 0) - allocs
            after = srv.stats()
            misses = [a.latency_s for a in answers if not a.cached]
            info["configs"][label] = {"capacity": cap, "open_loop": {
                **rates,
                "all": live_percentiles([a.latency_s for a in answers]),
                "misses": live_percentiles(misses),
                "hit_rate": 1 - len(misses) / len(answers),
                "num_device_alloc_delta": allocs,
                **live_delta(before, after)}}
            print(f"live {label} " + json.dumps(info["configs"][label]),
                  flush=True)
            recompiles = info["configs"][label]["open_loop"][
                "steady_recompiles"] + cap["steady_recompiles"]
            if recompiles:
                fail(f"{label}: {recompiles} steady-state recompiles")

        # (e) a second tenant, then a hot swap under load
        srv = server(kb, "batch16_wait1ms", warm=True)
        srv.add_tenant("bgd", kb_bgd)
        on_card(srv, "default", "bgd")
        want = kb_bgd.engine().query_tails(hot[:32, 0], hot[:32, 1],
                                           k=LIVE_K)
        mine = kb.engine().query_tails(hot[:32, 0], hot[:32, 1], k=LIVE_K)
        for i, (a, b) in enumerate(hot[:32]):
            ans = srv.submit("tails", a, b, tenant="bgd").result(
                timeout=LIVE_TIMEOUT_S)
            if ans.fingerprint != fp["bgd"] or not answer_bits(
                    ans, want.ids[i], want.energies[i]):
                fail("the second tenant did not answer with its own bits")
        if np.array_equal(want.energies, mine.energies):
            fail("the two artifacts give the same answers: the swap check "
                 "could not tell them apart")
        srv.clear_cache()
        before = srv.stats()
        rate = 0.5 * info["configs"]["batch16_wait1ms"]["capacity"][
            "completions_per_s"]
        # the swap's parts, timed on its own thread: the exclusion width
        # (a pass over the known index) and the new tenant's warm-up
        with StepTimer({name: (KGServer, name) for name in (
                "swap", "_ex_width", "_warm_tenant")}) as timer:
            pick, answers, rates = live_stream(
                srv, hot, rate, LIVE_SWAP_ARRIVALS, seed=2,
                midway=lambda: srv.swap(kb_bgd))
        after = srv.stats()
        by_fp = {}
        for (a, b), ans in zip(pick, answers):
            by_fp.setdefault(ans.fingerprint, []).append((a, b, ans))
        if set(by_fp) - set(fp.values()):
            fail(f"answers under unknown fingerprints {set(by_fp)}")
        for name, art in (("sgd", kb), ("bgd", kb_bgd)):
            group = by_fp.get(fp[name], [])
            if not group:
                fail(f"no answer from the {name} artifact across the swap")
            res = art.engine().query_tails(
                [g[0] for g in group], [g[1] for g in group], k=LIVE_K,
                chunk=64)
            for i, (_, _, ans) in enumerate(group):
                if not answer_bits(ans, res.ids[i], res.energies[i]):
                    fail(f"an answer stamped {name} differs from that "
                         "artifact's engine")
        info["swap"] = {
            **rates, "answers": {name: len(by_fp.get(key, []))
                                 for name, key in fp.items()},
            "cache_invalidations": after.cache_invalidations
            - before.cache_invalidations,
            "swaps": after.swaps - before.swaps,
            "all": live_percentiles([a.latency_s for a in answers]),
            "misses": live_percentiles([a.latency_s for a in answers
                                        if not a.cached]),
            "swap_s": sum(timer.seconds["swap"]),
            "warm_s": sum(timer.seconds["_warm_tenant"]),
            "ex_width_s": max(timer.seconds["_ex_width"]),
            **live_delta(before, after)}
        print("live swap " + json.dumps(info["swap"]), flush=True)
        if info["swap"]["cache_invalidations"] != 1 or \
                after.steady_recompiles != 0:
            fail(f"swap: {info['swap']}")
        launches = {"rank_counts": rank_topk.rank_counts.launches,
                    "transe_score": ts.transe_score.launches,
                    "transe_score_bwd": ts.transe_score_bwd.launches}
    finally:                                    # --- end ---
        for srv in servers:
            srv.stop()
        for d in dirs.values():
            d.cleanup()
    info["launches"] = launches
    info["phase_s"] = time.perf_counter() - t_phase
    return info, launches


def family_serving(torch, graph, kb, label):
    """Item 8(d) on one artifact: save/load, filtered queries, scores,
    ``rank()``, ``kg.evaluate(kb, engine="device")`` and the device engine
    against the host protocol on a slice of the test split.  Returns the
    artifact's info and its metrics."""
    import numpy as np

    from repro_torch import kg
    from repro_torch.core import eval as host_eval
    from repro_torch.core import eval_device

    info = {}
    test = graph.test
    tails_known, heads_known = graph.eval_filter_candidates()
    fp = kb.fingerprint()
    with tempfile.TemporaryDirectory() as tmp:
        kb.save(tmp)
        kb, info["load_s"] = wall(
            torch, lambda: kg.KnowledgeBase.load(tmp, device=DEVICE))
    if kb.fingerprint() != fp:
        fail(f"{label}: fingerprint changed across save/load")
    if not all(t.is_cuda for t in kb.params.values()):
        fail(f"{label}: the loaded artifact's tables are not on the card")
    pairs = test[:N_QUERY_PAIRS]
    h, r, t = pairs[:, 0], pairs[:, 1], pairs[:, 2]
    tails, info["query_tails_s"] = wall(
        torch, lambda: kb.query_tails(h, r, k=10, filtered=True))
    heads, info["query_heads_s"] = wall(
        torch, lambda: kb.query_heads(t, r, k=10, filtered=True))
    rels, info["query_relations_s"] = wall(
        torch, lambda: kb.query_relations(h, t, k=10))
    scores, info["score_s"] = wall(torch, lambda: kb.score(h, r, t))
    n = len(pairs)
    check_topk(tails, n, 10, f"{label} query_tails",
               graph.known_candidate_masks(pairs[:, :2], "tail"))
    check_topk(heads, n, 10, f"{label} query_heads",
               graph.known_candidate_masks(pairs[:, 1:], "head"))
    check_topk(rels, n, 10, f"{label} query_relations")
    # the tail side scores each candidate with score()'s operations
    if not np.array_equal(kb.score(h, r, tails.ids[:, 0]),
                          tails.energies[:, 0]):
        fail(f"{label}: query_tails energies disagree with score()")
    if scores.shape != (n,) or not np.all(np.isfinite(scores)):
        fail(f"{label}: score(): bad output")
    ranks, info["rank_s"] = wall(torch, lambda: kb.engine().rank(
        test, "tail", cand_masks=tails_known))
    metrics, info["evaluate_s"] = wall(
        torch, lambda: kg.evaluate(kb, engine="device"))
    n_q = len(test)
    for key in ("entity_raw", "entity_filtered", "relation_prediction"):
        row = metrics[key]
        if row["n"] != (2 * n_q if key.startswith("entity") else n_q) or \
                not 1 <= row["mean_rank"] <= graph.n_entities:
            fail(f"{label}: metrics[{key}] malformed: {row}")
    if not 0 <= metrics["triplet_classification_acc"] <= 1:
        fail(f"{label}: triplet classification accuracy out of [0, 1]")
    if ranks.shape != (n_q,) or ranks.min() < 1:
        fail(f"{label}: rank() gave malformed ranks")
    # the device engine against the host reference protocol, on a slice
    rows = test[:HOST_CHECK_ROWS]
    host = host_eval.entity_inference(
        kb.params, rows, kb.norm, graph.known_set(), model=kb.model,
        known_index=graph.known_index(), return_ranks=True)
    dev = eval_device.entity_ranks_device(
        kb.params, rows, kb.norm, (tails_known[:HOST_CHECK_ROWS],
                                   heads_known[:HOST_CHECK_ROWS]),
        model=kb.model, fused=False)
    for group in ("raw_ranks", "filtered_ranks"):
        for side in ("tail", "head"):
            if not np.array_equal(host[group][side], dev[group][side]):
                fail(f"{label}: the device engine differs from the host "
                     f"protocol: {group}.{side}")
    return info, metrics


def family_server_parity(torch, kb):
    """Item 8(e): a DistMult tenant in ``KGServer``, waves filling every
    bucket; each served answer against the engine on the same single
    query at ``chunk=1``, bit for bit.  Returns the answers checked."""
    import numpy as np

    from repro_torch.serve import KGServer

    graph = kb.graph
    eng = kb.engine()
    srv = KGServer(kb, max_batch=64, max_wait_us=2000, default_k=LIVE_K)
    checked = 0
    try:
        if srv.tenant_kb("default").engine().device.type != "cuda":
            fail("the DistMult tenant is not served from the card")
        cols = {"tails": (0, 1), "heads": (2, 1), "relations": (0, 2)}
        lo = 0
        for kind, mode in (("tails", "plain"), ("heads", "filtered"),
                           ("relations", "plain")):
            for size in PARITY_SIZES:
                wave_q, direct = [], []
                for row in graph.test[lo:lo + size]:
                    a, b = (int(row[c]) for c in cols[kind])
                    kw, ex = {}, None
                    if mode == "filtered":
                        kw = {"filtered": True}
                        ex = graph.known_candidate_masks(
                            np.array([[b, a]]), "head")
                    if kind == "relations":
                        want = eng.query_relations([a], [b], k=LIVE_K,
                                                   chunk=1)
                    else:
                        call = (eng.query_tails if kind == "tails"
                                else eng.query_heads)
                        want = call([a], [b], k=LIVE_K, exclude=ex,
                                    chunk=1)
                    wave_q.append((a, b, kw))
                    direct.append((want.ids[0], want.energies[0]))
                lo += size
                for ans, (ids, en) in zip(live_wave(srv, kind, wave_q),
                                          direct):
                    if ans.cached or not answer_bits(ans, ids, en):
                        fail(f"a served DistMult {kind} answer ({mode}) "
                             f"differs from the engine's at wave size "
                             f"{size}")
                    checked += 1
        st = srv.stats()
        if any(st.bucket_waves.get(b, 0) == 0 for b in srv.buckets):
            fail(f"the DistMult waves left a bucket empty: "
                 f"{st.bucket_waves}")
    finally:
        srv.stop()
    return checked


def model_family_path(torch, graph):
    """The model family and joint negatives (item 8 of the module
    docstring).  Returns the path's info and its launches of each
    kernel."""
    from repro_torch import kg
    from repro_torch.core import eval_device, mapreduce
    from repro_torch.core.models import KGConfig, get_model
    from repro_torch.data import kg as kg_data
    from repro_torch.kernels import rank_topk, transe_score as ts

    info = {}
    steps = len(graph.train) // TRAIN["n_workers"] // TRAIN["batch_size"]
    base_kw = dict(seed=0, device=DEVICE, **TRAIN)
    marks = {}

    def timer(label):                   # loss is a float: synchronized
        marks[label] = [time.perf_counter()]
        return lambda epoch, loss: marks[label].append(time.perf_counter())

    t_phase = time.perf_counter()
    rank_topk.rank_counts.launches = 0        # --- model family path ---
    ts.transe_score.launches = 0
    ts.transe_score_bwd.launches = 0
    runs = {}
    for model in ("transh", "distmult"):      # (a), (b): host pipeline
        runs[f"{model}_sgd"] = kg.fit(
            graph, model, "sgd", strategy="average",
            epochs=FAMILY_SGD_EPOCHS, callback=timer(f"{model}_sgd"),
            **base_kw)
        runs[f"{model}_bgd"] = kg.fit(
            graph, model, "bgd", epochs=FAMILY_BGD_EPOCHS,
            callback=timer(f"{model}_bgd"), **base_kw)
    # (c) TransE with joint negatives: joint-48 on the device pipeline in
    # blocks of 4 and of 2, the full pool under BGD on the host pipeline
    for blocks in (4, 2):
        runs[f"joint_sgd_block{blocks}"] = kg.fit(
            graph, "transe", "sgd", epochs=JOINT_EPOCHS,
            block_epochs=blocks, callback=timer(f"joint_sgd_block{blocks}"),
            **base_kw, **JOINT_SGD)
    runs["joint_bgd"] = kg.fit(graph, "transe", "bgd",
                               epochs=FAMILY_BGD_EPOCHS,
                               callback=timer("joint_bgd"), **base_kw,
                               **JOINT_BGD)
    # (d) each SGD artifact saved, loaded, queried, ranked, evaluated
    served, metrics = {}, {}
    for label, res in (("transh", runs["transh_sgd"]),
                       ("distmult", runs["distmult_sgd"]),
                       ("transe_joint", runs["joint_sgd_block4"])):
        served[label], metrics[label] = family_serving(torch, graph, res.kb,
                                                       label)
    # (e) a DistMult tenant in the live server
    parity_answers = family_server_parity(torch, runs["distmult_sgd"].kb)
    launches = {"rank_counts": rank_topk.rank_counts.launches,
                "transe_score": ts.transe_score.launches,
                "transe_score_bwd": ts.transe_score_bwd.launches}
    # --- end ---
    info["runs_s"] = time.perf_counter() - t_phase
    # the TransE artifact is ranked twice through the kernel: rank() and
    # kg.evaluate, each both sides of every test chunk
    predicted = {"rank_counts": 2 * 2 * eval_device._layout(
                     len(graph.test), eval_device.DEFAULT_CHUNK)[0],
                 "transe_score": 0, "transe_score_bwd": 0}
    info.update(launches=launches, launches_predicted=predicted,
                served=served, metrics=metrics,
                server_parity_answers=parity_answers,
                loss_history={k: v.loss_history for k, v in runs.items()})
    per_block = {"joint_sgd_block4": 4, "joint_sgd_block2": 2}
    info["epoch_s"] = {
        k: [(t1 - t0) / per_block.get(k, 1) for t0, t1 in zip(m, m[1:])]
        for k, m in marks.items()}
    for label, res in runs.items():
        if not all(t.is_cuda for t in res.params.values()):
            fail(f"{label}: a trained table is not on the card")

    # a same-seed rerun of FAMILY_RERUN_STEPS steps of each model through
    # the engine's epoch function, and its profile
    part = kg_data.PARTITIONERS["balanced"](0, graph.train,
                                            TRAIN["n_workers"])
    pos = kg_data.epoch_batches(0, 0, part, TRAIN["batch_size"])
    info["steps_per_epoch"] = steps
    info["rerun_bitwise"], info["step_profile"] = {}, {}
    info["cpu_vs_card"] = {}
    for label, model, opts in FAMILY_CELLS:
        # the host pipeline's form of the cell
        opts = {k: v for k, v in opts.items()
                if k not in ("pipeline", "merge_every")}
        kcfg, mcfg = kg.make_configs(graph, model, "sgd", **TRAIN, **opts)
        m = get_model(model)
        init = m.init_params(torch.Generator().manual_seed(0), kcfg,
                             device=DEVICE)
        neg = m.make_negatives(torch.as_tensor(pos), kcfg,
                               generator=torch.Generator().manual_seed(1))
        p20 = torch.as_tensor(pos[:, :FAMILY_RERUN_STEPS], device=DEVICE)
        n20 = neg[:, :FAMILY_RERUN_STEPS].to(DEVICE)
        epoch_fn = mapreduce.make_epoch_fn(mcfg, kcfg, check_ids=False)
        a = epoch_fn(init, p20, n20, None)
        b = epoch_fn(init, p20, n20, None)
        info["rerun_bitwise"][label] = bits_equal(a[1], b[1]) and all(
            bits_equal(a[0][n], b[0][n]) for n in a[0])
        prof = profile_busy(torch, lambda: epoch_fn(init, p20, n20, None))
        prof["launches_per_step"] = prof["launches"] / FAMILY_RERUN_STEPS
        prof["dtoh_copies_per_step"] = (prof["dtoh_copies"]
                                        / FAMILY_RERUN_STEPS)
        info["step_profile"][label] = prof
        # one SGD epoch on the CPU and on the card, same params and draws
        draws = lambda epoch: (neg.numpy(), None)
        card, card_s = wall(torch, lambda: kg.fit(
            graph, model, epochs=1, seed=0, params=init, draws=draws,
            device=DEVICE, **TRAIN, **opts))
        t0 = time.perf_counter()
        host = kg.fit(graph, model, epochs=1, seed=0, device="cpu",
                      draws=draws, params={n: t.cpu() for n, t in
                                           init.items()},
                      **TRAIN, **opts)
        info["cpu_vs_card"][label] = {
            "card_epoch_s": card_s, "cpu_epoch_s": time.perf_counter() - t0,
            "param_max_abs_err": max_err(
                [card.params[n].cpu() for n in sorted(card.params)],
                [host.params[n] for n in sorted(host.params)]),
            "params_bitwise": all(bits_equal(card.params[n].cpu(),
                                             host.params[n])
                                  for n in card.params),
            "loss": [card.loss_history[0], host.loss_history[0]],
            "loss_bitwise": card.loss_history == host.loss_history}
    info["bitwise"] = {
        "joint_block4_vs_block2": same_run(runs["joint_sgd_block4"],
                                           runs["joint_sgd_block2"]),
        **{f"rerun_{k}": v for k, v in info["rerun_bitwise"].items()}}
    info["phase_s"] = time.perf_counter() - t_phase
    print("model family " + json.dumps(info), flush=True)

    if launches != predicted:
        fail(f"launches {launches} on the model-family path; the path "
             f"predicts {predicted}")
    if not all(info["bitwise"].values()):
        fail(f"model-family runs that should agree gave other bits: "
             f"{info['bitwise']}")
    for label, c in info["cpu_vs_card"].items():
        if c["param_max_abs_err"] > FAMILY_CPU_TOL or abs(
                c["loss"][0] - c["loss"][1]) > FAMILY_CPU_TOL * abs(
                    c["loss"][1]):
            fail(f"the CPU and card SGD epochs of {label} disagree: {c}")
    for label, hist in info["loss_history"].items():
        if not all(map(math.isfinite, hist)):
            fail(f"{label}: non-finite loss {hist}")
        if len(hist) > 1 and not hist[-1] < hist[0]:
            fail(f"{label}: loss did not fall: {hist}")
    return info, launches


def random_kg(torch, n_entities, n_triplets, n_relations, n_eval, seed):
    """``benchmarks/bench_scale.py::random_kg`` rebuilt in numpy (the port
    imports nothing of the reference): uniform-random triplets as int32
    arrays, the train split first, then the valid and test splits."""
    import numpy as np

    from repro_torch.data import kg as kg_data

    rng = np.random.default_rng(seed)

    def draw(n):
        return np.stack([rng.integers(0, n_entities, n),
                         rng.integers(0, n_relations, n),
                         rng.integers(0, n_entities, n)],
                        axis=1).astype(np.int32)

    return kg_data.KG(n_entities, n_relations, draw(n_triplets),
                      draw(n_eval), draw(n_eval))


def scale_bytes(torch, graph, kcfg, mcfg, part):
    """bench_scale's three byte counts per Reduce (``_wire_bytes``): dense
    ``W·n_rows·(k + 2)·4`` (W tables and two touch stats), sparse
    ``W·C·(k + 3)·4`` (the capacity buffers: values, id, count, loss) and
    touched ``n_touched·(k + 3)·4`` with the rows each worker's epoch-0
    batches and negatives reference — here the device pipeline's own
    epoch-0 draws, as the run took them."""
    from repro_torch.core import keys, mapreduce, negative
    from repro_torch.core.models import get_model
    from repro_torch.data import kg as kg_data

    W, B = mcfg.n_workers, mcfg.batch_size
    model = get_model(mcfg.model)
    k_data, k_neg, _, _ = keys.device_keys(0)
    pos = kg_data.device_epoch_batches(keys.fold_in(k_data, 0), part, B)
    wkeys = keys.fold_in(keys.fold_in(k_neg, 0),
                         torch.arange(W, device=part.device))
    uniform, offset = negative.device_draws(wkeys, pos.shape[:-1],
                                            kcfg.n_entities, part.device)
    neg = model.make_negatives(pos, kcfg, None, uniform=uniform,
                               offset=offset)
    steps = part.shape[1] // B
    sizes = {"ent": kcfg.n_entities, "rel": kcfg.n_relations}
    out = {"dense_merge_bytes": 0, "sparse_merge_bytes": 0,
           "touched_merge_bytes": 0, "capacity": {}, "touched_rows": {}}
    for name, role in sorted(model.param_roles().items()):
        n_rows, k = sizes[role], kcfg.dim
        cap = mapreduce._delta_capacity(mcfg, n_rows, steps, 1, role)
        cols = (0, 2) if role == "ent" else (1,)
        touched = [int(torch.unique(torch.cat(
            [t[w][..., c].reshape(-1) for t in (pos, neg) for c in cols])
            ).numel()) for w in range(W)]
        out["dense_merge_bytes"] += W * n_rows * (k + 2) * 4
        out["sparse_merge_bytes"] += W * cap * (k + 3) * 4
        out["touched_merge_bytes"] += sum(touched) * (k + 3) * 4
        out["capacity"][name] = cap
        out["touched_rows"][name] = touched
    return out


def sparse_transport_path(torch, graph):
    """The sparse delta transport (item 9 of the module docstring).
    Returns the path's info and its launches of each kernel."""
    from repro_torch import kg
    from repro_torch.core import eval_device, mapreduce
    from repro_torch.core.models import get_model
    from repro_torch.data import kg as kg_data
    from repro_torch.kernels import rank_topk, transe_score as ts

    info = {}
    steps = len(graph.train) // TRAIN["n_workers"] // TRAIN["batch_size"]
    base_kw = dict(seed=0, device=DEVICE, **TRAIN)
    dense_dev = dict(base_kw, **DEVICE_SGD)
    sparse_dev = dict(base_kw, **SPARSE_DEVICE)
    marks = {}

    def timer(label):                   # loss is a float: synchronized
        marks[label] = [time.perf_counter()]
        return lambda epoch, loss: marks[label].append(time.perf_counter())

    def pair(label, *args, **kw):
        """A run on each transport: ``(dense, sparse)``."""
        return tuple(kg.fit(graph, *args, merge_transport=t,
                            callback=timer(f"{label}_{t}"), **kw)
                     for t in ("dense", "sparse"))

    kcfg, mcfg = kg.make_configs(graph, "transe", "sgd", block_epochs=2,
                                 **TRAIN, **SPARSE_DEVICE)
    part = torch.as_tensor(kg_data.PARTITIONERS["balanced"](
        0, graph.train, TRAIN["n_workers"]), device=DEVICE)
    init = get_model("transe").init_params(
        torch.Generator().manual_seed(0), kcfg, device=DEVICE)
    scale = random_kg(torch, SCALE_CELL["n_entities"],
                      SCALE_CELL["n_triplets"], SCALE_CELL["n_relations"],
                      SCALE_CELL["n_eval"], SCALE_CELL["seed"])
    scale_kw = dict(seed=0, device=DEVICE, n_workers=TRAIN["n_workers"],
                    batch_size=SCALE_CELL["batch"], dim=SCALE_CELL["dim"],
                    learning_rate=SCALE_CELL["learning_rate"],
                    strategy="average", pipeline="device",
                    block_epochs=SCALE_CELL["epochs"])
    scale_steps = (len(scale.train) // TRAIN["n_workers"]
                   // SCALE_CELL["batch"])
    runs, evals, peaks_b = {}, {}, {}
    t_phase = time.perf_counter()
    ts.transe_score.launches = 0           # --- sparse transport path ---
    ts.transe_score_bwd.launches = 0
    rank_topk.rank_counts.launches = 0
    # (a) phase 3's configuration
    runs["sgd"] = pair("sgd", "transe", "sgd", strategy="average", epochs=2,
                       **base_kw)
    runs["bgd"] = pair("bgd", "transe", "bgd", epochs=1, **base_kw)
    dense4 = kg.fit(graph, "transe", "sgd", epochs=4, block_epochs=4,
                    callback=timer("device_dense"), **dense_dev)
    sparse4 = kg.fit(graph, "transe", "sgd", epochs=4, block_epochs=4,
                     callback=timer("device_sparse_block4"), **sparse_dev)
    sparse2 = kg.fit(graph, "transe", "sgd", epochs=4, block_epochs=2,
                     callback=timer("device_sparse_block2"), **sparse_dev)
    card_epochs = 2 * 2 + 2 * 1 + 3 * 4
    block_fn = mapreduce.make_block_fn(mcfg, kcfg, part, seed=0,
                                       donate=True, with_overflow=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, losses, overflow = block_fn(dict(init), range(2))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    info["sync_checked_block"] = {"losses": losses.tolist(),
                                  "overflow": int(overflow)}
    for label, donate in (("donate_on", True), ("donate_off", False)):
        fn = mapreduce.make_block_fn(mcfg, kcfg, part, seed=0,
                                     donate=donate)
        given = {n: t.clone() for n, t in init.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out, _ = fn(given, range(2))
        torch.cuda.synchronize()
        peaks_b[label] = {"before_bytes": before,
                          "peak_bytes": torch.cuda.max_memory_allocated()}
        del given, out
    prof = profile_busy(torch, lambda: block_fn(dict(init), range(2)))
    prof.update(epochs=2, steps=2 * steps,
                launches_per_step=prof["launches"] / (2 * steps),
                dtoh_copies_per_step=prof["dtoh_copies"] / (2 * steps))
    card_epochs += 2 * 4
    for label in ("sgd", "bgd"):
        evals[label] = kg.evaluate(runs[label][1].kb, engine="device")
    # (b) the other models and joint-48, one epoch or merge round each
    for model in ("transh", "distmult"):
        runs[model] = pair(model, model, "sgd", strategy="average",
                           epochs=1, **base_kw)
    runs["joint48"] = pair("joint48", "transe", "sgd", epochs=2,
                           block_epochs=2, **dict(base_kw, **JOINT_SGD))
    # (c) the million-entity cell, each transport twice
    scale_runs = {}
    for rep in (0, 1):
        for t in ("dense", "sparse"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res, sec = wall(torch, lambda: kg.fit(
                scale, "transe", "sgd", epochs=SCALE_CELL["epochs"],
                merge_transport=t, **scale_kw))
            scale_runs.setdefault(t, []).append(
                (res, sec, torch.cuda.max_memory_allocated()))
    scale_epochs = 2 * 2 * SCALE_CELL["epochs"]
    scale_metrics, scale_eval_s = wall(torch, lambda: kg.evaluate(
        scale_runs["sparse"][0][0].kb, engine="device"))
    launches = {"rank_counts": rank_topk.rank_counts.launches,
                "transe_score": ts.transe_score.launches,
                "transe_score_bwd": ts.transe_score_bwd.launches}
    # --- end ---
    info["runs_s"] = time.perf_counter() - t_phase
    eval_chunks = lambda g: 2 * eval_device._layout(
        len(g.test), eval_device.DEFAULT_CHUNK)[0]
    predicted = {
        "rank_counts": 2 * eval_chunks(graph) + eval_chunks(scale),
        "transe_score": steps * card_epochs + scale_steps * scale_epochs,
        "transe_score_bwd": steps * card_epochs + scale_steps * scale_epochs}

    def per_epoch(label, epochs_per_block):
        m = marks[label]
        return [(t1 - t0) / epochs_per_block for t0, t1 in zip(m, m[1:])]

    # the callback fires once a block on the device pipeline, and
    # repartition_every=2 slices every block there at 2 epochs
    block_epochs = {"device_dense": 2, "device_sparse_block4": 2,
                    "device_sparse_block2": 2, "joint48_dense": 2,
                    "joint48_sparse": 2}

    skcfg, smcfg = kg.make_configs(scale, "transe", "sgd",
                                   merge_transport="sparse", **{
                                       k: v for k, v in scale_kw.items()
                                       if k not in ("seed", "device")})
    spart = torch.as_tensor(kg_data.PARTITIONERS["balanced"](
        0, scale.train, TRAIN["n_workers"]), device=DEVICE)
    info.update(
        steps_per_epoch=steps, launches=launches,
        launches_predicted=predicted,
        epoch_s={k: per_epoch(k, block_epochs.get(k, 1)) for k in marks},
        block_peak_memory=peaks_b, block_profile=prof,
        loss_history={k: [r.loss_history for r in v]
                      for k, v in runs.items()},
        metrics_sgd_sparse=evals["sgd"],
        scale={"graph": {"n_entities": scale.n_entities,
                         "n_relations": scale.n_relations,
                         "train": len(scale.train),
                         "test": len(scale.test)},
               "steps_per_epoch": scale_steps,
               "seconds": {t: [r[1] for r in v]
                           for t, v in scale_runs.items()},
               "epoch_s": {t: [r[1] / SCALE_CELL["epochs"] for r in v]
                           for t, v in scale_runs.items()},
               "peak_bytes": {t: [r[2] for r in v]
                              for t, v in scale_runs.items()},
               "tables_bytes": sum(
                   t.numel() * t.element_size()
                   for t in scale_runs["dense"][0][0].params.values()),
               **scale_bytes(torch, scale, skcfg, smcfg, spart),
               "evaluate_s": scale_eval_s, "metrics": scale_metrics,
               "loss_history": {t: v[0][0].loss_history
                                for t, v in scale_runs.items()}})
    info["bitwise"] = {
        **{f"{k}_sparse_vs_dense": same_run(*v) for k, v in runs.items()},
        "device_sparse_vs_dense": same_run(sparse4, dense4),
        "device_sparse_block4_vs_block2": same_run(sparse4, sparse2),
        "sync_checked_block_vs_fit": info["sync_checked_block"][
            "losses"] == dense4.loss_history[:2],
        "scale_sparse_vs_dense": same_run(scale_runs["sparse"][0][0],
                                          scale_runs["dense"][0][0]),
        "scale_reruns": same_run(scale_runs["sparse"][0][0],
                                 scale_runs["sparse"][1][0])
        and same_run(scale_runs["dense"][0][0], scale_runs["dense"][1][0]),
        "sparse_sgd_metrics_vs_dense_params": evals["sgd"] == kg.evaluate(
            runs["sgd"][0].kb, engine="device")}
    info["phase_s"] = time.perf_counter() - t_phase
    print("sparse transport " + json.dumps(info), flush=True)

    if not all(info["bitwise"].values()):
        fail(f"sparse-transport runs that should agree gave other bits: "
             f"{info['bitwise']}")
    if launches != predicted:
        fail(f"launches {launches} on the sparse-transport path; the path "
             f"predicts {predicted}")
    if prof["dtoh_copies"] != 0 or info["sync_checked_block"]["overflow"]:
        fail(f"a sparse block made {prof['dtoh_copies']} device-to-host "
             f"copies, overflow {info['sync_checked_block']['overflow']}")
    for label, (dense, sparse) in runs.items():
        if not all(t.is_cuda for t in sparse.params.values()):
            fail(f"{label}: a sparse-trained table is not on the card")
        if not all(map(math.isfinite, sparse.loss_history)):
            fail(f"{label}: non-finite sparse loss {sparse.loss_history}")
    hist = runs["sgd"][1].loss_history
    if not hist[-1] < hist[0]:
        fail(f"the sparse SGD loss did not fall: {hist}")
    ent = scale_metrics["entity_filtered"]
    if not (ent["n"] == 2 * SCALE_CELL["n_eval"]
            and 1 <= ent["mean_rank"] <= SCALE_CELL["n_entities"]
            and all(math.isfinite(v) for v in ent.values())):
        fail(f"the 1e6-entity evaluation is out of range: {ent}")
    return info, launches


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
    ts_cases = transe_kernel_phase(torch, rates)
    graph, graph_info = build_graph()
    print("graph " + json.dumps(graph_info), flush=True)
    sgd, bgd, train_info, ts_launches, init_metrics = training_path(
        torch, graph)
    info, launches = serving_path(torch, graph, sgd.kb)
    resume_info, phase_launches = eval_resume_path(torch, graph, sgd, bgd)
    device_info, device_launches = device_pipeline_path(torch, graph)
    live_info, live_launches = serving_live_path(torch, sgd, bgd)
    family_info, family_launches = model_family_path(torch, graph)
    sparse_info, sparse_launches = sparse_transport_path(torch, graph)
    info.update(build_s=build_s, graph=graph_info, training=train_info,
                init_metrics=init_metrics, eval_resume=resume_info,
                device_pipeline=device_info, serving_live=live_info,
                model_family=family_info, sparse_transport=sparse_info)
    init_rank = init_metrics["entity_filtered"]["mean_rank"]
    trained_rank = info["metrics"]["entity_filtered"]["mean_rank"]
    print(f"filtered mean rank: init {init_rank}, SGD-trained "
          f"{trained_rank}", flush=True)
    # A weak gate: a few epochs at lr 0.01 barely move unit-norm rows.  The
    # evidence that the updates are right is the CPU-against-card epoch
    # above and the CPU tests against the reference.
    if not trained_rank < init_rank:
        fail(f"the SGD-trained filtered mean rank {trained_rank} does not "
             f"beat the init's {init_rank}")

    from repro_torch.kernels import rank_topk

    main_case = next(c for c in cases if c["E"] == FB15K["n_entities"]
                     and c["norm"] == "l1" and c["dtype"] == "float32"
                     and not c.get("tie_stress"))
    kernels = [{
        "name": "rank_counts", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rank_topk.cu",
        "replaces": "src/repro/kernels/rank_topk.py:65",
        "launches": launches + phase_launches["rank_counts"]
        + device_launches["rank_counts"] + live_launches["rank_counts"]
        + family_launches["rank_counts"] + sparse_launches["rank_counts"],
        "launches_by_path": {"serving": launches,
                             "eval_resume": phase_launches["rank_counts"],
                             "device_pipeline":
                                 device_launches["rank_counts"],
                             "serving_live": live_launches["rank_counts"],
                             "model_family":
                                 family_launches["rank_counts"],
                             "sparse_transport":
                                 sparse_launches["rank_counts"]},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "count_mismatches": sum(c["count_mismatches"] for c in cases),
        "ms": main_case["ms"], "call_ms": main_case["call_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "kernels": list(rank_topk.KERNELS["l1"]),
        "kernel": main_case["kernel"],
        "cases": cases,
    }]
    # the training step's shape: 4 workers x 256 triplets, L1, fp32
    step = next(c for c in ts_cases if c["W"] == TRAIN["n_workers"]
                and c["norm"] == "l1" and c["dtype"] == "float32")
    # the sparse transport's compact step: the same batch over the 4B / 2B
    # rows it references
    compact = next(c for c in ts_cases if c["E"] == 4 * TRAIN["batch_size"]
                   and c["norm"] == "l1" and c["dtype"] == "float32")
    for kname, key, replaces, n in (
            ("transe_score", "fwd", "src/repro/kernels/transe_score.py:54",
             ts_launches[0]),
            ("transe_score_bwd", "bwd", "src/repro/kernels/ops.py:68",
             ts_launches[1])):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/transe_score.cu",
            "replaces": replaces,
            "launches": n + phase_launches[kname] + device_launches[kname]
            + live_launches[kname] + family_launches[kname]
            + sparse_launches[kname],
            "launches_by_path": {"training": n,
                                 "eval_resume": phase_launches[kname],
                                 "device_pipeline": device_launches[kname],
                                 "serving_live": live_launches[kname],
                                 "model_family": family_launches[kname],
                                 "sparse_transport":
                                     sparse_launches[kname]},
            "kernels": list(TRANSE_KERNELS[key]),
            "max_abs_err": max(c[f"{key}_max_abs_err"] for c in ts_cases),
            "ms": step[f"{key}_ms"], "plain_ms": step[f"{key}_plain_ms"],
            "bound_ms": step[f"{key}_bound_ms"],
            "bound_by": step[f"{key}_bound_by"],
            "library_ms": step[f"{key}_library_ms"],
            "compact_step": {f: compact[f"{key}_{f}"] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "cases": [{k: v for k, v in c.items()
                       if not k.startswith("fwd_" if key == "bwd"
                                           else "bwd_")}
                      for c in ts_cases],
        })
    device = {"platform": "gpu", "kind": name,
              "count": torch.cuda.device_count()}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"nvidia_smi": smi, "device": device, "kernels": kernels,
                   "main_path": info}, f, indent=1)
    print(json.dumps({k: info[k] for k in info
                      if k not in ("metrics", "init_metrics", "training",
                                   "eval_resume", "device_pipeline",
                                   "serving_live", "model_family",
                                   "sparse_transport")}),
          flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
