#!/usr/bin/env python3
"""Check and time the ``rank_counts`` CUDA kernel on one GPU.

    python3 tools/bench_rank_counts.py [--src DIR] [--no-check] [--tiles]
                                       [--clock] [--overhead]

1. Builds the kernel and prints ``nvcc -Xptxas -v``'s report and each
   instantiation's registers, shared memory and blocks per SM.
2. Unless ``--no-check``: holds the counts against the plain version
   (``kernels/ref.rank_counts_ref``) at shapes on every edge of the
   kernel's tiling (k in {1, 7, 50, 64, 129, 256}, B = 1, a table smaller
   than one tile, one row past a tile), and on ``chip_smoke.py``'s
   tie-stress inputs, L1 and L2, fp32 and bf16, with the share of pairs the
   L2 screen re-checked.  Exits non-zero on any mismatch.
3. Times the kernel (CUDA events) at ``chip_smoke.py``'s kernel cases
   beside their bounds, and the kernel alone (``torch.profiler``); with
   ``--tiles`` also the L1 sweep at both query tiles (128 and 64 queries
   x 128 rows), with ``--clock`` the SM clock and power sampled while the
   L1 sweep runs, and with ``--overhead`` the L1 kernel's own time at the
   evaluation chunk for k in {2, 26, 50, 98} and for one 128 x 128 tile at
   k in {2, 50}: what a call costs apart from its sums.

``--src`` imports ``repro_torch`` from another checkout's ``src`` (e.g. a
``git archive`` of the parent commit) and only times it, so that two
versions can be compared in one call on one card.  Prints one JSON line per
result; the last line holds them all.
"""
import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE_SHAPES = ((3, 129, 1), (70, 1000, 7), (1, 14951, 50), (256, 100, 50),
               (129, 129, 64), (33, 257, 129), (3, 129, 256),
               (200, 1000, 256))      # (B, E, k)
TILES = (128, 64)             # L1 query tiles (x 128 rows)


def sample_clocks(torch, fn, calls):
    """``nvidia-smi``'s SM clock, power draw and power limit, sampled every
    0.25 s from another thread while ``fn`` runs ``calls`` times."""
    import subprocess
    import threading

    samples, done = [], threading.Event()

    def sample():
        while not done.wait(0.25):
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True)
            samples.append(out.stdout.strip())

    fn()
    torch.cuda.synchronize()
    thread = threading.Thread(target=sample)
    thread.start()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    done.set()
    thread.join()
    return samples


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--overhead", action="store_true")
    ap.add_argument("--clock", action="store_true",
                    help="sample the SM clock and power while the L1 sweep "
                    "runs at 4,096 x 1e6")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_rank_counts: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import build, rank_topk, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.smi_line()
    print(smi, flush=True)
    rates = cs.peaks(torch.cuda.get_device_name(0))
    for name, rep in build.build_all(["rank_topk"]).items():
        print(f"nvcc {name} ({rep['seconds']:.2f} s):\n{rep['nvcc']}",
              flush=True)
    results = []

    def emit(kind, row):
        row = {"kind": kind, **row}
        print(json.dumps(row), flush=True)
        results.append(row)

    current = hasattr(rank_topk, "kernel_info")
    if current:
        for dtype in (torch.float32, torch.bfloat16):
            for norm in ("l1", "l2"):
                for E, B in cs.KERNEL_CASES:
                    for k in (50, 256):
                        emit("info", {"dtype": str(dtype), "norm": norm,
                                      "B": B, "E": E, "k": k,
                                      **rank_topk.kernel_info(dtype, norm, k,
                                                              B, E)})
    bad = 0
    if current and not args.no_check:
        g = torch.Generator(device="cuda").manual_seed(0)
        for B, E, k in EDGE_SHAPES:
            q32 = torch.randn(B, k, generator=g, device="cuda")
            t32 = torch.randn(E, k, generator=g, device="cuda")
            rows = torch.randint(0, E, (B,), generator=g, device="cuda")
            for norm in ("l1", "l2"):
                for dtype in (torch.float32, torch.bfloat16):
                    q, tab = q32.to(dtype), t32.to(dtype)
                    gold = cs.plain_distance(torch, q, tab[rows], norm)
                    gold = gold.contiguous()
                    case = cs.rank_case(torch, q, tab, gold, norm, rates,
                                        timed=False)
                    bad += case["count_mismatches"]
                    emit("check", case)
        E, B = cs.KERNEL_CASES[0]
        for norm in ("l1", "l2"):
            for dtype in (torch.float32, torch.bfloat16):
                case = cs.rank_case(
                    torch, *cs.tie_stress_inputs(torch, E, B, norm, dtype),
                    norm, rates, timed=False)
                bad += case["count_mismatches"]
                emit("tie_stress", case)

    if args.overhead:
        g = torch.Generator(device="cuda").manual_seed(0)
        for B, E, k in ((256, 14951, 2), (256, 14951, 26), (256, 14951, 50),
                        (256, 14951, 98), (128, 128, 2), (128, 128, 50)):
            q = torch.randn(B, k, generator=g, device="cuda")
            tab = torch.randn(E, k, generator=g, device="cuda")
            gold = (q - tab[:B]).abs().sum(1).contiguous()
            emit("overhead", {"B": B, "E": E, "k": k, "kernel_ms": sum(
                cs.kernel_ms(torch, lambda: rank_topk.rank_counts(
                    q, tab, gold), 50, rank_topk.KERNELS["l1"]).values())})
    if args.clock:
        E, B = cs.KERNEL_CASES[1]
        q, tab, gold = cs.rank_inputs(torch, E, B, "l1", torch.float32)
        emit("clocks", {"while": f"L1 fp32 {B} x {E}",
                        "samples": sample_clocks(torch, lambda: (
                            rank_topk.rank_counts(q, tab, gold)), 100)})
        del q, tab, gold
    for E, B in cs.KERNEL_CASES:
        for norm in ("l1", "l2"):
            for dtype in (torch.float32, torch.bfloat16):
                q, tab, gold = cs.rank_inputs(torch, E, B, norm, dtype)
                reps = 50 if E < 1e5 else 5
                call = lambda: rank_topk.rank_counts(q, tab, gold, norm=norm)
                ms = cs.cuda_ms(torch, call, reps=reps)
                names = getattr(rank_topk, "KERNELS",
                                {}).get(norm, ("rank_counts",))
                kernel_ms = sum(cs.kernel_ms(torch, call, reps,
                                             names).values())
                bound_ms, by = cs.rank_counts_bound(
                    B, E, cs.DIM, tab.element_size(), norm, rates)
                emit("time", {"src": args.src, "B": B, "E": E, "norm": norm,
                              "dtype": str(dtype), "ms": ms,
                              "kernel_ms": kernel_ms,
                              "bound_ms": bound_ms, "bound_by": by})
                if args.tiles and current and norm == "l1":
                    lib = rank_topk._library()
                    fn = lib.rank_counts_launch_l1_tile
                    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
                        + [ctypes.c_void_p]
                    for tq in TILES:
                        counts = torch.zeros(B, dtype=torch.int32,
                                             device="cuda")
                        stream = torch.cuda.current_stream().cuda_stream

                        def tile_call():
                            counts.zero_()
                            err = fn(q.data_ptr(), tab.data_ptr(),
                                     gold.data_ptr(), counts.data_ptr(), B, E,
                                     cs.DIM, 0 if dtype == torch.float32
                                     else 1, tq, stream)
                            if err:
                                raise RuntimeError(f"launch failed: {err}")
                        tile_call()
                        want = ref.rank_counts_ref(q, tab, gold, norm)
                        mism = int((counts != want).sum())
                        bad += mism
                        emit("tile", {"B": B, "E": E, "dtype": str(dtype),
                                      "tile": [tq, 128], "mismatches": mism,
                                      "kernel_ms": sum(cs.kernel_ms(
                                          torch, tile_call, reps,
                                          names).values())})
                del q, tab, gold
        torch.cuda.empty_cache()
    print(smi, flush=True)
    print(json.dumps({"nvidia_smi": smi, "mismatches": bad,
                      "results": results}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
