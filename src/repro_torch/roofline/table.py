"""Render the dry-run / roofline table from the per-cell JSON records
``launch/dryrun.py`` writes.  A port of ``repro.roofline.table``.

    PYTHONPATH=src python -m repro_torch.roofline.table [--mesh pod16x16] [--csv]
    PYTHONPATH=src python -m repro_torch.roofline.table --mesh pod16x16,pod2x16x16

Two meshes (comma-separated) render one row a cell with both meshes'
numbers side by side (``a / b``) and the cells neither traced in one
line.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

DEF_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh_dir: str) -> List[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(mesh_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    recs.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                             if r["shape"] in SHAPE_ORDER else 9))
    return recs


def fmt_s(x) -> str:
    if x is None:
        return "-"
    if x == 0:
        return "0"
    return f"{x:.2e}"


def render(recs: List[dict], md: bool = True) -> str:
    hdr = ["arch", "shape", "status", "mem/dev GB", "compute s", "memory s",
           "collective s", "bottleneck", "MODEL_FLOPS", "HLO_FLOPs",
           "useful", "note"]
    rows = []
    for r in recs:
        if r["status"] != "ok":
            note = r.get("reason", r.get("error", ""))[:60]
            rows.append([r["arch"], r["shape"], r["status"], "-", "-", "-",
                         "-", "-", "-", "-", "-", note])
            continue
        rl = r["roofline"]
        rows.append([
            r["arch"], r["shape"], "ok",
            f"{r['memory']['peak_per_device_gb']:.2f}",
            fmt_s(rl["compute_s"]), fmt_s(rl["memory_s"]),
            fmt_s(rl["collective_s"]), rl["bottleneck"],
            fmt_s(rl["model_flops"]), fmt_s(rl["hlo_flops_total"]),
            f"{rl['useful_ratio']:.2f}", "",
        ])
    if md:
        out = ["| " + " | ".join(hdr) + " |",
               "|" + "---|" * len(hdr)]
        for row in rows:
            out.append("| " + " | ".join(str(c) for c in row) + " |")
        return "\n".join(out)
    return "\n".join(",".join(str(c) for c in row) for row in [hdr] + rows)


def _pair(a, b, fmt) -> str:
    return f"{fmt(a)} / {fmt(b)}"


def render_pair(recs_a: List[dict], recs_b: List[dict]) -> str:
    """Markdown, one row a cell traced on either mesh: status, peak GB a
    device, the three terms, the bottleneck and the useful ratio on mesh
    a / mesh b; then the cells skipped on both, in one line."""
    by_b = {(r["arch"], r["shape"]): r for r in recs_b}
    hdr = ["arch", "shape", "status", "mem/dev GB", "compute s", "memory s",
           "collective s", "bottleneck", "useful"]
    out = ["| " + " | ".join(hdr) + " |", "|" + "---|" * len(hdr)]
    skipped = []
    for a in recs_a:
        b = by_b.get((a["arch"], a["shape"]), {"status": "missing"})
        if a["status"] == b["status"] == "skipped":
            skipped.append(f"{a['arch']} x {a['shape']}")
            continue

        def get(r, f):
            return f(r) if r["status"] == "ok" else r["status"]

        row = [a["arch"], a["shape"], _pair(a["status"], b["status"], str)]
        for f in (lambda r: f"{r['memory']['peak_per_device_gb']:.2f}",
                  lambda r: fmt_s(r["roofline"]["compute_s"]),
                  lambda r: fmt_s(r["roofline"]["memory_s"]),
                  lambda r: fmt_s(r["roofline"]["collective_s"]),
                  lambda r: r["roofline"]["bottleneck"],
                  lambda r: f"{r['roofline']['useful_ratio']:.2f}"):
            row.append(_pair(get(a, f), get(b, f), str))
        out.append("| " + " | ".join(row) + " |")
    if skipped:
        out.append("")
        out.append("Skipped on both: " + ", ".join(skipped) + ".")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DEF_DIR)
    ap.add_argument("--mesh", default="pod16x16",
                    help="a mesh tag, or two separated by a comma")
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args()
    meshes = args.mesh.split(",")
    recs = [load(os.path.join(args.dir, m)) for m in meshes]
    if len(recs) == 2:
        print(render_pair(*recs))
    else:
        print(render(recs[0], md=not args.csv))


if __name__ == "__main__":
    main()
