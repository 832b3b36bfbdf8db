"""The roofline and the dry-run: ``roofline/analysis.py``'s parameter and
model-FLOP counts equal to the reference's for every arch and shape cell;
``collective_stats`` weighting the same records with the reference's
ring factors; ``table.render`` giving the reference's text on the same
records; ``hlo_cost.CostMode`` counting FLOPs, bytes and the live peak of
eager ops; and ``python -m repro_torch.launch.dryrun`` on a reduced cell
over a small fake mesh (a subprocess: the fake process group is the
process's default group), plus the production cell on both meshes
(``slow``, as the reference's ``test_dryrun_cell_subprocess``).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro import configs as ref_configs
from repro.models import registry as ref_registry
from repro.roofline import analysis as ref_analysis
from repro.roofline import table as ref_table
from repro_torch import configs
from repro_torch.models import registry
from repro_torch.roofline import analysis, hlo_cost, table

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
REF_KEYS = ("arch", "shape", "mesh", "kind", "profile", "optimizer",
            "status", "lower_s", "compile_s", "memory", "cost_raw_backend",
            "hlo_cost", "top_buffers_gb", "roofline")


@pytest.mark.parametrize("arch", list(ref_configs.ARCH_IDS))
def test_count_params_and_model_flops_match_reference(arch):
    for reduced in (False, True):
        ref_cfg = ref_configs.get_config(arch, reduced=reduced)
        cfg = configs.get_config(arch, reduced=reduced)
        assert analysis.count_params(cfg) == ref_analysis.count_params(
            ref_cfg)
        for name, cell in registry.SHAPES.items():
            assert analysis.model_flops(cfg, cell) == \
                ref_analysis.model_flops(ref_cfg, ref_registry.SHAPES[name])


RECORDS = [("all-reduce", 4096, 16), ("all-gather", 1 << 20, 16),
           ("reduce-scatter", 3 * 1024, 256), ("all-to-all", 640, 2),
           ("collective-permute", 96, 4), ("all-reduce", 8, 512)]


def _hlo(records):
    lines = ["ENTRY %main (p: f32[1]) -> f32[1] {"]
    for i, (op, nbytes, s) in enumerate(records):
        lines.append(f"  %c{i} = u8[{nbytes}]{{0}} {op}(%p), "
                     f"replica_groups=[{max(1, 512 // s)},{s}]<=[512]")
    lines.append("}")
    return "\n".join(lines)


def test_collective_stats_matches_reference():
    ref = ref_analysis.collective_stats(_hlo(RECORDS))
    got = analysis.collective_stats(RECORDS)
    assert got.by_op.keys() == ref.by_op.keys()
    for k in ref.by_op:
        assert got.by_op[k] == pytest.approx(ref.by_op[k], rel=1e-12)
    assert got.by_op_count == ref.by_op_count
    assert got.buffer_bytes == ref.buffer_bytes
    assert got.wire_bytes == pytest.approx(ref.wire_bytes, rel=1e-12)
    assert got.by_link == {"network": got.wire_bytes}


def test_links_and_h100_terms():
    assert analysis.link_of(range(8)) == "nvlink"
    assert analysis.link_of(range(16)) == "network"
    assert analysis.link_of(range(0, 256, 16)) == "network"
    hc = hlo_cost.HLOCost(flops=989e12, bytes_accessed=3.35e12,
                          coll_wire_bytes=500e9, coll_by_op={},
                          coll_counts={},
                          coll_by_link={"nvlink": 450e9, "network": 50e9})
    rl = analysis.roofline_from_hlo(hc, 256, 1e15)
    assert (rl.compute_s, rl.memory_s, rl.collective_s) == \
        pytest.approx((1.0, 1.0, 2.0))
    assert rl.bottleneck == "collective"
    assert rl.hlo_flops_total == 989e12 * 256


def _records():
    ok = {"arch": "smollm-135m", "shape": "train_4k", "status": "ok",
          "memory": {"peak_per_device_gb": 3.25},
          "roofline": {"compute_s": 1.5e-2, "memory_s": 0.3,
                       "collective_s": 0.0, "bottleneck": "memory",
                       "model_flops": 1.29e15, "hlo_flops_total": 2.2e15,
                       "useful_ratio": 0.586}}
    skip = {"arch": "gemma2-2b", "shape": "long_500k", "status": "skipped",
            "reason": "full-attention arch; long_500k requires sub-quadratic"}
    err = {"arch": "zeta", "shape": "decode_32k", "status": "error",
           "error": "RuntimeError: something " * 5}
    return [ok, skip, err]


def test_table_render_matches_reference(tmp_path):
    recs = _records()
    for md in (True, False):
        assert table.render(recs, md=md) == ref_table.render(recs, md=md)
    for r in recs:
        with open(tmp_path / f"{r['arch']}__{r['shape']}.json", "w") as f:
            json.dump(r, f)
    assert table.load(str(tmp_path)) == ref_table.load(str(tmp_path))


def test_table_renders_two_meshes_side_by_side():
    a, b = _records(), _records()
    b[0] = dict(b[0], memory={"peak_per_device_gb": 7.5})
    text = table.render_pair(a, b)
    rows = text.splitlines()
    assert rows[2].startswith("| smollm-135m | train_4k | ok / ok | "
                              "3.25 / 7.50 | 1.50e-02 / 1.50e-02 |")
    assert "| zeta | decode_32k | error / error | error / error |" in text
    assert rows[-1] == "Skipped on both: gemma2-2b x long_500k."


def test_cost_mode_counts_eager_ops():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    mode = hlo_cost.CostMode()
    held = mode.hold([a, b])
    assert held == (8 * 16 + 16 * 4) * 4
    with mode:
        c = a @ b                       # 2*8*16*4 FLOPs
        v = c.view(-1)                  # a view: no bytes, no storage
        d = torch.relu(v)
        del c, v
        e = d * 2
        del d
    mode.sweep()
    cost = hlo_cost.analyze(mode)
    assert cost.flops == 2 * 8 * 16 * 4
    # mm reads a and b, writes c; relu and mul read and write 32 floats
    assert cost.bytes_accessed == (8 * 16 + 16 * 4 + 32) * 4 + 4 * 32 * 4
    assert mode.peak_live == 2 * 32 * 4        # c and d live together
    assert mode.live == 32 * 4                 # e alone
    assert e.shape == (32,)
    assert cost.coll_wire_bytes == 0


def _dryrun(args, out):
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(out)] + args, env=env, capture_output=True, text=True,
        timeout=900)


def test_dryrun_reduced_cell_on_a_small_mesh(tmp_path):
    proc = _dryrun(["--arch", "smollm-135m", "--shape", "train_4k",
                    "--reduced", "--mesh-shape", "2,2"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.load(open(tmp_path / "mesh2x2" / "smollm-135m__train_4k.json"))
    assert rec["status"] == "ok", rec
    assert set(REF_KEYS) <= set(rec)
    assert rec["mesh"] == "mesh2x2" and rec["kind"] == "train"
    cfg = configs.get_config("smollm-135m", reduced=True)
    assert rec["roofline"]["model_flops"] == ref_analysis.model_flops(
        ref_configs.get_config("smollm-135m", reduced=True),
        ref_registry.SHAPES["train_4k"]) == analysis.model_flops(
        cfg, registry.SHAPES["train_4k"])
    assert rec["hlo_cost"]["flops"] > 0
    # dp profile: the gradients are summed over every rank of the mesh
    assert rec["hlo_cost"]["all-reduce_count"] > 0
    assert rec["memory"]["peak_per_device_gb"] > 0
    assert rec["depth_traced"] == [1, 2, cfg.n_layers]
    assert "ok" in proc.stdout


@pytest.mark.slow
@pytest.mark.parametrize("flags", [[], ["--multi-pod"]])
def test_dryrun_cell_subprocess(flags, tmp_path):
    proc = _dryrun(["--arch", "smollm-135m", "--shape", "train_4k"] + flags,
                   tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    mesh = "pod2x16x16" if flags else "pod16x16"
    rec = json.load(open(tmp_path / mesh / "smollm-135m__train_4k.json"))
    assert rec["status"] == "ok", rec
    assert rec["memory"]["peak_per_device_gb"] < 16.0
    assert rec["roofline"]["model_flops"] == ref_analysis.model_flops(
        ref_configs.get_config("smollm-135m"), ref_registry.SHAPES["train_4k"])
    assert rec["hlo_cost"]["flops"] > 0
