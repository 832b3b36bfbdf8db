"""Three-term roofline of a dry-run cell on the H100 (no hardware).  A
port of ``repro.roofline.analysis``.

    compute term    = per-device FLOPs / peak FLOP/s
    memory term     = per-device bytes / HBM bandwidth
    collective term = sum over collectives of wire bytes / the link
                      bandwidth of the collective's group

The per-device numbers come from ``roofline/hlo_cost.analyze`` over the
aten ops one rank traced (``launch/dryrun.py``).  Wire bytes are modelled
per collective from its buffer size and group size S:

    all-reduce        2 (S-1)/S x bytes     (ring: reduce-scatter+all-gather)
    all-gather        (S-1)/S x bytes
    reduce-scatter    (S-1)/S x bytes
    all-to-all        (S-1)/S x bytes
    collective-permute  1.0 x bytes

Hardware model: ``H100_SXM``, one NVIDIA H100 SXM5 80 GB from NVIDIA's
data sheet (the card at a 700 W limit): 989e12 FLOP/s dense bf16,
3.35e12 B/s of HBM3, NVLink 4 at 450e9 B/s a direction within an
8-GPU node, and 50e9 B/s (400 Gb/s NDR InfiniBand, one NIC a GPU) a GPU
across nodes.  Ranks are numbered row-major over the mesh and packed 8 to
a node, so a group that stays inside one node runs on NVLink and any
other on the network: on the (16, 16) and (2, 16, 16) meshes every
``model`` group of 16 spans two nodes.  These are modelled numbers, not
measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

H100_SXM = {
    "peak_flops": 989e12,      # bf16 dense, per GPU
    "hbm_bw": 3.35e12,         # bytes/s per GPU
    "nvlink_bw": 450e9,        # bytes/s per GPU, one direction, in a node
    "net_bw": 50e9,            # bytes/s per GPU across nodes (NDR IB)
    "gpus_per_node": 8,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_WIRE_FACTOR = {
    "all-reduce": lambda s: 2.0 * (s - 1) / s,
    "all-gather": lambda s: (s - 1) / s,
    "reduce-scatter": lambda s: (s - 1) / s,
    "all-to-all": lambda s: (s - 1) / s,
    "collective-permute": lambda s: 1.0,
}


def link_of(ranks: Iterable[int], hw: dict = H100_SXM) -> str:
    """"nvlink" when a group's ranks share one node, else "network"."""
    nodes = {int(r) // hw["gpus_per_node"] for r in ranks}
    return "nvlink" if len(nodes) <= 1 else "network"


@dataclasses.dataclass
class CollectiveStats:
    by_op: Dict[str, float]
    by_op_count: Dict[str, int]
    buffer_bytes: float            # sum of buffer bytes (per device)
    wire_bytes: float              # wire-factor-weighted bytes (per device)
    by_link: Dict[str, float] = dataclasses.field(default_factory=dict)

    def row(self):
        return {
            "buffer_bytes": self.buffer_bytes,
            "wire_bytes": self.wire_bytes,
            **{f"{k}_bytes": v for k, v in self.by_op.items()},
            **{f"{k}_count": v for k, v in self.by_op_count.items()},
        }


def collective_stats(records: Iterable[Tuple], default_group: int = 16
                     ) -> CollectiveStats:
    """Wire bytes of collective records ``(op, buffer bytes, group size)``
    or ``(op, buffer bytes, group size, link)`` (``op`` one of the five
    names above; a group size of 0 takes ``default_group``; a record
    without a link counts as "network")."""
    by_op: Dict[str, float] = {}
    by_count: Dict[str, int] = {}
    by_link: Dict[str, float] = {}
    buffer_total = 0.0
    wire_total = 0.0
    for rec in records:
        op, nbytes, s = rec[:3]
        link = rec[3] if len(rec) > 3 else "network"
        if nbytes == 0:
            continue
        s = s or default_group
        wire = _WIRE_FACTOR[op](max(s, 1)) * nbytes
        by_op[op] = by_op.get(op, 0.0) + wire
        by_count[op] = by_count.get(op, 0) + 1
        by_link[link] = by_link.get(link, 0.0) + wire
        buffer_total += nbytes
        wire_total += wire
    return CollectiveStats(by_op, by_count, buffer_total, wire_total, by_link)


# ---------------------------------------------------------------------------
# model FLOPs (the "useful work" denominator)
# ---------------------------------------------------------------------------

def count_params(cfg) -> Tuple[float, float]:
    """(total, active) parameter counts from the config (analytic)."""
    d, V = cfg.d_model, cfg.vocab_size
    embed = V * d * (1 if cfg.tie_embeddings else 2)

    def attn_params():
        if cfg.use_mla:
            q = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads *
                 (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
                 if cfg.q_lora_rank else
                 d * cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
            kv = d * cfg.kv_lora_rank + d * cfg.qk_rope_head_dim
            up = cfg.kv_lora_rank * cfg.n_heads * (
                cfg.qk_nope_head_dim + cfg.v_head_dim)
            o = cfg.n_heads * cfg.v_head_dim * d
            return q + kv + up + o
        hd = cfg.head_dim_
        return d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)

    def mlp_params(ff):
        return 3 * d * ff if cfg.act in ("silu", "gelu") and True else 2 * d * ff

    def ssm_params():
        di = cfg.ssm_expand * d
        H = di // cfg.ssm_head_dim
        N = cfg.ssm_state
        return d * (2 * di + 2 * N + H) + di * d

    def rec_params():
        dr = cfg.d_rnn
        return 2 * d * dr + 2 * dr * dr + dr * d

    total = embed
    active = embed
    for pattern, reps in cfg.segments:
        for kind in pattern:
            mixer = kind.split(":")[0]
            dense_ffn = kind.endswith(":dense")
            if mixer in ("global", "local"):
                total += attn_params() * reps
                active += attn_params() * reps
            elif mixer == "ssm":
                total += ssm_params() * reps
                active += ssm_params() * reps
            else:
                total += rec_params() * reps
                active += rec_params() * reps
            if cfg.moe and not dense_ffn:
                expert = 3 * d * cfg.moe_d_ff
                shared = 3 * d * cfg.moe_d_ff * cfg.n_shared_experts
                total += (cfg.n_experts * expert + shared) * reps
                active += (cfg.top_k * expert + shared) * reps
            elif cfg.d_ff > 0:
                gated = not cfg.encoder_decoder
                per = (3 if gated else 2) * d * cfg.d_ff
                total += per * reps
                active += per * reps
    if cfg.encoder_decoder:
        # encoder self-attn + mlp, decoder adds cross-attn
        enc = (attn_params() + 2 * d * cfg.d_ff) * cfg.n_encoder_layers
        cross = attn_params() * cfg.n_layers
        total += enc + cross
        active += enc + cross
    return float(total), float(active)


def model_flops(cfg, cell) -> float:
    """6·N_active·D for train, 2·N_active·D for inference, plus the
    attention O(S²) term (not captured by N·D)."""
    total, active = count_params(cfg)
    if cell.kind == "train":
        tokens = cell.batch * cell.seq
        mult = 6.0
    elif cell.kind == "prefill":
        tokens = cell.batch * cell.seq
        mult = 2.0
    else:                                   # decode: one token per sequence
        tokens = cell.batch
        mult = 2.0

    flops = mult * active * tokens

    # attention score/value FLOPs
    attn_layers = 0
    local_layers = 0
    for pattern, reps in cfg.segments:
        for kind in pattern:
            mixer = kind.split(":")[0]
            if mixer == "global":
                attn_layers += reps
            elif mixer == "local":
                local_layers += reps
    hd = cfg.v_head_dim if cfg.use_mla else cfg.head_dim_
    H = cfg.n_heads
    if cell.kind in ("train", "prefill"):
        fwd = 2 * 2 * cell.batch * H * hd * (
            attn_layers * cell.seq ** 2 / 2
            + local_layers * cell.seq * min(cfg.window, cell.seq))
        flops += fwd * (3 if cell.kind == "train" else 1)
    else:
        flops += 2 * 2 * cell.batch * H * hd * (
            attn_layers * cell.seq
            + local_layers * min(cfg.window, cell.seq))
    return float(flops)


# ---------------------------------------------------------------------------
# the three terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_total: float
    hlo_bytes_total: float
    wire_bytes_per_dev: float
    model_flops: float
    useful_ratio: float
    bottleneck: str

    def row(self):
        return dataclasses.asdict(self)


def _collective_s(by_link: Dict[str, float], hw: dict) -> float:
    return (by_link.get("nvlink", 0.0) / hw["nvlink_bw"]
            + by_link.get("network", 0.0) / hw["net_bw"])


def _terms(flops_dev, bytes_dev, wire_dev, collective_s, n_chips, mflops,
           hw) -> Roofline:
    compute_s = flops_dev / hw["peak_flops"]
    memory_s = bytes_dev / hw["hbm_bw"]
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    total_flops = flops_dev * n_chips
    return Roofline(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        hlo_flops_total=total_flops,
        hlo_bytes_total=bytes_dev * n_chips,
        wire_bytes_per_dev=wire_dev,
        model_flops=mflops,
        useful_ratio=mflops / total_flops if total_flops else 0.0,
        bottleneck=max(terms, key=terms.get),
    )


def roofline_from_hlo(hc, n_chips: int, mflops: float,
                      hw: dict = H100_SXM) -> Roofline:
    """Roofline terms from the traced cost (``hlo_cost.HLOCost``); all hc
    numbers are per device."""
    return _terms(hc.flops, hc.bytes_accessed, hc.coll_wire_bytes,
                  _collective_s(hc.coll_by_link, hw), n_chips, mflops, hw)


def roofline(cost: dict, coll: CollectiveStats, n_chips: int, mflops: float,
             hw: dict = H100_SXM) -> Roofline:
    """``cost`` = per-device {"flops", "bytes accessed"}; totals are
    per-device x chips."""
    return _terms(float(cost.get("flops", 0.0)),
                  float(cost.get("bytes accessed", 0.0)), coll.wire_bytes,
                  _collective_s(coll.by_link, hw), n_chips, mflops, hw)
