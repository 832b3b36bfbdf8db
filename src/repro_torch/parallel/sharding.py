"""Sharding rules: where the KG engine's tables rest over a ``shard_map``
mesh, and how every LM parameter, batch, cache and optimizer tensor is
laid out over the ``("pod", "data", "model")`` mesh.  A port of
``repro.parallel.sharding``.

KG half (``KGPartitions``, ``kg_partitions``, ``kg_table_shardings``).

In JAX these name ``PartitionSpec``s that XLA lays out; in PyTorch every
rank is a process holding its own tensors, so the same rules say which
rows of which table a rank keeps between the device pipeline's blocks.
Rank ``r`` of M holds the ``W / M`` workers ``[lo, hi)``
(``parallel/util.local_workers``), and worker ``w`` owns the row block
``[w·R, (w+1)·R)`` of an entity-role table, ``R = merge.shard_rows(N,
W)``, the rule by which the sharded Reduce routes rows
(``core/merge.py``).  Under ``table_sharding="sharded"`` an entity-role
table whose row count divides W rests as the blocks of the rank's own
workers, rows ``[lo·R, hi·R)``; relation-role tables (small, and not
shard-routed) and tables that do not divide stay whole on every rank, as
the reference's ``kg_table_shardings`` replicates them.  The layout
changes no bit of the training: a block all-gathers the resting blocks
into whole tables before its Map runs.

LM half.  Profiles (``ModelConfig.sharding_profile``):
  * ``dp``      — params/opt replicated; batch over (pod, data, model).
  * ``tp``      — attention heads / ffn / vocab / experts over ``model``;
                  batch over (pod, data).
  * ``fsdp_tp`` — tp plus parameter/optimizer sharding over ``data``.

A spec is one entry per dimension of a tensor: ``None`` (whole), a mesh
axis name, or a tuple of names (the dim cut over their product, the
first major), the reference's ``PartitionSpec`` as a tuple.  Rules are
name and shape based and divisibility-safe: an axis that does not divide
its dim moves to the largest free dim it divides, or is dropped.  The
reference stacks a segment's layers under a leading dim that no rule
shards; the port holds one module per layer, so its specs are the
reference's with that leading dim dropped.  ``mesh`` is a
``DeviceMesh`` or a mapping of axis name to size (the tables need no
process group).  :func:`placements` turns a spec into the DTensor
placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.parallel import util as par

ROW, WHOLE = "row", "whole"


@dataclasses.dataclass(frozen=True)
class KGPartitions:
    """The layout of the KG engine's tables under one ``table_sharding``
    profile: every embedding table ``(N, k)`` takes ``table`` on its row
    axis (``"row"``: cut into the workers' row blocks, ``"whole"``: kept
    whole).  The partitioned triplets ``(W, N_w, 3)`` are always split on
    the worker axis (each rank holds its workers' rows)."""

    table: str


def kg_partitions(table_sharding: str) -> KGPartitions:
    """The profile of the ``table_sharding`` knob: ``"replicated"`` keeps
    every table whole on every rank; ``"sharded"`` rests the tables in
    the row blocks of the rank's workers, the blocks the sharded Reduce
    assigns them, so the rank that merges a block stores it.  Which
    tables the ``table`` rule reaches is :func:`kg_table_shardings`'s
    choice."""
    if table_sharding == "sharded":
        return KGPartitions(table=ROW)
    if table_sharding == "replicated":
        return KGPartitions(table=WHOLE)
    raise ValueError(
        f"bad table_sharding {table_sharding!r}; "
        "want 'replicated' or 'sharded'")


def kg_table_shardings(roles: Dict[str, str], n_rows: Dict[str, int],
                       n_workers: int,
                       table_sharding: str) -> Dict[str, str]:
    """``{name: "row" | "whole"}`` for KG tables of ``n_rows[name]`` rows:
    under ``"sharded"`` only entity-role tables whose row count divides
    ``n_workers`` rest in row blocks; relation-role tables and tables
    that do not divide stay whole (the reference's ``assign``)."""
    row = kg_partitions(table_sharding).table

    def assign(name, rows) -> str:
        if (row == ROW and roles.get(name) == "ent"
                and rows % n_workers == 0):
            return ROW
        return WHOLE

    return {name: assign(name, rows) for name, rows in n_rows.items()}


def resting_rows(n_rows: int, n_workers: int, mesh) -> tuple:
    """``(lo, hi)``: the rows of a row-blocked table this rank keeps, the
    blocks of its workers."""
    R = n_rows // n_workers
    w_lo, w_hi = par.local_workers(mesh, n_workers)
    return w_lo * R, w_hi * R


def place(params, layout: Dict[str, str], n_workers: int, mesh):
    """The tables as this rank rests them: a ``"row"`` table cut to its
    workers' blocks (a copy, so the whole table's storage can go), a
    ``"whole"`` one as it is."""
    out = {}
    for name, t in params.items():
        if layout[name] == ROW:
            lo, hi = resting_rows(t.shape[0], n_workers, mesh)
            t = t[lo:hi].clone()
        out[name] = t
    return out


def gather(params, layout: Dict[str, str], mesh):
    """Whole tables from every rank's resting ones: a ``"row"`` table's
    blocks all-gathered in rank order (the ranks' bytes exactly), a
    ``"whole"`` one as it is."""
    return {name: par.all_gather(t, mesh) if layout[name] == ROW else t
            for name, t in params.items()}


def resident_bytes(params) -> int:
    """Bytes of the storage behind the tables a rank holds (a view counts
    its whole storage)."""
    return sum(t.untyped_storage().nbytes() for t in params.values())


# ---------------------------------------------------------------------------
# LM parameters, batches, caches and optimizer state
# ---------------------------------------------------------------------------

# tensor-name -> trailing-dim spec (profile-dependent axes filled in below).
# 'M' = model axis, 'F' = fsdp axis (data; only in fsdp_tp), None = whole.
_RULES = {
    # embeddings: vocab-sharded only (sharding d over the fsdp axis makes
    # every chunked-CE contraction emit partial sums)
    "table": ("M", None),            # (V, d)
    "unembed": (None, "M"),          # (d, V)
    # attention
    "wq": ("F", "M", None),          # (d, H, hd)
    "wk": ("F", "M", None),          # (d, KV, hd)
    "wv": ("F", "M", None),
    "wo": ("M", None, "F"),          # (H, hd, d)
    # MLA
    "w_dq": ("F", "M"),              # (d, q_lora)
    "w_uq": (None, "M", None),       # (q_lora|d, H, nope+rope)
    "w_dkv": ("F", "M"),             # (d, kv_lora)
    "w_krope": ("F", None),          # (d, rope_hd)
    "w_uk": (None, "M", None),       # (kv_lora, H, nope)
    "w_uv": (None, "M", None),       # (kv_lora, H, vh)
    # mlp ('wo' of an mlp is (ff, d): _WO_2D)
    "wi": ("F", "M"),                # (d, ff)
    "wg": ("F", "M"),
    # moe
    "router": (None, None),          # (d, E) whole (tiny, fp32)
    # ssm
    "in_proj": ("F", "M"),           # (d, 2*di+2GN+H)
    "out_proj": ("M", "F"),          # (di, d)
    "conv_w": (None, "M"),           # (K, convdim)
    "conv_b": ("M",),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    # rglru
    "w_rec_in": ("F", "M"),          # (d, dr)
    "w_gate_in": ("F", "M"),
    "w_a": ("M", None, None),        # (nb, drb, drb) block-diagonal
    "w_x": ("M", None, None),
    "b_a": ("M",),
    "b_x": ("M",),
    "lam": ("M",),
    "w_out": ("M", "F"),             # (dr, d)
}

# a MoE FFN's expert tensors (E, ., .) get an expert-parallel leading axis
_MOE_3D = {"wi": ("M", "F", None), "wg": ("M", "F", None),
           "wo": ("M", None, "F")}
# mlp 'wo': (ff, d)
_WO_2D = ("M", "F")

Spec = Tuple


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a mapping."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def _size(ax, sizes) -> int:
    return math.prod(sizes[a] for a in (ax if isinstance(ax, tuple)
                                        else (ax,)))


def _resolve(axis: Optional[str], profile: str):
    if axis == "M":
        return "model" if profile in ("tp", "fsdp_tp") else None
    if axis == "F":
        return "data" if profile == "fsdp_tp" else None
    return None


def _spec_for(name: str, ndim: int, profile: str) -> Spec:
    base = _RULES.get(name)
    if base is None:
        return ()
    return tuple(_resolve(a, profile) for a in base)


def _fit(spec: Spec, shape, mesh) -> Spec:
    """Left-pad to ndim; an axis that does not divide its dim is RELOCATED
    to the largest unassigned dim it divides (qwen2-moe's 60 experts
    cannot take a 16-way model axis: it moves to the ffn dim), and
    dropped only if nowhere fits."""
    sizes = _axis_sizes(mesh)
    shape = tuple(shape)
    spec = (None,) * (len(shape) - len(spec)) + tuple(spec)
    spec = spec[-len(shape):] if shape else ()
    out: list = []
    homeless: list = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        size = _size(ax, sizes)
        if dim % size == 0:
            out.append(ax)
        else:
            out.append(None)
            homeless.append((ax, size))
    for ax, size in homeless:
        cands = [i for i, cur in enumerate(out)
                 if cur is None and shape[i] % size == 0 and shape[i] >= size]
        if cands:
            best = max(cands, key=lambda i: shape[i])
            out[best] = ax
    return tuple(out)


def _is_moe_expert(owner, name: str) -> bool:
    """A MoE FFN's routed-expert tensor: ``wi`` / ``wg`` / ``wo`` held by
    a ``moe.MoEParams`` (its shared experts are an MLP module of their
    own).  The reference tells them by ``ndim >= 4``, which holds only for
    its stacked tensors."""
    from repro_torch.models.moe import MoEParams

    return name in _MOE_3D and isinstance(owner, MoEParams)


def param_shardings(model, mesh, profile: str) -> Dict[str, Spec]:
    """{parameter name: spec} for every ``named_parameters()`` entry of a
    model (built on any device, ``meta`` included).  An attention ``wo``
    (H, hd, d) and an MLP ``wo`` (ff, d) are told apart by the subtree
    that holds them (``ffn`` / ``mlp`` / ``shared``)."""
    out = {}
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            parts = full.split(".")
            if _is_moe_expert(mod, name):
                spec = tuple(_resolve(a, profile) for a in _MOE_3D[name])
            elif name == "wo" and any(k in ("ffn", "mlp", "shared")
                                      for k in parts[:-1]):
                spec = tuple(_resolve(a, profile) for a in _WO_2D)
            else:
                spec = _spec_for(name, p.dim(), profile)
            out[full] = _fit(spec, p.shape, mesh)
    return out


def batch_axes(mesh, profile: str = "tp") -> Tuple[str, ...]:
    """Axes the batch dim shards over.  Pure-DP profiles fold the (otherwise
    idle) model axis into the batch so all ranks hold distinct data."""
    sizes = _axis_sizes(mesh)
    names = ("pod", "data", "model") if profile == "dp" else ("pod", "data")
    return tuple(a for a in names if a in sizes)


def _dividing_prefix(dim: int, axes: Tuple[str, ...], mesh) -> Tuple[str, ...]:
    """Longest prefix of ``axes`` whose product divides ``dim``."""
    sizes = _axis_sizes(mesh)
    out = []
    size = 1
    for a in axes:
        nxt = size * sizes[a]
        if dim % nxt != 0:
            break
        out.append(a)
        size = nxt
    return tuple(out)


def _shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def data_shardings(batch, mesh, profile: str = "tp"):
    """The batch's specs (a dict like the batch): dim0 of every input over
    the longest dividing prefix of the DP axes (a batch of 32 on a 16x16
    dp mesh still shards 16-way instead of not at all); scalars whole."""
    axes = batch_axes(mesh, profile)

    def assign(leaf):
        shape = _shape(leaf)
        if not shape:
            return ()
        prefix = _dividing_prefix(shape[0], axes, mesh)
        first = (None if not prefix else prefix[0] if len(prefix) == 1
                 else prefix)
        return (first,) + (None,) * (len(shape) - 1)

    return par.tree_map(assign, batch)


def _cache_spec(shape, mesh, dp_axes, msize) -> Spec:
    """One per-layer cache leaf (B, ...): batch over the longest dividing
    prefix of (pod, data), then ``model`` on the largest remaining dim it
    divides (the sequence axis of a 32k KV cache, typically: what makes
    decode_32k and long_500k fit).  The reference's leaf has a leading
    layer dim, never its batch dim here, and which dims it offers
    ``model`` does not depend on it."""
    if not shape:
        return ()
    spec: list = [None] * len(shape)
    bdim = None
    prefix = _dividing_prefix(shape[0], dp_axes, mesh)
    if prefix:
        spec[0] = prefix if len(prefix) > 1 else prefix[0]
        bdim = 0
    if msize > 1:
        cands = [i for i in range(len(shape))
                 if i != bdim and shape[i] % msize == 0
                 and shape[i] >= msize]
        if cands:
            best = max(cands, key=lambda i: shape[i])
            spec[best] = "model"
    return tuple(spec)


def cache_shardings(caches, mesh, profile: str):
    """KV / state caches (a list of per-layer NamedTuples, the port's
    ``init_caches``): the batch over (pod, data) where it divides, and
    ``model`` on the largest other dim it divides (long_500k's batch of
    1)."""
    sizes = _axis_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    msize = sizes.get("model", 1)

    def one(tree):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(one(x) for x in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(one(x) for x in tree)
        return _cache_spec(_shape(tree), mesh, dp_axes, msize)

    return one(caches)


def opt_shardings(opt_state, param_specs: Dict[str, Spec], mesh,
                  profile: str):
    """The optimizer state's specs (a tree like ``opt_state``): a moment
    takes its parameter's spec; a factored Adafactor vector (``vr`` /
    ``vc``) the leading entries of it, re-checked for divisibility on its
    own shape; scalars (``step``) are whole."""
    sizes = _axis_sizes(mesh)

    def assign(leaf, name):
        shape = _shape(leaf)
        if not shape:
            return ()
        spec = param_specs.get(name)
        if spec is None:
            return (None,) * len(shape)
        if len(spec) == len(shape):
            return spec
        return tuple(ax if ax is not None and dim % _size(ax, sizes) == 0
                     else None for dim, ax in zip(shape, spec))

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k if name is None and k in param_specs
                            else name) for k, v in tree.items()}
        return assign(tree, name)

    return {k: walk(v, None) if isinstance(v, dict) else assign(v, None)
            for k, v in opt_state.items()}


def placements(spec: Spec, mesh):
    """The DTensor placements of a spec on a ``DeviceMesh``: mesh dim
    ``a`` is ``Shard(d)`` where the spec puts ``a`` on tensor dim ``d``,
    else ``Replicate()``.  A dim cut over several axes is cut in mesh-dim
    order, the first axis major (the reference's tuple order)."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, ax in enumerate(spec):
        for a in (() if ax is None else
                  (ax,) if isinstance(ax, str) else ax):
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)
