"""Rank entry of the ``shard_map`` tests (``tests/test_torch_shard_map.py``);
it holds no tests and imports only ``torch`` and ``repro_torch``.

    python tests/test_torch_rank_worker.py SPEC RANK

``SPEC`` is a pickle of the run: the ranks' world size M, a ``FileStore``
path, the worker counts W to run, an output prefix and a scratch
directory (and, optionally, a graph, init tables and replayed draws from
the reference).  ``RANK`` is this process's rank in ``[0, M)``; rank
``-1`` is the twin, which runs the same suite on the ``vmap`` backend in
one process, with no process group.  Each rank of an M-rank gloo group
on the CPU (one thread, a 60 s collective timeout) runs the suite on
``backend="shard_map"`` over ``parallel.util.workers_mesh(M, "cpu")`` and
pickles its results to ``PREFIX.rank{RANK}`` (the twin to
``PREFIX.twin``), which the test reads and compares.

:func:`single_rank_mesh` is a one-rank gloo mesh in the calling process,
for in-process checks of the ``M = 1`` backend.
"""
import contextlib
import os
import pickle
import sys
import warnings
from datetime import timedelta

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import kg  # noqa: E402
from repro_torch.core import eval_device  # noqa: E402
from repro_torch.data import kg as kg_lib  # noqa: E402
from repro_torch.parallel import util as par  # noqa: E402

GRAPH = (0, 200, 5, 2000)       # synthetic_kg(seed, entities, relations, N)
KW = dict(dim=8, batch_size=16, learning_rate=0.05)
STRATEGIES = ("average", "miniloss_perkey", "miniloss_global", "random")
DEVICE_KW = dict(pipeline="device", merge_every=2, repartition_every=2,
                 block_epochs=4)
HOST_EPOCHS, DEVICE_EPOCHS = 2, 4


@contextlib.contextmanager
def single_rank_mesh(tmp_dir):
    """A one-rank gloo process group (a ``FileStore`` under ``tmp_dir``)
    and its ``"workers"`` mesh on the CPU, torn down on exit."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(str(tmp_dir), "store"), 1),
        world_size=1, rank=0, timeout=timedelta(seconds=60))
    try:
        yield par.workers_mesh(1, "cpu")
    finally:
        dist.destroy_process_group()


def _host(res) -> dict:
    out = {"params": {n: t.cpu().numpy() for n, t in res.params.items()},
           "loss": list(res.loss_history)}
    if res.trace is not None:
        out["trace"] = [(e.epoch, e.metrics) for e in res.trace.entries]
    return out


def _fit(graph, mesh, **kw):
    shard = dict(backend="shard_map", mesh=mesh) if mesh is not None else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return kg.fit(graph, device="cpu", **dict(KW, **kw), **shard)


def _serve(res, graph, mesh, W) -> dict:
    """Evaluation, ranks and top-k of one trained artifact."""
    kb = res.kb
    eng = dict(backend="shard_map", mesh=mesh) if mesh is not None else {}
    test = graph.test[:50]
    h, r, t = test[:, 0], test[:, 1], test[:, 2]
    ranks = eval_device.entity_ranks_device(
        kb.params, graph.test, "l1", graph.eval_filter_candidates(),
        n_workers=W, relations=True, chunk=32, **eng)
    _, rel = eval_device.relation_prediction_device(
        kb.params, graph.test, "l1", n_workers=W, chunk=32,
        return_ranks=True, **eng)
    out = {"evaluate": kg.evaluate(kb, engine="device", n_workers=W, **eng),
           "ranks": ranks, "relation_ranks": rel,
           "rank": kb.engine(n_workers=W, **eng).rank(test, "head")}
    for label, res_ in (
            ("tails", kb.query_tails(h, r, k=5, filtered=True,
                                     n_workers=W, **eng)),
            ("heads", kb.query_heads(t, r, k=7, n_workers=W, chunk=8,
                                     **eng)),
            ("relations", kb.query_relations(h, t, k=3, n_workers=W,
                                             **eng))):
        out[label] = (res_.ids, res_.energies)
    return out


def suite(mesh, W: int, scratch: str, replay=None) -> dict:
    """Every check of one (M, W) cell, on ``shard_map`` over ``mesh`` or,
    with ``mesh=None``, on ``vmap``: a dict of named host results."""
    graph = kg_lib.synthetic_kg(GRAPH[0], n_entities=GRAPH[1],
                                n_relations=GRAPH[2], n_triplets=GRAPH[3])
    out = {}
    base = dict(n_workers=W, epochs=HOST_EPOCHS, seed=0)
    for strategy in STRATEGIES:
        for impl in ("allgather", "psum"):
            out[f"host-sgd-{strategy}-{impl}"] = _host(_fit(
                graph, mesh, strategy=strategy, reduce_impl=impl, **base))
    out["host-sgd-average-sparse"] = _host(_fit(
        graph, mesh, merge_transport="sparse", **base))
    out["host-sgd-random-sparse"] = _host(_fit(
        graph, mesh, strategy="random", merge_transport="sparse", **base))
    for transport in ("dense", "sparse"):
        out[f"host-bgd-{transport}"] = _host(_fit(
            graph, mesh, paradigm="bgd", merge_transport=transport, **base))
    dev = dict(base, epochs=DEVICE_EPOCHS, **DEVICE_KW)
    for strategy in STRATEGIES:
        out[f"device-sgd-{strategy}-allgather"] = _host(_fit(
            graph, mesh, strategy=strategy, reduce_impl="allgather", **dev))
    out["device-sgd-average-psum"] = _host(_fit(graph, mesh, **dev))
    out["device-sgd-average-sparse"] = _host(_fit(
        graph, mesh, merge_transport="sparse", **dev))
    bgd = dict(dev, merge_every=1, epochs=2, block_epochs=2)
    for transport in ("dense", "sparse"):
        out[f"device-bgd-{transport}"] = _host(_fit(
            graph, mesh, paradigm="bgd", merge_transport=transport, **bgd))
    # evaluation, ranks and top-k of the allgather artifact (the same
    # bits on every rank and in the twin)
    trained = _fit(graph, mesh, reduce_impl="allgather", **base)
    out["serve"] = _serve(trained, graph, mesh, W)
    # in-loop evaluation, checkpoints and a resume on the device pipeline
    ckpt = os.path.join(scratch, f"W{W}-{'shard' if mesh else 'vmap'}")
    traced = _fit(graph, mesh, reduce_impl="allgather", eval_every=2,
                  ckpt_dir=ckpt + "-a", checkpoint_every=2, **dev)
    out["device-traced"] = _host(traced)
    _fit(graph, mesh, reduce_impl="allgather", ckpt_dir=ckpt + "-b",
         **dict(dev, epochs=2, block_epochs=2))
    out["device-resumed"] = _host(_fit(
        graph, mesh, reduce_impl="allgather", ckpt_dir=ckpt + "-b",
        resume=True, **dev))
    out["steps"] = sorted(os.listdir(ckpt + "-a"))
    if mesh is not None and par.mesh_size(mesh) > 1:
        try:
            _fit(graph, mesh, **dict(base, n_workers=par.mesh_size(mesh)
                                     + 1))
        except ValueError as e:
            out["indivisible"] = str(e)
    if replay is not None:
        rgraph = kg_lib.KG(*replay["graph"])
        draws = replay["draws"]
        out["replay"] = _host(_fit(
            rgraph, mesh, params=replay["tables"],
            draws=lambda epoch: draws[epoch], **replay["kw"]))
    return out


def main(spec_path: str, rank: int) -> None:
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    mesh = None
    if rank >= 0:
        dist.init_process_group(
            "gloo", store=dist.FileStore(spec["store"], spec["M"]),
            world_size=spec["M"], rank=rank, timeout=timedelta(seconds=60))
        mesh = par.workers_mesh(spec["M"], "cpu")
    try:
        results = {W: suite(mesh, W, spec["scratch"],
                            spec.get("replay") if W == spec["W"][0]
                            else None)
                   for W in spec["W"]}
    finally:
        if rank >= 0:
            dist.destroy_process_group()
    name = f"{spec['out']}.{'twin' if rank < 0 else f'rank{rank}'}"
    with open(name + ".tmp", "wb") as f:
        pickle.dump(results, f)
    os.replace(name + ".tmp", name)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
