"""Rank entry of the ``shard_map`` tests (``tests/test_torch_shard_map.py``);
it holds no tests and imports only ``torch`` and ``repro_torch``.

    python tests/test_torch_rank_worker.py SPEC RANK

``SPEC`` is a pickle of the run: the ranks' world size M, a ``FileStore``
path, the worker counts W to run, an output prefix and a scratch
directory (and, optionally, a graph, init tables, replayed draws and
refresh phases from the reference).  ``RANK`` is this process's rank
in ``[0, M)``; rank ``-1`` is the twin, which runs the same suite on
the ``vmap`` backend in one process, with no process group.  Each rank of an M-rank gloo group
on the CPU (one thread, a 60 s collective timeout) runs the suite on
``backend="shard_map"`` over ``parallel.util.workers_mesh(M, "cpu")`` and
pickles its results to ``PREFIX.rank{RANK}`` (the twin to
``PREFIX.twin``), which the test reads and compares: ``{W: suite}`` holds
what every rank returns alike, ``{("rank", W): rank_suite}`` what is the
rank's own (its resting rows, the live server rank 0 drives).

:func:`single_rank_mesh` is a one-rank gloo mesh in the calling process,
for in-process checks of the ``M = 1`` backend.
"""
import contextlib
import os
import pickle
import sys
import time
import warnings
from datetime import timedelta

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import kg  # noqa: E402
from repro_torch.core import eval_device, mapreduce  # noqa: E402
from repro_torch.core.models import get_model  # noqa: E402
from repro_torch.data import kg as kg_lib  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel import util as par  # noqa: E402
from repro_torch.serve import KGServer  # noqa: E402
from repro_torch.serve import server as server_mod  # noqa: E402

GRAPH = (0, 200, 5, 2000)       # synthetic_kg(seed, entities, relations, N)
KW = dict(dim=8, batch_size=16, learning_rate=0.05)
STRATEGIES = ("average", "miniloss_perkey", "miniloss_global", "random")
DEVICE_KW = dict(pipeline="device", merge_every=2, repartition_every=2,
                 block_epochs=4)
HOST_EPOCHS, DEVICE_EPOCHS = 2, 4
# the reference's check_sharded_tables and check_bounded_staleness cells
SHARDED_KW = dict(pipeline="device", block_epochs=2, epochs=4,
                  merge_transport="sparse", table_sharding="sharded")
STALE_KW = dict(pipeline="device", block_epochs=4, merge_every=2, epochs=8,
                staleness=2)
STALE_TRANSPORTS = {"dense": {}, "sparse": dict(merge_transport="sparse"),
                    "sharded": dict(merge_transport="sparse",
                                    table_sharding="sharded")}
SERVER_WAVES = ((1, False), (3, True), (4, False))
WAIT_S = 60                     # every future's bound
FAULT_TIMEOUT_S = 5.0           # the command group's timeout in _server_faults


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


def _sharded(graph, mesh, W: int) -> dict:
    """Sharded tables (the reference's ``check_sharded_tables``): sparse
    SGD with a Reduce every epoch and every 2, sparse BGD; then the
    sharded evaluation, ranks and top-k (k above and below the block
    size) of the SGD artifact."""
    out = {}
    base = dict(SHARDED_KW, n_workers=W, seed=0)
    for K in (1, 2):
        out[f"sharded-sgd-merge{K}"] = _host(_fit(graph, mesh, merge_every=K,
                                                  **base))
    out["sharded-bgd"] = _host(_fit(graph, mesh, paradigm="bgd", **base))
    kb = _fit(graph, mesh, merge_every=2, **base).kb
    eng = dict(backend="shard_map", mesh=mesh) if mesh is not None else {}
    sh = dict(n_workers=W, table_sharding="sharded", **eng)
    out["sharded-evaluate"] = kg.evaluate(kb, engine="device", **sh)
    out["sharded-ranks"] = eval_device.entity_ranks_device(
        kb.params, graph.test, "l1", graph.eval_filter_candidates(),
        relations=True, chunk=32, **sh)
    test = graph.test[:32]
    h, r, t = test[:, 0], test[:, 1], test[:, 2]
    for k in (10, 40):              # 40 > R = 25 at W = 8: the local cut
        for label, res_ in (
                ("tails", kb.query_tails(h, r, k=k, **sh)),
                ("tails-filtered", kb.query_tails(h, r, k=k, filtered=True,
                                                  **sh)),
                ("heads", kb.query_heads(t, r, k=k, chunk=8, **sh))):
            out[f"sharded-{label}-k{k}"] = (res_.ids, res_.energies)
    out["sharded-rank"] = kb.engine(**sh).rank(test, "tail")
    return out


def _stale(graph, mesh, W: int) -> dict:
    """Bounded staleness (the reference's ``check_bounded_staleness``):
    S = 2 under the dense, sparse and sparse + sharded transports."""
    return {f"stale-{name}": _host(_fit(graph, mesh, n_workers=W, seed=0,
                                        **STALE_KW, **extra))
            for name, extra in STALE_TRANSPORTS.items()}


def _resting(graph, mesh, W: int) -> dict:
    """One device-pipeline block of sharded sparse SGD driven directly:
    its params in (placed) and out as this rank rests them, the rows it
    keeps and the bytes they take, beside the whole tables."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        kcfg, mcfg = kg.make_configs(
            graph, "transe", "sgd", n_workers=W, merge_every=2,
            **{k: v for k, v in SHARDED_KW.items() if k != "epochs"},
            **dict(KW, backend="shard_map" if mesh is not None else "vmap"))
    model = get_model("transe")
    params = model.init_params(torch.Generator().manual_seed(0), kcfg,
                               device="cpu")
    part = kg_lib.PARTITIONERS[mcfg.partition](0, graph.train, W)
    lo, hi = 0, W
    if mesh is not None:
        lo, hi = par.local_workers(mesh, W)
        layout = mapreduce.resting_layout(mcfg, kcfg, model)
        params = sharding.place(params, layout, W, mesh)
    block = mapreduce.make_block_fn(mcfg, kcfg, torch.as_tensor(part[lo:hi]),
                                    model=model, seed=0, mesh=mesh)
    rest, _ = block(params, range(2))
    rows = (None if mesh is None else
            sharding.resting_rows(kcfg.n_entities, W, mesh))
    return {"rest": {n: t.numpy() for n, t in rest.items()}, "rows": rows,
            "bytes": sharding.resident_bytes(rest)}


def _server(graph, kb, kb2, mesh, W: int, table_sharding: str) -> dict:
    """A live server over the mesh (the reference's ``check_kg_server``):
    waves of 1, 3 and 4 requests, filtered and unfiltered, ``max_batch``
    4, then the first wave again from the cache; then a swap to ``kb2``
    (every rank hands it in) and the 3-request wave on it.  Rank 0 drives
    it and records the answers beside the single-device engine's; every
    other rank follows until rank 0's stop."""
    eng = dict(backend="shard_map", mesh=mesh) if mesh is not None else {}
    server = KGServer(kb, max_batch=4, max_wait_us=5000, default_k=10,
                      n_workers=W, table_sharding=table_sharding, **eng)
    out = {"follower": True}
    try:
        if mesh is not None and par.mesh_rank(mesh) > 0:
            server.swap(kb2)
            return out
        server.warmup(kinds=("tails",))
        waves = []
        for i, (size, filtered) in enumerate(
                SERVER_WAVES + SERVER_WAVES[:2]):
            if i == len(SERVER_WAVES) + 1:
                server.swap(kb2)
                kb = kb2
            rows = graph.test[10:10 + size]
            h, r = rows[:, 0], rows[:, 1]
            server.pause()
            futs = [server.submit("tails", hh, rr, filtered=filtered)
                    for hh, rr in zip(h, r)]
            server.resume()
            answers = [f.result(timeout=WAIT_S) for f in futs]
            ref = kb.query_tails(h, r, k=10, filtered=filtered)
            waves.append({
                "ids": np.stack([a.ids for a in answers]),
                "energies": np.stack([a.energies for a in answers]),
                "cached": [a.cached for a in answers],
                "fingerprints": [a.fingerprint for a in answers],
                "ref": (ref.ids, ref.energies, kb.fingerprint())})
        stats = server.stats()
        out = {"waves": waves, "steady": stats.steady_recompiles,
               "bucket_waves": stats.bucket_waves, "swaps": stats.swaps,
               "invalidations": stats.cache_invalidations}
    finally:
        server.stop()
        out["stopped"] = not server._thread.is_alive()
    return out


def _server_faults(graph, kb, kb2, mesh, W: int) -> dict:
    """Over a mesh of M > 1, with the command group's timeout cut to
    ``FAULT_TIMEOUT_S``: (1) every follower calls ``stop()`` at once while
    rank 0 idles for 1.5 timeouts and then answers a wave, so the
    followers stop cleanly when rank 0 stops; (2) on a swap rank 1 is
    handed the old artifact and the others the new one: rank 0's swap
    raises with rank 1's error, its later requests are refused, and every
    follower's ``stop()`` raises."""
    saved = server_mod.CHANNEL_TIMEOUT_S, server_mod.HEARTBEAT_S
    server_mod.CHANNEL_TIMEOUT_S = FAULT_TIMEOUT_S
    server_mod.HEARTBEAT_S = FAULT_TIMEOUT_S / 10
    rank = par.mesh_rank(mesh)
    make = lambda: KGServer(kb, max_batch=4, max_wait_us=5000, n_workers=W,
                            backend="shard_map", mesh=mesh)
    out = {}

    def stopped(server, key):
        try:
            server.stop()
            out[key] = None
        except RuntimeError as e:
            out[key] = repr(e.__cause__)
        out[key + "-thread"] = server._thread.is_alive()
        out[key + "-channel"] = server._channel is None

    try:
        server = make()
        try:
            if rank == 0:
                time.sleep(1.5 * FAULT_TIMEOUT_S)
                rows = graph.test[:3]
                futs = [server.submit("tails", h, r) for h, r in rows[:, :2]]
                got = [f.result(timeout=WAIT_S) for f in futs]
                ref = kb.query_tails(rows[:, 0], rows[:, 1], k=10)
                out["long-ids"] = (np.stack([a.ids for a in got]), ref.ids)
                out["long-energies"] = (np.stack([a.energies for a in got]),
                                        ref.energies)
        finally:
            stopped(server, "long-stop")
        server = make()
        try:
            if rank == 0:
                try:
                    server.swap(kb2)
                    out["swap"] = None
                except RuntimeError as e:
                    out["swap"] = str(e)
                try:
                    server.submit("tails", 0, 0)
                    out["after"] = None
                except RuntimeError as e:
                    out["after"] = str(e)
            else:
                server.swap(kb if rank == 1 else kb2)
        finally:
            stopped(server, "swap-stop")
    finally:
        server_mod.CHANNEL_TIMEOUT_S, server_mod.HEARTBEAT_S = saved
    return out


def rank_suite(mesh, W: int) -> dict:
    """What is this rank's own in one (M, W) cell: its resting rows of a
    sharded block and, per table layout, the live server's answers (rank
    0) or a follower's clean stop; at W = M > 1 also the live server's
    faults (:func:`_server_faults`)."""
    graph = kg_lib.synthetic_kg(GRAPH[0], n_entities=GRAPH[1],
                                n_relations=GRAPH[2], n_triplets=GRAPH[3])
    out = {"resting": _resting(graph, mesh, W)}
    kb = _fit(graph, mesh, n_workers=W, epochs=HOST_EPOCHS, seed=0,
              reduce_impl="allgather").kb
    kb2 = _fit(graph, mesh, n_workers=W, epochs=1, seed=1,
               reduce_impl="allgather").kb
    for layout in ("replicated", "sharded"):
        out[f"server-{layout}"] = _server(graph, kb, kb2, mesh, W, layout)
    if mesh is not None and W == par.mesh_size(mesh) > 1:
        out["server-faults"] = _server_faults(graph, kb, kb2, mesh, W)
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
    # checkpoints every 2 epochs inside blocks of 4, sharded tables
    # resting between the blocks and an evaluation at the end: every
    # rank slices its blocks where rank 0 writes
    out["device-sharded-ckpt"] = _host(_fit(
        graph, mesh, n_workers=W, seed=0, merge_every=2,
        ckpt_dir=ckpt + "-c", checkpoint_every=2, eval_every=4,
        **dict(SHARDED_KW, block_epochs=4)))
    out["sharded-steps"] = sorted(os.listdir(ckpt + "-c"))
    if mesh is not None and par.mesh_size(mesh) > 1:
        try:
            _fit(graph, mesh, **dict(base, n_workers=par.mesh_size(mesh)
                                     + 1))
        except ValueError as e:
            out["indivisible"] = str(e)
    out.update(_sharded(graph, mesh, W))
    out.update(_stale(graph, mesh, W))
    if replay is not None:
        rgraph = kg_lib.KG(*replay["graph"])
        draws = replay["draws"]
        out["replay"] = _host(_fit(
            rgraph, mesh, params=replay["tables"],
            draws=lambda epoch: draws[epoch], **replay["kw"]))
        stale = replay["stale"]
        out["replay-stale"] = _host(_fit(
            rgraph, mesh, params=stale["tables"],
            draws=lambda epoch: stale["draws"][epoch],
            stale_offsets=stale["offsets"], **stale["kw"]))
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
        results.update({("rank", W): rank_suite(mesh, W)
                        for W in spec["W"]})
    finally:
        if rank >= 0:
            dist.destroy_process_group()
    name = f"{spec['out']}.{'twin' if rank < 0 else f'rank{rank}'}"
    with open(name + ".tmp", "wb") as f:
        pickle.dump(results, f)
    os.replace(name + ".tmp", name)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
