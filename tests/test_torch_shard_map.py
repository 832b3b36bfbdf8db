"""The ``shard_map`` backend of the port over ``torch.distributed``: gloo
ranks on the CPU against the ``vmap`` backend, mirroring the reference's
``tests/helpers/multiworker_check.py`` (the engine's SGD and BGD
Reduces, the device pipeline, the device evaluation, re-partitioning,
in-loop evaluation, resume and the query engine, the sparse transport,
sharded tables, bounded staleness and the live server), at its size:
``synthetic_kg(0, 200, 5, 2000)``, dim 8, batch 16.

Each mesh size M in {1, 2, 4} is one run of
``tests/test_torch_rank_worker.py``: M rank processes meeting through a
``FileStore`` under ``tmp_path`` (never a TCP port) plus one twin process
that runs the same suite on ``vmap``, all started together, each joined
within a bound and killed in ``finally``.  Every rank runs W in {M, 2M}.

Contracts: under ``reduce_impl="allgather"`` (four strategies), the sparse
transport (SGD and BGD) and for every loss history, ranks, metrics and
top-k answer, each rank gives the vmap twin's bits, on both pipelines;
sparse SGD gives dense SGD's bits; the ``psum`` Reduce and dense BGD add
across ranks in gloo's order: bitwise at M = 1, else within the
reference's rtol 1e-4 / atol 1e-5.  All ranks give the same bits.
Sharded tables (sparse SGD at a Reduce every 1 and 2 epochs, sparse BGD),
bounded staleness (S = 2; dense, sparse, sparse + sharded), the sharded
evaluation and top-k give the twin's bits too, loss histories included
(all-gathered and summed in worker order); each rank rests exactly its
own workers' row blocks of the entity table; a live server over the mesh
(rank 0 serving, the others following) answers every wave as the
single-device engine does, with no steady-state recompile, and every
rank stops.  Two cells run at M = 2 on the reference's replayed draws
against its vmap ``fit``: host SGD at 1e-5 (the reference's own vmap =
shard_map contract) and stale sparse + sharded SGD on its refresh phases
at the reference's rtol 1e-4 / atol 1e-5.
"""
import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro import kg as ref_kg
from repro.core.models import get_model as ref_get_model
from repro.data import kg as ref_kg_lib
from repro_torch import kg as port_kg
from repro_torch.data import kg as port_kg_lib
from repro_torch.parallel import util as par
from repro_torch.serve import KGServer

import test_torch_rank_worker as rank_worker
from test_torch_mapreduce import replay_draws
from test_torch_pipeline_device import replay_device_draws
from test_torch_staleness import ref_stale_offsets

MESHES = (1, 2, 4)
# every process's bound: at least twice the module's fixture set-up under
# the tier-1 command (6 xdist workers), which bounds the slowest rank
JOIN_S = 360
TOL = dict(rtol=1e-4, atol=1e-5)
REPLAY_KW = dict(dim=8, batch_size=16, learning_rate=0.05, n_workers=2,
                 strategy="average", reduce_impl="allgather")
REPLAY_EPOCHS = 2
STALE_REPLAY_KW = dict(dim=8, batch_size=16, learning_rate=0.05,
                       n_workers=2, pipeline="device", block_epochs=4,
                       merge_every=2, staleness=2, merge_transport="sparse",
                       table_sharding="sharded")
STALE_REPLAY_EPOCHS = 8
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_torch_rank_worker.py")


def _stale_replay_cell(graph):
    """The reference's stale sparse + sharded vmap fit, with its init
    tables, replayed device draws and refresh phases."""
    kcfg, mcfg = ref_kg.make_configs(graph, "transe", "sgd",
                                     **STALE_REPLAY_KW)
    init = ref_get_model("transe").init_params(jax.random.PRNGKey(1), kcfg)
    tables = {n: np.asarray(t) for n, t in init.items()}
    want = ref_kg.fit(graph, "transe", "sgd", epochs=STALE_REPLAY_EPOCHS,
                      seed=0, params=init, **STALE_REPLAY_KW)
    spec = {"tables": tables,
            "draws": replay_device_draws(graph, kcfg, mcfg, tables, 0,
                                         STALE_REPLAY_EPOCHS),
            "offsets": ref_stale_offsets(0, mcfg.n_workers, mcfg.staleness),
            "kw": dict(STALE_REPLAY_KW, epochs=STALE_REPLAY_EPOCHS, seed=0)}
    return spec, want


def _replay_cell():
    """The reference's graph, init tables, replayed draws and vmap fit
    (and the stale cell's, :func:`_stale_replay_cell`)."""
    graph = ref_kg_lib.synthetic_kg(rank_worker.GRAPH[0],
                                    n_entities=rank_worker.GRAPH[1],
                                    n_relations=rank_worker.GRAPH[2],
                                    n_triplets=rank_worker.GRAPH[3])
    fit_kw = {k: v for k, v in REPLAY_KW.items() if k != "reduce_impl"}
    kcfg, mcfg = ref_kg.make_configs(graph, "transe", "sgd", **fit_kw)
    init = ref_get_model("transe").init_params(jax.random.PRNGKey(1), kcfg)
    tables = {n: np.asarray(t) for n, t in init.items()}
    want = ref_kg.fit(graph, "transe", "sgd", epochs=REPLAY_EPOCHS, seed=0,
                      params=init, **fit_kw)
    stale, stale_want = _stale_replay_cell(graph)
    spec = {"graph": (graph.n_entities, graph.n_relations, graph.train,
                      graph.valid, graph.test),
            "tables": tables,
            "draws": replay_draws(graph, kcfg, mcfg, tables, 0,
                                  REPLAY_EPOCHS),
            "kw": dict(REPLAY_KW, epochs=REPLAY_EPOCHS, seed=0),
            "stale": stale}
    return spec, (want, stale_want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{M: (twin, [rank results])}``, every mesh's processes started at
    once; plus the replay cell's reference fit."""
    replay, want = _replay_cell()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(WORKER), "..", "src"),
         os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs, specs = [], {}
    try:
        for M in MESHES:
            d = tmp_path_factory.mktemp(f"mesh{M}")
            spec = {"M": M, "store": str(d / "store"), "W": [M, 2 * M],
                    "out": str(d / "res"), "scratch": str(d)}
            if M == 2:
                spec["replay"] = replay
            with open(d / "spec", "wb") as f:
                pickle.dump(spec, f)
            specs[M] = spec
            for rank in list(range(M)) + [-1]:
                log = open(d / f"log{rank}", "wb")
                procs.append((M, rank, log, subprocess.Popen(
                    [sys.executable, WORKER, str(d / "spec"), str(rank)],
                    env=env, stdout=log, stderr=subprocess.STDOUT)))
        deadline = time.monotonic() + JOIN_S
        for M, rank, log, p in procs:
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                log.flush()
                with open(log.name, "rb") as f:
                    tail = f.read()[-4000:].decode(errors="replace")
                pytest.fail(f"mesh {M} rank {rank} ended with {rc}:\n{tail}")
    finally:
        for *_, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    out = {}
    for M, spec in specs.items():
        load = lambda name: pickle.load(open(f"{spec['out']}.{name}", "rb"))
        out[M] = (load("twin"), [load(f"rank{r}") for r in range(M)])
    out["reference"], out["reference-stale"] = want
    return out


def _bits(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_bits(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return a == b


def _close(a, b) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


CELLS = [(M, W) for M in MESHES for W in (M, 2 * M)]
CELL_IDS = [f"M{M}-W{W}" for M, W in CELLS]


def _pick(runs, M, W, name):
    twin, ranks = runs[M]
    return twin[W][name], [r[W][name] for r in ranks]


def _own(runs, M, W, name):
    """The twin's and each rank's own result (``rank_suite``)."""
    twin, ranks = runs[M]
    return twin[("rank", W)][name], [r[("rank", W)][name] for r in ranks]


@pytest.mark.parametrize("pipeline", ["host", "device"])
@pytest.mark.parametrize("strategy", rank_worker.STRATEGIES)
@pytest.mark.parametrize("M,W", CELLS, ids=CELL_IDS)
def test_sgd_allgather_is_vmap_bitwise(runs, M, W, strategy, pipeline):
    want, got = _pick(runs, M, W, f"{pipeline}-sgd-{strategy}-allgather")
    for g in got:
        assert _bits(g, want)


@pytest.mark.parametrize("name", [
    "host-sgd-average-psum", "host-sgd-miniloss_perkey-psum",
    "host-sgd-miniloss_global-psum", "host-sgd-random-psum",
    "device-sgd-average-psum", "host-bgd-dense", "device-bgd-dense"])
@pytest.mark.parametrize("M,W", CELLS, ids=CELL_IDS)
def test_psum_and_dense_bgd_within_tolerance(runs, M, W, name):
    """All-reduces add across ranks in the backend's order: the vmap bits
    at M = 1, within the reference's tolerance otherwise."""
    want, got = _pick(runs, M, W, name)
    for g in got:
        if M == 1:
            assert _bits(g, want)
        _close(g["params"], want["params"])
        _close(g["loss"], want["loss"])
        # the first epoch's loss precedes any Reduce: all-gathered and
        # summed in worker order, it is the vmap bits
        assert g["loss"][0] == want["loss"][0]


@pytest.mark.parametrize("name,dense", [
    ("host-sgd-average-sparse", "host-sgd-average-allgather"),
    ("host-sgd-random-sparse", "host-sgd-random-allgather"),
    ("device-sgd-average-sparse", "device-sgd-average-allgather"),
    ("host-bgd-sparse", None), ("device-bgd-sparse", None)])
@pytest.mark.parametrize("M,W", CELLS, ids=CELL_IDS)
def test_sparse_transport_is_vmap_bitwise(runs, M, W, name, dense):
    """Sparse SGD and sparse BGD all-gather packed buffers: the vmap
    twin's bits, and sparse SGD gives dense SGD's."""
    want, got = _pick(runs, M, W, name)
    for i, g in enumerate(got):
        assert _bits(g, want)
        if dense is not None:
            assert _bits(g, runs[M][1][i][W][dense])


@pytest.mark.parametrize("what", ["evaluate", "ranks", "relation_ranks",
                                  "rank", "tails", "heads", "relations"])
@pytest.mark.parametrize("M,W", CELLS, ids=CELL_IDS)
def test_evaluation_and_queries_exact(runs, M, W, what):
    """Ranks, metrics and top-k ids and energies split over the mesh are
    the vmap engine's, exactly."""
    want, got = _pick(runs, M, W, "serve")
    for g in got:
        assert _bits(g[what], want[what])


@pytest.mark.parametrize("M,W", CELLS, ids=CELL_IDS)
def test_in_loop_evaluation_checkpoints_and_resume(runs, M, W):
    """The traced run's trace and params are the twin's; a run of 2
    epochs resumed to 4 gives the unbroken run's bits; rank 0 wrote each
    step once."""
    want, got = _pick(runs, M, W, "device-traced")
    resumed = _pick(runs, M, W, "device-resumed")[1]
    steps = _pick(runs, M, W, "steps")[1]
    for g, r, s in zip(got, resumed, steps):
        assert _bits(g, want)
        assert [e for e, _ in g["trace"]] == [1, 3]
        assert _bits(r["params"], g["params"]) and r["loss"] == g["loss"]
        assert s == ["step_0000000002", "step_0000000004"]


@pytest.mark.parametrize("M,W", CELLS, ids=CELL_IDS)
def test_every_rank_returns_the_same_bits(runs, M, W):
    _, ranks = runs[M]
    for r in ranks[1:]:
        assert _bits(r[W], ranks[0][W])


@pytest.mark.parametrize("M", [2, 4])
def test_indivisible_workers_raise(runs, M):
    for r in runs[M][1]:
        assert "does not divide over mesh axis" in r[M]["indivisible"]


def test_replayed_draws_match_the_reference(runs):
    """M = 2 ranks on the reference's replayed draws against its vmap
    ``fit``: the reference's own vmap = shard_map contract, at 1e-5."""
    want = runs["reference"]
    for r in runs[2][1]:
        got = r[2]["replay"]
        np.testing.assert_allclose(got["loss"], want.loss_history,
                                   rtol=1e-5, atol=1e-5)
        for name, t in got["params"].items():
            np.testing.assert_allclose(t, np.asarray(want.params[name]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["sharded-sgd-merge1", "sharded-sgd-merge2",
                                  "sharded-bgd"])
@pytest.mark.parametrize("M,W", CELLS, ids=CELL_IDS)
def test_sharded_tables_are_vmap_bitwise(runs, M, W, name):
    """Sharded sparse SGD and BGD over the mesh: params and loss history
    are the vmap twin's bits."""
    want, got = _pick(runs, M, W, name)
    for g in got:
        assert _bits(g, want)


@pytest.mark.parametrize("M,W", CELLS, ids=CELL_IDS)
def test_checkpoints_inside_blocks_over_the_mesh(runs, M, W):
    """Checkpoints every 2 epochs inside blocks of 4, with sharded tables
    resting between blocks and an evaluation at the end: every rank
    slices its blocks where rank 0 writes, so the run is the twin's and
    the unsliced run's bits, and rank 0 wrote both steps."""
    want, got = _pick(runs, M, W, "device-sharded-ckpt")
    steps = _pick(runs, M, W, "sharded-steps")[1]
    for g, s, r in zip(got, steps, runs[M][1]):
        assert _bits(g, want)
        assert [e for e, _ in g["trace"]] == [3]
        assert _bits(g["params"], r[W]["sharded-sgd-merge2"]["params"])
        assert g["loss"] == r[W]["sharded-sgd-merge2"]["loss"]
        assert s == ["step_0000000002", "step_0000000004"]


@pytest.mark.parametrize("transport", ["dense", "sparse", "sharded"])
@pytest.mark.parametrize("M,W", CELLS, ids=CELL_IDS)
def test_staleness_is_vmap_bitwise(runs, M, W, transport):
    """Bounded staleness S = 2 over the mesh: params and loss history are
    the vmap twin's bits, and every transport gives the dense one's."""
    want, got = _pick(runs, M, W, f"stale-{transport}")
    for i, g in enumerate(got):
        assert _bits(g, want)
        assert _bits(g, runs[M][1][i][W]["stale-dense"])


@pytest.mark.parametrize("what", [
    "sharded-evaluate", "sharded-ranks", "sharded-rank",
    "sharded-tails-k10", "sharded-tails-filtered-k10", "sharded-heads-k10",
    "sharded-tails-k40", "sharded-tails-filtered-k40", "sharded-heads-k40"])
@pytest.mark.parametrize("M,W", CELLS, ids=CELL_IDS)
def test_sharded_evaluation_and_topk_exact(runs, M, W, what):
    """The sharded scan over the mesh: ranks, metrics, top-k ids and
    energies are the vmap engine's, exactly."""
    want, got = _pick(runs, M, W, what)
    for g in got:
        assert _bits(g, want)


@pytest.mark.parametrize("M,W", CELLS, ids=CELL_IDS)
def test_sharded_tables_rest_in_own_blocks(runs, M, W):
    """After a block, each rank holds exactly its workers' row blocks of
    the entity table (the twin's rows there, bitwise) and the whole
    relation table: its entity bytes are 1/M of the table's."""
    want, got = _own(runs, M, W, "resting")
    E = want["rest"]["ent"].shape[0]
    for rank, g in enumerate(got):
        lo, hi = g["rows"]
        assert (lo, hi) == (rank * E // M, (rank + 1) * E // M)
        assert _bits(g["rest"]["ent"], want["rest"]["ent"][lo:hi])
        assert _bits(g["rest"]["rel"], want["rest"]["rel"])
        assert g["bytes"] == (want["bytes"]
                              - want["rest"]["ent"].nbytes * (M - 1) // M)


@pytest.mark.parametrize("layout", ["replicated", "sharded"])
@pytest.mark.parametrize("M,W", CELLS, ids=CELL_IDS)
def test_live_server_over_the_mesh(runs, M, W, layout):
    """A ``KGServer`` over the mesh: rank 0's answers to waves of 1, 3 and
    4 requests, filtered and unfiltered, are the single-device engine's
    and the twin server's bits; the repeated wave comes from the cache
    with the same bits; after a swap (every rank handing in the new
    artifact) a wave is the new artifact's, fresh; no steady-state
    recompile; every rank stops."""
    want, got = _own(runs, M, W, f"server-{layout}")
    lead = got[0]
    assert not lead.get("follower")
    assert lead["steady"] == 0 and want["steady"] == 0
    assert (lead["swaps"], lead["invalidations"]) == (1, 1)
    for wave, twin_wave in zip(lead["waves"], want["waves"]):
        assert _bits(wave["ids"], wave["ref"][0])
        assert _bits(wave["energies"], wave["ref"][1])
        assert set(wave["fingerprints"]) == {wave["ref"][2]}
        assert _bits(wave, twin_wave)
    swapped = lead["waves"][-1]
    assert swapped["ref"][2] != lead["waves"][0]["ref"][2]
    assert swapped["cached"] == [False] * 3
    first, cached = lead["waves"][0], lead["waves"][-2]
    assert cached["cached"] == [True] and first["cached"] == [False]
    assert _bits(cached["ids"], first["ids"])
    assert _bits(cached["energies"], first["energies"])
    assert all(g["stopped"] for g in got)
    assert all(g["follower"] for g in got[1:])


@pytest.mark.parametrize("M", [m for m in MESHES if m > 1])
def test_live_server_faults_over_the_mesh(runs, M):
    """With the command group's timeout cut short: followers that call
    ``stop()`` at once wait past that timeout (rank 0's heartbeats keep
    them) and stop cleanly with rank 0, whose wave is the engine's bits;
    a follower handed the wrong artifact on a swap makes rank 0's swap
    raise with that follower's error, rank 0 then refuses requests, every
    follower's ``stop()`` raises, and every rank's thread and command
    group end."""
    got = [r[("rank", M)]["server-faults"] for r in runs[M][1]]
    lead = got[0]
    for name in ("long-ids", "long-energies"):
        served, want = lead[name]
        assert _bits(served, want)
    assert all(g["long-stop"] is None for g in got)
    assert "rank 1: RuntimeError" in lead["swap"]
    assert "fingerprint" in lead["swap"]
    assert sum(f"rank {r}:" in lead["swap"] for r in range(M)) == 1
    assert "stopped" in lead["after"]
    assert lead["swap-stop"] is None
    for g in got[1:]:
        assert "KGServer over the mesh failed" in g["swap-stop"]
    for g in got:
        for key in ("long-stop", "swap-stop"):
            assert not g[key + "-thread"] and g[key + "-channel"]


def test_replayed_stale_sharded_matches_reference(runs):
    """M = 2 ranks, stale sparse + sharded SGD on the reference's replayed
    device draws and refresh phases, against its vmap ``fit`` at the
    reference's rtol 1e-4 / atol 1e-5."""
    want = runs["reference-stale"]
    for r in runs[2][1]:
        got = r[2]["replay-stale"]
        np.testing.assert_allclose(got["loss"], want.loss_history, **TOL)
        for name, t in got["params"].items():
            np.testing.assert_allclose(t, np.asarray(want.params[name]),
                                       **TOL)


@pytest.mark.filterwarnings("ignore:batch_size=8 does not divide")
def test_mesh_checks(tmp_path):
    """In one process, a one-rank mesh: a mesh of the wrong device type,
    a mesh that is no DeviceMesh, a missing one and a CUDA mesh without a
    card all raise; a fit over the mesh gives the vmap bits, and a live
    server over it answers a wave as the artifact's engine does."""
    graph = port_kg_lib.synthetic_kg(0, n_entities=60, n_relations=3,
                                     n_triplets=400)
    kw = dict(dim=4, batch_size=8, n_workers=2, epochs=1)
    with rank_worker.single_rank_mesh(tmp_path) as mesh:
        with pytest.raises(ValueError, match="device type"):
            port_kg.fit(graph, device="cuda", backend="shard_map",
                        mesh=mesh, **kw)
        with pytest.raises(TypeError, match="DeviceMesh"):
            par.check_mesh(object())
        with pytest.raises(ValueError, match="needs a mesh"):
            port_kg.fit(graph, device="cpu", backend="shard_map", **kw)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                par.workers_mesh(1, "cuda")
        # a one-rank mesh gives the vmap bits in process too
        a = port_kg.fit(graph, device="cpu", backend="shard_map", mesh=mesh,
                        **kw)
        b = port_kg.fit(graph, device="cpu", **kw)
        for name in a.params:
            assert torch.equal(a.params[name], b.params[name])
        assert torch.signbit(par.all_gather(torch.tensor([-0.0]), mesh))
        # a live server over the one-rank mesh answers a wave as the
        # artifact's engine does
        server = KGServer(a.kb, backend="shard_map", mesh=mesh,
                          n_workers=2, max_batch=4)
        try:
            h, r = graph.test[:3, 0], graph.test[:3, 1]
            server.pause()
            futs = [server.submit("tails", hh, rr) for hh, rr in zip(h, r)]
            server.resume()
            answers = [f.result(timeout=60) for f in futs]
            want = a.kb.query_tails(h, r, k=10)
            assert np.array_equal(np.stack([x.ids for x in answers]),
                                  want.ids)
            assert np.stack([x.energies for x in answers]).tobytes() == (
                want.energies.tobytes())
        finally:
            server.stop()
    with pytest.raises(RuntimeError, match="process group"):
        par.workers_mesh(1, "cpu")
