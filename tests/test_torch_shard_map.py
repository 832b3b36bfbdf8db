"""The ``shard_map`` backend of the port over ``torch.distributed``: gloo
ranks on the CPU against the ``vmap`` backend, mirroring the reference's
``tests/helpers/multiworker_check.py`` (the engine's SGD and BGD
Reduces, the device pipeline, the device evaluation, re-partitioning,
in-loop evaluation, resume and the query engine, the sparse transport),
at its size: ``synthetic_kg(0, 200, 5, 2000)``, dim 8, batch 16.

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
reference's rtol 1e-4 / atol 1e-5.  All ranks give the same bits.  One
cell runs on the reference's replayed draws against the reference's vmap
``fit`` at 1e-5 (the reference's own vmap = shard_map contract).
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

MESHES = (1, 2, 4)
JOIN_S = 240                  # every process's bound
TOL = dict(rtol=1e-4, atol=1e-5)
REPLAY_KW = dict(dim=8, batch_size=16, learning_rate=0.05, n_workers=2,
                 strategy="average", reduce_impl="allgather")
REPLAY_EPOCHS = 2
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_torch_rank_worker.py")


def _replay_cell():
    """The reference's graph, init tables, replayed draws and vmap fit."""
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
    spec = {"graph": (graph.n_entities, graph.n_relations, graph.train,
                      graph.valid, graph.test),
            "tables": tables,
            "draws": replay_draws(graph, kcfg, mcfg, tables, 0,
                                  REPLAY_EPOCHS),
            "kw": dict(REPLAY_KW, epochs=REPLAY_EPOCHS, seed=0)}
    return spec, want


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
    out["reference"] = want
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


@pytest.mark.filterwarnings("ignore:batch_size=8 does not divide")
def test_mesh_checks(tmp_path):
    """In one process, a one-rank mesh: a mesh of the wrong device type,
    a mesh that is no DeviceMesh, a missing one and a CUDA mesh without a
    card all raise."""
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
        # a live server over a mesh is item 12d
        with pytest.raises(NotImplementedError, match="item 12d"):
            KGServer(a.kb, backend="shard_map", mesh=mesh)
    with pytest.raises(RuntimeError, match="process group"):
        par.workers_mesh(1, "cpu")
