"""Sharded tables (``table_sharding="sharded"``, sparse transport, vmap
backend) in the port: bitwise the replicated layout across training,
evaluation and serving (the reference's ``tests/test_sharded_tables.py``;
its shard_map cells run over gloo ranks in ``test_torch_shard_map.py``,
and here over a one-rank mesh), and against the reference.

W = 3 shards over 200 entities keep the blocks ragged (67/67/66 and one
pad row), so every cell also runs the padded tail's masking.

Against the reference (both on the CPU): ``shard_rows`` and
``own_candidates`` exactly, ``merge_sparse_sharded_stacked`` at rtol/atol
1e-6 (the averages' worker sums run in another order), whole sharded runs
on the reference's replayed draws at 1e-5, and the sharded evaluation's
ranks and the sharded engine's top-k ids and ranks exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kg as ref_kg
from repro.core import eval_device as ref_eval_device
from repro.core import merge as ref_merge
from repro.core.models import get_model as ref_get_model
from repro.data import kg as ref_kg_lib
from repro.serve.kg_engine import KGQueryEngine as RefEngine
from repro_torch import kg as port_kg
from repro_torch.core import eval_device, merge
from repro_torch.core.models import get_model
from repro_torch.kb import KnowledgeBase
from repro_torch.serve.kg_engine import KGQueryEngine

from test_torch_mapreduce import replay_draws
from test_torch_parity_helpers import port_graph
from test_torch_pipeline_device import replay_device_draws
from test_torch_rank_worker import single_rank_mesh
from test_torch_staleness import ref_stale_offsets

pytestmark = pytest.mark.filterwarnings(
    "ignore:batch_size=.* does not divide")

MODELS = ["transe", "transh", "distmult"]
STRATEGIES = list(merge.STRATEGIES)
W = 3          # does not divide n_entities=200: ragged shard blocks
RUN_TOL = dict(rtol=1e-5, atol=1e-5)
MERGE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def graphs():
    ref = ref_kg_lib.synthetic_kg(0, n_entities=200, n_relations=5,
                                  n_triplets=1200)
    return ref, port_graph(ref)


@pytest.fixture(scope="module")
def masks(graphs):
    tails, heads = graphs[1].eval_filter_candidates()
    return lambda n: (tails[:n], heads[:n])


def _fit(graph, **kw):
    defaults = dict(model="transe", paradigm="sgd", n_workers=W, dim=8,
                    learning_rate=0.05, batch_size=83, seed=0, epochs=3,
                    merge_transport="sparse", device="cpu")
    defaults.update(kw)
    return port_kg.fit(graph, **defaults)


def _assert_identical(a, b):
    assert a.loss_history == b.loss_history
    assert set(a.params) == set(b.params)
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name


def _pair(graph, **kw):
    return (_fit(graph, table_sharding="replicated", **kw),
            _fit(graph, table_sharding="sharded", **kw))


def _tables(graph, model_name, seed=0, dim=8):
    """The reference's init of ``model_name`` as numpy tables, and the
    port's copy of them."""
    kcfg, _ = ref_kg.make_configs(graph, model=model_name, dim=dim)
    init = ref_get_model(model_name).init_params(jax.random.PRNGKey(seed),
                                                 kcfg)
    ref = {n: np.asarray(t) for n, t in init.items()}
    return ref, {n: torch.tensor(t) for n, t in ref.items()}


# ---------------------------------------------------------------------------
# Training: the shard-routed Reduce is the replicated one, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_matches_replicated_host(graphs, strategy):
    _assert_identical(*_pair(graphs[1], strategy=strategy))


def test_sharded_matches_replicated_device(graphs):
    _assert_identical(*_pair(
        graphs[1], pipeline="device", epochs=4, block_epochs=2,
        merge_every=2, strategy="average_all"))


@pytest.mark.parametrize("pipeline", ["host", "device"])
def test_sharded_matches_replicated_bgd(graphs, pipeline):
    kw = dict(paradigm="bgd", pipeline=pipeline)
    if pipeline == "device":
        kw.update(epochs=4, block_epochs=2)
    _assert_identical(*_pair(graphs[1], **kw))


def test_sharded_block_size_invariant(graphs):
    kw = dict(pipeline="device", table_sharding="sharded", epochs=4,
              merge_every=2)
    _assert_identical(_fit(graphs[1], block_epochs=2, **kw),
                      _fit(graphs[1], block_epochs=4, **kw))


def test_sharded_requires_sparse_transport(graphs):
    with pytest.raises(ValueError, match="merge_transport='sparse'"):
        _fit(graphs[1], merge_transport="dense", table_sharding="sharded")


def test_checkpoint_moves_between_layouts(graphs, tmp_path):
    """``table_sharding`` is not in the resume manifest: a checkpoint of
    either layout resumes under the other and reproduces the unbroken
    run."""
    graph = graphs[1]
    kw = dict(pipeline="device", block_epochs=2, checkpoint_every=2)
    ref = _fit(graph, epochs=4, ckpt_dir=str(tmp_path / "ref"), **kw)
    for first, second in (("replicated", "sharded"),
                          ("sharded", "replicated")):
        d = str(tmp_path / f"{first}-to-{second}")
        _fit(graph, epochs=2, table_sharding=first, ckpt_dir=d, **kw)
        res = _fit(graph, epochs=4, table_sharding=second, ckpt_dir=d,
                   resume=True, **kw)
        for k in ref.params:
            assert torch.equal(ref.params[k], res.params[k]), (first, k)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_matrix(graphs, model, strategy):
    _assert_identical(*_pair(
        graphs[1], model=model, strategy=strategy, pipeline="device",
        epochs=4, block_epochs=2, merge_every=2))


@pytest.mark.parametrize("strategy", ["average", "random"])
def test_stale_sharded_matches_stale_replicated(graphs, strategy):
    """The bounded-staleness Reduce routed by shard is the replicated stale
    Reduce, bitwise (the reference's test_stale_sharded_matches_replicated,
    at its configuration)."""
    kw = dict(pipeline="device", n_workers=2, batch_size=64, epochs=8,
              block_epochs=4, merge_every=2, staleness=1, strategy=strategy)
    _assert_identical(*_pair(graphs[1], **kw))


# ---------------------------------------------------------------------------
# core/merge.py's sharded half against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rows,n_shards", [(200, 3), (200, 4), (7, 8),
                                             (1, 1), (14951, 4)])
def test_shard_rows_matches_reference(n_rows, n_shards):
    R = merge.shard_rows(n_rows, n_shards)
    assert R == ref_merge.shard_rows(n_rows, n_shards)
    assert (n_shards - 1) * R < n_rows <= n_shards * R or n_rows < n_shards


@pytest.mark.parametrize("U,block", [(30, 10), (30, 100), (5, 3), (41, 7)])
def test_own_candidates_match_reference(U, block):
    rng = np.random.default_rng(U + block)
    n_rows = 60
    real = np.sort(rng.choice(n_rows, size=U - 1 - U // 4, replace=False))
    cand = np.concatenate([real, np.full(U - len(real), n_rows)])
    for lo in range(0, n_rows + block, block):
        want = np.asarray(ref_merge.own_candidates(
            jnp.asarray(cand, jnp.int32), jnp.int32(lo), block, n_rows))
        got = merge.own_candidates(torch.tensor(cand), lo, block, n_rows)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def deltas():
    """Stacked worker tables and touch stats (rows touched by nobody, by one
    worker, by several; untouched rows at the virgin value), their packed
    buffers, the round input."""
    rng = np.random.default_rng(3)
    Wn, N, K = 3, 40, 6
    stacked = rng.normal(size=(Wn, N, K)).astype(np.float32)
    counts = rng.integers(0, 3, size=(Wn, N)).astype(np.float32)
    counts[:, :6] = 0
    counts[0, 6:10], counts[1:, 6:10] = 2, 0
    losses = (counts * rng.uniform(0.1, 2.0, (Wn, N))).astype(np.float32)
    worker_loss = rng.uniform(0.5, 1.5, (Wn,)).astype(np.float32)
    base = rng.normal(size=(N, K)).astype(np.float32)
    virgin = get_model("transe").normalize_rows("ent", torch.tensor(base))
    stacked = np.where(counts[..., None] > 0, stacked,
                       virgin.numpy()[None])
    return stacked, counts, losses, worker_loss, base


@pytest.mark.parametrize("n_shards", [3, 4])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_merge_sparse_sharded_matches_reference(deltas, strategy, n_shards):
    stacked, counts, losses, worker_loss, base = deltas
    Wn, N = counts.shape
    key = jax.random.PRNGKey(5)
    pri = np.asarray(ref_merge._random_priorities(key, Wn, N))
    ref_fn = functools.partial(ref_get_model("transe").normalize_rows, "ent")
    port_fn = functools.partial(get_model("transe").normalize_rows, "ent")
    idx, vals, cnt, lss = jax.vmap(functools.partial(
        ref_merge.pack_delta, capacity=25, n_rows=N))(
            jnp.asarray(stacked), jnp.asarray(counts), jnp.asarray(losses))
    want = ref_merge.merge_sparse_sharded_stacked(
        strategy, idx, vals, cnt, lss, jnp.asarray(worker_loss),
        jnp.asarray(stacked[0]), jnp.asarray(base), ref_fn, 1, key,
        n_shards=n_shards)
    t = [torch.tensor(np.asarray(a)) for a in (
        idx, vals, cnt, lss, worker_loss, stacked[0], base)]
    got = merge.merge_sparse_sharded_stacked(
        strategy, *t, port_fn, 1, torch.tensor(pri), n_shards=n_shards)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MERGE_TOL)
    # and the port's sharded merge is its monolithic merge, bitwise
    assert torch.equal(got, merge.merge_sparse_stacked(
        strategy, *t, port_fn, 1, torch.tensor(pri)))
    # the stale forms likewise
    stale = merge.merge_sparse_stale_sharded_stacked(
        strategy, *t[:5], t[6], torch.tensor(pri), n_shards=n_shards)
    want_stale = ref_merge.merge_sparse_stale_sharded_stacked(
        strategy, idx, vals, cnt, lss, jnp.asarray(worker_loss),
        jnp.asarray(base), key, n_shards=n_shards)
    np.testing.assert_allclose(stale.numpy(), np.asarray(want_stale),
                               **MERGE_TOL)
    assert torch.equal(stale, merge.merge_sparse_stale(
        strategy, *t[:5], t[6], torch.tensor(pri)))


# ---------------------------------------------------------------------------
# Whole sharded runs against the reference's, on its replayed draws
# ---------------------------------------------------------------------------

RUN_CELLS = {
    # (paradigm, pipeline, options)
    "sgd-host-random": ("sgd", "host", dict(strategy="random")),
    "sgd-device-merge2": ("sgd", "device", dict(merge_every=2, epochs=4,
                                                block_epochs=2)),
    "bgd-host": ("bgd", "host", {}),
    "sgd-device-stale1": ("sgd", "device", dict(
        staleness=1, merge_every=2, epochs=4, block_epochs=4)),
}


@pytest.mark.parametrize("name", sorted(RUN_CELLS))
def test_sharded_run_matches_reference(graphs, name):
    ref_graph, graph = graphs
    paradigm, pipeline, opts = RUN_CELLS[name]
    opts = dict(opts)
    epochs = opts.pop("epochs", 2)
    kw = dict(dim=8, batch_size=83, n_workers=W, learning_rate=0.05,
              pipeline=pipeline, merge_transport="sparse",
              table_sharding="sharded", **opts)
    kcfg, mcfg = ref_kg.make_configs(ref_graph, "transe", paradigm, **kw)
    init = ref_get_model("transe").init_params(jax.random.PRNGKey(1), kcfg)
    tables = {n: np.asarray(t) for n, t in init.items()}
    want = ref_kg.fit(ref_graph, "transe", paradigm, epochs=epochs, seed=0,
                      params=init, **kw)
    replay = replay_device_draws if pipeline == "device" else replay_draws
    draws = replay(ref_graph, kcfg, mcfg, tables, 0, epochs)
    offsets = (ref_stale_offsets(0, W, mcfg.staleness)
               if mcfg.staleness else None)
    got = port_kg.fit(graph, "transe", paradigm, epochs=epochs, seed=0,
                      params=tables, device="cpu", stale_offsets=offsets,
                      draws=lambda e: draws[e], **kw)
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               **RUN_TOL)
    for n in want.params:
        np.testing.assert_allclose(got.params[n].numpy(),
                                   np.asarray(want.params[n]), **RUN_TOL)


# ---------------------------------------------------------------------------
# Evaluation: the shard-local scan, combined exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_name", MODELS)
def test_sharded_eval_ranks_bitwise(graphs, masks, model_name):
    """Raw, filtered and relation ranks of the sharded scan equal the
    replicated scan's and the reference's sharded scan's, exactly."""
    ref_graph, _ = graphs
    ref_p, params = _tables(ref_graph, model_name, seed=1)
    test = ref_graph.test[:48]
    kw = dict(model=model_name, cand_masks=masks(48), n_workers=W,
              relations=True)
    rep = eval_device.entity_ranks_device(params, test, **kw)
    sh = eval_device.entity_ranks_device(params, test,
                                         table_sharding="sharded", **kw)
    ref = ref_eval_device.entity_ranks_device(
        {n: jnp.asarray(t) for n, t in ref_p.items()}, test,
        table_sharding="sharded", **kw)
    for group in ("raw_ranks", "filtered_ranks"):
        for side in ("tail", "head"):
            np.testing.assert_array_equal(rep[group][side], sh[group][side])
            np.testing.assert_array_equal(ref[group][side], sh[group][side])
    np.testing.assert_array_equal(rep["relation_ranks"],
                                  sh["relation_ranks"])


@pytest.mark.parametrize("n_workers", [1, 2, 7])
def test_sharded_eval_chunk_invariant(graphs, masks, n_workers):
    """Neither the chunk size nor the shard count moves a rank."""
    ref_graph, _ = graphs
    _, params = _tables(ref_graph, "transe", seed=1)
    test = ref_graph.test[:32]
    rep = eval_device.entity_ranks_device(params, test, cand_masks=masks(32))
    for c in (8, 64):
        out = eval_device.entity_ranks_device(
            params, test, cand_masks=masks(32), n_workers=n_workers,
            table_sharding="sharded", chunk=c)
        for group in ("raw_ranks", "filtered_ranks"):
            for side in ("tail", "head"):
                np.testing.assert_array_equal(out[group][side],
                                              rep[group][side])


def test_sharded_entity_inference_metrics(graphs, masks):
    """``entity_inference_device`` threads the layout: the sharded metrics
    are the replicated ones and the reference's sharded ones, exactly."""
    ref_graph, _ = graphs
    ref_p, params = _tables(ref_graph, "transh", seed=2)
    test = ref_graph.test[:40]
    kw = dict(model="transh", cand_masks=masks(40), n_workers=W)
    rep = eval_device.entity_inference_device(params, test, **kw)
    sh = eval_device.entity_inference_device(
        params, test, table_sharding="sharded", **kw)
    ref = ref_eval_device.entity_inference_device(
        {n: jnp.asarray(t) for n, t in ref_p.items()}, test,
        table_sharding="sharded", **kw)
    for group in ("raw", "filtered"):
        assert sh[group].row() == rep[group].row() == ref[group].row()


def test_sharded_eval_rejects_fused_and_bad_value(graphs, tmp_path):
    """Refusals: ``fused=True``, a bad layout, a mesh that is no
    ``DeviceMesh``; over a real one-rank mesh the sharded scan gives the
    vmap scan's ranks."""
    _, params = _tables(graphs[0], "transe")
    test = graphs[0].test[:4]
    with pytest.raises(ValueError, match="fused"):
        eval_device.entity_ranks_device(params, test, n_workers=W,
                                        fused=True, table_sharding="sharded")
    with pytest.raises(ValueError, match="table_sharding"):
        eval_device.entity_ranks_device(params, test,
                                        table_sharding="diagonal")
    with pytest.raises(TypeError, match="DeviceMesh"):
        eval_device.entity_ranks_device(params, test, n_workers=W,
                                        backend="shard_map", mesh=object(),
                                        table_sharding="sharded")
    masks = graphs[1].eval_filter_candidates()
    test = graphs[1].test
    want = eval_device.entity_ranks_device(
        params, test, cand_masks=masks, n_workers=W, relations=True,
        table_sharding="sharded")
    with single_rank_mesh(tmp_path) as mesh:
        got = eval_device.entity_ranks_device(
            params, test, cand_masks=masks, n_workers=W, relations=True,
            backend="shard_map", mesh=mesh, table_sharding="sharded")
    for group in ("raw_ranks", "filtered_ranks"):
        for side in ("tail", "head"):
            np.testing.assert_array_equal(got[group][side],
                                          want[group][side])
    np.testing.assert_array_equal(got["relation_ranks"],
                                  want["relation_ranks"])


def test_sharded_eval_picks_the_plain_scan(graphs, monkeypatch):
    """``fused=None`` under sharding takes the slice scan, never the rank
    kernel, even where the kernel would be picked."""
    from repro_torch.kernels import ops

    _, params = _tables(graphs[0], "transe")
    monkeypatch.setattr(ops, "fused_eval_available", lambda *a: True)
    called = []
    monkeypatch.setattr(type(get_model("transe")), "fused_rank_counts",
                        lambda *a, **k: called.append(1))
    eval_device.entity_ranks_device(params, graphs[0].test[:4], n_workers=W,
                                    table_sharding="sharded")
    assert not called


# ---------------------------------------------------------------------------
# Serving: shard-local top-k, combined exactly, ties included
# ---------------------------------------------------------------------------

def _engines(graph, model_name, **kw):
    ref_p, params = _tables(graph, model_name, seed=3)
    return (KGQueryEngine(model_name, params, n_workers=W, **kw),
            KGQueryEngine(model_name, params, n_workers=W,
                          table_sharding="sharded", **kw),
            RefEngine(model_name, {n: jnp.asarray(t)
                                   for n, t in ref_p.items()},
                      n_workers=W, table_sharding="sharded", **kw))


def _assert_query_equal(a, b):
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.energies, b.energies)


@pytest.mark.parametrize("model_name", MODELS)
def test_sharded_topk_bitwise(graphs, model_name):
    """k < R, k > R (the local cut) and k = E: ids and energies equal the
    replicated engine's; ids equal the reference's sharded engine's."""
    rep, sh, ref = _engines(graphs[0], model_name)
    rows = graphs[0].test[:12]
    h, r, t = rows[:, 0], rows[:, 1], rows[:, 2]
    for k in (5, 80, 200):
        got = sh.query_tails(h, r, k=k)
        _assert_query_equal(rep.query_tails(h, r, k=k), got)
        np.testing.assert_array_equal(got.ids, ref.query_tails(h, r, k=k).ids)
        got = sh.query_heads(t, r, k=k)
        _assert_query_equal(rep.query_heads(t, r, k=k), got)
        np.testing.assert_array_equal(got.ids, ref.query_heads(t, r, k=k).ids)
    _assert_query_equal(rep.query_relations(h, t, k=3),
                        sh.query_relations(h, t, k=3))


def test_sharded_topk_with_exclusion(graphs):
    """Exclusions land in their owning shard only; the pad id (E) in
    none."""
    rep, sh, ref = _engines(graphs[0], "transe")
    rows = graphs[0].test[:6]
    h, r = rows[:, 0], rows[:, 1]
    base = rep.query_tails(h, r, k=8)
    ex = np.sort(base.ids[:, :3].astype(np.int32), axis=1)
    ex = np.concatenate([ex, np.full((len(ex), 2), 200, np.int32)], axis=1)
    b = sh.query_tails(h, r, k=8, exclude=ex)
    _assert_query_equal(rep.query_tails(h, r, k=8, exclude=ex), b)
    np.testing.assert_array_equal(b.ids,
                                  ref.query_tails(h, r, k=8, exclude=ex).ids)
    for i in range(len(ex)):
        assert not set(ex[i, :3].tolist()) & set(
            int(x) for x in b.ids[i][np.isfinite(b.energies[i])])


def test_sharded_topk_tie_break_exact():
    """All-zero tables tie every candidate: the shard-major union keeps
    the lowest ids, as the replicated stable sort does."""
    params = {"ent": torch.zeros(200, 8), "rel": torch.zeros(5, 8)}
    rep = KGQueryEngine("transe", params, n_workers=W)
    sh = KGQueryEngine("transe", params, n_workers=W,
                       table_sharding="sharded")
    q = np.zeros(4, np.int32)
    for k in (5, 67, 80, 200):
        got = sh.query_tails(q, q, k=k)
        _assert_query_equal(rep.query_tails(q, q, k=k), got)
        np.testing.assert_array_equal(got.ids[0], np.arange(k))


def test_sharded_rank_and_score_parity(graphs):
    """``rank()`` threads the layout into the eval scan (the reference's
    sharded ranks too); ``score()`` never shards."""
    rep, sh, ref = _engines(graphs[0], "transe")
    rows = graphs[0].test[:16]
    got = sh.rank(rows, "tail")
    np.testing.assert_array_equal(rep.rank(rows, "tail"), got)
    np.testing.assert_array_equal(ref.rank(rows, "tail"), got)
    np.testing.assert_array_equal(
        rep.score(rows[:, 0], rows[:, 1], rows[:, 2]),
        sh.score(rows[:, 0], rows[:, 1], rows[:, 2]))


def test_engine_rejects_bad_sharding_config(graphs, tmp_path):
    """Refusals: a bad layout, ``shard_map`` without a mesh, a mesh that
    is no ``DeviceMesh``, no workers; over a real one-rank mesh the
    sharded engine answers as the vmap one does, bitwise."""
    _, params = _tables(graphs[0], "transe")
    with pytest.raises(ValueError, match="table_sharding"):
        KGQueryEngine("transe", params, n_workers=W, table_sharding="nope")
    with pytest.raises(ValueError, match="mesh"):
        KGQueryEngine("transe", params, n_workers=2, backend="shard_map",
                      table_sharding="sharded")
    with pytest.raises(TypeError, match="DeviceMesh"):
        KGQueryEngine("transe", params, n_workers=2, backend="shard_map",
                      mesh=object(), table_sharding="sharded")
    with pytest.raises(ValueError, match="n_workers"):
        KGQueryEngine("transe", params, n_workers=0,
                      table_sharding="sharded")
    rows = graphs[1].test[:40]
    ex = graphs[1].known_candidate_masks(rows[:, :2], "tail")
    vm = KGQueryEngine("transe", params, n_workers=W,
                       table_sharding="sharded")
    with single_rank_mesh(tmp_path) as mesh:
        sh = KGQueryEngine("transe", params, n_workers=W,
                           backend="shard_map", mesh=mesh,
                           table_sharding="sharded")
        for k in (5, 80):           # 80 > R = 67: whole blocks kept
            got = sh.query_tails(rows[:, 0], rows[:, 1], k=k, exclude=ex)
            want = vm.query_tails(rows[:, 0], rows[:, 1], k=k, exclude=ex)
            np.testing.assert_array_equal(got.ids, want.ids)
            assert got.energies.tobytes() == want.energies.tobytes()
            got = sh.query_heads(rows[:, 2], rows[:, 1], k=k)
            want = vm.query_heads(rows[:, 2], rows[:, 1], k=k)
            np.testing.assert_array_equal(got.ids, want.ids)
            assert got.energies.tobytes() == want.energies.tobytes()


# ---------------------------------------------------------------------------
# End to end: kg.fit, the KnowledgeBase engines, evaluate
# ---------------------------------------------------------------------------

def test_kb_engine_cache_keys_on_sharding(graphs):
    _, params = _tables(graphs[0], "transe")
    kb = KnowledgeBase("transe", params, graph=graphs[1])
    sh = kb.engine(n_workers=W, table_sharding="sharded")
    assert kb.engine(n_workers=W, table_sharding="sharded") is sh
    assert kb.engine(n_workers=W) is not sh
    assert sh.table_sharding == "sharded"


def test_kb_evaluate_sharded_parity(graphs):
    """The three-task protocol through the artifact: the sharded device
    engine's metrics equal the replicated ones, and ``kg.evaluate``
    threads the layout through."""
    _, params = _tables(graphs[0], "transe", seed=4)
    kb = KnowledgeBase("transe", params, graph=graphs[1])
    rep = kb.evaluate(engine="device", n_workers=W)
    assert kb.evaluate(engine="device", n_workers=W,
                       table_sharding="sharded") == rep
    assert port_kg.evaluate(kb, engine="device", n_workers=W,
                            table_sharding="sharded") == rep


def test_fit_threads_sharding_into_result(graphs):
    _, mcfg = port_kg.make_configs(graphs[1], merge_transport="sparse",
                                   table_sharding="sharded")
    assert mcfg.table_sharding == "sharded"
    with pytest.raises(ValueError, match="merge_transport"):
        port_kg.make_configs(graphs[1], table_sharding="sharded")
