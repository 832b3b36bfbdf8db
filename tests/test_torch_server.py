"""The port's live serving tier (``repro_torch.serve.server.KGServer``).

Its determinism contract is the reference's (``tests/test_kg_server.py``,
mirrored here test for test): a served answer is **bit-identical** to
calling the bound artifact's ``KGQueryEngine`` directly with the same
query — whatever wave the batcher formed around it, whichever
power-of-two bucket padded it, whether it came from the LRU answer cache
or a fresh wave, and on whichever side of a ``swap()`` it was admitted.
After ``warmup()`` a mixed-size stream meets no new shape
(``steady_recompiles == 0``, counted against the engine's shape registry);
a swap that changes the artifact's fingerprint invalidates the answer
cache, one that doesn't keeps it.

The reference's two fallback tests (``test_cache_size_fallback_is_narrow``,
``test_registry_fallback_warns_once_and_still_counts``) have no
counterpart: the port's counter of warm shapes is the engine's own
registry and cannot be missing, so there is no fallback to test.  The
registry's part of the second one — a never-warmed shape counts as a
steady-state recompile — is ``test_novel_shape_counts_as_steady_recompile``.

The cross-package cells build the reference's ``KGServer`` and the port's
over the same artifact, feed both the same scripted waves (``pause`` /
``resume``), and hold ids equal, energies within the engine's 1e-6 and
the servers' counters equal.

Every wait is bounded (``result(timeout=30)``, ``drain(timeout=30)``,
``stop()`` in a ``finally``), and no test sleeps to compose a wave, so a
hung batcher fails one test instead of running the suite into its clock.
The ``cuda`` test runs on a card only (``-m cuda --noconftest``: it needs
neither jax nor the conftest).
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.models import KGConfig, get_model
from repro_torch.data import kg as port_kg_lib
from repro_torch.kb import KnowledgeBase
from repro_torch.serve import KGServer, ServedAnswer, ServerStats
from repro_torch.serve import kg_engine

DIM = 8
MAX_BATCH = 8
WAIT_US = 5000
TIMEOUT = 30
TOL = dict(rtol=1e-6, atol=1e-6)


def _tables(n_entities: int, n_relations: int, seed: int, device="cpu"):
    return get_model("transe").init_params(
        torch.Generator().manual_seed(seed),
        KGConfig(n_entities, n_relations, dim=DIM), device=device)


def _make_kb(graph, seed: int = 0, device="cpu") -> KnowledgeBase:
    return KnowledgeBase("transe", _tables(graph.n_entities,
                                           graph.n_relations, seed, device),
                         graph=graph, norm="l1")


def _port_graph(graph) -> port_kg_lib.KG:
    return port_kg_lib.KG(graph.n_entities, graph.n_relations,
                          graph.train, graph.valid, graph.test)


@pytest.fixture(scope="module")
def graph(tiny_kg):
    return _port_graph(tiny_kg)


@pytest.fixture(scope="module")
def kb(graph):
    return _make_kb(graph, seed=0)


@pytest.fixture(scope="module")
def uniq(graph):
    """Test-split indices with pairwise-distinct (h, r) — so tests that
    count cache hits/misses never collide on a duplicated query pair."""
    _, first = np.unique(graph.test[:, :2], axis=0, return_index=True)
    return np.sort(first)


@pytest.fixture()
def server(kb):
    srv = KGServer(kb, max_batch=MAX_BATCH, max_wait_us=WAIT_US,
                   default_k=10, warm=True)
    try:
        yield srv
    finally:
        srv.stop()


def _wave(server, kind, a_ids, b_ids, **kw):
    """Submit a batch while admission is paused, then release it — the
    batcher admits exactly this set as one wave (sizes <= max_batch)."""
    server.pause()
    futs = [server.submit(kind, a, b, **kw) for a, b in zip(a_ids, b_ids)]
    server.resume()
    return [f.result(timeout=TIMEOUT) for f in futs]


def _same_bits(ans, ids, energies):
    np.testing.assert_array_equal(ans.ids, ids)
    np.testing.assert_array_equal(ans.energies.view(np.uint32),
                                  np.asarray(energies).view(np.uint32))


# ---------------------------------------------------------------------------
# Answer parity: cache hit/miss, every bucket size, pad slots
# ---------------------------------------------------------------------------

def test_single_query_parity_and_cache(server, kb, graph, uniq):
    eng = kb.engine()
    rows = graph.test[uniq[:4]]
    for h, r, _ in rows:
        ans = server.submit("tails", h, r).result(timeout=TIMEOUT)
        direct = eng.query_tails([h], [r], k=10)
        assert isinstance(ans, ServedAnswer) and not ans.cached
        assert ans.fingerprint == kb.fingerprint()
        _same_bits(ans, direct.ids[0], direct.energies[0])
    before = server.stats()
    for h, r, _ in rows:            # identical queries: all cache hits,
        ans = server.submit("tails", h, r).result(timeout=TIMEOUT)
        direct = eng.query_tails([h], [r], k=10)   # still bit-identical
        assert ans.cached
        _same_bits(ans, direct.ids[0], direct.energies[0])
    after = server.stats()
    assert after.cache_hits - before.cache_hits == len(rows)
    assert after.cache_misses == before.cache_misses
    assert after.waves == before.waves      # hits never reach the batcher


@pytest.mark.parametrize("size", [1, 2, 3, 4, 5, 8])
def test_wave_parity_every_bucket(server, kb, graph, uniq, size):
    """One wave per size: every bucket (1, 2, 4, 8), including partially
    padded ones, answers bit-identically to a direct engine batch."""
    eng = kb.engine()
    rows = graph.test[uniq[10:10 + size]]
    h, r = rows[:, 0], rows[:, 1]
    before = server.stats()
    answers = _wave(server, "tails", h, r, k=7)
    direct = eng.query_tails(h, r, k=7)
    for i, ans in enumerate(answers):
        _same_bits(ans, direct.ids[i], direct.energies[i])
    after = server.stats()
    assert after.waves - before.waves == 1
    bucket = 1 << (size - 1).bit_length() if size > 1 else 1
    assert after.bucket_waves.get(bucket, 0) == \
        before.bucket_waves.get(bucket, 0) + 1


def test_pad_slots_do_not_leak(server, kb, graph, uniq):
    """A wave of 3 rides a bucket of 4; each answer equals the engine's
    answer for a batch of exactly one — pad rows never touch live rows."""
    eng = kb.engine()
    rows = graph.test[uniq[20:23]]
    answers = _wave(server, "tails", rows[:, 0], rows[:, 1], k=6)
    for ans, (h, r, _) in zip(answers, rows):
        direct = eng.query_tails([h], [r], k=6, chunk=1)
        _same_bits(ans, direct.ids[0], direct.energies[0])


def test_heads_and_relations_parity(server, kb, graph, uniq):
    eng = kb.engine()
    rows = graph.test[uniq[25:30]]
    h, r, t = rows[:, 0], rows[:, 1], rows[:, 2]
    heads = _wave(server, "heads", t, r, k=9)
    direct = eng.query_heads(t, r, k=9)
    for i, ans in enumerate(heads):
        _same_bits(ans, direct.ids[i], direct.energies[i])
    rels = _wave(server, "relations", h, t, k=3)
    direct = eng.query_relations(h, t, k=3)
    for i, ans in enumerate(rels):
        _same_bits(ans, direct.ids[i], direct.energies[i])


def test_filtered_and_explicit_exclusion_parity(server, kb, graph, uniq):
    rows = graph.test[uniq[30:34]]
    h, r = rows[:, 0], rows[:, 1]
    answers = _wave(server, "tails", h, r, k=8, filtered=True)
    direct = kb.query_tails(h, r, k=8, filtered=True)
    for i, ans in enumerate(answers):
        _same_bits(ans, direct.ids[i], direct.energies[i])
    # explicit blacklist: excluded ids never appear, answers match the
    # engine given the same padded exclusion row
    eng = kb.engine()
    block = tuple(int(x) for x in direct.ids[0][:3])
    ans = server.submit("tails", h[0], r[0], k=8,
                        exclude=block).result(timeout=TIMEOUT)
    ex = np.array([sorted(block)], np.int32)
    ref = eng.query_tails([h[0]], [r[0]], k=8, exclude=ex)
    _same_bits(ans, ref.ids[0], ref.energies[0])
    assert not set(block) & set(ans.ids.tolist())


def test_answers_are_copies_of_the_cache(server, kb, graph, uniq):
    """A caller who mutates an answer — the fresh one or a cached one —
    cannot corrupt what the cache serves next."""
    h, r, _ = graph.test[uniq[35]]
    direct = kb.engine().query_tails([h], [r], k=10)
    first = server.submit("tails", h, r).result(timeout=TIMEOUT)
    first.ids[:] = -1
    first.energies[:] = 0.0
    hit = server.submit("tails", h, r).result(timeout=TIMEOUT)
    assert hit.cached
    _same_bits(hit, direct.ids[0], direct.energies[0])
    hit.ids[:] = -1
    again = server.submit("tails", h, r).result(timeout=TIMEOUT)
    _same_bits(again, direct.ids[0], direct.energies[0])


# ---------------------------------------------------------------------------
# Bucketing: zero steady-state recompiles across a mixed-size stream
# ---------------------------------------------------------------------------

def test_mixed_stream_zero_steady_recompiles(server, graph, uniq):
    """After warmup, a stream mixing every wave size (and filtered and
    unfiltered exclusion shapes) at the warmed k meets no new shape."""
    idx = 0
    for size in (1, 3, 8, 2, 5, 4, 7, 6, 1, 8):
        rows = graph.test[uniq[idx:idx + size]]
        idx += size
        _wave(server, "tails", rows[:, 0], rows[:, 1],
              filtered=bool(size % 2))
    st = server.stats()
    assert st.steady_recompiles == 0, st
    # (warm_compiles may be 0 here: the shape registry is process-global,
    # so earlier tests can have run every shape warmup targets)


def test_warm_compiles_count_distinct_shapes(kb, monkeypatch):
    """On an empty registry, ``warm_compiles`` is the number of distinct
    shapes warm-up ran — per bucket, tails and heads at the unfiltered
    and the filtered widths plus relations, unless the filtered width is
    the unfiltered one — and a second ``warmup()`` adds none."""
    monkeypatch.setattr(kg_engine, "_SHAPES", set())
    srv = KGServer(kb, max_batch=MAX_BATCH, max_wait_us=WAIT_US,
                   default_k=10, warm=True)
    try:
        width = srv._ex_width(srv._tenants["default"])
        widths = {1, width}
        expected = len(srv.buckets) * (2 * len(widths) + 1)
        st = srv.stats()
        assert st.warm_compiles == expected == kg_engine.shapes_seen()
        assert width > 1 and expected == 20
        assert srv.warmup() == 0
        assert srv.stats().warm_compiles == expected
        # a k that was never warmed is its own set of shapes
        assert srv.warmup(ks=(3,), kinds=("relations",)) == \
            len(srv.buckets)
    finally:
        srv.stop()


def test_novel_shape_counts_as_steady_recompile(kb, graph, uniq,
                                                monkeypatch):
    """The registry catches a genuinely novel steady-state shape: a
    never-warmed k meets a shape the warm-up did not run."""
    monkeypatch.setattr(kg_engine, "_SHAPES", set())
    srv = KGServer(kb, max_batch=4, max_wait_us=WAIT_US, default_k=10,
                   warm=True)
    try:
        h, r, _ = graph.test[uniq[0]]
        srv.submit("tails", h, r).result(timeout=TIMEOUT)
        assert srv.stats().steady_recompiles == 0
        srv.submit("tails", h, r, k=3).result(timeout=TIMEOUT)
        assert srv.stats().steady_recompiles == 1
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Hot swap: drain old, admit new, exactly one artifact per answer
# ---------------------------------------------------------------------------

def test_swap_mid_wave_drains_against_old_artifact(kb, graph, uniq):
    """A swap landing while a wave is in flight: the wave already bound
    the old artifact and answers from it; the next admission sees the
    new one.  Both sides are bit-checked against their own engine."""
    kb2 = _make_kb(graph, seed=1)
    assert kb2.fingerprint() != kb.fingerprint()
    srv = KGServer(kb, max_batch=4, max_wait_us=WAIT_US, default_k=10,
                   warm=True)
    try:
        swapped = threading.Event()

        def mid_wave_swap(kind, size, bucket, tenant, fp):
            if not swapped.is_set():
                swapped.set()
                srv.swap(kb2)       # flips the pointer mid-flight

        srv.on_wave_start = mid_wave_swap
        rows = graph.test[uniq[40:43]]
        h, r = rows[:, 0], rows[:, 1]
        old_wave = _wave(srv, "tails", h, r)
        assert swapped.is_set()
        direct_old = kb.engine().query_tails(h, r, k=10)
        for i, ans in enumerate(old_wave):
            assert ans.fingerprint == kb.fingerprint()
            _same_bits(ans, direct_old.ids[i], direct_old.energies[i])
        # everything admitted after the flip answers from the new KB
        new_ans = srv.submit("tails", h[0], r[0]).result(timeout=TIMEOUT)
        direct_new = kb2.engine().query_tails([h[0]], [r[0]], k=10)
        assert new_ans.fingerprint == kb2.fingerprint()
        assert not new_ans.cached   # old-KB answers were invalidated
        _same_bits(new_ans, direct_new.ids[0], direct_new.energies[0])
    finally:
        srv.on_wave_start = None
        srv.stop()


def test_queued_requests_admit_the_new_artifact(kb, graph, uniq):
    """Requests still queued (not yet admitted) when swap() flips the
    pointer are answered by the NEW artifact — binding happens at
    admission, so no answer ever mixes artifacts."""
    kb2 = _make_kb(graph, seed=2)
    srv = KGServer(kb, max_batch=4, max_wait_us=WAIT_US, default_k=10,
                   warm=True)
    try:
        rows = graph.test[uniq[45:47]]
        srv.pause()
        futs = [srv.submit("tails", h, r) for h, r, _ in rows]
        srv.swap(kb2)
        srv.resume()
        direct = kb2.engine().query_tails(rows[:, 0], rows[:, 1], k=10)
        for i, f in enumerate(futs):
            ans = f.result(timeout=TIMEOUT)
            assert ans.fingerprint == kb2.fingerprint()
            _same_bits(ans, direct.ids[i], direct.energies[i])
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Answer cache vs artifact identity
# ---------------------------------------------------------------------------

def test_swap_with_new_fingerprint_invalidates_cache(kb, graph, uniq):
    """A swap() to a KB whose graph (here: graph AND params) fingerprint
    differs must invalidate the LRU answer cache."""
    other_graph = port_kg_lib.synthetic_kg(
        7, n_entities=graph.n_entities, n_relations=graph.n_relations,
        n_triplets=800)
    kb_other = _make_kb(other_graph, seed=3)
    assert other_graph.fingerprint() != graph.fingerprint()
    assert kb_other.fingerprint() != kb.fingerprint()
    srv = KGServer(kb, max_batch=4, max_wait_us=WAIT_US, default_k=10,
                   warm=True)
    try:
        h, r, _ = graph.test[uniq[50]]
        assert not srv.submit("tails", h, r).result(timeout=TIMEOUT).cached
        assert srv.submit("tails", h, r).result(timeout=TIMEOUT).cached
        srv.swap(kb_other)
        st = srv.stats()
        assert st.swaps == 1 and st.cache_invalidations == 1
        ans = srv.submit("tails", h, r).result(timeout=TIMEOUT)
        assert not ans.cached                        # miss again, new KB
        assert ans.fingerprint == kb_other.fingerprint()
        direct = kb_other.engine().query_tails([h], [r], k=10)
        _same_bits(ans, direct.ids[0], direct.energies[0])
    finally:
        srv.stop()


def test_swap_with_same_fingerprint_keeps_cache(kb, graph, uniq):
    """Identical content => identical fingerprint => the cache survives
    the swap (the keys could never go stale), and the same shapes stay
    warm."""
    twin = KnowledgeBase(kb.model, kb.params, graph=kb.graph, norm=kb.norm)
    assert twin.fingerprint() == kb.fingerprint()
    srv = KGServer(kb, max_batch=4, max_wait_us=WAIT_US, default_k=10,
                   warm=True)
    try:
        h, r, _ = graph.test[uniq[51]]
        assert not srv.submit("tails", h, r).result(timeout=TIMEOUT).cached
        srv.swap(twin)
        st = srv.stats()
        assert st.swaps == 1 and st.cache_invalidations == 0
        assert srv.submit("tails", h, r).result(timeout=TIMEOUT).cached
        assert srv.stats().steady_recompiles == 0
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Multi-KB tenancy, stats, error surface, lifecycle
# ---------------------------------------------------------------------------

def test_multi_tenant_isolation(kb, graph, uniq):
    kb_b = _make_kb(graph, seed=4)
    srv = KGServer(kb, max_batch=4, max_wait_us=WAIT_US, default_k=10,
                   warm=True)
    try:
        srv.add_tenant("b", kb_b)
        assert srv.tenant_kb("b") is kb_b
        assert srv.tenant_fingerprint("b") == kb_b.fingerprint()
        h, r, _ = graph.test[uniq[52]]
        a = srv.submit("tails", h, r).result(timeout=TIMEOUT)
        b = srv.submit("tails", h, r, tenant="b").result(timeout=TIMEOUT)
        assert a.fingerprint == kb.fingerprint()
        assert b.fingerprint == kb_b.fingerprint()
        assert not b.cached     # cache keys are fingerprint-scoped
        want_a = kb.engine().query_tails([h], [r], k=10)
        want_b = kb_b.engine().query_tails([h], [r], k=10)
        _same_bits(a, want_a.ids[0], want_a.energies[0])
        _same_bits(b, want_b.ids[0], want_b.energies[0])
    finally:
        srv.stop()


def test_stats_and_error_surface(kb, graph, uniq):
    srv = KGServer(kb, max_batch=4, max_wait_us=WAIT_US, default_k=10,
                   slo_p99_ms=60_000.0)
    try:
        with pytest.raises(ValueError, match="kind"):
            srv.submit("tail", 0, 0)
        with pytest.raises(ValueError, match="exclusion"):
            srv.submit("relations", 0, 0, filtered=True)
        with pytest.raises(KeyError, match="tenant"):
            srv.submit("tails", 0, 0, tenant="nope")
        h, r, _ = graph.test[uniq[53]]
        srv.query_tails(h, r)
        st = srv.stats()
        assert isinstance(st, ServerStats)
        assert st.completed == st.requests == 1
        assert st.p50_ms <= st.p99_ms
        assert st.slo_met is True   # a minute of headroom on one query
    finally:
        srv.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit("tails", 0, 0)
    with pytest.raises(ValueError, match="KnowledgeBase"):
        KGServer()
    with pytest.raises(ValueError, match="max_batch"):
        KGServer(kb, max_batch=0)


def test_recompile_counter_reports_live_source(server):
    """stats() names the counter steady_recompiles was measured against:
    the engine's shape registry, the only one the port has."""
    assert server.stats().recompile_counter == "engine-shapes"


def test_filtered_needs_graph(kb):
    bare = KnowledgeBase(kb.model, kb.params, graph=None, norm=kb.norm)
    srv = KGServer(bare, max_batch=2, max_wait_us=WAIT_US)
    try:
        with pytest.raises(ValueError, match="graph"):
            srv.submit("tails", 0, 0, filtered=True)
        srv.submit("tails", 0, 0).result(timeout=TIMEOUT)   # no graph
    finally:
        srv.stop()


def test_wave_errors_reach_the_futures(kb, graph, uniq, monkeypatch):
    """An exception inside a wave (on the card: a CUDA error) is set on
    every future of the wave, and the server keeps serving."""
    srv = KGServer(kb, max_batch=4, max_wait_us=WAIT_US, default_k=10)
    try:
        eng = srv._tenants["default"].engine

        def broken(*args, **kw):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(eng, "query_tails", broken)
        rows = graph.test[uniq[54:57]]
        srv.pause()
        futs = [srv.submit("tails", h, r) for h, r, _ in rows]
        srv.resume()
        for f in futs:
            with pytest.raises(RuntimeError, match="illegal memory"):
                f.result(timeout=TIMEOUT)
        monkeypatch.undo()
        h, r, _ = rows[0]
        ans = srv.submit("tails", h, r).result(timeout=TIMEOUT)
        want = kb.engine().query_tails([h], [r], k=10)
        _same_bits(ans, want.ids[0], want.energies[0])
        st = srv.stats()
        assert st.completed == 1 and st.requests == 4
    finally:
        srv.stop()


def test_drain_and_stop_without_drain(kb, graph, uniq):
    srv = KGServer(kb, max_batch=4, max_wait_us=WAIT_US, default_k=10)
    try:
        rows = graph.test[uniq[60:63]]
        srv.pause()
        futs = [srv.submit("heads", t, r) for _, r, t in rows]
        assert srv.drain(timeout=0.05) is False     # paused: still queued
        srv.resume()
        assert srv.drain(timeout=TIMEOUT) is True
        assert all(f.done() for f in futs)
        srv.pause()
        late = srv.submit("relations", rows[0, 0], rows[0, 2])
    finally:
        srv.stop(drain=False)
    with pytest.raises(RuntimeError, match="stopped"):
        late.result(timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# The port's server against the reference's, on the same artifact
# ---------------------------------------------------------------------------

CROSS_CELLS = [("tails", "plain"), ("tails", "filtered"),
               ("tails", "exclude"), ("heads", "plain"),
               ("heads", "filtered"), ("heads", "exclude"),
               ("relations", "plain")]
CROSS_SIZES = (1, 2, 3, 4)          # every bucket of max_batch=4, padded
COUNTERS = ("requests", "completed", "cache_hits", "cache_misses", "waves",
            "bucket_waves", "swaps", "cache_invalidations")


@pytest.fixture(scope="module")
def cross_kbs(tiny_kg, graph):
    """(reference KB, port KB) over the same tables and splits, and the
    same pair for a second artifact (the swap target)."""
    import jax.numpy as jnp

    from repro.kb import KnowledgeBase as RefKnowledgeBase

    pairs = []
    for seed in (0, 1):
        tables = _tables(graph.n_entities, graph.n_relations, seed)
        ref = RefKnowledgeBase(
            model="transe", graph=tiny_kg,
            params={n: jnp.asarray(t.numpy()) for n, t in tables.items()})
        port = KnowledgeBase("transe", tables, graph=graph)
        assert ref.fingerprint() == port.fingerprint()
        pairs.append((ref, port))
    return pairs


@pytest.mark.parametrize("kind,mode", CROSS_CELLS,
                         ids=[f"{k}-{m}" for k, m in CROSS_CELLS])
def test_served_like_the_reference(cross_kbs, graph, uniq, kind, mode):
    """The same scripted waves at every bucket, a cached repeat and a swap
    through both servers: ids equal, energies within 1e-6, counters
    equal."""
    from repro.serve import KGServer as RefKGServer

    (ref_kb, port_kb), (ref_kb2, port_kb2) = cross_kbs
    kw = dict(max_batch=4, max_wait_us=WAIT_US, default_k=10)
    ref_srv, port_srv = RefKGServer(ref_kb, **kw), KGServer(port_kb, **kw)
    try:
        rows = graph.test[uniq[:sum(CROSS_SIZES)]]
        if kind == "tails":
            a, b = rows[:, 0], rows[:, 1]
        elif kind == "heads":
            a, b = rows[:, 2], rows[:, 1]
        else:
            a, b = rows[:, 0], rows[:, 2]

        def opts(i):
            if mode == "filtered":
                return {"filtered": True}
            if mode == "exclude":
                return {"exclude": [(7 * i) % graph.n_entities,
                                    (7 * i + 3) % graph.n_entities, 5]}
            return {}

        def wave(lo, hi, srv):
            srv.pause()
            futs = [srv.submit(kind, a[i], b[i], **opts(i))
                    for i in range(lo, hi)]
            srv.resume()
            return [f.result(timeout=TIMEOUT) for f in futs]

        def same(lo, hi):
            got, want = wave(lo, hi, port_srv), wave(lo, hi, ref_srv)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.ids, w.ids)
                np.testing.assert_allclose(g.energies, w.energies, **TOL)
                assert g.cached == w.cached
                assert g.fingerprint == w.fingerprint

        lo = 0
        for size in CROSS_SIZES:
            same(lo, lo + size)
            lo += size
        same(0, 3)                              # cached repeats
        for srv, new in ((ref_srv, ref_kb2), (port_srv, port_kb2)):
            srv.swap(new)
        same(0, 4)                              # the new artifact
        assert ref_srv.drain(timeout=TIMEOUT)
        assert port_srv.drain(timeout=TIMEOUT)
        ref_st, port_st = ref_srv.stats(), port_srv.stats()
        for name in COUNTERS:
            assert getattr(port_st, name) == getattr(ref_st, name), name
        assert port_st.cache_hits == 3 and port_st.swaps == 1
        assert port_st.cache_invalidations == 1
    finally:
        ref_srv.stop()
        port_srv.stop()


# ---------------------------------------------------------------------------
# On the card: bucket invariance and no steady-state recompile
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_bucket_invariance_on_the_card():
    """The same query answered alone (bucket 1) and in a full wave (bucket
    64), tails, heads and relations, filtered and not: equal ids and
    energies, bit for bit, on CUDA tables; no shape after warm-up is
    new."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tables live on the card")
    graph = port_kg_lib.synthetic_kg(0, n_entities=2000, n_relations=20,
                                     n_triplets=20000)
    kb = _make_kb(graph, seed=0, device="cuda")
    srv = KGServer(kb, max_batch=64, max_wait_us=WAIT_US, default_k=10,
                   warm=True)
    try:
        assert srv._tenants["default"].engine.device.type == "cuda"
        rows = graph.test[:64]
        for kind, cols, kw in (("tails", (0, 1), {}),
                               ("tails", (0, 1), {"filtered": True}),
                               ("heads", (2, 1), {"filtered": True}),
                               ("relations", (0, 2), {})):
            a, b = rows[:, cols[0]], rows[:, cols[1]]
            srv.clear_cache()
            full = _wave(srv, kind, a, b, **kw)
            srv.clear_cache()
            for i in (0, 31, 63):
                alone = _wave(srv, kind, a[i:i + 1], b[i:i + 1], **kw)[0]
                _same_bits(alone, full[i].ids, full[i].energies)
        st = srv.stats()
        assert st.bucket_waves[64] == 4 and st.bucket_waves[1] == 12
        assert st.steady_recompiles == 0, st
    finally:
        srv.stop()
