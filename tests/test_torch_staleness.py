"""Bounded staleness (``staleness=S > 0``: SGD on the device pipeline,
vmap backend, either transport) in the port, against the reference and
between the port's own runs.

Against the reference (both on the CPU): each stale ``core/merge.py``
function on the same numpy inputs — selection strategies exactly, the
averaging ones at rtol/atol 1e-6 (the port sums over workers in worker
order, ``jnp.sum`` in its own); and whole ``fit(pipeline="device",
staleness=S)`` runs on the reference's replayed draws and refresh phases
(``stale_offsets``) at rtol/atol 1e-5, the device pipeline's tolerance
(``test_torch_pipeline_device.py``).

Between the port's own runs: bitwise (the reference's
``tests/test_async_schedule.py`` contracts, vmap cells).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kg as ref_kg
from repro.core import mapreduce as ref_mr
from repro.core import merge as ref_merge
from repro.core.models import get_model as ref_get_model
from repro.data import kg as ref_kg_lib
from repro_torch import kg as port_kg
from repro_torch.core import keys, mapreduce, merge
from repro_torch.core.models import get_model
from repro_torch.data import kg as port_kg_lib

from test_torch_parity_helpers import TINY_KG, port_graph
from test_torch_pipeline_device import replay_device_draws

pytestmark = pytest.mark.filterwarnings(
    "ignore:batch_size=.* does not divide")

TOL = dict(rtol=1e-5, atol=1e-5)
MERGE_TOL = dict(rtol=1e-6, atol=1e-6)
STRATEGIES = list(merge.STRATEGIES)
W = 2


@pytest.fixture(scope="module")
def graphs():
    ref = ref_kg_lib.synthetic_kg(0, **TINY_KG)
    return ref, port_graph(ref)


def _fit(graph, *, epochs=8, **kw):
    """The reference test file's defaults: the device pipeline, 2 workers,
    blocks of 4 epochs, a Reduce every 2."""
    defaults = dict(pipeline="device", n_workers=W, dim=8,
                    learning_rate=0.05, batch_size=64, seed=0,
                    block_epochs=4, merge_every=2, device="cpu")
    defaults.update(kw)
    return port_kg.fit(graph, epochs=epochs, **defaults)


def _identical(a, b) -> bool:
    return a.loss_history == b.loss_history and all(
        torch.equal(a.params[n], b.params[n]) for n in a.params)


def _assert_identical(a, b):
    assert a.loss_history == b.loss_history
    assert set(a.params) == set(b.params)
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name


# ---------------------------------------------------------------------------
# The stale merges against the reference's, on the same numpy inputs
# ---------------------------------------------------------------------------

def _stale_inputs(seed=0, Wn=3, N=40, k=6):
    """Worker copies, this-round counts (some rows touched by nobody, some
    by one worker), losses, worker losses, the global view."""
    rng = np.random.default_rng(seed)
    stacked = rng.normal(size=(Wn, N, k)).astype(np.float32)
    counts = rng.integers(0, 3, size=(Wn, N)).astype(np.float32)
    counts[:, :5] = 0                         # rows nobody touched
    counts[1:, 5:10] = 0                      # rows one worker touched
    losses = (rng.random((Wn, N)) * counts).astype(np.float32)
    worker_loss = rng.random(Wn).astype(np.float32)
    base = rng.normal(size=(N, k)).astype(np.float32)
    return stacked, counts, losses, worker_loss, base


def _ref_priorities(Wn, N):
    key = jax.random.PRNGKey(11)
    return key, np.asarray(ref_merge._random_priorities(key, Wn, N))


def _assert_merged(strategy, got, want):
    """Selections are exact; the averages differ in summation order only."""
    got, want = np.asarray(got), np.asarray(want)
    if strategy in ("average", "average_all"):
        np.testing.assert_allclose(got, want, **MERGE_TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_merge_stacked_stale_matches_reference(strategy):
    stacked, counts, losses, wl, base = _stale_inputs()
    key, pri = _ref_priorities(*counts.shape)
    want = ref_merge.merge_stacked_stale(
        strategy, jnp.asarray(stacked), jnp.asarray(counts),
        jnp.asarray(losses), jnp.asarray(wl), jnp.asarray(base), key)
    got = merge.merge_stacked_stale(
        strategy, torch.from_numpy(stacked), torch.from_numpy(counts),
        torch.from_numpy(losses), torch.from_numpy(wl),
        torch.from_numpy(base), torch.from_numpy(pri))
    _assert_merged(strategy, got, want)
    # rows nobody touched keep the global view exactly
    np.testing.assert_array_equal(got.numpy()[:5], base[:5])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_merge_sparse_stale_matches_reference(strategy):
    stacked, counts, losses, wl, base = _stale_inputs(seed=1)
    Wn, N = counts.shape
    key, pri = _ref_priorities(Wn, N)
    cap = int((counts > 0).sum(1).max())
    ridx, rvals, rcnt, rlss = jax.vmap(
        lambda t, c, l: ref_merge.pack_delta(t, c, l, cap, N))(
            jnp.asarray(stacked), jnp.asarray(counts), jnp.asarray(losses))
    want = ref_merge.merge_sparse_stale(
        strategy, ridx, rvals, rcnt, rlss, jnp.asarray(wl),
        jnp.asarray(base), key)
    idx, vals, cnt, lss = merge.pack_delta(
        torch.from_numpy(stacked), torch.from_numpy(counts),
        torch.from_numpy(losses), cap, N)
    got = merge.merge_sparse_stale(
        strategy, idx, vals, cnt, lss, torch.from_numpy(wl),
        torch.from_numpy(base), torch.from_numpy(pri))
    _assert_merged(strategy, got, want)
    # and the port's sparse form is its dense form, bitwise
    dense = merge.merge_stacked_stale(
        strategy, torch.from_numpy(stacked), torch.from_numpy(counts),
        torch.from_numpy(losses), torch.from_numpy(wl),
        torch.from_numpy(base), torch.from_numpy(pri))
    assert torch.equal(got, dense)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_merge_candidates_stale_matches_reference(strategy):
    """On a candidate subset with a pad id: the per-row math, the global
    view at untouched candidates, ``random`` gathering its columns."""
    stacked, counts, losses, wl, base = _stale_inputs(seed=2)
    Wn, N = counts.shape
    key, pri = _ref_priorities(Wn, N)
    cand = np.array([0, 3, 7, 8, 20, 33, N], np.int64)
    c = np.minimum(cand, N - 1)
    live = (cand < N)
    sv = stacked[:, c] * live[None, :, None]
    sc = counts[:, c] * live[None]
    sl = losses[:, c] * live[None]
    bc = base[c] * live[:, None]
    want = ref_merge.merge_candidates_stale(
        strategy, jnp.asarray(cand, jnp.int32), jnp.asarray(sv),
        jnp.asarray(sc), jnp.asarray(sl), jnp.asarray(wl), jnp.asarray(bc),
        N, key)
    got = merge.merge_candidates_stale(
        strategy, torch.from_numpy(cand), torch.from_numpy(sv),
        torch.from_numpy(sc), torch.from_numpy(sl), torch.from_numpy(wl),
        torch.from_numpy(bc), N, torch.from_numpy(pri))
    _assert_merged(strategy, got, want)


def test_stale_merges_need_their_inputs():
    stacked, counts, losses, wl, base = _stale_inputs()
    t = [torch.from_numpy(x) for x in (stacked, counts, losses, wl, base)]
    with pytest.raises(ValueError, match="priorities"):
        merge.merge_stacked_stale("random", *t)
    with pytest.raises(ValueError, match="losses"):
        merge.merge_stacked_stale("miniloss_perkey", t[0], t[1], None,
                                  t[3], t[4])
    with pytest.raises(ValueError, match="unknown strategy"):
        merge.merge_stacked_stale("median", *t)


# ---------------------------------------------------------------------------
# Whole stale runs against the reference, on its replayed draws and phases
# ---------------------------------------------------------------------------

def ref_stale_offsets(seed: int, n_workers: int, staleness: int) -> list:
    """The reference's refresh phases ``o_w``: ``randint(fold_in(k_stale,
    w), (), 0, S + 1)`` of ``_device_keys``' fifth key."""
    k_stale = ref_mr._device_keys(seed)[4]
    return [int(jax.random.randint(jax.random.fold_in(k_stale, w), (), 0,
                                   staleness + 1))
            for w in range(n_workers)]


# (options) of the parity cells: S = 1 and 2, both transports, three
# strategies, one and two local epochs a round
CELLS = {
    "s1-average-dense": dict(staleness=1, merge_every=1),
    "s2-average-sparse-merge2": dict(staleness=2, merge_transport="sparse"),
    "s1-random-sparse": dict(staleness=1, strategy="random", merge_every=1,
                             merge_transport="sparse"),
    "s2-random-dense-merge2": dict(staleness=2, strategy="random"),
    "s1-miniloss_perkey-merge2": dict(staleness=1,
                                      strategy="miniloss_perkey"),
    "s2-miniloss_perkey-sparse": dict(staleness=2, merge_every=1,
                                      strategy="miniloss_perkey",
                                      merge_transport="sparse"),
}
KW = dict(dim=8, batch_size=64, n_workers=W, learning_rate=0.05,
          pipeline="device", block_epochs=4, merge_every=2)
EPOCHS = 8


@pytest.mark.parametrize("name", sorted(CELLS))
def test_stale_run_matches_reference(graphs, name):
    ref_graph, graph = graphs
    kw = dict(KW, **CELLS[name])
    kcfg, mcfg = ref_kg.make_configs(ref_graph, "transe", "sgd", **kw)
    init = ref_get_model("transe").init_params(jax.random.PRNGKey(1), kcfg)
    tables = {n: np.asarray(t) for n, t in init.items()}
    want = ref_kg.fit(ref_graph, "transe", "sgd", epochs=EPOCHS, seed=0,
                      params=init, **kw)
    draws = replay_device_draws(ref_graph, kcfg, mcfg, tables, 0, EPOCHS)
    offsets = ref_stale_offsets(0, W, mcfg.staleness)
    got = port_kg.fit(graph, "transe", "sgd", epochs=EPOCHS, seed=0,
                      params=tables, device="cpu",
                      draws=lambda e: draws[e], stale_offsets=offsets, **kw)
    np.testing.assert_allclose(got.loss_history, want.loss_history, **TOL)
    for n in want.params:
        np.testing.assert_allclose(got.params[n].numpy(),
                                   np.asarray(want.params[n]), **TOL)


def test_replayed_offsets_change_the_run(graphs):
    """The injected phases are what the run uses: the reference's differ
    from the port's own at this seed, and so do the runs."""
    _, graph = graphs
    own = keys.stale_offsets(keys.stale_key(0), 4, 3).tolist()
    theirs = ref_stale_offsets(0, 4, 3)
    assert own != theirs
    a = _fit(graph, staleness=3, n_workers=4, batch_size=32)
    b = _fit(graph, staleness=3, n_workers=4, batch_size=32,
             stale_offsets=theirs)
    c = _fit(graph, staleness=3, n_workers=4, batch_size=32,
             stale_offsets=own)
    assert not _identical(a, b)
    _assert_identical(a, c)


@pytest.mark.parametrize("bad", [dict(stale_offsets=[0, 2]),
                                 dict(stale_offsets=[0, -1]),
                                 dict(stale_offsets=[0, 1, 1]),
                                 dict(stale_offsets=[0, 0], staleness=0)])
def test_injected_offsets_are_checked(graphs, bad):
    _, graph = graphs
    kw = dict(dict(staleness=1), **bad)
    with pytest.raises(ValueError, match="stale_offsets"):
        _fit(graph, epochs=2, **kw)


# ---------------------------------------------------------------------------
# The port's own refresh phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 2**40 + 3])
@pytest.mark.parametrize("S", [1, 2, 5])
def test_offsets_are_in_range_and_pure(seed, S):
    """``o_w`` lies in ``[0, S]`` and is a pure function of (seed, w):
    the same with more workers, on every call."""
    k = keys.stale_key(seed)
    a = keys.stale_offsets(k, 64, S)
    assert a.dtype == torch.int64 and a.shape == (64,)
    assert int(a.min()) >= 0 and int(a.max()) <= S
    assert torch.equal(keys.stale_offsets(k, 8, S), a[:8])
    assert torch.equal(keys.stale_offsets(keys.stale_key(seed), 64, S), a)
    assert len(set(a.tolist())) == S + 1       # every phase occurs


def test_stale_key_leaves_the_other_streams_alone():
    k = keys.stale_key(0)
    assert k not in keys.device_keys(0)
    assert keys.stale_key(1) != k


# ---------------------------------------------------------------------------
# Between the port's own runs: the reference's contracts, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport", ["dense", "sparse"])
def test_staleness_zero_is_sync(graphs, transport):
    _, graph = graphs
    _assert_identical(_fit(graph, merge_transport=transport),
                      _fit(graph, merge_transport=transport, staleness=0))


def test_staleness_changes_trajectory_and_learns(graphs):
    _, graph = graphs
    sync = _fit(graph, staleness=0)
    stale = _fit(graph, staleness=1)
    assert not _identical(sync, stale)
    assert stale.loss_history[-1] < stale.loss_history[0]


def test_staleness_deterministic(graphs):
    _, graph = graphs
    r1 = _fit(graph, staleness=2)
    _assert_identical(r1, _fit(graph, staleness=2))
    assert not _identical(r1, _fit(graph, staleness=2, seed=1))


@pytest.mark.parametrize("transport", ["dense", "sparse"])
def test_staleness_block_invariance(graphs, transport):
    """The locals survive block boundaries and the gate reads the absolute
    round, so the block split changes no bit."""
    _, graph = graphs
    kw = dict(staleness=1, merge_transport=transport)
    r2 = _fit(graph, block_epochs=2, **kw)
    _assert_identical(r2, _fit(graph, block_epochs=4, **kw))
    _assert_identical(r2, _fit(graph, block_epochs=8, **kw))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_stale_sparse_matches_dense(graphs, strategy):
    _, graph = graphs
    _assert_identical(
        _fit(graph, staleness=2, strategy=strategy),
        _fit(graph, staleness=2, strategy=strategy,
             merge_transport="sparse"))


def test_stale_composes_with_repartition(graphs):
    _, graph = graphs
    kw = dict(staleness=1, repartition_every=4)
    r4 = _fit(graph, block_epochs=4, **kw)
    _assert_identical(r4, _fit(graph, block_epochs=2, **kw))
    assert r4.loss_history[-1] < r4.loss_history[0]


def test_stale_eval_reads_the_global_view(graphs):
    """Evaluation slices the blocks and reads the global view: the traced
    run is the untraced run's bits, and its last entry is what a later
    ``evaluate`` of the result gives."""
    _, graph = graphs
    plain = _fit(graph, staleness=1)
    traced = _fit(graph, staleness=1, eval_every=2, block_epochs=8)
    _assert_identical(plain, traced)
    last = traced.trace.entries[-1]
    assert last.metrics == port_kg.evaluate(traced.kb, engine="device")


def test_staleness_validation():
    with pytest.raises(ValueError, match="staleness must be >= 0"):
        mapreduce.MapReduceConfig(staleness=-1)
    with pytest.raises(ValueError, match="pipeline='device'"):
        mapreduce.MapReduceConfig(staleness=1, pipeline="host")
    with pytest.raises(ValueError, match="pipeline='device'"):
        mapreduce.MapReduceConfig(staleness=1, paradigm="bgd",
                                  pipeline="device")


def test_staleness_rejects_checkpointing(graphs, tmp_path):
    _, graph = graphs
    with pytest.raises(ValueError, match="cannot checkpoint or resume"):
        _fit(graph, staleness=1, ckpt_dir=str(tmp_path),
             checkpoint_every=4, sync_checkpoints=True)
    with pytest.raises(ValueError, match="cannot checkpoint or resume"):
        mapreduce.train(graph, *port_kg.make_configs(
            graph, "transe", "sgd", **dict(KW, staleness=1)),
            epochs=4, start_epoch=2, device="cpu")


def test_joint_composes_with_staleness(graphs):
    _, graph = graphs
    res = _fit(graph, negatives="joint", staleness=1)
    assert res.loss_history[-1] < res.loss_history[0]


def test_stale_block_takes_the_dicts_it_is_given(graphs):
    """``make_block_fn(donate=True)`` on the stale state ``(global_view,
    worker_locals)`` empties both dicts it is given, and gives the bits of
    the undonated block; the caller's tensors stay unwritten."""
    _, graph = graphs
    kcfg, mcfg = port_kg.make_configs(graph, "transe", "sgd",
                                      **dict(KW, staleness=1))
    part = torch.as_tensor(port_kg_lib.partition_balanced(0, graph.train, W))
    g0 = get_model("transe").init_params(torch.Generator().manual_seed(0),
                                         kcfg, device="cpu")
    l0 = mapreduce._broadcast(g0, W)
    keep = {n: t.clone() for n, t in g0.items()}
    out = {}
    for donate in (True, False):
        g, loc = dict(g0), dict(l0)
        (gn, ln), losses = mapreduce.make_block_fn(
            mcfg, kcfg, part, donate=donate)((g, loc), range(4))
        assert (not g and not loc) if donate else (g and loc)
        assert set(gn) == set(ln) == set(g0)
        assert ln["ent"].shape == (W,) + g0["ent"].shape
        out[donate] = (gn, ln, losses)
    for a, b in zip(out[True][:2], out[False][:2]):
        for n in a:
            assert torch.equal(a[n], b[n])
    assert torch.equal(out[True][2], out[False][2])
    for n, t in keep.items():
        assert torch.equal(g0[n], t)
