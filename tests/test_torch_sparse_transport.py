"""The port's sparse delta transport (``merge_transport="sparse"``): the
compact SGD step, the packed-delta Reduce and sparse BGD, on both
pipelines — the reference's ``tests/test_sparse_transport.py`` test for
test, plus cells against the reference.

Between the port's own runs: **bitwise** (the bits of params and losses,
signed zeros included), sparse against dense, for every strategy, model,
objective, pipeline and normalization cadence.  The reference fails its
own cells of this contract under jax 0.9 on the CPU
(``test_compact_step_bitwise[step-*]``,
``test_async_schedule.py::test_joint_sparse_transport_bitwise``), so the
port proves it between its own two paths.

Against the reference, on the same numpy inputs:
  * each sparse function of ``core/merge.py`` (and ``_compact_batch``,
    ``_bgd_candidate_ids``): ids, counts, slots and overflow exactly;
    floats at rtol/atol 1e-6 (selections pick whole rows and are exact
    too; a virgin row's projection sums in another order in each package);
  * whole sparse runs on the reference's replayed draws
    (``test_torch_mapreduce.replay_draws``,
    ``test_torch_pipeline_device.replay_device_draws``) at rtol/atol 1e-5,
    the tolerance of the dense runs.  Cells whose reference sparse run
    breaks the reference's own contract (the joint objective) are held
    against its dense run.
"""
import functools
import warnings

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
from repro_torch.core import mapreduce
from repro_torch.core import merge as merge_lib
from repro_torch.core.models import get_model
from repro_torch.data import kg as kg_lib

from test_torch_mapreduce import replay_draws
from test_torch_parity_helpers import port_graph
from test_torch_pipeline_device import replay_device_draws

MODELS = ["transe", "transh", "distmult"]
STRATEGIES = list(merge_lib.STRATEGIES)
FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
RUN_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def graphs():
    # 1200 triples split 748 train / 3 workers = 249 per worker; batch 83
    # gives 3 exact steps (no remainder warning)
    ref = ref_kg_lib.synthetic_kg(0, n_entities=200, n_relations=5,
                                  n_triplets=1200)
    return ref, port_graph(ref)


@pytest.fixture(scope="module")
def small_kg(graphs):
    return graphs[1]


DEFAULTS = dict(model="transe", paradigm="sgd", n_workers=3, dim=8,
                learning_rate=0.05, batch_size=83, seed=0, epochs=3)


def _fit(graph, **kw):
    return port_kg.fit(graph, device="cpu", **dict(DEFAULTS, **kw))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _assert_identical(r1, r2):
    """Same loss history and the same bits in every table."""
    assert r1.loss_history == r2.loss_history
    assert set(r1.params) == set(r2.params)
    for k in r1.params:
        assert torch.equal(_bits(r1.params[k]), _bits(r2.params[k])), k


def _pair(graph, **kw):
    return (_fit(graph, merge_transport="dense", **kw),
            _fit(graph, merge_transport="sparse", **kw))


# ---------------------------------------------------------------------------
# Bit-identity, sparse against dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sparse_matches_dense_host(small_kg, strategy):
    """Every merge strategy, host pipeline, W=3 (the averaging strategies'
    untouched rows replay the dense worker mean)."""
    _assert_identical(*_pair(small_kg, strategy=strategy))


@pytest.mark.parametrize("model", MODELS)
def test_sparse_matches_dense_device(small_kg, model):
    """Device pipeline with deferred Reduces (merge_every=2): K local
    epochs of drift between merges, TransH's relation-role ``norm`` table
    included."""
    _assert_identical(*_pair(
        small_kg, model=model, pipeline="device", epochs=4, block_epochs=2,
        merge_every=2, strategy="average_all"))


@pytest.mark.parametrize("normalize", ["step", "none"])
def test_sparse_matches_dense_normalize_modes(small_kg, normalize):
    """The virgin rows depend on the projection's cadence: 'step' chains
    one projection per step, 'none' none."""
    _assert_identical(*_pair(
        small_kg, pipeline="device", epochs=4, block_epochs=2,
        merge_every=2, normalize=normalize))


@pytest.mark.parametrize("pipeline", ["host", "device"])
def test_sparse_matches_dense_bgd(small_kg, pipeline):
    kw = dict(paradigm="bgd", pipeline=pipeline)
    if pipeline == "device":
        kw.update(epochs=4, block_epochs=2)
    _assert_identical(*_pair(small_kg, **kw))


@pytest.mark.parametrize("strategy", ["average", "average_all"])
def test_sparse_matches_dense_batch_remainder(small_kg, strategy):
    """Batch remainder and W=3: steps drop 49 triples per worker, and rows
    no worker touched take the replayed worker mean of
    ``sparse_untouched_base``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _assert_identical(*_pair(small_kg, strategy=strategy,
                                 batch_size=100, epochs=6))


@pytest.mark.parametrize("pipeline,paradigm", [
    ("host", "sgd"), ("device", "sgd"), ("host", "bgd")])
def test_joint_sparse_transport_bitwise(small_kg, pipeline, paradigm):
    """The joint objective: the compact step remaps the pool's ids too,
    and the gold-collision masks survive the remap."""
    kw = dict(negatives="joint", neg_candidates=16, norm="l2",
              paradigm=paradigm, pipeline=pipeline)
    if pipeline == "device":
        kw.update(epochs=4, block_epochs=4, merge_every=2)
    _assert_identical(*_pair(small_kg, **kw))


@pytest.mark.parametrize("pipeline", ["host", "device"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("model", MODELS)
def test_sparse_matrix(small_kg, model, strategy, pipeline):
    """Every model x strategy x pipeline (the reference keeps this matrix
    in its slow suite; here it takes seconds)."""
    kw = dict(model=model, strategy=strategy, pipeline=pipeline)
    if pipeline == "device":
        kw.update(epochs=4, block_epochs=2, merge_every=2)
    _assert_identical(*_pair(small_kg, **kw))


def test_sparse_block_size_invariant(small_kg):
    """Block size cannot matter under the sparse transport either: its
    capacity and virgin-repeat counts are per merge round."""
    kw = dict(pipeline="device", merge_transport="sparse", epochs=4,
              merge_every=2)
    _assert_identical(_fit(small_kg, block_epochs=2, **kw),
                      _fit(small_kg, block_epochs=4, **kw))


@pytest.fixture(scope="module")
def wide_kg():
    """A graph with more rows than a step references (at batch 90, 4B =
    360 < 1,000 entities and 2B = 180 < 200 relations), so the compact
    tables are smaller than the tables and the remap moves every id."""
    return kg_lib.synthetic_kg(0, n_entities=1000, n_relations=200,
                               n_triplets=1200)


@pytest.mark.parametrize("pipeline", ["host", "device"])
@pytest.mark.parametrize("model", MODELS)
def test_sparse_matches_dense_wide(wide_kg, model, pipeline):
    kw = dict(model=model, strategy="average", pipeline=pipeline,
              batch_size=90)
    if pipeline == "device":
        kw.update(epochs=4, block_epochs=4, merge_every=2)
    _assert_identical(*_pair(wide_kg, **kw))


def test_sparse_block_makes_no_dense_step(wide_kg, monkeypatch):
    """Nothing runs the dense transport in place of the sparse one: a
    sparse run never calls the dense Reduce or the dense BGD update, and
    every SGD step's objective sees compact tables."""
    def refuse(*args, **kw):
        raise AssertionError("the dense transport ran")

    rows = []
    model = get_model("transe")
    pairs_and_grads = type(model)._pairs_and_grads

    def spy(self, params, *args, **kw):
        rows.append((params["ent"].shape[-2], params["rel"].shape[-2],
                     kw.get("shared", False)))
        return pairs_and_grads(self, params, *args, **kw)

    monkeypatch.setattr(mapreduce, "_merge_tables_stacked", refuse)
    monkeypatch.setattr(mapreduce, "apply_gradients", refuse)
    monkeypatch.setattr(type(model), "_pairs_and_grads", spy)
    for pipeline in ("host", "device"):
        for paradigm in ("sgd", "bgd"):
            _fit(wide_kg, merge_transport="sparse", pipeline=pipeline,
                 paradigm=paradigm, epochs=2, batch_size=90)
    assert {r for r in rows if not r[2]} == {(4 * 90, 2 * 90, False)}


def test_checkpoint_resume_across_transports(small_kg, tmp_path):
    """``merge_transport`` stays out of the resume manifest: a dense
    checkpoint resumes under the sparse transport (and the other way
    round) and gives the unbroken run's bits."""
    kw = dict(pipeline="device", block_epochs=2, checkpoint_every=2)
    ref = _fit(small_kg, epochs=4, ckpt_dir=str(tmp_path / "ref"), **kw)
    for first, second in (("dense", "sparse"), ("sparse", "dense")):
        d = str(tmp_path / f"{first}-to-{second}")
        _fit(small_kg, epochs=2, merge_transport=first, ckpt_dir=d, **kw)
        res = _fit(small_kg, epochs=4, merge_transport=second, ckpt_dir=d,
                   resume=True, **kw)
        _assert_identical(ref, res)


# ---------------------------------------------------------------------------
# Capacity and overflow: raise, never corrupt silently
# ---------------------------------------------------------------------------

def test_undersized_touched_capacity_raises_at_config_time(small_kg):
    with pytest.raises(ValueError, match="below the analytic bound"):
        _fit(small_kg, merge_transport="sparse", touched_capacity=3)


@pytest.mark.parametrize("option,match", [
    (dict(merge_transport="dense", touched_capacity=100), "sparse"),
    (dict(merge_transport="sparse", touched_capacity=100, paradigm="bgd"),
     "SGD-paradigm"),
    (dict(merge_transport="sparse", touched_capacity=0), ">= 1"),
    (dict(merge_transport="dense", table_sharding="sharded"),
     "needs merge_transport='sparse'"),
])
def test_touched_capacity_must_match_transport(graphs, option, match):
    """The reference's configuration errors, raised by both packages."""
    ref_graph, graph = graphs
    kw = dict(DEFAULTS, epochs=1, **option)
    with pytest.raises(ValueError, match=match):
        ref_kg.fit(ref_graph, **kw)
    with pytest.raises(ValueError, match=match):
        port_kg.fit(graph, device="cpu", **kw)


@pytest.mark.parametrize("pipeline", ["host", "device"])
def test_overflow_raises_at_reduce_boundary(small_kg, pipeline, monkeypatch):
    """If the capacity bound itself regressed (simulated by patching it
    tiny), the device's overflow count surfaces at the next Reduce
    boundary as a RuntimeError instead of training on a corrupt merge."""
    monkeypatch.setattr(merge_lib, "touched_capacity",
                        lambda n_rows, batch, steps, k, role: 2)
    kw = dict(merge_transport="sparse", pipeline=pipeline)
    if pipeline == "device":
        kw.update(epochs=4, block_epochs=2)
    with pytest.raises(RuntimeError, match="delta overflow at epoch "
                       + ("0" if pipeline == "host" else "1")):
        _fit(small_kg, **kw)


def test_generous_touched_capacity_still_bitwise(small_kg):
    """An oversized override packs the same touched rows."""
    dense = _fit(small_kg, merge_transport="dense")
    sparse = _fit(small_kg, merge_transport="sparse",
                  touched_capacity=small_kg.n_entities)
    _assert_identical(dense, sparse)


def test_block_fn_overflow_scalar(small_kg):
    """``make_block_fn(with_overflow=True)`` returns the block's worst
    overflow as a device scalar: 0 under the bound, the excess under a
    capacity one row short of a round's touched rows; BGD's is 0."""
    kcfg, mcfg = port_kg.make_configs(
        small_kg, n_workers=3, dim=8, batch_size=83, pipeline="device",
        merge_transport="sparse")
    part = torch.as_tensor(kg_lib.PARTITIONERS["balanced"](
        0, small_kg.train, 3))
    init = get_model("transe").init_params(torch.Generator().manual_seed(0),
                                           kcfg, device="cpu")
    block = mapreduce.make_block_fn(mcfg, kcfg, part, with_overflow=True)
    params, losses, ovf = block(dict(init), range(2))
    assert ovf.dtype == torch.int64 and ovf.dim() == 0 and int(ovf) == 0
    bgd = mapreduce.make_block_fn(
        port_kg.make_configs(small_kg, "transe", "bgd", n_workers=3, dim=8,
                             batch_size=83, pipeline="device",
                             merge_transport="sparse")[1],
        kcfg, part, with_overflow=True)
    assert int(bgd(dict(init), range(1))[2]) == 0
    assert len(block(dict(init), range(1))) == 3
    assert len(mapreduce.make_block_fn(mcfg, kcfg, part)(
        dict(init), range(1))) == 2


# ---------------------------------------------------------------------------
# The compact Map step in isolation
# ---------------------------------------------------------------------------

def _random_batch(rng, E, R, *lead):
    return torch.tensor(np.stack([
        rng.integers(0, E, lead), rng.integers(0, R, lead),
        rng.integers(0, E, lead)], axis=-1).astype(np.int32))


@pytest.mark.parametrize("model_name", MODELS)
@pytest.mark.parametrize("normalize", ["epoch", "step"])
def test_compact_step_bitwise(model_name, normalize):
    """``sgd_step_sparse`` == ``sgd_step`` bitwise, on one table set and on
    stacked per-worker tables, with compact tables as large as the tables
    (60 entities, 4 relations) and smaller (500 and 90: 4B = 128 and 2B =
    64 rows): the same forward floats on the compact tables, the same
    per-row sums of the gradient, and rows no id references with a dense
    gradient of exactly ``+0.0``."""
    model = get_model(model_name)
    rng = np.random.default_rng(7)
    for E, R in ((60, 4), (500, 90)):
        _check_compact_step(model, model_name, normalize, rng, E, R)


def _check_compact_step(model, model_name, normalize, rng, E, R):
    kcfg, _ = port_kg.make_configs(
        kg_lib.synthetic_kg(0, n_entities=E, n_relations=R, n_triplets=200),
        model=model_name, dim=8, learning_rate=0.05, normalize=normalize)
    params = model.init_params(torch.Generator().manual_seed(0), kcfg,
                               device="cpu")
    stacked = {n: t.unsqueeze(0).repeat(3, 1, 1) + 0.01 * torch.arange(
        3.0)[:, None, None] for n, t in params.items()}
    for p, lead in ((params, (32,)), (stacked, (3, 32))):
        pos = _random_batch(rng, E, R, *lead)
        neg = _random_batch(rng, E, R, *lead)
        given = {n: t.clone() for n, t in p.items()}
        dense_p, dense_l = model.sgd_step(p, pos, neg, kcfg)
        sparse_p, sparse_l = model.sgd_step_sparse(p, pos, neg, kcfg)
        assert torch.equal(_bits(dense_l), _bits(sparse_l))
        for k in dense_p:
            assert torch.equal(_bits(dense_p[k]), _bits(sparse_p[k])), k
            assert torch.equal(_bits(p[k]), _bits(given[k]))   # untouched


def test_compact_step_update_mask_not_ported():
    """The compact step's ``update_mask``, now ported: an all-true mask
    gives the unmasked compact step's bits, an all-false one the input's
    bits, under both projections and on stacked workers."""
    model = get_model("transe")
    rng = np.random.default_rng(0)
    for normalize in ("epoch", "step"):
        kcfg, _ = port_kg.make_configs(
            kg_lib.synthetic_kg(0, n_entities=60, n_relations=4,
                                n_triplets=200),
            dim=8, learning_rate=0.05, normalize=normalize)
        params = model.init_params(torch.Generator(), kcfg, device="cpu")
        stacked = {n: t.unsqueeze(0).repeat(2, 1, 1)
                   for n, t in params.items()}
        for p, lead in ((params, (8,)), (stacked, (2, 8))):
            pos = _random_batch(rng, 60, 4, *lead)
            neg = _random_batch(rng, 60, 4, *lead)
            given = {n: t.clone() for n, t in p.items()}
            ones = {n: torch.ones(t.shape[-2], dtype=torch.bool)
                    for n, t in p.items()}
            zeros = {n: ~m for n, m in ones.items()}
            plain, plain_l = model.sgd_step_sparse(p, pos, neg, kcfg)
            free, free_l = model.sgd_step_sparse(p, pos, neg, kcfg,
                                                 update_mask=ones)
            frozen, frozen_l = model.sgd_step_sparse(p, pos, neg, kcfg,
                                                     update_mask=zeros)
            assert torch.equal(_bits(free_l), _bits(plain_l))
            assert torch.equal(_bits(frozen_l), _bits(plain_l))
            for k in p:
                assert torch.equal(_bits(free[k]), _bits(plain[k])), k
                assert torch.equal(_bits(frozen[k]), _bits(given[k])), k
                assert torch.equal(_bits(p[k]), _bits(given[k]))
                assert not torch.equal(_bits(plain[k]), _bits(given[k]))


@pytest.mark.parametrize("model_name", MODELS)
def test_compact_batch_matches_reference(model_name):
    """``_compact_batch`` against the reference's on one worker's batch:
    candidate ids and remapped triplets exactly, compact tables exactly
    (a gather); and per worker of a stacked batch, each worker's own."""
    rng = np.random.default_rng(3)
    E, R, B = 50, 4, 16
    ref_m, port_m = ref_get_model(model_name), get_model(model_name)
    ref_cfg, _ = ref_kg.make_configs(
        ref_kg_lib.synthetic_kg(0, n_entities=E, n_relations=R,
                                n_triplets=150), model=model_name, dim=6)
    kcfg, _ = port_kg.make_configs(
        kg_lib.synthetic_kg(0, n_entities=E, n_relations=R, n_triplets=150),
        model=model_name, dim=6)
    tables = {n: np.asarray(t) for n, t in ref_m.init_params(
        jax.random.PRNGKey(2), ref_cfg).items()}
    pos = _random_batch(rng, E, R, 2, B)
    neg = _random_batch(rng, E, R, 2, B)
    stacked = {n: torch.tensor(np.stack([t, t + 1])) for n, t in
               tables.items()}
    cand, compact, pos_c, neg_c = port_m._compact_batch(stacked, pos, neg,
                                                        kcfg)
    for w in range(2):
        want = ref_m._compact_batch(
            {n: jnp.asarray(t) + w for n, t in tables.items()},
            jnp.asarray(pos[w].numpy()), jnp.asarray(neg[w].numpy()),
            ref_cfg)
        for role in ("ent", "rel"):
            np.testing.assert_array_equal(cand[role][w].numpy(),
                                          np.asarray(want[0][role]))
        for n in tables:
            np.testing.assert_array_equal(compact[n][w].numpy(),
                                          np.asarray(want[1][n]))
        np.testing.assert_array_equal(pos_c[w].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(neg_c[w].numpy(), np.asarray(want[3]))


# ---------------------------------------------------------------------------
# core/merge.py's sparse half against the reference's
# ---------------------------------------------------------------------------

W, N, K = 3, 40, 6


@pytest.fixture(scope="module")
def deltas():
    """Stacked tables and touch stats with rows touched by no worker, by
    one and by several, and a round-input table."""
    rng = np.random.default_rng(0)
    stacked = rng.normal(size=(W, N, K)).astype(np.float32)
    counts = rng.integers(0, 3, size=(W, N)).astype(np.float32)
    counts[:, :6] = 0                              # touched by nobody
    counts[0, 6:10], counts[1:, 6:10] = 2, 0       # by worker 0 alone
    losses = (counts * rng.uniform(0.1, 2.0, (W, N))).astype(np.float32)
    worker_loss = rng.uniform(0.5, 1.5, (W,)).astype(np.float32)
    base = rng.normal(size=(N, K)).astype(np.float32)
    return stacked, counts, losses, worker_loss, base


def _ref_pack(stacked, counts, losses, cap):
    return jax.vmap(functools.partial(ref_merge.pack_delta, capacity=cap,
                                      n_rows=N))(
        jnp.asarray(stacked), jnp.asarray(counts), jnp.asarray(losses))


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("cap", [N, 25, 12])
def test_pack_delta_and_overflow_match_reference(deltas, cap):
    """Ids, counts and the overflow exactly; values exactly (gathers),
    also when the capacity drops rows."""
    stacked, counts, losses, _, _ = deltas
    want = _ref_pack(stacked, counts, losses, cap)
    got = merge_lib.pack_delta(*_t(stacked, counts, losses), cap, N)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(merge_lib.delta_overflow(torch.tensor(counts), cap)) == int(
        ref_merge.delta_overflow(jnp.asarray(counts), cap))
    idx, vals, cnt, lss = merge_lib.pack_delta(
        torch.tensor(stacked), torch.tensor(counts), None, cap, N)
    assert lss is None and torch.equal(idx, got[0])


@pytest.mark.parametrize("n,size", [(37, 12), (37, 40), (37, 5)])
def test_sized_unique_matches_jnp_unique(n, size):
    rng = np.random.default_rng(n + size)
    ids = rng.integers(0, 20, (2, n)).astype(np.int64)
    got = merge_lib.sized_unique(torch.tensor(ids), size, 20)
    for w in range(2):
        np.testing.assert_array_equal(
            got[w].numpy(), np.asarray(jnp.unique(ids[w], size=size,
                                                  fill_value=20)))


def test_candidates_and_lookups_match_reference(deltas):
    stacked, counts, losses, _, base = deltas
    idx, vals, cnt, lss = _ref_pack(stacked, counts, losses, 25)
    cand = ref_merge.sparse_candidates(idx, N)
    got_cand = merge_lib.sparse_candidates(torch.tensor(np.asarray(idx)), N)
    np.testing.assert_array_equal(got_cand.numpy(), np.asarray(cand))
    virgin = jnp.take(jnp.asarray(base), cand, axis=0, mode="fill",
                      fill_value=0.0)
    want = jax.vmap(ref_merge.lookup_delta,
                    in_axes=(0, 0, 0, 0, None, None, None))(
        idx, vals, cnt, lss, cand, virgin, N)
    got = merge_lib.lookup_delta(*_t(idx, vals, cnt, lss, cand, virgin), N)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rows = jax.vmap(ref_merge.lookup_rows, in_axes=(0, 0, None, None, None))(
        idx, vals, cand, virgin, N)
    np.testing.assert_array_equal(
        merge_lib.lookup_rows(*_t(idx, vals, cand, virgin), N).numpy(),
        np.asarray(rows))
    np.testing.assert_array_equal(
        merge_lib.take_fill(torch.tensor(base), got_cand, 0).numpy(),
        np.asarray(virgin))
    assert merge_lib.touched_capacity(N, 8, 3, 2, "ent") == \
        ref_merge.touched_capacity(N, 8, 3, 2, "ent") == N
    assert merge_lib.touched_capacity(1000, 8, 3, 2, "rel") == \
        ref_merge.touched_capacity(1000, 8, 3, 2, "rel") == 48


@pytest.mark.parametrize("repeats", [0, 1, 3])
def test_virgin_rows_match_reference(deltas, repeats):
    base = deltas[4]
    ref_fn = functools.partial(ref_get_model("transe").normalize_rows, "ent")
    port_fn = functools.partial(get_model("transe").normalize_rows, "ent")
    want = ref_merge.virgin_rows(jnp.asarray(base), ref_fn, repeats)
    got = merge_lib.virgin_rows(torch.tensor(base), port_fn, repeats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOAT_TOL)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sparse_untouched_base(deltas, strategy, w):
    """Against the reference at 1e-6, and bitwise against the port's own
    dense merge of W identical copies (the reference's power-of-two
    shortcut does not hold for the port's in-order sum at W = 8)."""
    local = torch.tensor(deltas[0][0])
    got = merge_lib.sparse_untouched_base(strategy, local, w)
    want = ref_merge.sparse_untouched_base(strategy, jnp.asarray(deltas[0][0]),
                                           w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOAT_TOL)
    copies = local.expand(w, N, K)
    dense = merge_lib.merge_stacked(
        strategy, copies, torch.zeros(w, N), torch.zeros(w, N),
        torch.arange(w, dtype=torch.float32),
        priorities=torch.rand(w, N, generator=torch.Generator()))
    assert torch.equal(_bits(got), _bits(dense))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_merge_sparse_stacked_matches_reference(deltas, strategy):
    """``merge_candidates``, ``apply_delta`` and ``merge_sparse_stacked``
    against the reference's (priorities replayed from its key), and the
    whole sparse merge bitwise against the port's dense merge of tables
    whose untouched rows hold the virgin value."""
    stacked, counts, losses, worker_loss, base = deltas
    key = jax.random.PRNGKey(5)
    pri = np.asarray(ref_merge._random_priorities(key, W, N))
    ref_fn = functools.partial(ref_get_model("transe").normalize_rows, "ent")
    port_fn = functools.partial(get_model("transe").normalize_rows, "ent")
    virgin = port_fn(torch.tensor(base))
    # untouched rows of each worker hold the virgin value, as in a round
    dense_tables = np.where(counts[..., None] > 0, stacked,
                            virgin.numpy()[None])
    idx, vals, cnt, lss = _ref_pack(dense_tables, counts, losses, 25)
    cand = ref_merge.sparse_candidates(idx, N)
    svals, scnt, sloss = jax.vmap(
        ref_merge.lookup_delta, in_axes=(0, 0, 0, 0, None, None, None))(
        idx, vals, cnt, lss, cand,
        ref_fn(jnp.take(jnp.asarray(base), cand, axis=0, mode="fill",
                        fill_value=0.0)), N)
    want_rows = ref_merge.merge_candidates(
        strategy, cand, svals, scnt, sloss, jnp.asarray(worker_loss), N,
        key)
    got_rows = merge_lib.merge_candidates(
        strategy, *_t(cand, svals, scnt, sloss, worker_loss), N,
        torch.tensor(pri))
    np.testing.assert_allclose(got_rows.numpy(), np.asarray(want_rows),
                               **FLOAT_TOL)
    np.testing.assert_allclose(
        merge_lib.apply_delta(*_t(base, cand), got_rows).numpy(),
        np.asarray(ref_merge.apply_delta(jnp.asarray(base), cand,
                                         want_rows)), **FLOAT_TOL)
    want = ref_merge.merge_sparse_stacked(
        strategy, idx, vals, cnt, lss, jnp.asarray(worker_loss),
        jnp.asarray(dense_tables[0]), jnp.asarray(base), ref_fn, 1, key)
    got = merge_lib.merge_sparse_stacked(
        strategy, *_t(idx, vals, cnt, lss, worker_loss, dense_tables[0],
                      base), port_fn, 1, torch.tensor(pri))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOAT_TOL)
    dense = merge_lib.merge_stacked(strategy, *_t(dense_tables, counts,
                                                  losses, worker_loss),
                                    priorities=torch.tensor(pri))
    assert torch.equal(_bits(got), _bits(dense))


def test_put_drop_writes_real_rows_only():
    """Pads write nothing, on one table and per worker of a stacked one,
    also when every id is a pad."""
    x = torch.arange(12.0).reshape(4, 3)
    merge_lib.put_drop_(x, torch.tensor([1, 3, 4, 4]),
                        torch.full((4, 3), -1.0))
    assert x[:, 0].tolist() == [0.0, -1.0, 6.0, -1.0]
    merge_lib.put_drop_(x, torch.tensor([4, 4]), torch.full((2, 3), 7.0))
    assert x[:, 0].tolist() == [0.0, -1.0, 6.0, -1.0]
    s = torch.zeros(2, 4, 1)
    merge_lib.put_drop_(s, torch.tensor([[0, 2, 4], [3, 4, 4]]),
                        torch.tensor([[[1.0], [2.0], [9.0]],
                                      [[3.0], [9.0], [9.0]]]))
    assert s[..., 0].tolist() == [[1.0, 0.0, 2.0, 0.0], [0.0, 0.0, 0.0, 3.0]]


@pytest.mark.parametrize("role,n_rows", [("ent", 200), ("ent", 30),
                                         ("rel", 5)])
def test_bgd_candidate_ids_match_reference(role, n_rows):
    rng = np.random.default_rng(1)
    pos = _random_batch(rng, min(n_rows, 30), 5, 3, 16)
    neg = _random_batch(rng, min(n_rows, 30), 5, 3, 16)
    want = ref_mr._bgd_candidate_ids(jnp.asarray(pos.numpy()),
                                     jnp.asarray(neg.numpy()), role, n_rows)
    got = mapreduce._bgd_candidate_ids(pos, neg, role, n_rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Whole sparse runs against the reference, on its replayed draws
# ---------------------------------------------------------------------------

HOST_CELLS = {
    # name: (model, paradigm, options, reference transport)
    "average": ("transe", "sgd", dict(strategy="average"), "sparse"),
    "random": ("transe", "sgd", dict(strategy="random"), "sparse"),
    "transh-miniloss_perkey": ("transh", "sgd",
                               dict(strategy="miniloss_perkey"), "sparse"),
    "distmult-bgd": ("distmult", "bgd", {}, "sparse"),
    # the reference's joint sparse run breaks its own contract: its dense
    "joint8-l2": ("transe", "sgd", dict(negatives="joint", neg_candidates=8,
                                        norm="l2"), "dense"),
}
DEVICE_CELLS = {
    "average-merge2": ("transe", "sgd", dict(strategy="average",
                                             merge_every=2), "sparse"),
    "transh-random-merge2": ("transh", "sgd", dict(strategy="random",
                                                   merge_every=2), "sparse"),
    "bgd": ("transe", "bgd", {}, "sparse"),
}


def _reference_run(ref_graph, model, paradigm, kw, transport, epochs,
                   replay):
    kcfg, mcfg = ref_kg.make_configs(ref_graph, model, paradigm, **kw)
    init = ref_get_model(model).init_params(jax.random.PRNGKey(1), kcfg)
    tables = {n: np.asarray(t) for n, t in init.items()}
    want = ref_kg.fit(ref_graph, model, paradigm, epochs=epochs, seed=0,
                      params=init, merge_transport=transport, **kw)
    return tables, want, replay(ref_graph, kcfg, mcfg, tables, 0, epochs)


def _close_to(got, want):
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               **RUN_TOL)
    for n in want.params:
        np.testing.assert_allclose(got.params[n].numpy(),
                                   np.asarray(want.params[n]), **RUN_TOL)


@pytest.mark.parametrize("name", sorted(HOST_CELLS))
def test_sparse_host_run_matches_reference(graphs, name):
    ref_graph, graph = graphs
    model, paradigm, opts, transport = HOST_CELLS[name]
    kw = dict(dim=8, batch_size=83, n_workers=3, learning_rate=0.05, **opts)
    tables, want, draws = _reference_run(ref_graph, model, paradigm, kw,
                                         transport, 2, replay_draws)
    got = port_kg.fit(graph, model, paradigm, epochs=2, seed=0,
                      params=tables, device="cpu", merge_transport="sparse",
                      draws=lambda e: draws[e], **kw)
    _close_to(got, want)


@pytest.mark.parametrize("name", sorted(DEVICE_CELLS))
def test_sparse_device_run_matches_reference(graphs, name):
    ref_graph, graph = graphs
    model, paradigm, opts, transport = DEVICE_CELLS[name]
    kw = dict(dim=8, batch_size=83, n_workers=3, learning_rate=0.05,
              pipeline="device", block_epochs=4 if paradigm == "sgd" else 2,
              **opts)
    epochs = 4 if paradigm == "sgd" else 2
    tables, want, draws = _reference_run(ref_graph, model, paradigm, kw,
                                         transport, epochs,
                                         replay_device_draws)
    got = port_kg.fit(graph, model, paradigm, epochs=epochs, seed=0,
                      params=tables, device="cpu", merge_transport="sparse",
                      draws=lambda e: draws[e], **kw)
    _close_to(got, want)


# ---------------------------------------------------------------------------
# Touch-stat properties the transport is built on
# ---------------------------------------------------------------------------

_E, _R, _W, _S, _B = 80, 5, 3, 4, 16


def _epoch_inputs(seed):
    model = get_model("transe")
    kcfg, _ = port_kg.make_configs(
        kg_lib.synthetic_kg(0, n_entities=_E, n_relations=_R,
                            n_triplets=200), dim=6, learning_rate=0.1)
    rng = np.random.default_rng(seed)
    params = model.init_params(torch.Generator().manual_seed(seed), kcfg,
                               device="cpu")
    pos = _random_batch(rng, _E, _R, _W, _S, _B)
    neg = _random_batch(rng, _E, _R, _W, _S, _B)
    return model, kcfg, params, pos, neg


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sgd_touched_covers_changed(strategy, seed):
    """After a worker epoch every row that differs from its virgin value
    is marked touched; after the Reduce every row the merge moved away
    from virgin lies in the union of the workers' touched sets."""
    model, kcfg, params, pos, neg = _epoch_inputs(seed)
    stacked, stats = model.run_epoch(mapreduce._broadcast(params, _W), pos,
                                     neg, kcfg)
    counts = {"ent": stats.ent_count, "rel": stats.rel_count}
    pri = torch.rand(_W, _E, generator=torch.Generator().manual_seed(seed))
    for name in params:
        role = model.roles[name]
        virgin = merge_lib.virgin_rows(
            params[name], functools.partial(model.normalize_rows, name), 1)
        touched = counts[role] > 0
        for w in range(_W):
            changed = (stacked[name][w] != virgin).any(1)
            assert not (changed & ~touched[w]).any(), (name, w)
        merged = merge_lib.merge_stacked(
            strategy, stacked[name], counts[role],
            getattr(stats, f"{role}_loss"), stats.mean_loss,
            priorities=pri[:, :len(virgin)])
        changed = (merged != virgin).any(1)
        assert not (changed & ~touched.any(0)).any(), (name, strategy)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bgd_grads_within_batch_ids(seed):
    """Rows with a nonzero batch gradient are rows the batch references:
    the candidate set the sparse BGD update uses."""
    model, kcfg, params, pos, neg = _epoch_inputs(seed)
    pos_b, neg_b = pos[:, 0], neg[:, 0]
    _, grads = model.batch_gradients(params, pos_b, neg_b, kcfg)
    for name in params:
        role = model.roles[name]
        cand = mapreduce._bgd_candidate_ids(pos_b, neg_b, role,
                                            params[name].shape[0])
        for w in range(_W):
            nz = set(torch.nonzero((grads[name][w] != 0).any(1))[:, 0]
                     .tolist())
            assert nz <= set(cand.tolist()), name
