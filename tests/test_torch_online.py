"""The port's online tier (``repro_torch.online``, ``KG.extend``,
``data/datasets.py``, the masked fine-tune of ``mapreduce.train`` and
``KGModel.run_epoch``) against the reference's, both on the CPU, and its
own contracts, mirroring ``tests/test_online.py`` test for test.

Against the reference:

  * ``plan()`` on the same artifact and delta gives the same delta, the
    same table sizes and engine configuration, the same masks exactly,
    the same base rows bitwise and the same warm-initialised rows: the
    neighbour means (``_warm_init``, float64 on the host) bitwise, the
    projected rows within 1e-6.  The appended rows' fresh draw differs
    by design (the port draws from a ``torch.Generator``, the reference
    from ``jax.random``), so those rows are not compared.
  * The port's ``mapreduce.train`` on the reference's plan (its tables
    and masks carried across, its device draws replayed through
    ``train(draws=...)``): frozen rows bitwise, free rows within 1e-5 of
    the reference's ``update()``, for TransE (L1, L2), TransH and
    DistMult, with ``scope`` ``touched`` and ``cold``.
  * ``extend_vocab``, ``load_dataset`` and ``KG.extend``: ids and splits
    exactly; ``train(update_mask=)``'s refusals in the same order and
    words.

The property test of the warm-init constraint runs on a fixed list of
seeds (no random search), and holds the projection at 1e-6, not bitwise:
the reference's bitwise form fails for DistMult (seed 35147, where
re-normalising a unit row moves its last bits).  Every wait on a thread
is bounded: ``flush(timeout=...)``, ``result(timeout=...)``, and the
daemon and the server are stopped in ``finally`` with the daemon's
thread checked dead after a bounded ``stop``.
"""
import os

import numpy as np
import pytest
import torch

from repro import kg as ref_kg
from repro.core import mapreduce as ref_mr
from repro.core.models import get_model as ref_get_model
from repro.data import datasets as ref_datasets
from repro.data import kg as ref_kg_lib
from repro.kb import KnowledgeBase as RefKnowledgeBase
from repro.online import OnlineUpdater as RefOnlineUpdater
from repro_torch import convert
from repro_torch import kg as port_kg
from repro_torch.core import mapreduce
from repro_torch.core.models import available, get_model
from repro_torch.data import datasets
from repro_torch.data import kg as kg_lib
from repro_torch.kb import KnowledgeBase
from repro_torch.online import OnlineUpdater, RefreshDaemon
from repro_torch.serve import KGServer

from test_torch_parity_helpers import port_graph
from test_torch_pipeline_device import replay_device_draws

pytestmark = pytest.mark.filterwarnings("ignore:batch_size=")

TIMEOUT = 60
TOL = dict(rtol=1e-5, atol=1e-5)
# (model, norm) of the cross-package fine-tune cells
CELLS = (("transe", "l1"), ("transe", "l2"), ("transh", "l1"),
         ("distmult", "l1"))


@pytest.fixture(scope="module")
def ref_graph():
    return ref_kg_lib.synthetic_kg(0, n_entities=60, n_relations=8,
                                   n_triplets=500)


@pytest.fixture(scope="module")
def small_kg(ref_graph):
    return port_graph(ref_graph)


@pytest.fixture(scope="module")
def base_kb(small_kg):
    n_w = len(small_kg.train) // 2
    return port_kg.fit(small_kg, model="transe", epochs=3, seed=0,
                       pipeline="device", n_workers=2, batch_size=n_w,
                       dim=16, device="cpu").kb


def _delta(small_kg, n_old=20, n_new_ent=3, seed=0):
    """Delta triples: n_old among existing entities plus rows naming
    n_new_ent brand-new entity ids (each adjacent to an old entity)."""
    rng = np.random.default_rng(seed)
    E, R = small_kg.n_entities, small_kg.n_relations
    old = np.stack([rng.integers(0, E, n_old), rng.integers(0, R, n_old),
                    rng.integers(0, E, n_old)], axis=1)
    new = np.stack([np.arange(E, E + n_new_ent),
                    rng.integers(0, R, n_new_ent),
                    rng.integers(0, E, n_new_ent)], axis=1)
    return np.concatenate([old, new]).astype(np.int32)


def _host(params):
    return {name: t.numpy() for name, t in params.items()}


# -- interning canonicality ------------------------------------------------


def _write_tsv(path, train, valid, test):
    os.makedirs(path, exist_ok=True)
    for name, rows in (("train", train), ("valid", valid), ("test", test)):
        with open(os.path.join(path, f"{name}.txt"), "w") as f:
            for h, r, t in rows:
                f.write(f"{h}\t{r}\t{t}\n")


BASE_TRAIN = [("a", "r1", "b"), ("b", "r2", "c"), ("c", "r1", "a")]
VALID = [("a", "r2", "c")]
TEST = [("b", "r1", "c")]
DELTA = [("c", "r3", "dd"), ("dd", "r1", "ee"), ("a", "r1", "ee")]


def test_extend_vocab_matches_load_tsv_dir(tmp_path):
    """Interning a delta through extend_vocab assigns exactly the ids a
    fresh load_tsv_dir of base+delta would."""
    _write_tsv(tmp_path / "base", BASE_TRAIN, VALID, TEST)
    kg_base = kg_lib.load_tsv_dir(str(tmp_path / "base"))

    ent2id, rel2id = {}, {}
    rep_train = datasets.extend_vocab(BASE_TRAIN, ent2id, rel2id)
    rep_valid = datasets.extend_vocab(VALID, ent2id, rel2id)
    rep_test = datasets.extend_vocab(TEST, ent2id, rel2id)
    assert np.array_equal(rep_train, kg_base.train)
    assert np.array_equal(rep_valid, kg_base.valid)
    assert np.array_equal(rep_test, kg_base.test)

    # load_tsv_dir interns train before valid/test; the valid/test names
    # here all appear in train first
    _write_tsv(tmp_path / "ext", BASE_TRAIN + DELTA, VALID, TEST)
    kg_ext = kg_lib.load_tsv_dir(str(tmp_path / "ext"))
    delta_ids = datasets.extend_vocab(DELTA, ent2id, rel2id)
    assert np.array_equal(
        np.concatenate([kg_base.train, delta_ids]), kg_ext.train)
    assert kg_ext.n_entities == len(ent2id)
    assert kg_ext.n_relations == len(rel2id)


def test_extend_vocab_matches_reference():
    """The same names give the same ids and the same grown maps as the
    reference's ``extend_vocab``."""
    maps = [({}, {}), ({}, {})]
    for rows in (BASE_TRAIN, VALID, TEST, DELTA, [("zz", "r9", "a")]):
        got = datasets.extend_vocab(rows, *maps[0])
        want = ref_datasets.extend_vocab(rows, *maps[1])
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)
    assert maps[0] == maps[1]
    assert datasets.extend_vocab([], {}, {}).shape == (0, 3)


@pytest.mark.parametrize("layout", ["dir", "file"])
def test_load_dataset_matches_reference(tmp_path, layout):
    """``load_dataset`` (a dataset directory, or one file split by a
    seeded permutation), its cache and ``load_vocab``: the same splits,
    sizes and vocabulary as the reference's; a cached reload equals the
    first load, and an edited source re-ingests."""
    rng = np.random.default_rng(4)
    rows = np.stack([rng.integers(0, 40, 300), rng.integers(0, 5, 300),
                     rng.integers(0, 40, 300)], 1)
    if layout == "dir":
        src = tmp_path / "ds"
        os.makedirs(src)
        for name, part in zip(("train", "valid", "test"),
                              np.split(rows, [240, 270])):
            datasets.write_tsv(str(src / f"{name}.txt"), part)
    else:
        src = tmp_path / "all.tsv"
        datasets.write_tsv(str(src), rows, ent_fmt="ent{}", rel_fmt="rel{}")
    got = datasets.load_dataset(str(src), seed=3,
                                cache_dir=str(tmp_path / "port_cache"))
    want = ref_datasets.load_dataset(str(src), seed=3,
                                     cache_dir=str(tmp_path / "ref_cache"))
    assert (got.n_entities, got.n_relations) == (want.n_entities,
                                                 want.n_relations)
    for split in ("train", "valid", "test"):
        assert np.array_equal(getattr(got, split), getattr(want, split))
    assert got.fingerprint() == want.fingerprint()
    assert datasets.load_vocab(str(tmp_path / "port_cache")) == \
        ref_datasets.load_vocab(str(tmp_path / "ref_cache"))
    again = datasets.load_dataset(str(src), seed=3,
                                  cache_dir=str(tmp_path / "port_cache"))
    assert again.fingerprint() == got.fingerprint()
    path = str(src / "train.txt") if layout == "dir" else str(src)
    with open(path, "a") as f:
        f.write("fresh\tr0\tnew\n")
    edited = datasets.load_dataset(str(src), seed=3,
                                   cache_dir=str(tmp_path / "port_cache"))
    assert edited.n_entities == got.n_entities + 2


def test_update_with_string_triples(base_kb):
    """String deltas intern through vocab= and grow the tables."""
    ent2id = {str(i): i for i in range(base_kb.n_entities)}
    rel2id = {f"r{i}": i for i in range(base_kb.n_relations)}
    kb2 = base_kb.update([("0", "r0", "brand-new")],
                         vocab=(ent2id, rel2id), epochs=1)
    assert kb2.n_entities == base_kb.n_entities + 1
    assert ent2id["brand-new"] == base_kb.n_entities

    with pytest.raises(ValueError, match="vocab"):
        base_kb.update([("0", "r0", "another")], epochs=1)


# -- masked fine-tune ------------------------------------------------------


def test_update_grows_and_freezes(base_kb, small_kg):
    delta = _delta(small_kg)
    given = {name: t.clone() for name, t in base_kb.params.items()}
    kb2 = base_kb.update(delta, epochs=2, seed=3)

    assert kb2.n_entities == small_kg.n_entities + 3
    assert len(kb2.graph.train) == len(small_kg.train) + len(delta)
    plan = OnlineUpdater(base_kb, epochs=2, seed=3).plan(delta)
    for name in base_kb.params:
        assert torch.equal(base_kb.params[name], given[name])  # base intact
        old_n = base_kb.params[name].shape[0]
        frozen = torch.as_tensor(~plan.update_mask[name][:old_n])
        assert torch.equal(kb2.params[name][:old_n][frozen],
                           base_kb.params[name][frozen])
    moved = torch.as_tensor(plan.update_mask["ent"][:small_kg.n_entities])
    assert not torch.equal(kb2.params["ent"][:small_kg.n_entities][moved],
                           base_kb.params["ent"][moved])


def test_update_equals_direct_masked_train(base_kb, small_kg):
    """No special path: update() is exactly mapreduce.train on the plan."""
    delta = _delta(small_kg)
    up = OnlineUpdater(base_kb, epochs=2, seed=3)
    kb2 = up.update(delta)
    p = up.plan(delta)
    res = mapreduce.train(
        p.delta_kg, p.kcfg, p.mcfg, epochs=p.epochs, seed=p.seed,
        params=p.params, update_mask=p.update_mask, model=base_kb.model,
        device="cpu")
    for name in kb2.params:
        assert torch.equal(kb2.params[name], res.params[name])


def test_update_deterministic(base_kb, small_kg):
    delta = _delta(small_kg)
    kb_a = base_kb.update(delta, epochs=2, seed=3)
    kb_b = base_kb.update(delta, epochs=2, seed=3)
    assert kb_a.fingerprint() == kb_b.fingerprint()


def test_zero_triple_update_is_noop(base_kb):
    kb2 = base_kb.update([])
    assert kb2 is not base_kb
    assert kb2.fingerprint() == base_kb.fingerprint()
    for name in base_kb.params:
        assert torch.equal(kb2.params[name], base_kb.params[name])


def test_update_refuses_staleness(base_kb):
    with pytest.raises(ValueError, match="staleness"):
        base_kb.update([[0, 0, 1]], staleness=1)


def test_facade_update_matches_method(base_kb, small_kg):
    """kg.update(kb, ...) is the same call as kb.update(...)."""
    delta = _delta(small_kg)
    via_facade = port_kg.update(base_kb, delta, epochs=2, seed=3)
    via_method = base_kb.update(delta, epochs=2, seed=3)
    assert via_facade.fingerprint() == via_method.fingerprint()

    with pytest.raises(TypeError, match="KnowledgeBase"):
        port_kg.update({"ent": None}, delta)


def test_update_scope_cold(base_kb, small_kg):
    """scope="cold" frees only rows the base artifact never trained:
    appended ids plus base ids with no triple in the train split.  Every
    trained row stays bitwise frozen even when the delta names it."""
    delta = _delta(small_kg)
    up = OnlineUpdater(base_kb, epochs=2, seed=3, scope="cold")
    p = up.plan(delta)

    E = small_kg.n_entities
    seen = np.zeros(E, bool)
    seen[small_kg.train[:, (0, 2)].ravel()] = True
    assert not p.update_mask["ent"][:E][seen].any()
    assert p.update_mask["ent"][E:].all()

    kb2 = up.update(delta)
    seen = torch.as_tensor(seen)
    assert torch.equal(kb2.params["ent"][:E][seen],
                       base_kb.params["ent"][seen])

    with pytest.raises(ValueError, match="scope"):
        OnlineUpdater(base_kb, scope="warm")


def test_masked_train_refusals_match_reference(ref_graph, small_kg,
                                               base_kb):
    """``train(update_mask=)``'s refusals, each against the reference's
    on the same arguments: the same order and the same words."""
    mask = {"ent": np.ones(small_kg.n_entities, bool),
            "rel": np.ones(small_kg.n_relations, bool)}
    params = _host(base_kb.params)
    ok = dict(dim=16, paradigm="sgd", merge_transport="sparse",
              pipeline="device", n_workers=2, batch_size=64)
    cases = [
        (dict(ok, paradigm="bgd"), {}),
        (dict(ok, merge_transport="dense"), {}),
        (dict(ok, pipeline="host"), {}),
        (dict(ok, staleness=1), {}),
        (ok, dict(checkpoint=True)),
        (ok, dict(params=None)),
        (ok, dict(update_mask={"ent": mask["ent"]})),
        (ok, dict(update_mask=dict(mask, rel=mask["rel"][:3]))),
    ]
    for cfg_kw, call_kw in cases:
        msgs = []
        for kg_api, graph, extra in (
                (ref_kg, ref_graph, {}),
                (port_kg, small_kg, {"device": "cpu"})):
            kcfg, mcfg = kg_api.make_configs(graph, "transe", **cfg_kw)
            ckpt = (mapreduce.CheckpointConfig("unused") if kg_api is port_kg
                    else ref_mr.CheckpointConfig("unused"))
            kw = dict(epochs=1, params=params, update_mask=mask)
            kw.update({k: (ckpt if k == "checkpoint" else v)
                       for k, v in call_kw.items()})
            train = (mapreduce.train if kg_api is port_kg
                     else ref_mr.train)
            with pytest.raises(ValueError) as err:
                train(graph, kcfg, mcfg, **kw, **extra)
            msgs.append(str(err.value))
        assert msgs[0].replace("repro.online", "repro_torch.online") == \
            msgs[1], cfg_kw
    # the block function checks on its own, and run_epoch needs the
    # compact step
    kcfg, mcfg = port_kg.make_configs(small_kg, "transe",
                                      **dict(ok, paradigm="bgd"))
    with pytest.raises(ValueError, match="requires the SGD"):
        mapreduce.make_block_fn(mcfg, kcfg, torch.zeros((2, 8, 3),
                                                        dtype=torch.int32),
                                update_mask=mask)


# -- the masked fine-tune against the reference's --------------------------


@pytest.fixture(scope="module")
def ref_cells(ref_graph):
    """Per (model, norm, scope): the reference's base artifact (its
    seed-0 init, projected), plan and ``update()``, built on first use."""
    cache = {}

    def get(model, norm, scope):
        key = (model, norm, scope)
        if key not in cache:
            import jax

            m = ref_get_model(model)
            kcfg, _ = ref_kg.make_configs(ref_graph, model=m, dim=8)
            params = m.normalize(m.init_params(jax.random.PRNGKey(0), kcfg))
            kb = RefKnowledgeBase(model=m, params=params, graph=ref_graph,
                                  norm=norm)
            up = RefOnlineUpdater(kb, epochs=2, seed=3, scope=scope)
            delta = _delta(ref_graph)
            cache[key] = (kb, up.plan(delta), up.update(delta))
        return cache[key]

    return get


@pytest.mark.parametrize("scope", ["touched", "cold"])
@pytest.mark.parametrize("model,norm", CELLS)
def test_plan_matches_reference(ref_cells, ref_graph, model, norm, scope):
    """The port's ``plan()`` on the reference's artifact carried across:
    the same delta, sizes, engine configuration and masks, the base rows
    bitwise, the neighbour means bitwise and the projected warm rows
    within 1e-6."""
    ref_kb, ref_plan, _ = ref_cells(model, norm, scope)
    kb = convert.kb_from_reference(
        {n: np.asarray(t) for n, t in ref_kb.params.items()}, model,
        ref_graph, norm=norm, device="cpu")
    up = OnlineUpdater(kb, epochs=2, seed=3, scope=scope)
    plan = up.plan(_delta(ref_graph))
    assert np.array_equal(plan.delta, ref_plan.delta)
    assert plan.delta_kg.fingerprint() == ref_plan.delta_kg.fingerprint()
    for f in ("n_entities", "n_relations", "dim", "norm", "learning_rate",
              "normalize"):
        assert getattr(plan.kcfg, f) == getattr(ref_plan.kcfg, f), f
    for f in ("n_workers", "batch_size", "paradigm", "merge_transport",
              "pipeline", "strategy", "staleness"):
        assert getattr(plan.mcfg, f) == getattr(ref_plan.mcfg, f), f
    assert plan.mcfg.schedule.block_epochs == \
        ref_plan.mcfg.schedule.block_epochs
    assert (plan.epochs, plan.seed) == (ref_plan.epochs, ref_plan.seed)
    assert set(plan.update_mask) == set(ref_plan.update_mask)
    for name, m in plan.update_mask.items():
        assert m.dtype == bool
        assert np.array_equal(m, ref_plan.update_mask[name]), name
    E = ref_graph.n_entities
    old = np.asarray(ref_kb.params["ent"])
    delta = plan.delta
    # the warm rows: new entities with an old neighbour in the delta
    warm = np.unique(np.concatenate([
        delta[(delta[:, 0] >= E) & (delta[:, 2] < E), 0],
        delta[(delta[:, 2] >= E) & (delta[:, 0] < E), 2]])) - E
    assert len(warm) == 3
    app = np.zeros((3, old.shape[1]), np.float32)
    means = OnlineUpdater._warm_init(app, old, delta)
    assert np.array_equal(means, RefOnlineUpdater._warm_init(app, old,
                                                             delta))
    for name, table in plan.params.items():
        want = np.asarray(ref_plan.params[name])
        got = table.numpy()
        assert got.shape == want.shape
        n = np.asarray(ref_kb.params[name]).shape[0]
        assert np.array_equal(got[:n], want[:n])
    np.testing.assert_allclose(plan.params["ent"].numpy()[E + warm],
                               np.asarray(ref_plan.params["ent"])[E + warm],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scope", ["touched", "cold"])
@pytest.mark.parametrize("model,norm", CELLS)
def test_masked_train_matches_reference(ref_cells, ref_graph, small_kg,
                                        model, norm, scope):
    """The port's ``mapreduce.train`` on the reference's plan, its device
    draws replayed: frozen rows bitwise the plan's, free rows within 1e-5
    of the reference's ``update()``."""
    _, ref_plan, ref_kb2 = ref_cells(model, norm, scope)
    tables = {n: np.asarray(t) for n, t in ref_plan.params.items()}
    draws = replay_device_draws(ref_plan.delta_kg, ref_plan.kcfg,
                                ref_plan.mcfg, tables, ref_plan.seed,
                                ref_plan.epochs)
    dkg = port_graph(ref_plan.delta_kg)
    kcfg, mcfg = port_kg.make_configs(
        dkg, model=model, paradigm="sgd", dim=ref_plan.kcfg.dim, norm=norm,
        n_workers=ref_plan.mcfg.n_workers,
        batch_size=ref_plan.mcfg.batch_size, pipeline="device",
        merge_transport="sparse", block_epochs=ref_plan.epochs)
    res = mapreduce.train(
        dkg, kcfg, mcfg, epochs=ref_plan.epochs, seed=ref_plan.seed,
        params=tables, update_mask=ref_plan.update_mask,
        model=get_model(model), device="cpu", draws=lambda e: draws[e])
    for name, table in res.params.items():
        got = table.numpy()
        mask = ref_plan.update_mask[name]
        assert np.array_equal(got[~mask], tables[name][~mask]), name
        np.testing.assert_allclose(got[mask],
                                   np.asarray(ref_kb2.params[name])[mask],
                                   **TOL)
        if mask.any():                             # the free rows moved
            assert not np.array_equal(got[mask], tables[name][mask])


# -- warm-init constraint safety -------------------------------------------


def _check_extended_invariants(model_name, seed):
    """Extended tables satisfy the model's normalize invariants before the
    first step: normalize_rows leaves the appended rows where they are,
    within 1e-6 (not bitwise: re-normalising a unit row may move its last
    bits, as the reference's DistMult rows show at seed 35147)."""
    rng = np.random.default_rng(seed)
    E, R = 12, 3
    graph = kg_lib.KG(
        n_entities=E, n_relations=R,
        train=np.stack([rng.integers(0, E, 30), rng.integers(0, R, 30),
                        rng.integers(0, E, 30)], 1).astype(np.int32),
        valid=np.zeros((0, 3), np.int32), test=np.zeros((0, 3), np.int32))
    model = get_model(model_name)
    kcfg, _ = port_kg.make_configs(graph, model=model, dim=8)
    params = model.normalize(model.init_params(
        torch.Generator().manual_seed(seed), kcfg, device="cpu"))
    kb = KnowledgeBase(model=model, params=params, graph=graph)

    n_new_ent, n_new_rel = int(rng.integers(1, 4)), int(rng.integers(0, 2))
    rows = [[E + i, int(rng.integers(0, R)), int(rng.integers(0, E))]
            for i in range(n_new_ent)]
    rows += [[int(rng.integers(0, E)), R + i, int(rng.integers(0, E))]
             for i in range(n_new_rel)]
    plan = OnlineUpdater(kb, epochs=1, seed=seed).plan(
        np.asarray(rows, np.int32))
    roles = model.param_roles()
    for name, table in plan.params.items():
        old_n = params[name].shape[0]
        app = table[old_n:]
        np.testing.assert_allclose(
            model.normalize_rows(name, app).numpy(), app.numpy(),
            rtol=1e-6, atol=1e-6,
            err_msg=f"{model_name}:{name} appended rows violate the "
                    "constraint")
        assert torch.equal(table[:old_n], params[name])
        assert plan.update_mask[name].shape == (table.shape[0],)
        assert roles[name] in ("ent", "rel")


@pytest.mark.parametrize("seed", [0, 1, 7, 1234, 35147])
@pytest.mark.parametrize("model_name", available())
def test_warm_init_constraint_safety(model_name, seed):
    _check_extended_invariants(model_name, seed)


def test_warm_init_uses_neighbor_mean(base_kb, small_kg):
    """A new entity adjacent to old entities starts at the mean of their
    embeddings (projected), not at the random draw."""
    E = small_kg.n_entities
    delta = np.asarray([[E, 2, 5], [E, 3, 9]], np.int32)
    plan = OnlineUpdater(base_kb, seed=7).plan(delta)
    old = base_kb.params["ent"].numpy()
    want = (old[5].astype(np.float64) + old[9]) / 2
    want = base_kb.model.normalize_rows(
        "ent", torch.as_tensor(want.astype(old.dtype)[None, :]))[0]
    np.testing.assert_allclose(plan.params["ent"][E].numpy(), want.numpy(),
                               rtol=1e-6)


# -- freshness: fingerprints and caches ------------------------------------


def test_kg_stale_cache_regression(small_kg):
    """Mutating a KG's triples with warm lazy caches leaves eval filters
    answering from the old graph; invalidate_caches() fixes it, and
    KG.extend() returns a fresh instance, so it cannot happen there."""
    g = kg_lib.KG(small_kg.n_entities, small_kg.n_relations,
                  small_kg.train.copy(), small_kg.valid.copy(),
                  small_kg.test.copy())
    h, r = int(g.train[0, 0]), int(g.train[0, 1])
    known_tails = {int(t) for hh, rr, t in g.all_triplets.tolist()
                   if hh == h and rr == r}
    t_new = next(t for t in range(g.n_entities) if t not in known_tails)
    pairs = np.asarray([[h, r]], np.int64)

    def filtered_out(graph):
        row = graph.known_candidate_masks(pairs, "tail")[0]
        return set(row.tolist()) - {graph.n_entities}

    assert t_new not in filtered_out(g)               # warms the cache
    g.train = np.concatenate(
        [g.train, np.asarray([[h, r, t_new]], np.int32)])
    assert t_new not in filtered_out(g)               # stale
    g.invalidate_caches()
    assert t_new in filtered_out(g)

    g2 = small_kg.extend(np.asarray([[h, r, t_new]], np.int32))
    assert t_new in filtered_out(g2)
    assert t_new not in filtered_out(small_kg)        # base untouched


def test_kg_extend_matches_reference(ref_graph, small_kg):
    """``KG.extend`` grows like the reference's (sizes, splits,
    fingerprint) and raises its ``ValueError``s."""
    delta = _delta(ref_graph, n_old=4, n_new_ent=2)
    for kw in ({}, dict(n_entities=70, n_relations=9)):
        got, want = small_kg.extend(delta, **kw), ref_graph.extend(delta,
                                                                   **kw)
        assert got.fingerprint() == want.fingerprint()
        assert np.array_equal(got.train, want.train)
    for kw, match in ((dict(n_entities=61), "n_entities=61"),
                      (dict(n_relations=2), "n_relations=2")):
        with pytest.raises(ValueError, match=match):
            small_kg.extend(delta, **kw)
        with pytest.raises(ValueError, match=match):
            ref_graph.extend(delta, **kw)


def test_fingerprints_change_on_update(base_kb, small_kg):
    delta = _delta(small_kg, n_old=5, n_new_ent=0)
    kb2 = base_kb.update(delta, epochs=1, seed=2)
    assert kb2.fingerprint() != base_kb.fingerprint()
    assert kb2.graph.fingerprint() != small_kg.fingerprint()
    assert kb2.n_entities == base_kb.n_entities


def _tails(srv, h, r, k=4):
    return srv.submit("tails", h, r, k).result(timeout=TIMEOUT)


def test_server_cache_invalidated_across_update(base_kb, small_kg):
    """swap() to an updated artifact changes the tenant fingerprint and
    flushes the answer cache."""
    srv = KGServer(base_kb, max_batch=4, max_wait_us=100, cache_size=64)
    try:
        a1 = _tails(srv, 3, 1)
        a1c = _tails(srv, 3, 1)                 # served from cache
        assert a1c.cached and np.array_equal(a1.ids, a1c.ids)
        fp_before = srv.tenant_fingerprint()

        kb2 = base_kb.update(_delta(small_kg), epochs=2, seed=3)
        srv.swap(kb2)
        assert srv.tenant_fingerprint() != fp_before
        assert srv.stats().cache_invalidations >= 1

        a2 = _tails(srv, 3, 1)
        ref = kb2.query_tails(3, 1, k=4)
        assert np.array_equal(np.atleast_2d(a2.ids)[0],
                              np.atleast_2d(ref.ids)[0])
    finally:
        srv.stop()


# -- serve while training --------------------------------------------------


def _stop(daemon):
    assert daemon.stop(timeout=TIMEOUT)
    assert daemon._thread is None


def test_refresh_daemon_swap_consistency(base_kb, small_kg):
    """Answers before a refresh are the base artifact's, after flush()
    the refreshed one's, bitwise; the swap adds no steady recompile and
    drain() waits out in-flight waves."""
    srv = KGServer(base_kb, max_batch=4, max_wait_us=100)
    daemon = RefreshDaemon(srv, epochs=2, seed=5)
    try:
        before = _tails(srv, 5, 2)
        ref_before = base_kb.engine().query_tails([5], [2], k=4)
        assert np.array_equal(before.ids, ref_before.ids[0])
        assert np.array_equal(before.energies, ref_before.energies[0])

        daemon.start()
        daemon.submit(_delta(small_kg, n_old=10, n_new_ent=1))
        assert daemon.flush(timeout=TIMEOUT)
        assert daemon.refreshes == 1
        after = _tails(srv, 5, 2)
        ref_after = daemon.kb.engine().query_tails([5], [2], k=4)
        assert np.array_equal(after.ids, ref_after.ids[0])
        assert np.array_equal(after.energies, ref_after.energies[0])
        assert after.fingerprint == daemon.kb.fingerprint() == \
            srv.tenant_fingerprint()
        assert daemon.triples_applied == 11
        assert srv.drain(timeout=TIMEOUT)
        st = srv.stats()
        assert st.swaps == 1
        assert st.steady_recompiles == 0
    finally:
        _stop(daemon)
        srv.stop()


def test_refresh_daemon_surfaces_errors(base_kb):
    class Boom(Exception):
        pass

    class BadServer:
        def tenant_kb(self, tenant="default"):
            return base_kb

        def swap(self, kb, tenant="default"):
            raise Boom()

    daemon = RefreshDaemon(BadServer(), epochs=1)
    try:
        daemon.start()
        daemon.submit(np.asarray([[0, 0, 1]], np.int32))
        with pytest.raises(Boom):
            daemon.flush(timeout=TIMEOUT)
        assert daemon.flush(timeout=TIMEOUT)        # the error is consumed
    finally:
        _stop(daemon)


def test_refresh_daemon_error_is_never_missed(base_kb):
    """Stress: with a tiny thread switch interval, every failed refresh's
    error reaches the flush that waits for it (the error is kept in the
    critical section that ends the pass, so a flush woken by that end
    cannot return True first)."""
    import sys

    class Boom(Exception):
        pass

    class BadServer:
        def tenant_kb(self, tenant="default"):
            return base_kb

        def swap(self, kb, tenant="default"):
            raise Boom()

    interval = sys.getswitchinterval()
    daemon = RefreshDaemon(BadServer(), epochs=1)
    try:
        # the pass that fails keeps its error before it reports its end
        daemon.submit(np.asarray([[0, 0, 1]], np.int32))
        with pytest.raises(Boom):
            daemon._refresh(keep_error=True)
        with pytest.raises(Boom):
            daemon.flush(timeout=TIMEOUT)
        sys.setswitchinterval(1e-6)
        daemon.start()
        for _ in range(20):
            daemon.submit(np.asarray([[0, 0, 1]], np.int32))
            with pytest.raises(Boom):
                daemon.flush(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
        _stop(daemon)


def test_refresh_daemon_synchronous_refresh(base_kb, small_kg):
    """``refresh()`` without the thread: drains the queue, swaps, and a
    refresh of an empty queue is a no-op artifact; ``stop()`` of a daemon
    never started returns at once."""
    srv = KGServer(base_kb, max_batch=4, max_wait_us=100)
    daemon = RefreshDaemon(srv, epochs=1, seed=2)
    try:
        daemon.submit(_delta(small_kg, n_old=3, n_new_ent=0))
        kb2 = daemon.refresh()
        assert srv.tenant_fingerprint() == kb2.fingerprint()
        assert daemon.refresh().fingerprint() == kb2.fingerprint()
        assert (daemon.refreshes, daemon.triples_applied) == (2, 3)
        assert daemon.flush(timeout=TIMEOUT)
    finally:
        _stop(daemon)
        srv.stop()
