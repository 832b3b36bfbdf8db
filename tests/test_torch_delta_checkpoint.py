"""The port's delta checkpoint chains (``train/checkpoint.py``'s
``save_delta`` / ``chain_*`` / ``load_tree``, ``AsyncSaver.
save_delta_async`` and ``KnowledgeBase.load_chain``), mirroring
``tests/test_delta_checkpoint.py`` test for test, plus chains across the
two packages both ways.

Contracts:

  * **Round trip**: base + N deltas replays to exactly the artifact the
    Nth update produced (tables bitwise, graph and artifact fingerprint),
    every link checked both ways.
  * **Fail fast**: a delta saved against a directory holding an
    unrelated base refuses before any byte lands (sync and async), a
    broken or reordered chain refuses at load, ``restore()`` refuses
    delta steps, and ``OnlineUpdater`` refuses staleness > 0.
  * **Across the packages**: a chain the reference wrote replays in the
    port to the reference's tip fingerprint and tables, and a chain the
    port wrote replays in the reference to the port's.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from repro import kg as ref_kg
from repro.data import kg as ref_kg_lib
from repro.kb import KnowledgeBase as RefKnowledgeBase
from repro.train import checkpoint as ref_ckpt
from repro_torch import kg as port_kg
from repro_torch.kb import KnowledgeBase
from repro_torch.online import OnlineUpdater
from repro_torch.train import checkpoint as ckpt_lib

from test_torch_parity_helpers import port_graph

pytestmark = pytest.mark.filterwarnings("ignore:batch_size=")


@pytest.fixture(scope="module")
def ref_graph():
    return ref_kg_lib.synthetic_kg(1, n_entities=50, n_relations=6,
                                   n_triplets=400)


@pytest.fixture(scope="module")
def small_kg(ref_graph):
    return port_graph(ref_graph)


def _fit_kw(graph):
    return dict(model="transe", epochs=2, seed=0, pipeline="device",
                n_workers=2, batch_size=len(graph.train) // 2, dim=8)


@pytest.fixture(scope="module")
def base_kb(small_kg):
    return port_kg.fit(small_kg, device="cpu", **_fit_kw(small_kg)).kb


@pytest.fixture(scope="module")
def ref_base_kb(ref_graph):
    return ref_kg.fit(ref_graph, **_fit_kw(ref_graph)).kb


def _delta(small_kg, n, seed, n_new=0):
    rng = np.random.default_rng(seed)
    E, R = small_kg.n_entities, small_kg.n_relations
    rows = np.stack([rng.integers(0, E, n), rng.integers(0, R, n),
                     rng.integers(0, E, n)], 1)
    new = np.stack([np.arange(E, E + n_new), rng.integers(0, R, n_new),
                    rng.integers(0, E, n_new)], 1) if n_new else \
        np.zeros((0, 3), np.int64)
    return np.concatenate([rows, new]).astype(np.int32)


def _same_tables(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert np.array_equal(np.asarray(a[name]), np.asarray(b[name])), name


def test_chain_round_trip(base_kb, small_kg, tmp_path):
    chain = str(tmp_path / "chain")
    kb1 = base_kb.update(_delta(small_kg, 8, 0, n_new=1), epochs=2,
                         seed=3, delta_dir=chain)
    kb2 = kb1.update(_delta(small_kg, 6, 1), epochs=2, seed=4,
                     delta_dir=chain)

    assert ckpt_lib.chain_steps(chain) == [0, 1, 2]
    assert ckpt_lib.chain_tip_fingerprint(chain) == kb2.fingerprint()

    re = KnowledgeBase.load_chain(chain, device="cpu")
    assert re.fingerprint() == kb2.fingerprint()
    for name in kb2.params:
        assert torch.equal(re.params[name], kb2.params[name])
    assert re.graph.fingerprint() == kb2.graph.fingerprint()
    assert re.n_entities == small_kg.n_entities + 1
    assert re.meta["updates"] == 2


def test_delta_stores_only_touched_rows(base_kb, small_kg, tmp_path):
    """The delta step ships changed and appended rows, not whole tables,
    and its manifest names the base it applies to."""
    chain = str(tmp_path / "chain")
    base_kb.update(_delta(small_kg, 5, 0), epochs=1, seed=3,
                   delta_dir=chain)
    tree, extra = ckpt_lib.load_tree(chain, 1)
    n_stored = np.asarray(tree["rows"]["ent"]["idx"]).size
    assert 0 < n_stored < base_kb.n_entities
    assert extra["base"] == base_kb.fingerprint()
    assert extra["kind"] == ckpt_lib.DELTA_KIND == ref_ckpt.DELTA_KIND


def test_broken_chain_refuses(base_kb, small_kg, tmp_path):
    """Deleting a middle link (or reordering) breaks the base -> result
    fingerprint chain and load_chain refuses."""
    chain = str(tmp_path / "chain")
    kb1 = base_kb.update(_delta(small_kg, 8, 0), epochs=1, seed=3,
                         delta_dir=chain)
    kb1.update(_delta(small_kg, 6, 1), epochs=1, seed=4, delta_dir=chain)
    shutil.rmtree(os.path.join(chain, "step_0000000001"))
    with pytest.raises(ValueError, match="fingerprint|chain"):
        KnowledgeBase.load_chain(chain, device="cpu")


def test_unrelated_base_fails_fast(base_kb, small_kg, tmp_path):
    """Saving a delta into a directory holding an unrelated base artifact
    refuses on the manifest fingerprint before writing anything."""
    other = str(tmp_path / "other")
    kb1 = base_kb.update(_delta(small_kg, 5, 0), epochs=1, seed=3)
    base_kb.save(other)
    with pytest.raises(ValueError, match="unrelated|chain tip"):
        kb1.update(_delta(small_kg, 4, 1), epochs=1, seed=4,
                   delta_dir=other)
    assert ckpt_lib.chain_steps(other) == [0]         # nothing landed


def test_empty_dir_needs_base_via_save_delta(tmp_path):
    with pytest.raises(FileNotFoundError, match="base"):
        ckpt_lib.save_delta(
            str(tmp_path / "nope"), {"rows": {}},
            {"delta": True, "base": "aa", "result": "bb"})


def test_save_delta_validates_manifest_keys(tmp_path):
    with pytest.raises(ValueError, match="result"):
        ckpt_lib.save_delta(str(tmp_path), {"rows": {}},
                            {"delta": True, "base": "aa"})


def test_async_saver_delta_fails_fast(base_kb, tmp_path):
    """save_delta_async checks the chain tip in the caller's frame, not
    at a later wait(); the happy path round-trips through the thread."""
    d = str(tmp_path / "base")
    base_kb.save(d)
    saver = ckpt_lib.AsyncSaver()
    with pytest.raises(ValueError, match="chain tip"):
        saver.save_delta_async(
            d, {"rows": {}},
            {"delta": True, "base": "not-the-tip", "result": "x"})

    fp = base_kb.fingerprint()
    saver.save_delta_async(
        d, {"rows": {}, "graph": {"train": np.zeros((0, 3), np.int32)}},
        {"delta": True, "base": fp, "result": fp, "model": "transe",
         "n_entities": base_kb.n_entities,
         "n_relations": base_kb.n_relations, "tables": {}})
    saver.wait()
    assert ckpt_lib.chain_steps(d) == [0, 1]


def test_restore_refuses_delta_steps(base_kb, small_kg, tmp_path):
    """restore() (and so fit(resume=True)) never starts from a delta
    step, in the reference's words; the chain replays only through
    load_chain, and its base step is still a plain artifact."""
    chain = str(tmp_path / "chain")
    base_kb.update(_delta(small_kg, 5, 0), epochs=1, seed=3,
                   delta_dir=chain)
    with pytest.raises(ValueError, match="load_chain") as port_err:
        ckpt_lib.restore(chain)
    with pytest.raises(ValueError, match="load_chain") as ref_err:
        ref_ckpt.restore(chain)
    assert str(port_err.value) == str(ref_err.value)
    step, tree, extra = ckpt_lib.restore(chain, step=0)
    assert step == 0 and extra["kind"] == "knowledge_base"


def test_updater_refuses_staleness(base_kb):
    with pytest.raises(ValueError, match="staleness"):
        OnlineUpdater(base_kb, staleness=1)


def test_manifest_fingerprint_recorded_on_save(base_kb, tmp_path):
    """KnowledgeBase.save stamps its fingerprint into the manifest, the
    anchor every chain hangs off."""
    d = str(tmp_path / "kb")
    base_kb.save(d)
    assert ckpt_lib.chain_tip_fingerprint(d) == base_kb.fingerprint()
    _, _, extra = ckpt_lib.restore(d)
    assert extra["fingerprint"] == base_kb.fingerprint()


def test_chain_helpers_match_reference(base_kb, small_kg, tmp_path):
    """``chain_steps``, ``chain_tip_fingerprint``, ``latest_step`` and
    ``load_tree`` read a chain as the reference's do; an empty directory
    has no tip, and an artifact without a fingerprint refuses to anchor
    a chain."""
    chain = str(tmp_path / "chain")
    assert ckpt_lib.chain_tip_fingerprint(chain) is None
    assert ckpt_lib.chain_steps(chain) == []
    base_kb.update(_delta(small_kg, 5, 2), epochs=1, seed=3,
                   delta_dir=chain)
    assert ckpt_lib.chain_steps(chain) == ref_ckpt.chain_steps(chain)
    assert ckpt_lib.latest_step(chain) == ref_ckpt.latest_step(chain) == 1
    assert ckpt_lib.chain_tip_fingerprint(chain) == \
        ref_ckpt.chain_tip_fingerprint(chain)
    got, got_extra = ckpt_lib.load_tree(chain, 1)
    want, want_extra = ref_ckpt.load_tree(chain, 1)
    assert got_extra == want_extra
    for name in want["rows"]:
        for key in ("idx", "vals"):
            assert np.array_equal(got["rows"][name][key],
                                  want["rows"][name][key])
    bare = str(tmp_path / "bare")
    ckpt_lib.save(bare, 0, {"w": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="no fingerprint|carries no"):
        ckpt_lib.chain_tip_fingerprint(bare)
    with pytest.raises(FileExistsError):
        ckpt_lib.save_delta(chain, {"rows": {}},
                            {"delta": True, "base": got_extra["result"],
                             "result": "x"}, step=1)


def test_reference_chain_loads_in_port(ref_base_kb, ref_graph, tmp_path):
    """A chain the reference wrote (base + 2 updates) replays in the port
    to the reference's tip fingerprint, tables bitwise, graph equal."""
    chain = str(tmp_path / "chain")
    kb1 = ref_base_kb.update(_delta(ref_graph, 8, 0, n_new=1), epochs=2,
                             seed=3, delta_dir=chain)
    kb2 = kb1.update(_delta(ref_graph, 6, 1, n_new=1), epochs=1, seed=4,
                     delta_dir=chain)
    re = KnowledgeBase.load_chain(chain, device="cpu")
    assert re.fingerprint() == kb2.fingerprint() == \
        ckpt_lib.chain_tip_fingerprint(chain)
    _same_tables({n: t.numpy() for n, t in re.params.items()}, kb2.params)
    assert re.graph.fingerprint() == kb2.graph.fingerprint()
    # and the port appends to it: a port update of the replayed tip
    kb3 = re.update(_delta(ref_graph, 4, 2), epochs=1, seed=5,
                    delta_dir=chain)
    assert ckpt_lib.chain_steps(chain) == [0, 1, 2, 3]
    assert RefKnowledgeBase.load_chain(chain).fingerprint() == \
        kb3.fingerprint()


def test_port_chain_loads_in_reference(base_kb, small_kg, tmp_path):
    """A chain the port wrote replays in the reference to the port's tip
    fingerprint, tables bitwise; the port's async delta save writes what
    the reference reads too."""
    chain = str(tmp_path / "chain")
    kb1 = base_kb.update(_delta(small_kg, 8, 0, n_new=2), epochs=2,
                         seed=3, delta_dir=chain)
    kb2 = kb1.update(_delta(small_kg, 6, 1, n_new=1), epochs=1, seed=4,
                     delta_dir=chain)
    re = RefKnowledgeBase.load_chain(chain)
    assert re.fingerprint() == kb2.fingerprint()
    _same_tables(re.params, {n: t.numpy() for n, t in kb2.params.items()})
    assert re.graph.fingerprint() == kb2.graph.fingerprint()

    d = str(tmp_path / "async")
    base_kb.save(d)
    tree, extra = ckpt_lib.load_tree(chain, 1)
    saver = ckpt_lib.AsyncSaver()
    saver.save_delta_async(d, {"rows": {n: {k: torch.as_tensor(v)
                                            for k, v in r.items()}
                                        for n, r in tree["rows"].items()},
                               "graph": tree["graph"]}, extra)
    saver.wait()
    assert RefKnowledgeBase.load_chain(d).fingerprint() == \
        kb1.fingerprint()
