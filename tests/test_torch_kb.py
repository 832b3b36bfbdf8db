"""``KnowledgeBase`` artifacts cross between the packages both ways, and
the port's query engine answers as the reference's does: identical top-k
ids, energies at rtol/atol 1e-6 (summation order, see
test_torch_models.py), identical ranks.  Also the port's checkpoint
format against the reference's."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kb as ref_kb_lib
from repro import kg as ref_kg
from repro.core.models import get_model as ref_get_model
from repro.core.models.base import KGConfig as RefKGConfig
from repro.train import checkpoint as ref_ckpt
from repro_torch import convert, kg as port_kg
from repro_torch.kb import KnowledgeBase
from repro_torch.train import checkpoint as port_ckpt

from test_torch_parity_helpers import DIM, port_graph, ref_tables
from test_torch_rank_worker import single_rank_mesh

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def kbs(tiny_kg, tmp_path_factory):
    """(reference KB, the port's load of its saved artifact)."""
    tables = ref_tables(tiny_kg.n_entities, tiny_kg.n_relations, DIM)
    ref = ref_kb_lib.KnowledgeBase(
        model="transe", params={k: jnp.asarray(v) for k, v in tables.items()},
        graph=tiny_kg, meta={"seed": 0})
    path = tmp_path_factory.mktemp("ref_kb")
    ref.save(str(path))
    return ref, KnowledgeBase.load(str(path), device="cpu")


def _same_answer(got, want):
    np.testing.assert_array_equal(got.ids, want.ids)
    assert got.ids.dtype == np.int32
    np.testing.assert_allclose(got.energies, want.energies, **TOL)


def test_reference_artifact_loads_with_same_fingerprint(kbs):
    ref, port = kbs
    assert port.fingerprint() == ref.fingerprint()
    assert port.params["ent"].device.type == "cpu"
    assert port.meta == {"seed": 0}
    assert port.graph.fingerprint() == ref.graph.fingerprint()


@pytest.mark.parametrize("filtered", [False, True])
def test_entity_queries_identical(kbs, filtered):
    ref, port = kbs
    test = ref.graph.test[:70]
    h, r, t = test[:, 0], test[:, 1], test[:, 2]
    _same_answer(port.query_tails(h, r, k=12, filtered=filtered),
                 ref.query_tails(h, r, k=12, filtered=filtered))
    _same_answer(port.query_heads(t, r, k=12, filtered=filtered, chunk=32),
                 ref.query_heads(t, r, k=12, filtered=filtered, chunk=32))


def test_relation_queries_and_scores(kbs):
    ref, port = kbs
    test = ref.graph.test[:50]
    h, r, t = test[:, 0], test[:, 1], test[:, 2]
    _same_answer(port.query_relations(h, t, k=4),
                 ref.query_relations(h, t, k=4))
    # k beyond the relation count is cut to it, as in the reference
    assert port.query_relations(h[:3], t[:3], k=50).ids.shape == (3, 6)
    np.testing.assert_allclose(port.score(h, r, t), ref.score(h, r, t),
                               **TOL)
    np.testing.assert_allclose(port.score(3, 1, [4, 5]),
                               ref.score(3, 1, [4, 5]), **TOL)


@pytest.mark.parametrize("side", ["tail", "head"])
def test_rank_exact(kbs, side):
    ref, port = kbs
    test = ref.graph.test
    tails, heads = ref.graph.eval_filter_candidates()
    masks = tails if side == "tail" else heads
    for cand in (None, masks):
        np.testing.assert_array_equal(
            port.engine().rank(test, side, cand_masks=cand),
            ref.engine().rank(test, side, cand_masks=cand))


def test_port_artifact_loads_in_reference(kbs, tmp_path):
    ref, port = kbs
    path = tmp_path / "port_kb"
    port.save(str(path))
    back = ref_kb_lib.KnowledgeBase.load(str(path))
    assert back.fingerprint() == port.fingerprint() == ref.fingerprint()
    assert back.meta == ref.meta and back.norm == ref.norm
    test = ref.graph.test[:20]
    _same_answer(port.query_tails(test[:, 0], test[:, 1], filtered=True),
                 back.query_tails(test[:, 0], test[:, 1], filtered=True))
    # the port reads its own artifact back the same
    again = KnowledgeBase.load(str(path), device="cpu")
    assert again.fingerprint() == port.fingerprint()


def test_top_k_ties_go_to_the_lowest_id(kbs):
    """Entities with identical rows tie in energy; both engines list them
    by ascending id, wherever the rows sit in the table."""
    ref, _ = kbs
    tables = {k: np.array(v) for k, v in ref.params.items()}
    h, r = 7, 2
    q = tables["ent"][h] + tables["rel"][r]
    twins = [250, 3, 150, 77, 299]
    tables["ent"][twins] = q                     # energy 0 for each twin
    tables["ent"][[11, 12]] = tables["ent"][10]  # a tie further down
    ref_t = ref_kb_lib.KnowledgeBase(
        model="transe",
        params={k: jnp.asarray(v) for k, v in tables.items()},
        graph=ref.graph)
    port_t = convert.kb_from_reference(tables, "transe", ref.graph,
                                       device="cpu")
    assert port_t.fingerprint() == ref_t.fingerprint()
    got = port_t.query_tails([h], [r], k=8)
    np.testing.assert_array_equal(got.ids[0, :5], sorted(twins))
    np.testing.assert_array_equal(got.energies[0, :5], 0.0)
    _same_answer(got, ref_t.query_tails([h], [r], k=8))
    heads = [10, 11, 12, 40]
    _same_answer(port_t.query_tails(heads, [0] * 4, k=300),
                 ref_t.query_tails(heads, [0] * 4, k=300))


def test_evaluate_matches_reference(kbs):
    ref, port = kbs
    want = ref.evaluate()
    # inject the reference's triplet-classification draws
    port.graph._tc_negatives[0] = ref.graph.tc_negatives(0)
    assert port_kg.evaluate(port, engine="device") == want
    assert port.evaluate() == want
    assert port_kg.evaluate(port.params, "transe", port_graph(ref.graph),
                            engine="host") == want
    assert port_kg.models() == ref_kg.models()


@pytest.mark.parametrize("model,norm", [("transh", "l2"),
                                        ("distmult", "l1")])
def test_other_models_artifact_answers_as_the_reference(
        tiny_kg, tmp_path, model, norm):
    """A reference TransH or DistMult artifact loads in the port (its
    third table included) and answers as the reference does: top-k ids
    exact, energies at 1e-6, ranks and the evaluation's metric dict
    exact, on the device engine and the host protocol; a
    ``kb_from_reference`` of the same tables is the same artifact."""
    params = ref_get_model(model).init_params(
        jax.random.PRNGKey(4), RefKGConfig(tiny_kg.n_entities,
                                            tiny_kg.n_relations, DIM))
    ref = ref_kb_lib.KnowledgeBase(model=model, params=params,
                                   graph=tiny_kg, norm=norm)
    ref.save(str(tmp_path))
    port = KnowledgeBase.load(str(tmp_path), device="cpu")
    assert port.model.name == model and port.norm == norm
    assert sorted(port.params) == sorted(params)
    assert port.fingerprint() == ref.fingerprint()
    tables = {k: np.asarray(v) for k, v in params.items()}
    assert convert.kb_from_reference(
        tables, model, tiny_kg, norm=norm,
        device="cpu").fingerprint() == ref.fingerprint()
    test = ref.graph.test[:60]
    h, r, t = test[:, 0], test[:, 1], test[:, 2]
    _same_answer(port.query_tails(h, r, k=10, filtered=True),
                 ref.query_tails(h, r, k=10, filtered=True))
    _same_answer(port.query_heads(t, r, k=10, chunk=16),
                 ref.query_heads(t, r, k=10, chunk=16))
    _same_answer(port.query_relations(h, t, k=3),
                 ref.query_relations(h, t, k=3))
    np.testing.assert_allclose(port.score(h, r, t), ref.score(h, r, t),
                               **TOL)
    tails, _ = ref.graph.eval_filter_candidates()
    np.testing.assert_array_equal(
        port.engine().rank(test, "tail", cand_masks=tails[:60]),
        ref.engine().rank(test, "tail", cand_masks=tails[:60]))
    port.graph._tc_negatives[0] = ref.graph.tc_negatives(0)
    want = ref.evaluate()
    assert port_kg.evaluate(port, engine="device") == want
    assert port_kg.evaluate(port, engine="host") == want


def test_artifact_without_graph(kbs, tmp_path):
    _, port = kbs
    path = tmp_path / "no_graph"
    port.save(str(path), include_graph=False)
    bare = KnowledgeBase.load(str(path), device="cpu")
    assert bare.graph is None
    with pytest.raises(ValueError, match="filtered=True needs the graph"):
        bare.query_tails([1], [0], filtered=True)
    with pytest.raises(ValueError, match="graph"):
        bare.evaluate()
    assert bare.query_tails([1], [0], k=3).ids.shape == (1, 3)


def test_load_refuses_other_checkpoints(tmp_path):
    port_ckpt.save(str(tmp_path), 0, {"w": np.zeros(3, np.float32)},
                   extra={"kind": "kg_train"})
    with pytest.raises(ValueError, match="kind"):
        KnowledgeBase.load(str(tmp_path), device="cpu")


def test_checkpoint_format_matches_reference(tmp_path):
    """Same tree, same npz keys and arrays, same manifest — whether a leaf
    is a numpy array or a tensor."""
    rel = np.arange(6, dtype=np.float32).reshape(2, 3)
    ref_tree = {"params": {"rel": rel, "ent": np.ones((4, 3), np.float32)},
                "graph": {"test": np.zeros((2, 3), np.int32)},
                "pair": [np.ones(2), np.zeros(1)]}
    port_tree = dict(ref_tree, params={"rel": rel, "ent": torch.ones(4, 3)})
    extra = {"kind": "x", "fingerprint": "abc"}
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save(ref_dir, 5, ref_tree, extra=extra)
    port_ckpt.save(port_dir, 5, port_tree, extra=extra)
    step_dir = "step_0000000005"
    with np.load(os.path.join(ref_dir, step_dir, "arrays.npz")) as r, \
            np.load(os.path.join(port_dir, step_dir, "arrays.npz")) as p:
        assert sorted(p.files) == sorted(r.files)
        assert "params::params/ent" in p.files
        for key in r.files:
            np.testing.assert_array_equal(p[key], r[key])
            assert p[key].dtype == r[key].dtype
    manifests = []
    for d in (ref_dir, port_dir):
        with open(os.path.join(d, step_dir, "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    # the port restores the reference's checkpoint
    step, params, got_extra = port_ckpt.restore(
        ref_dir, expect={"kind": "x"})
    assert step == 5 and got_extra == extra
    np.testing.assert_array_equal(params["params"]["ent"], np.ones((4, 3)))
    np.testing.assert_array_equal(params["pair"]["1"], np.zeros(1))
    tree_back, extra_back = port_ckpt.load_tree(ref_dir, 5)
    np.testing.assert_array_equal(tree_back["params"]["rel"], rel)
    assert extra_back == extra
    with pytest.raises(ValueError, match="fingerprint"):
        port_ckpt.validate_extra(extra, {"fingerprint": "zzz"}, "here")


def test_checkpoint_steps_and_refusals(tmp_path):
    d = str(tmp_path)
    assert port_ckpt.latest_step(d + "/missing") is None
    with pytest.raises(FileNotFoundError):
        port_ckpt.restore(d)
    for step in (1, 2, 3, 4):
        port_ckpt.save(d, step, {"w": np.full(1, step, np.float32)},
                       extra={"fingerprint": f"fp{step}"}, keep=2)
    assert sorted(os.listdir(d)) == ["step_0000000003", "step_0000000004"]
    assert port_ckpt.latest_step(d) == 4
    step, params, _ = port_ckpt.restore(d)
    assert step == 4 and params["w"][0] == 4
    # a delta step of a reference delta chain is refused, not misread
    ref_ckpt.save_delta(d, {"rows": {}}, {"delta": True, "base": "fp4",
                                          "result": "fp5"})
    with pytest.raises(ValueError, match="delta"):
        port_ckpt.restore(d)


# (model, norm) cells of the bf16 serving test; TransE's keep their ids
BF16_CELLS = {"l1": ("transe", "l1"), "l2": ("transe", "l2"),
              "transh-l1": ("transh", "l1"), "transh-l2": ("transh", "l2"),
              "distmult": ("distmult", "l1")}


@pytest.fixture(scope="module")
def bf16_kbs(tiny_kg):
    """(reference KB, port KB) over the same tables cast to bf16, per cell
    of ``BF16_CELLS``: TransE over ``ref_tables``, TransH and DistMult over
    the reference's own init under ``PRNGKey(0)``."""
    out = {}
    for cell, (model, norm) in BF16_CELLS.items():
        if model == "transe":
            tables = ref_tables(tiny_kg.n_entities, tiny_kg.n_relations, DIM)
        else:
            tables = {name: np.asarray(t) for name, t in ref_get_model(
                model).init_params(jax.random.PRNGKey(0), RefKGConfig(
                    tiny_kg.n_entities, tiny_kg.n_relations, DIM)).items()}
        out[cell] = (
            ref_kb_lib.KnowledgeBase(
                model=model, graph=tiny_kg, norm=norm,
                params={k: jnp.asarray(v, jnp.bfloat16)
                        for k, v in tables.items()}),
            convert.kb_from_reference(tables, model, tiny_kg, norm=norm,
                                      device="cpu", dtype=torch.bfloat16))
    return out


def _same_bf16_answer(got, want):
    """Identical ids; energies widened to float32, which holds the
    reference's bf16 values exactly."""
    np.testing.assert_array_equal(got.ids, want.ids)
    assert got.energies.dtype == np.float32
    np.testing.assert_array_equal(got.energies,
                                  np.asarray(want.energies, np.float32))


@pytest.mark.parametrize("cell", list(BF16_CELLS))
def test_bf16_tables_serve_as_in_the_reference(bf16_kbs, cell):
    """Every served form of every model: the reference's bf16 arithmetic
    on the CPU (XLA rounds each elementwise result to bf16, except a
    product that feeds a sum; sums run in float32), bit for bit."""
    ref, port = bf16_kbs[cell]
    test = ref.graph.test
    h, r, t = test[:, 0], test[:, 1], test[:, 2]
    _same_bf16_answer(port.query_tails(h, r, k=10),
                      ref.query_tails(h, r, k=10))
    _same_bf16_answer(port.query_heads(t, r, k=10, filtered=True),
                      ref.query_heads(t, r, k=10, filtered=True))
    _same_bf16_answer(port.query_relations(h, t, k=3),
                      ref.query_relations(h, t, k=3))
    got = port.score(h, r, t)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(ref.score(h, r, t),
                                                  np.float32))
    assert port.fingerprint() == ref.fingerprint()


def test_bf16_save_writes_the_reference_bytes(bf16_kbs, tmp_path):
    """A bf16 table is saved as the reference saves it: its raw 2-byte
    values, which numpy reads back as ``|V2`` in both cases.  Neither
    package can serve that after a load: the reference loads it and
    fails at the first query, the port refuses it at load."""
    ref, port = bf16_kbs["l1"]
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref.save(ref_dir)
    port.save(port_dir)
    npz = lambda d: np.load(os.path.join(d, "step_0000000000",
                                         "arrays.npz"))
    with npz(ref_dir) as r, npz(port_dir) as p:
        assert sorted(p.files) == sorted(r.files)
        for key in r.files:
            assert p[key].dtype == r[key].dtype
            assert p[key].tobytes() == r[key].tobytes()
        assert p["params::params/ent"].dtype == np.dtype("V2")
    for d in (ref_dir, port_dir):
        with open(os.path.join(d, "step_0000000000", "manifest.json")) as f:
            assert json.load(f)["extra"]["fingerprint"] == ref.fingerprint()
    back = ref_kb_lib.KnowledgeBase.load(port_dir)
    assert back.params["ent"].dtype == np.dtype("V2")
    for d in (ref_dir, port_dir):
        with pytest.raises(ValueError, match="raw 2-byte values"):
            KnowledgeBase.load(d, device="cpu")


@pytest.mark.parametrize("call", [
    lambda kb: kb.query_tails([1], [1], k=-1),
    lambda kb: kb.query_heads([1], [1], k=-1),
    lambda kb: kb.query_relations([1], [2], k=-1),
], ids=["tails", "heads", "relations"])
def test_negative_k_raises_as_in_the_reference(kbs, call):
    ref, port = kbs
    with pytest.raises(ValueError, match="nonnegative"):
        call(ref)
    with pytest.raises(ValueError, match="nonnegative"):
        call(port)
    # k = 0 stays the port's empty answer (the reference cannot reshape it)
    assert port.query_tails([1, 2], [1, 1], k=0).ids.shape == (2, 0)


def test_engine_takes_the_reference_keywords(kbs, tmp_path):
    """``KnowledgeBase.engine`` accepts the reference's keywords, caches
    under the reference's key (several workers and sharded tables on the
    vmap backend included; a one-rank ``shard_map`` mesh, replicated or
    sharded, whose answers are the vmap engine's bits) and refuses what
    it does not serve: a mesh that is no ``DeviceMesh``, with sharded
    tables too, and ``shard_map`` without a mesh."""
    ref, port = kbs
    defaults = dict(n_workers=1, backend="vmap", mesh=None, chunk=None,
                    table_sharding="replicated")
    eng = port.engine(**defaults)
    assert port.engine() is eng
    assert port.engine(chunk=32) is not eng
    assert port.engine(chunk=32) is port.engine(chunk=32, n_workers=1)
    ref.engine(**defaults)
    ref.engine(chunk=32)
    for kw in ({"n_workers": 2}, {"n_workers": 3,
                                  "table_sharding": "sharded"}):
        assert port.engine(**kw) is port.engine(**kw)
        ref.engine(**kw)
    assert set(port._engines) == set(ref._engines)
    sh = port.engine(n_workers=3, table_sharding="sharded")
    assert sh.table_sharding == "sharded" and sh.n_workers == 3
    with pytest.raises(ValueError, match="table_sharding"):
        port.engine(table_sharding="diagonal")
    for kw, exc, match in (
            ({"mesh": object()}, TypeError, "DeviceMesh"),
            ({"backend": "shard_map"}, ValueError, "needs a mesh"),
            ({"n_workers": 2, "table_sharding": "sharded",
              "backend": "shard_map", "mesh": object()},
             TypeError, "DeviceMesh")):
        with pytest.raises(exc, match=match):
            port.engine(**kw)
        with pytest.raises(exc, match=match):
            port.query_tails([0], [0], k=3, **kw)
    heads, rels = np.arange(5), np.arange(5) % port.n_relations
    with single_rank_mesh(tmp_path) as mesh:
        kw = dict(n_workers=2, backend="shard_map", mesh=mesh)
        assert port.engine(**kw) is port.engine(**kw)
        assert port.engine(**kw).backend == "shard_map"
        for got, want in (
                (port.query_tails(heads, rels, k=4, **kw),
                 port.query_tails(heads, rels, k=4)),
                (port.query_relations(heads, heads, k=2, mesh=mesh,
                                      backend="shard_map"),
                 port.query_relations(heads, heads, k=2)),
                (port.query_tails(heads, rels, k=4, table_sharding="sharded",
                                  **kw),
                 port.query_tails(heads, rels, k=4, n_workers=2,
                                  table_sharding="sharded"))):
            np.testing.assert_array_equal(got.ids, want.ids)
            assert got.energies.tobytes() == want.energies.tobytes()
