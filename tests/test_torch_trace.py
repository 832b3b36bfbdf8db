"""``repro_torch.core.trace`` and ``kg.fit(eval_every=...)`` against the
reference's ``repro.core.trace`` on the host pipeline, both on the CPU.

The reference's draws are replayed into the port
(``test_torch_mapreduce.replay_draws``) and both packages start from the
reference's init tables; the port's graph carries the reference's
triplet-classification draws (``port_graph``).  Held against the
reference: boundary epochs, merge rounds, best epoch, early stop and
epochs run exactly; losses at rtol/atol 1e-5 (the training drift of
test_torch_mapreduce.py); every entry's metrics dict exactly — these
inputs flip no rank between the packages.  Between the port's own runs:
trace metrics equal a later ``kg.evaluate`` exactly, and a traced run
gives the bits of an untraced one.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import kg as ref_kg
from repro.core import trace as ref_trace
from repro.core.models import get_model as ref_get_model
from repro.data import kg as ref_kg_lib
from repro_torch import kg as port_kg
from repro_torch.core import mapreduce
from repro_torch.core import trace as trace_lib
from repro_torch.core.models import KGConfig

from test_torch_mapreduce import replay_draws
from test_torch_parity_helpers import TINY_KG, port_graph

TOL = dict(rtol=1e-5, atol=1e-5)
EPOCHS = 4
# batch 75 divides each of 2 workers' 750 triplets: no remainder warning
KW = dict(dim=8, batch_size=75, n_workers=2, learning_rate=0.05)
PARADIGMS = ("sgd", "bgd")


@pytest.fixture(scope="module")
def graphs():
    ref = ref_kg_lib.synthetic_kg(0, **TINY_KG)
    return ref, port_graph(ref)


@pytest.fixture(scope="module")
def runs(graphs):
    """Per paradigm: the reference's traced run from its init tables, the
    port's traced run on the replayed draws, and those draws."""
    ref_graph, graph = graphs
    out = {}
    for paradigm in PARADIGMS:
        kcfg, mcfg = ref_kg.make_configs(ref_graph, "transe", paradigm, **KW)
        init = ref_get_model("transe").init_params(
            jax.random.PRNGKey(1), kcfg)
        tables = {name: np.asarray(t) for name, t in init.items()}
        want = ref_kg.fit(ref_graph, "transe", paradigm, epochs=EPOCHS,
                          seed=0, params=init, eval_every=2, **KW)
        draws = replay_draws(ref_graph, kcfg, mcfg, tables, 0, EPOCHS)
        got = port_kg.fit(graph, "transe", paradigm, epochs=EPOCHS, seed=0,
                          params=tables, device="cpu", eval_every=2,
                          draws=lambda epoch, d=draws: d[epoch], **KW)
        out[paradigm] = dict(ref=want, port=got, tables=tables, draws=draws)
    return out


def _fit(graph, **kw):
    return port_kg.fit(graph, device="cpu", **dict(KW, **kw))


@pytest.mark.parametrize("paradigm", PARADIGMS)
def test_trace_matches_reference(runs, paradigm):
    want, got = runs[paradigm]["ref"], runs[paradigm]["port"]
    assert got.trace.epochs() == want.trace.epochs() == [1, 3]
    assert [e.merge_round for e in got.trace.entries] == \
        [e.merge_round for e in want.trace.entries] == [2, 4]
    assert got.best_epoch == want.best_epoch
    assert got.trace.best_epoch == want.trace.best_epoch
    assert got.trace.best_value == want.trace.best_value
    assert got.trace.stopped_early == want.trace.stopped_early is False
    assert got.epochs_run == want.epochs_run == EPOCHS
    assert (got.trace.eval_every, got.trace.metric) == \
        (want.trace.eval_every, want.trace.metric)
    np.testing.assert_allclose([e.loss for e in got.trace.entries],
                               [e.loss for e in want.trace.entries], **TOL)
    np.testing.assert_allclose(got.loss_history, want.loss_history, **TOL)
    for g, w in zip(got.trace.entries, want.trace.entries):
        assert g.metrics == w.metrics, g.epoch
    for name in got.best_params:
        np.testing.assert_allclose(got.best_params[name].numpy(),
                                   np.asarray(want.best_params[name]), **TOL)


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("paradigm", PARADIGMS)
def test_trace_matches_posthoc_evaluate(graphs, paradigm, engine):
    """Every entry equals ``kg.evaluate`` of a run stopped at its epoch,
    whichever engine scored the boundary and evaluates afterwards."""
    _, graph = graphs
    res = _fit(graph, paradigm=paradigm, epochs=EPOCHS, eval_every=2,
               eval_engine=engine)
    assert res.trace.epochs() == [1, 3]
    for entry in res.trace.entries:
        rerun = _fit(graph, paradigm=paradigm, epochs=entry.epoch + 1)
        assert port_kg.evaluate(rerun.kb, engine=engine) == entry.metrics
    assert port_kg.evaluate(res.kb, engine="host") == \
        res.trace.entries[-1].metrics


@pytest.mark.parametrize("paradigm", PARADIGMS)
def test_traced_run_equals_untraced_bitwise(graphs, paradigm):
    _, graph = graphs
    plain = _fit(graph, paradigm=paradigm, epochs=EPOCHS, seed=3)
    traced = _fit(graph, paradigm=paradigm, epochs=EPOCHS, seed=3,
                  eval_every=1)
    assert traced.loss_history == plain.loss_history
    for name in plain.params:
        assert torch.equal(traced.params[name], plain.params[name])
    assert plain.trace is None and plain.best_params is None
    assert traced.trace.epochs() == [0, 1, 2, 3]


def test_early_stopping_deterministic(graphs):
    """lr=0 freezes the params, so every evaluation repeats the same
    metrics: the first sets the best, the second does not improve, and
    patience=1 stops the run at epoch 4 — twice the same."""
    _, graph = graphs
    kw = dict(epochs=8, eval_every=2, patience=1, learning_rate=0.0)
    a, b = _fit(graph, **kw), _fit(graph, **kw)
    assert a.epochs_run == b.epochs_run == 4
    assert a.trace.stopped_early and b.trace.stopped_early
    assert len(a.loss_history) == a.epochs_run
    assert a.trace.epochs() == b.trace.epochs() == [1, 3]
    assert a.trace.values() == b.trace.values()
    assert a.best_epoch == b.best_epoch == 1
    assert a.kb.meta["epochs"] == 4


def test_best_params_are_the_best_boundary(graphs):
    """keep_best keeps the best boundary's params, bit for bit those of a
    run stopped there, though training went on after it."""
    _, graph = graphs
    res = _fit(graph, epochs=6, eval_every=1, patience=6, seed=2,
               eval_metric="entity_filtered.hits@10")
    assert res.best_epoch in res.trace.epochs()
    best = res.trace.best()
    assert best.epoch == res.best_epoch
    assert trace_lib.metric_value(best.metrics, res.trace.metric) == \
        res.trace.best_value
    rerun = _fit(graph, epochs=res.best_epoch + 1, seed=2)
    for name in rerun.params:
        assert torch.equal(res.best_params[name], rerun.params[name])


def test_keep_best_false_and_higher_is_better(graphs):
    _, graph = graphs
    res = _fit(graph, epochs=4, eval_every=2, keep_best=False)
    assert res.best_params is None and res.best_epoch is not None
    # hits@10 improves upward: with frozen params the second evaluation
    # does not improve on the first for a max-mode metric either
    res = _fit(graph, epochs=6, eval_every=2, patience=1, learning_rate=0.0,
               eval_metric="entity_filtered.hits@10")
    assert res.trace.stopped_early and res.epochs_run == 4
    assert res.best_epoch == 1


def test_wall_clock_and_losses(graphs):
    _, graph = graphs
    res = _fit(graph, epochs=EPOCHS, eval_every=1)
    walls = [e.wall_clock for e in res.trace.entries]
    assert all(b >= a >= 0 for a, b in zip(walls, walls[1:]))
    for e in res.trace.entries:
        assert e.loss == res.loss_history[e.epoch]


SPECS = ["entity_filtered.mean_rank", "entity_filtered.hits@10",
         "entity_raw.mrr", "relation_prediction.mean_rank",
         "triplet_classification_acc"]


@pytest.mark.parametrize("spec", SPECS)
def test_metric_spec_helpers_match_reference(spec):
    metrics = {"entity_filtered": {"mean_rank": 12.5, "hits@10": 0.4},
               "entity_raw": {"mrr": 0.25},
               "relation_prediction": {"mean_rank": 2.0},
               "triplet_classification_acc": 0.8}
    assert trace_lib.metric_mode(spec) == ref_trace.metric_mode(spec)
    assert trace_lib.metric_value(metrics, spec) == \
        ref_trace.metric_value(metrics, spec)


def test_metric_value_errors():
    metrics = {"entity_filtered": {"mean_rank": 12.5}}
    with pytest.raises(KeyError, match="available"):
        trace_lib.metric_value(metrics, "entity_raw.mean_rank")
    with pytest.raises(KeyError, match="no key"):
        trace_lib.metric_value(metrics, "entity_filtered.mean_rank.x")
    with pytest.raises(ValueError, match="pick a leaf"):
        trace_lib.metric_value(metrics, "entity_filtered")


@pytest.mark.parametrize("kw,match", [
    (dict(eval_every=0), "eval_every"),
    (dict(eval_every=2, patience=0), "patience"),
    (dict(eval_every=2, filtered=False), "filtered=True"),
])
def test_eval_loop_config_checks(kw, match):
    with pytest.raises(ValueError, match=match):
        ref_trace.EvalLoopConfig(**kw)
    with pytest.raises(ValueError, match=match):
        trace_lib.EvalLoopConfig(**kw)


def test_unknown_metric_fails_at_first_evaluation(graphs):
    _, graph = graphs
    with pytest.raises(KeyError, match="no key"):
        _fit(graph, epochs=2, eval_every=2, eval_metric="nope.mean_rank")


def test_jsonl_matches_reference(runs, tmp_path):
    """The port's JSONL parses key for key like the reference's; the
    values agree as the traces do, wall clock apart."""
    rows = {}
    for name in ("ref", "port"):
        path = tmp_path / f"{name}.jsonl"
        runs["sgd"][name].trace.to_jsonl(str(path))
        rows[name] = [json.loads(line)
                      for line in path.read_text().splitlines()]
    assert len(rows["port"]) == len(rows["ref"]) == 2
    for got, want in zip(rows["port"], rows["ref"]):
        assert list(got) == list(want)
        assert list(got["metrics"]) == list(want["metrics"])
        for key in ("epoch", "merge_round", "metrics"):
            assert got[key] == want[key]
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
        assert isinstance(got["wall_clock"], float)
    assert [r["epoch"] for r in rows["port"]] == \
        runs["sgd"]["port"].trace.epochs()


def test_train_accepts_eval_loop_config(graphs):
    """``mapreduce.train`` below the facade: an ``EvalLoopConfig`` with
    engine options."""
    _, graph = graphs
    cfg = mapreduce.MapReduceConfig(n_workers=2, batch_size=75)
    tcfg = KGConfig(graph.n_entities, graph.n_relations, dim=8)
    loop = trace_lib.EvalLoopConfig(eval_every=2, engine_kw={"chunk": 32})
    res = mapreduce.train(graph, tcfg, cfg, epochs=2, seed=0,
                          eval_loop=loop, device="cpu")
    assert res.trace.epochs() == [1]
    assert res.trace.entries[0].metrics == port_kg.evaluate(
        res.params, "transe", graph, engine="device")
