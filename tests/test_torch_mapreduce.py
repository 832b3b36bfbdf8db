"""``repro_torch.core.mapreduce`` / ``repro_torch.kg.fit`` against the
reference's ``repro.kg.fit`` on the host pipeline (vmap backend, dense
Reduce), both on the CPU.

The two packages draw different random numbers, so the reference's draws
are replayed here from its key chain (``mapreduce.train``: one
``split(key, 3)`` per epoch into the negatives key and the merge key; the
merge key split once per table in sorted name order, each table's
priorities ``uniform(fold_in(key, w))`` per worker) and handed to the port
through ``fit(draws=...)``; both start from the reference's init tables.

Tolerance: loss history and final params at rtol/atol 1e-5.  Per step the
port takes the kernel's closed-form gradient summed in a fixed order where
the reference takes ``jax.grad`` (they agree to a few ulps), and both sum
distances in different orders; over 3 epochs of 17 steps that drift stays
near 1e-7.  A gradient whose L1 sign or hinge activity flipped on an ulp
would show as a jump far above 1e-5: none of these inputs has one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kg as ref_kg
from repro.core import merge as ref_merge
from repro.core import negative as ref_negative
from repro.core.models import get_model as ref_get_model
from repro.data import kg as ref_kg_lib
from repro_torch import kg as port_kg
from repro_torch.core import mapreduce
from repro_torch.kb import KnowledgeBase

from test_torch_parity_helpers import TINY_KG, port_graph

TOL = dict(rtol=1e-5, atol=1e-5)
EPOCHS = 3
KW = dict(dim=8, batch_size=64, n_workers=2, learning_rate=0.05)


@pytest.fixture(scope="module")
def graphs():
    ref = ref_kg_lib.synthetic_kg(0, **TINY_KG)
    return ref, port_graph(ref)


def replay_draws(graph, kcfg, mcfg, tables, seed, epochs):
    """Per epoch, the reference's negatives and (``random`` strategy) merge
    priorities, as ``fit(draws=...)`` takes them."""
    model = ref_get_model(mcfg.model)
    part = ref_kg_lib.PARTITIONERS[mcfg.partition](
        seed, graph.train, mcfg.n_workers)
    head_prob = None
    if kcfg.sampling == "bern":
        head_prob = jnp.asarray(ref_negative.bernoulli_stats(
            graph.train, graph.n_relations))
    key = jax.random.PRNGKey(seed)       # params given: no init split
    out = []
    for epoch in range(epochs):
        pos = ref_kg_lib.epoch_batches(seed, epoch, part, mcfg.batch_size)
        key, k_neg, k_merge = jax.random.split(key, 3)
        neg = np.asarray(model.make_negatives(
            k_neg, jnp.asarray(pos), kcfg, head_prob))
        priorities = None
        if mcfg.paradigm == "sgd" and mcfg.strategy == "random":
            names = sorted(tables)
            keys = jax.random.split(k_merge, len(names))
            priorities = {
                name: np.asarray(ref_merge._random_priorities(
                    k, mcfg.n_workers, tables[name].shape[0]))
                for name, k in zip(names, keys)}
        out.append((neg, priorities))
    return out


FIT_CELLS = [
    # (model, paradigm, strategy, norm, sampling, extra fit keywords)
    ("transe", "sgd", "average", "l1", "unif", {}),
    ("transe", "sgd", "average_all", "l1", "unif", {}),
    ("transe", "sgd", "random", "l1", "unif", {}),
    ("transe", "sgd", "miniloss_perkey", "l1", "unif", {}),
    ("transe", "sgd", "miniloss_global", "l1", "bern", {}),
    ("transe", "sgd", "average", "l2", "unif", {}),
    ("transe", "bgd", "average", "l1", "unif", {}),
    ("transe", "bgd", "average", "l2", "bern", {}),
    # the other models: TransH's third table through the Reduce (its
    # relation touch stats under miniloss_perkey), DistMult under BGD
    ("transh", "sgd", "average", "l1", "unif", {}),
    ("transh", "sgd", "miniloss_perkey", "l1", "unif", {}),
    ("distmult", "bgd", "average", "l1", "unif", {}),
    # joint negatives: a capped pool under SGD, the full pool under BGD
    ("transe", "sgd", "average", "l2", "unif",
     dict(negatives="joint", neg_candidates=8)),
    ("transe", "bgd", "average", "l1", "unif", dict(negatives="joint")),
]


def _fit_id(cell):
    model, *rest, extra = cell
    parts = ([] if model == "transe" else [model]) + list(rest)
    if extra:
        parts.append(f"joint{extra.get('neg_candidates', 0)}")
    return "-".join(parts)


@pytest.mark.filterwarnings("ignore:batch_size=64 does not divide")
@pytest.mark.parametrize("model,paradigm,strategy,norm,sampling,extra",
                         FIT_CELLS, ids=[_fit_id(c) for c in FIT_CELLS])
def test_fit_matches_reference(graphs, model, paradigm, strategy, norm,
                               sampling, extra):
    ref_graph, graph = graphs
    kw = dict(KW, strategy=strategy, norm=norm, sampling=sampling, **extra)
    kcfg, mcfg = ref_kg.make_configs(ref_graph, model, paradigm, **kw)
    init = ref_get_model(model).init_params(jax.random.PRNGKey(1), kcfg)
    tables = {name: np.asarray(t) for name, t in init.items()}
    want = ref_kg.fit(ref_graph, model, paradigm, epochs=EPOCHS, seed=0,
                      params=init, **kw)
    draws = replay_draws(ref_graph, kcfg, mcfg, tables, 0, EPOCHS)
    got = port_kg.fit(graph, model, paradigm, epochs=EPOCHS, seed=0,
                      params=tables, device="cpu",
                      draws=lambda epoch: draws[epoch], **kw)
    np.testing.assert_allclose(got.loss_history, want.loss_history, **TOL)
    for name in tables:
        np.testing.assert_allclose(got.params[name].numpy(),
                                   np.asarray(want.params[name]), **TOL)
    assert got.epochs_run == EPOCHS and got.model == model


@pytest.mark.filterwarnings("ignore:batch_size=64 does not divide")
def test_fit_own_draws_deterministic(graphs):
    """The port's own draws: one seed gives the same run twice; the result
    carries a KnowledgeBase that evaluates."""
    _, graph = graphs
    seen = []
    runs = [port_kg.fit(graph, epochs=2, seed=seed, device="cpu",
                        callback=lambda e, loss: seen.append((e, loss)),
                        **KW) for seed in (4, 4, 5)]
    a, b, c = runs
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name])
    assert a.loss_history == b.loss_history != c.loss_history
    assert seen[:2] == list(enumerate(a.loss_history))
    assert isinstance(a.kb, KnowledgeBase) and a.kb.graph is graph
    assert a.kb.meta == {"paradigm": "sgd", "epochs": 2, "seed": 4,
                         "dim": 8}
    metrics = port_kg.evaluate(a.kb, engine="device")
    assert metrics["entity_filtered"]["n"] == 2 * len(graph.test)


def test_epoch_draws_are_pure_in_seed_and_epoch():
    draw = lambda s, e, stream: torch.rand(
        4, generator=mapreduce.epoch_generator(s, e, stream))
    assert torch.equal(draw(0, 3, 0), draw(0, 3, 0))
    assert not torch.equal(draw(0, 3, 0), draw(0, 2, 0))
    assert not torch.equal(draw(0, 3, 0), draw(0, 3, 1))
    assert not torch.equal(draw(0, 3, 0), draw(1, 3, 0))


@pytest.mark.parametrize("option,exc,match", [
    (dict(merge_transport="sparse", staleness=1, pipeline="device",
          backend="shard_map"), NotImplementedError, "item 12d"),
    (dict(merge_transport="sparse", backend="shard_map"), ValueError,
     "shard_map backend needs a mesh"),
    (dict(backend="shard_map"), ValueError, "shard_map backend needs a mesh"),
    (dict(table_sharding="sharded", merge_transport="sparse",
          backend="shard_map"), NotImplementedError, "item 12d"),
    (dict(staleness=1, pipeline="device", backend="shard_map"),
     NotImplementedError, "item 12d"),
    (dict(negatives="joint", merge_transport="sparse", staleness=1,
          pipeline="device", mesh=object()), TypeError, "DeviceMesh"),
    (dict(mesh=object()), TypeError, "DeviceMesh"),
])
def test_options_not_ported(graphs, option, exc, match):
    """The shard_map backend runs (``test_torch_shard_map.py``); without a
    mesh it raises the reference's ``ValueError``, a mesh that is no
    ``DeviceMesh`` a ``TypeError``, and what is left of item 12 (its part
    d: staleness and sharded tables over a mesh) names item 12d."""
    _, graph = graphs
    with pytest.raises(exc, match=match):
        port_kg.fit(graph, epochs=1, device="cpu", **dict(KW, **option))


@pytest.mark.parametrize("option,match", [
    (dict(checkpoint_every=1), "need ckpt_dir"),
    (dict(resume=True), "need ckpt_dir"),
    (dict(keep_checkpoints=5), "need ckpt_dir"),
    (dict(patience=2), "pass eval_every"),
    (dict(eval_metric="entity_raw.mrr"), "pass eval_every"),
    (dict(keep_best=False), "pass eval_every"),
    (dict(resume=True, ckpt_dir="ckpt", params={}), "not both"),
])
def test_option_needs_its_switch(graphs, option, match):
    """The in-training evaluation and checkpoint options of the reference,
    ported with its checks: an option of either loop without the switch
    that turns the loop on would be ignored, and raises."""
    _, graph = graphs
    with pytest.raises(ValueError, match=match):
        port_kg.fit(graph, epochs=1, device="cpu", **dict(KW, **option))


@pytest.mark.parametrize("bad", [dict(paradigm="adam"),
                                 dict(strategy="median"),
                                 dict(partition="hash"),
                                 dict(staleness=-1)])
def test_bad_config_values(graphs, bad):
    _, graph = graphs
    kw = dict(KW, **bad)
    paradigm = kw.pop("paradigm", "sgd")
    with pytest.raises(ValueError):
        port_kg.make_configs(graph, "transe", paradigm, **kw)


def test_batching_rules(graphs):
    _, graph = graphs
    with pytest.raises(ValueError, match="zero steps"):
        port_kg.fit(graph, epochs=1, device="cpu", **dict(KW,
                                                          batch_size=5000))
    with pytest.raises(ValueError, match="does not divide"):
        port_kg.fit(graph, epochs=1, device="cpu", strict_batching=True,
                    **KW)
    with pytest.warns(UserWarning, match="does not divide"):
        port_kg.fit(graph, epochs=1, device="cpu", **KW)
    with pytest.raises(ValueError, match="tables"):
        port_kg.fit(graph, epochs=1, device="cpu",
                    params={"ent": np.zeros((300, 8), np.float32)}, **KW)
