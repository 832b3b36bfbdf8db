"""The port's device pipeline (``kg.fit(pipeline="device")``,
``EpochSchedule``, ``make_block_fn``, ``data/kg.device_*``, the
counter-based draws of ``core/keys.py``) against the reference's
``kg.fit(pipeline="device")``, both on the CPU, and between the port's own
runs.

Against the reference: the reference's device draws are replayed from its
key chain (``_device_keys(seed)``; per epoch ``e`` the batches
``device_epoch_batches(fold_in(k_data, e), part_r, B)`` of re-partition
round ``r = e // M``, the negatives of worker ``w`` from
``fold_in(fold_in(k_neg, e), w)``, and at a merge round's last epoch the
``random`` strategy's priorities from ``split(fold_in(k_merge, e),
n_tables)``) and handed to the port through ``fit(draws=...)``; both start
from the reference's init tables.  Tolerance: loss history and params at
rtol/atol 1e-5, as on the host pipeline (``test_torch_mapreduce.py``); the
reference's epoch loss is ``jnp.mean`` over the workers where the port
sums them in worker order.

Between the port's own runs (its own draws): bitwise.
"""
import shutil
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kg as ref_kg
from repro.core import mapreduce as ref_mr
from repro.core import merge as ref_merge
from repro.core import negative as ref_negative
from repro.core.models import get_model as ref_get_model
from repro.data import kg as ref_kg_lib
from repro_torch import kg as port_kg
from repro_torch import util
from repro_torch.core import keys, mapreduce, negative
from repro_torch.core.models import KGConfig, get_model
from repro_torch.data import kg as port_kg_lib

from test_torch_parity_helpers import TINY_KG, port_graph

pytestmark = pytest.mark.filterwarnings(
    "ignore:batch_size=64 does not divide")

TOL = dict(rtol=1e-5, atol=1e-5)
EPOCHS = 4
KW = dict(dim=8, batch_size=64, n_workers=2, learning_rate=0.05,
          pipeline="device")


@pytest.fixture(scope="module")
def graphs():
    ref = ref_kg_lib.synthetic_kg(0, **TINY_KG)
    return ref, port_graph(ref)


def replay_device_draws(graph, kcfg, mcfg, tables, seed, epochs):
    """Per epoch, the reference's device-pipeline batches, negatives and
    (at a merge round's last epoch, ``random`` strategy) priorities, as
    the port's ``fit(draws=...)`` takes them."""
    model = ref_get_model(mcfg.model)
    W, B = mcfg.n_workers, mcfg.batch_size
    K, M = mcfg.schedule.merge_every, mcfg.schedule.repartition_every
    part = jnp.asarray(ref_kg_lib.PARTITIONERS[mcfg.partition](
        seed, graph.train, W))
    strata = None
    if mcfg.partition == "degree" and M is not None:
        strata = jnp.asarray(ref_kg_lib.triplet_strata(
            np.asarray(part).reshape(-1, 3), kcfg.n_entities))
    head_prob = None
    if kcfg.sampling == "bern":
        head_prob = jnp.asarray(ref_negative.bernoulli_stats(
            graph.train, graph.n_relations))
    k_data, k_neg, k_merge, k_part, _ = ref_mr._device_keys(seed)
    out = []
    for e in range(epochs):
        part_e = part
        if M is not None:
            r = e // M
            part_e = ref_kg_lib.device_repartition(
                jax.random.fold_in(k_part, r), part, r, strata)
        pos = ref_kg_lib.device_epoch_batches(
            jax.random.fold_in(k_data, e), part_e, B)
        kn = jax.random.fold_in(k_neg, e)
        neg = jnp.stack([model.make_negatives(
            jax.random.fold_in(kn, w), pos[w], kcfg, head_prob)
            for w in range(W)])
        priorities = None
        if (mcfg.paradigm == "sgd" and mcfg.strategy == "random"
                and (e + 1) % K == 0):
            names = sorted(tables)
            ks = jax.random.split(jax.random.fold_in(k_merge, e), len(names))
            priorities = {
                name: np.asarray(ref_merge._random_priorities(
                    k, W, tables[name].shape[0]))
                for name, k in zip(names, ks)}
        out.append((np.asarray(pos), np.asarray(neg), priorities))
    return out


# (paradigm, options) of the parity cells
CONFIGS = {
    "sgd-average-merge2": ("sgd", dict(strategy="average", merge_every=2,
                                       block_epochs=4)),
    "sgd-random-merge2": ("sgd", dict(strategy="random", merge_every=2,
                                      block_epochs=4)),
    "sgd-miniloss_perkey-merge2": ("sgd", dict(
        strategy="miniloss_perkey", merge_every=2, block_epochs=4)),
    "sgd-repartition2-balanced": ("sgd", dict(
        repartition_every=2, partition="balanced", block_epochs=4)),
    "sgd-repartition2-degree": ("sgd", dict(
        repartition_every=2, partition="degree", block_epochs=4)),
    "bgd-l1": ("bgd", dict(norm="l1", block_epochs=2)),
    "bgd-l2": ("bgd", dict(norm="l2", block_epochs=2)),
    # the other models (``model`` picks one; TransE otherwise): TransH's
    # third table through the per-table priorities of ``random``, and
    # DistMult under BGD; then joint negatives, bench_async's joint-48
    "transh-sgd-random-merge2": ("sgd", dict(
        model="transh", strategy="random", merge_every=2, block_epochs=4)),
    "distmult-bgd": ("bgd", dict(model="distmult", block_epochs=2)),
    "joint48-sgd-l2-merge2": ("sgd", dict(
        negatives="joint", neg_candidates=48, norm="l2", merge_every=2,
        block_epochs=4)),
    "joint-bgd-l1": ("bgd", dict(negatives="joint", block_epochs=2)),
}


@pytest.fixture(scope="module")
def reference(graphs):
    """The reference's device-pipeline runs of each parity cell from its
    own init tables, computed once per cell: ``(init tables, kw, result,
    replayed draws)``."""
    ref_graph, _ = graphs
    cache = {}

    def run(name):
        if name not in cache:
            paradigm, opts = CONFIGS[name]
            kw = dict(KW, **opts)
            model = kw.pop("model", "transe")
            kcfg, mcfg = ref_kg.make_configs(ref_graph, model, paradigm,
                                             **kw)
            init = ref_get_model(model).init_params(
                jax.random.PRNGKey(1), kcfg)
            tables = {n: np.asarray(t) for n, t in init.items()}
            want = ref_kg.fit(ref_graph, model, paradigm, epochs=EPOCHS,
                              seed=0, params=init, **kw)
            draws = replay_device_draws(ref_graph, kcfg, mcfg, tables, 0,
                                        EPOCHS)
            cache[name] = (tables, kw, want, draws)
        return cache[name]

    return run


def _close(got_params, got_history, want):
    np.testing.assert_allclose(got_history, want.loss_history, **TOL)
    for name in want.params:
        np.testing.assert_allclose(np.asarray(got_params[name]),
                                   np.asarray(want.params[name]), **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_device_pipeline_matches_reference(graphs, reference, name):
    _, graph = graphs
    tables, kw, want, draws = reference(name)
    paradigm, opts = CONFIGS[name]
    got = port_kg.fit(graph, opts.get("model", "transe"), paradigm,
                      epochs=EPOCHS, seed=0, params=tables, device="cpu",
                      draws=lambda epoch: draws[epoch], **kw)
    _close({n: t.numpy() for n, t in got.params.items()}, got.loss_history,
           want)
    assert got.epochs_run == EPOCHS == len(got.loss_history)


# ---------------------------------------------------------------------------
# Between the port's own runs: bitwise
# ---------------------------------------------------------------------------

def _fit(graph, *, epochs=EPOCHS, **kw):
    kw = dict(dict(KW, seed=0, device="cpu"), **kw)
    return port_kg.fit(graph, epochs=epochs, **kw)


def _same(a, b):
    assert a.loss_history == b.loss_history
    assert set(a.params) == set(b.params)
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name


@pytest.mark.parametrize("paradigm,opts,blocks", [
    ("sgd", {}, (1, 4)),
    ("sgd", dict(merge_every=2), (2, 4)),
    ("sgd", dict(repartition_every=2), (1, 4)),
    ("bgd", dict(repartition_every=2, partition="degree"), (1, 4)),
    ("sgd", dict(model="transh", merge_every=2, strategy="random"), (2, 4)),
    ("sgd", dict(negatives="joint", neg_candidates=48, norm="l2",
                 merge_every=2), (2, 4)),
    ("bgd", dict(model="distmult", negatives="joint"), (1, 4)),
])
def test_block_invariance(graphs, paradigm, opts, blocks):
    """How epochs are grouped into blocks changes no bit: every draw is a
    pure function of (seed, epoch)."""
    _, graph = graphs
    a, b = (_fit(graph, paradigm=paradigm, block_epochs=n, **opts)
            for n in blocks)
    _same(a, b)


def test_repartition_past_the_run_is_none(graphs):
    _, graph = graphs
    _same(_fit(graph, block_epochs=4),
          _fit(graph, block_epochs=4, repartition_every=10**6))


def test_donation_changes_nothing(graphs):
    """Results are bit-identical with donation on and off, and the caller's
    tensors are neither written nor dropped."""
    _, graph = graphs
    warm = _fit(graph, epochs=2, block_epochs=2)
    theirs = {n: t.clone() for n, t in warm.params.items()}
    on = _fit(graph, epochs=2, block_epochs=2, params=warm.params,
              donate_params=True)
    off = _fit(graph, epochs=2, block_epochs=2, params=warm.params,
               donate_params=False)
    _same(on, off)
    assert set(warm.params) == set(theirs)
    for name, t in theirs.items():
        assert torch.equal(warm.params[name], t)


def test_block_fn_takes_the_dict_it_is_given(graphs):
    """``make_block_fn(donate=True)`` empties the dict passed in (the
    driver's own) and holds no reference to its tables once they are
    broadcast, so they are freed during the round; without donation the
    caller's dict keeps them.  A block that crosses a re-partition
    boundary or splits a merge round is refused."""
    _, graph = graphs
    kcfg, mcfg = port_kg.make_configs(graph, "transe", "sgd",
                                      **dict(KW, merge_every=2,
                                             block_epochs=2,
                                             repartition_every=2))
    part = torch.as_tensor(port_kg_lib.partition_balanced(0, graph.train, 2))
    params = get_model("transe").init_params(
        torch.Generator().manual_seed(0), kcfg, device="cpu")
    alive = []

    class Spy(type(get_model("transe"))):
        def run_epoch(self, *args, **kw):
            alive.append(table() is not None)
            return super().run_epoch(*args, **kw)

    for donate in (True, False):
        given = {n: t.clone() for n, t in params.items()}
        table = weakref.ref(given["ent"])
        out, losses = mapreduce.make_block_fn(
            mcfg, kcfg, part, model=Spy(), donate=donate)(given, range(2))
        assert (given == {}) is donate and set(out) == set(params)
        assert alive == [not donate] * 2
        alive.clear()
    assert losses.shape == (2,) and losses.dtype == torch.float32
    kept = dict(params)
    block_fn = mapreduce.make_block_fn(mcfg, kcfg, part)
    block_fn(kept, range(2))
    assert kept.keys() == params.keys()
    with pytest.raises(ValueError, match="re-partition boundary"):
        block_fn(dict(params), range(4))
    with pytest.raises(ValueError, match="whole merge rounds"):
        block_fn(dict(params), range(1))


def test_traced_equals_untraced(graphs):
    _, graph = graphs
    untraced = _fit(graph, merge_every=2, block_epochs=4)
    traced = _fit(graph, merge_every=2, block_epochs=4, eval_every=2)
    _same(untraced, traced)
    assert traced.trace.epochs() == [1, 3]
    assert [e.merge_round for e in traced.trace.entries] == [1, 2]
    last = port_kg.evaluate(traced.kb, engine="device")
    assert last == traced.trace.entries[-1].metrics


def test_resume_is_bitwise(graphs, tmp_path):
    """fit(4) equals fit(2) -> save -> resume to 4, and the manifest says
    which pipeline and schedule made the checkpoint."""
    _, graph = graphs
    kw = dict(merge_every=2, repartition_every=2, block_epochs=4)
    full = _fit(graph, **kw)
    d = str(tmp_path)
    _fit(graph, epochs=2, ckpt_dir=d, checkpoint_every=2,
         sync_checkpoints=True, **kw)
    resumed = _fit(graph, ckpt_dir=d, resume=True, sync_checkpoints=True,
                   **kw)
    _same(full, resumed)
    from repro_torch.train import checkpoint as ckpt_lib
    _, _, extra = ckpt_lib.restore(d, step=4)
    assert extra["pipeline"] == "device"
    assert extra["config"]["pipeline"] == "device"
    assert extra["config"]["merge_every"] == 2
    assert extra["config"]["repartition_every"] == 2


def test_one_seed_one_run(graphs):
    _, graph = graphs
    a, b = _fit(graph, block_epochs=2), _fit(graph, block_epochs=2)
    c = _fit(graph, block_epochs=2, seed=1)
    _same(a, b)
    assert a.loss_history != c.loss_history


@pytest.mark.parametrize("opts", [dict(merge_every=2),
                                  dict(repartition_every=2)])
def test_schedule_changes_the_trajectory_and_learns(graphs, opts):
    _, graph = graphs
    base = _fit(graph, epochs=6, block_epochs=6, dim=16)
    other = _fit(graph, epochs=6, block_epochs=6, dim=16, **opts)
    assert not torch.equal(base.params["ent"], other.params["ent"])
    assert other.loss_history[-1] < other.loss_history[0], \
        other.loss_history


def test_callback_fires_at_block_boundaries(graphs):
    _, graph = graphs
    calls = []
    res = _fit(graph, epochs=6, block_epochs=2,
               callback=lambda e, loss: calls.append((e, loss)))
    assert [e for e, _ in calls] == [1, 3, 5]
    assert [loss for _, loss in calls] == res.loss_history[1::2]


# ---------------------------------------------------------------------------
# Resume across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cross(graphs, reference, tmp_path_factory):
    """Two-epoch checkpoints of the ``merge_every=2`` cell: the reference's
    from its own run, the port's from the replayed draws."""
    ref_graph, graph = graphs
    tables, kw, want, draws = reference("sgd-average-merge2")
    root = tmp_path_factory.mktemp("cross_device")
    ref_dir, port_dir = str(root / "ref"), str(root / "port")
    init = {n: jnp.asarray(t) for n, t in tables.items()}
    ref_kg.fit(ref_graph, "transe", "sgd", epochs=2, seed=0, params=init,
               ckpt_dir=ref_dir, checkpoint_every=2, sync_checkpoints=True,
               **kw)
    port_kg.fit(graph, "transe", "sgd", epochs=2, seed=0, params=tables,
                device="cpu", ckpt_dir=port_dir, checkpoint_every=2,
                sync_checkpoints=True, draws=lambda e: draws[e], **kw)
    return dict(kw=kw, want=want, draws=draws, root=root, ref_dir=ref_dir,
                port_dir=port_dir)


def test_port_resumes_reference_device_checkpoint(graphs, cross):
    _, graph = graphs
    d = str(cross["root"] / "ref_copy")
    shutil.copytree(cross["ref_dir"], d)
    draws = cross["draws"]
    got = port_kg.fit(graph, "transe", "sgd", epochs=EPOCHS, seed=0,
                      device="cpu", ckpt_dir=d, resume=True,
                      sync_checkpoints=True,
                      draws=lambda e: draws[e], **cross["kw"])
    _close({n: t.numpy() for n, t in got.params.items()}, got.loss_history,
           cross["want"])
    assert got.loss_history[:2] == cross["want"].loss_history[:2]


def test_reference_resumes_port_device_checkpoint(graphs, cross):
    ref_graph, _ = graphs
    d = str(cross["root"] / "port_copy")
    shutil.copytree(cross["port_dir"], d)
    got = ref_kg.fit(ref_graph, "transe", "sgd", epochs=EPOCHS, seed=0,
                     ckpt_dir=d, resume=True, sync_checkpoints=True,
                     **cross["kw"])
    _close(got.params, got.loss_history, cross["want"])


# ---------------------------------------------------------------------------
# The draws
# ---------------------------------------------------------------------------

KNOWN_BITS = [669439499, 1569962428, 2030472462, 3527680319]
KNOWN_SEED_KEY = 1227298020
KNOWN_DEVICE_KEYS = (537258108, 1299122225, 1302266306, 1078367268)
KNOWN_U24 = [5279263, 12360953, 8345047]


def test_known_answers():
    """Pinned values of the hash: a change to it changes every run.  The
    tensor path and Python's integers agree."""
    assert keys.random_bits(0, 4).tolist() == KNOWN_BITS
    assert [keys.bits(0, c) for c in range(4)] == KNOWN_BITS
    assert keys.seed_key(0) == KNOWN_SEED_KEY
    assert keys.device_keys(0) == KNOWN_DEVICE_KEYS
    assert keys.uniform(7, 3).tolist() == [b / 2**24 for b in KNOWN_U24]


def test_draws_are_pure_in_seed_stream_epoch_worker():
    k = keys.device_keys(3)
    assert keys.device_keys(3) == k and keys.device_keys(4) != k
    assert len(set(k)) == 4
    draw = lambda key, e, w: keys.uniform(
        keys.fold_in(keys.fold_in(key, e), w), 64)
    ref = draw(k[0], 5, 1)
    assert torch.equal(draw(k[0], 5, 1), ref)
    for other in (draw(k[0], 6, 1), draw(k[0], 5, 0), draw(k[1], 5, 1),
                  draw(keys.device_keys(4)[0], 5, 1)):
        assert not torch.equal(other, ref)
    # a tensor of keys draws each key's own stream
    ws = keys.fold_in(keys.fold_in(k[0], 5), torch.arange(3))
    many = keys.uniform(ws, 64)
    assert many.shape == (3, 64) and torch.equal(many[1], ref)
    assert keys.fold_in(k[0], 5) == int(keys.fold_in(k[0], torch.tensor(5)))
    u = keys.uniform(k[2], 10000)
    assert 0 <= float(u.min()) and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 0.02
    r = keys.randint(k[2], 10000, 1, 300)
    assert int(r.min()) == 1 and int(r.max()) == 299
    p = keys.permutation(k[3], 1000)
    assert torch.equal(p.sort().values, torch.arange(1000))


def test_device_batches_from_each_workers_split(graphs):
    _, graph = graphs
    W, B = 2, 64
    part = torch.as_tensor(port_kg_lib.partition_balanced(0, graph.train, W))
    n_w = part.shape[1]
    key = keys.fold_in(keys.device_keys(0)[0], 3)
    pos = port_kg_lib.device_epoch_batches(key, part, B)
    assert pos.shape == (W, n_w // B, B, 3) and pos.dtype == torch.int32
    for w in range(W):
        rows = pos[w].reshape(-1, 3)
        split = {tuple(t) for t in part[w].tolist()}
        drawn = [tuple(t) for t in rows.tolist()]
        assert len(set(drawn)) == len(drawn)            # no repeats
        assert set(drawn) <= split                       # its own split
        assert torch.equal(pos[w], port_kg_lib.device_worker_batches(
            keys.fold_in(key, w), part[w], B))
    other = port_kg_lib.device_epoch_batches(keys.fold_in(key, 1), part, B)
    assert not torch.equal(other, pos)


@pytest.mark.parametrize("sampling", ["unif", "bern"])
def test_device_negatives_corrupt_one_side(graphs, sampling):
    _, graph = graphs
    E = graph.n_entities
    part = torch.as_tensor(port_kg_lib.partition_balanced(0, graph.train, 2))
    pos = port_kg_lib.device_epoch_batches(5, part, 64)
    wkeys = keys.fold_in(9, torch.arange(2))
    uniform, offset = negative.device_draws(wkeys, pos.shape[:-1], E)
    assert uniform.shape == offset.shape == pos.shape[:-1]
    assert int(offset.min()) >= 1 and int(offset.max()) < E
    head_prob = torch.as_tensor(negative.bernoulli_stats(
        graph.train, graph.n_relations))
    cfg = KGConfig(E, graph.n_relations, dim=8, sampling=sampling)
    neg = get_model("transe").make_negatives(
        pos, cfg, head_prob, uniform=uniform, offset=offset)
    head = neg[..., 0] != pos[..., 0]
    tail = neg[..., 2] != pos[..., 2]
    assert torch.equal(neg[..., 1], pos[..., 1])
    assert bool((head ^ tail).all())
    if sampling == "unif":                               # a fair coin
        assert 0.4 < float(head.float().mean()) < 0.6
    assert int(neg.min()) >= 0 and int(neg[..., [0, 2]].max()) < E


def test_stratified_repartition_equals_reference(graphs):
    """On the same injected uniforms the port's stratified permutation is
    the reference's, and every worker keeps its stratum counts round after
    round."""
    ref_graph, _ = graphs
    W = 2
    part = ref_kg_lib.partition_degree_stratified(0, ref_graph.train, W)
    flat = part.reshape(-1, 3)
    strata = ref_kg_lib.triplet_strata(flat, ref_graph.n_entities)
    n = len(strata)
    counts = []
    for r in (1, 2):
        key = jax.random.fold_in(jax.random.PRNGKey(0), r)
        want = np.asarray(ref_kg_lib.repartition_perm_stratified(
            key, jnp.asarray(strata), W, r))
        u = torch.as_tensor(np.asarray(jax.random.uniform(key, (n,))))
        got = port_kg_lib.repartition_perm_stratified(
            None, torch.as_tensor(strata), W, r, uniform=u)
        np.testing.assert_array_equal(got.numpy(), want)
        own = port_kg_lib.repartition_perm_stratified(
            keys.fold_in(11, r), torch.as_tensor(strata), W, r)
        per_worker = own.reshape(W, -1)
        counts.append([np.bincount(strata[p], minlength=8).tolist()
                       for p in per_worker.numpy()])
        moved = port_kg_lib.device_repartition(
            keys.fold_in(11, r), torch.as_tensor(part), r,
            torch.as_tensor(strata))
        np.testing.assert_array_equal(moved.numpy(), flat[own.numpy()]
                                      .reshape(W, -1, 3))
    assert counts[0] == counts[1]
    spread = np.ptp(np.asarray(counts[0]), axis=0)
    assert spread.max() <= 1
    ident = port_kg_lib.repartition_perm_stratified(
        3, torch.as_tensor(strata), W, 0)
    assert torch.equal(ident, torch.arange(n))


def test_repartition_round_zero_is_the_partition(graphs):
    _, graph = graphs
    part = torch.as_tensor(port_kg_lib.partition_balanced(0, graph.train, 2))
    assert port_kg_lib.device_repartition(5, part, 0) is part
    moved = port_kg_lib.device_repartition(5, part, 1)
    assert moved.shape == part.shape and not torch.equal(moved, part)
    assert sorted(map(tuple, moved.reshape(-1, 3).tolist())) == \
        sorted(map(tuple, part.reshape(-1, 3).tolist()))


def test_injected_ids_are_checked(graphs):
    """The kernels skip their id checks inside the engine, so the engine
    checks what it is handed: injected draws, and the params' shapes."""
    _, graph = graphs
    part = port_kg_lib.partition_balanced(0, graph.train, 2)
    pos = port_kg_lib.epoch_batches(0, 0, part, 64)
    bad = pos.copy()
    bad[0, 0, 0, 2] = graph.n_entities
    with pytest.raises(IndexError, match="injected negatives"):
        _fit(graph, epochs=1, draws=lambda e: (pos, bad, None))
    with pytest.raises(IndexError, match="injected batches"):
        _fit(graph, epochs=1, draws=lambda e: (bad, pos, None))
    with pytest.raises(IndexError, match="injected negatives"):
        _fit(graph, epochs=1, pipeline="host", draws=lambda e: (bad, None))
    with pytest.raises(ValueError, match="rows"):
        _fit(graph, epochs=1, params={
            "ent": np.zeros((graph.n_entities - 1, 8), np.float32),
            "rel": np.zeros((graph.n_relations, 8), np.float32)})


@pytest.mark.parametrize("n", [1, 2, 5, 256, 520])
def test_pairwise_mean_is_a_fixed_tree(n):
    """The epoch loss's reduction: ``+0.0``-padded to a power of two and
    summed pairwise level by level, then one division — the order a
    Python float32 emulation of the same tree gives, along any axis."""
    x = torch.rand(3, n, generator=torch.Generator().manual_seed(n))

    def tree(vals):
        vals = list(vals) + [np.float32(0)] * ((1 << (n - 1).bit_length())
                                               - n)
        while len(vals) > 1:
            vals = [np.float32(a + b) for a, b in zip(vals[0::2],
                                                      vals[1::2])]
        return np.float32(vals[0] / np.float32(n))

    want = [tree(row.numpy()) for row in x]
    got = util.pairwise_mean(x)
    assert got.tolist() == want
    assert torch.equal(util.pairwise_mean(x.T.contiguous(), 0), got)
    torch.testing.assert_close(got, x.mean(-1))


# ---------------------------------------------------------------------------
# Validation: the reference's errors, raised by both packages
# ---------------------------------------------------------------------------

def _packages(graphs):
    ref_graph, graph = graphs
    return {
        "reference": dict(mr=ref_mr, kg=ref_kg, graph=ref_graph, extra={}),
        "port": dict(mr=mapreduce, kg=port_kg, graph=graph,
                     extra=dict(device="cpu")),
    }


def _fit_in(p, **kw):
    kw = dict(KW, seed=0, **kw, **p["extra"])
    return p["kg"].fit(p["graph"], **kw)


def _train_in(p, epochs, **kw):
    kcfg, mcfg = p["kg"].make_configs(p["graph"], "transe", "sgd",
                                      **dict(KW, merge_every=2,
                                             block_epochs=2))
    return p["mr"].train(p["graph"], kcfg, mcfg, epochs=epochs,
                         **kw, **p["extra"])


VALIDATION = {
    "repartition_needs_device": (
        lambda p: p["mr"].MapReduceConfig(
            pipeline="host",
            schedule=p["mr"].EpochSchedule(repartition_every=2)),
        "pipeline='device'"),
    "repartition_every_positive": (
        lambda p: p["mr"].EpochSchedule(repartition_every=0),
        "repartition_every"),
    "repartition_multiple_of_merge": (
        lambda p: p["mr"].EpochSchedule(block_epochs=2, merge_every=2,
                                        repartition_every=3),
        "repartition_every"),
    "schedule_needs_device": (
        lambda p: p["mr"].MapReduceConfig(
            pipeline="host", schedule=p["mr"].EpochSchedule(block_epochs=4)),
        "pipeline='device'"),
    "merge_every_needs_sgd": (
        lambda p: p["mr"].MapReduceConfig(
            paradigm="bgd", pipeline="device",
            schedule=p["mr"].EpochSchedule(block_epochs=4, merge_every=2)),
        "SGD-paradigm"),
    "block_multiple_of_merge": (
        lambda p: p["mr"].EpochSchedule(block_epochs=3, merge_every=2),
        "multiple of"),
    "block_epochs_positive": (
        lambda p: p["mr"].EpochSchedule(block_epochs=0), "block_epochs"),
    "merge_every_positive": (
        lambda p: p["mr"].EpochSchedule(merge_every=0), "merge_every"),
    "epochs_multiple_of_merge": (
        lambda p: _fit_in(p, epochs=5, block_epochs=2, merge_every=2),
        "multiple of"),
    "bad_pipeline_name": (
        lambda p: p["mr"].MapReduceConfig(pipeline="offload"),
        "bad pipeline"),
    "overlap_refuses_repartition": (
        lambda p: p["mr"].MapReduceConfig(
            pipeline="device", partition="overlap",
            schedule=p["mr"].EpochSchedule(repartition_every=2)),
        "overlap"),
    "eval_every_multiple_of_merge": (
        lambda p: _fit_in(p, epochs=4, merge_every=2, block_epochs=2,
                          eval_every=1),
        "eval_every=1"),
    "checkpoint_every_multiple_of_merge": (
        lambda p: _train_in(p, 4, checkpoint=p["mr"].CheckpointConfig(
            ckpt_dir="unused", every=1)),
        "checkpoint every=1"),
    "start_epoch_multiple_of_merge": (
        lambda p: _train_in(p, 4, start_epoch=1), "start_epoch=1"),
}


@pytest.mark.parametrize("package", ["reference", "port"])
@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_errors(graphs, case, package):
    make, match = VALIDATION[case]
    with pytest.raises(ValueError, match=match):
        make(_packages(graphs)[package])
